"""Drive the PyTorch port's main path on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with an NVIDIA H100 (any
sm_90 card) and the CUDA toolkit. The paths are driven through the
training session runtime and its ``train`` entry point: PPO on jax:lift
(the GAE kernel; at gae_impl='assoc' the reverse linear scan), IMPALA on
pixel jax:pong (the V-trace kernel; at vtrace_impl='assoc' the reverse
linear scan), DDPG with prioritized replay on jax:lift (the replay
gather and scatter kernels), and the trajectory transformer
(``model.encoder.kind='trajectory'``: KV-cached acting, then the sequence
learn) under PPO on jax:pendulum and pixel jax:pong16 (GAE; the scan at
'assoc') and IMPALA on jax:cartpole (V-trace), then the host-env paths
(PPO on dm_control:cheetah-run and gym:CartPole-v1 through the Trainer's
alternate and overlap loops, IMPALA on gym:CartPole-v1, DDPG with
prioritized replay on gym:Pendulum-v1 through its host loop), PPO with
the NatureCNN on the NutAssembly pixel env jax:nut_pixels, and the SEED
topology (env workers, threads or spawned processes, feeding one batched
inference server: PPO on cheetah-run, IMPALA on CartPole and on 256
pixel envs), the profiling and cost accounting of a session (the
profiler captures, the perf gauges, the diag and trace readers), and
the 'bf16' and 'bf16_fp8' precision policies (dynamic loss scaling, bf16
staging and replay storage, the fp8 Dense path), live parameter
publishing with the processes that consume it (``actor``, ``eval
--follow``) and ``eval --best`` with its video, the serving tier
(SEED behind a replicated, autoscaled inference fleet; the versioned
parameter fanout with a subscriber process), and the sharded experience
plane (remote DDPG over shard servers, the device hot tier, SEED's chunk
relay), the disk spill tier with replay from its log, the session
gateway with its load generator, the ops plane with its control loop
(the aggregator, SLOs, the watchdog, incidents and remediation, on in
every session as by default), the program autotuner and chaos campaigns.
Five kernels are built
and checked. Phases, each printing one JSON line:

1. device  - the card as nvidia-smi and torch name it;
2. build   - every CUDA kernel, compiled from csrc/, one nvcc per source,
             all started together;
3. kernels - each kernel against its plain PyTorch version on the card,
             at its path's shapes and ragged ones (for the three scan
             kernels also the edges of their shared-memory ring), plus its
             time, its bound, a copy_ of as many bytes (the scans), the
             launch floor (a one-element fill_), the plain version's time
             and, where one PyTorch call computes the same function, that
             call's time (GAE, V-trace, replay gather, replay scatter,
             reverse linear scan; the scan also at IMPALA's shape);
4. parity  - one small f32 train iteration (two for DDPG) on the card and
             on the CPU with the same injected randomness (the CPU path is
             the one the tests hold against the JAX package), TF32 off,
             with the launches of each scan kernel counted on the card:
             PPO on jax:lift at gae_impl 'xla' and 'assoc', IMPALA on
             jax:pong at vtrace_impl 'xla' and 'assoc', DDPG on jax:lift
             under uniform and under prioritized replay; the trajectory
             transformer (kv acting, sequence learn) under PPO on
             jax:pendulum at 'xla' and 'assoc', IMPALA on jax:cartpole,
             PPO with the CNN stem on jax:pong16; and kv acting against
             padded acting on the card, in f32 and under 'mixed';
5. train   - ``Trainer(config).run`` / ``OffPolicyTrainer(config).run``
             (the session runtime: ``SessionHooks`` around a
             ``LoopEngine``, in a fresh folder, metrics read every
             iteration, checkpoint and eval off) with one warm-up
             iteration and three timed ones (one and two at 'assoc');
             checks finite metrics and that every iteration launched its
             path's kernels as often as the path says:
             PPO at the north-star geometry (MLP 64x64, jax:lift, 4096
             envs x 256 steps, 4 epochs x 4 minibatches, 'mixed'), at
             gae_impl 'xla' and 'assoc', then IMPALA at the pong geometry
             (NatureCNN (32, 64, 64) / (8, 4, 3) / (4, 2, 1) / 512,
             jax:pong [42, 42, 2] uint8 pixels, 1024 envs x 32 steps,
             'mixed') at vtrace_impl 'xla' and 'assoc', then DDPG at its
             headline geometry (actor and critic 64x64 tanh with
             LayerNorm, jax:lift, 2048 envs x 16 steps, 64 updates of 256
             per iteration, prioritized replay of 200,000, 'mixed'), with
             one more DDPG iteration under ``torch.cuda.set_sync_debug_mode
             ("error")`` to show that it makes no host sync; then PPO with
             the trajectory transformer at the JAX package's
             perf_report.py::ppo_trajectory_pendulum geometry (jax:pendulum,
             1024 envs x 128 steps, 2 epochs x 2 minibatches, encoder 64
             wide, 2 layers of 4 heads x 16, kv acting, 'mixed'), with one
             more iteration under set_sync_debug_mode("error"), and IMPALA
             with it on jax:cartpole (default encoder widths, 1024 envs x
             32 steps);
6. session - the runtime users start, one JSON line a step:
             ``train ppo jax:lift`` through the CLI at the north-star
             geometry for 8 iterations (metrics every 2, checkpoint and
             eval every 4; GAE launched once an iteration; iteration 3,
             off every cadence, and every cadence's ops sweep, after its
             metrics read, under set_sync_debug_mode("error")); a
             SIGTERM stop with its emergency checkpoint and a bit-equal
             auto-resume; a ``nan_state`` fault rolled back to the last
             finite checkpoint with the LR backed off; ``train ddpg
             jax:lift`` at the headline geometry with
             ``checkpoint.include_replay``, 3 iterations and a resume
             that starts from the saved replay bit for bit (gather and
             scatter 64 launches each an iteration); and PPO on jax:lift
             at tests/test_envs.py::test_ppo_learns_on_lift's config until
             the episode return reaches 400 (fails if it does not within
             5,000,000 env steps); then the three trajectory commands
             (``train ppo jax:pendulum``, ``train impala jax:cartpole``,
             ``train ppo jax:pong16`` with the CNN stem, each with ``--set
             learner_config.model.encoder.kind=trajectory``) through the
             CLI with eval on, whose episodes outrun the horizon, so the
             evaluator's acting context wraps;
7. host    - the env probe (which of gymnasium, dm_control and mujoco
             import; where one is missing, a seeded numpy fixture env
             with the missing env's specs stands in for it, and every
             line names the env's source); host PPO on cheetah-run on the
             card against the CPU, one alternate iteration at 'xla' and at
             'assoc' (the reverse scan); PPO on cheetah-run at the JAX
             package's perf_report.py:672-735 geometry (32 envs x 64
             steps, 4 x 4, 'mixed'; 1 warm-up and 3 timed iterations)
             under the alternate loop, with one more iteration whose host
             syncs are counted against its 64 action reads, and under the
             overlap loop; IMPALA and PPO on CartPole (32 x 32); the
             replay gather against its plain version at host DDPG's rows
             (the trainer's replay example in a 200,000-row ring, 256
             indices, with and without repeats) and two f32 host DDPG
             iterations on Pendulum on the card against the CPU (32 x 16,
             prioritized, 200,000 rows, 4 updates of 256 an iteration);
             DDPG with prioritized replay on Pendulum (32 x 16, 64 updates
             of 256 from a 200,000-row ring; gather and scatter 64 each an
             iteration) and ``train ddpg`` with include_replay and a
             bit-equal resume; the nut pixels on the card against the CPU,
             bit for bit; PPO on jax:nut_pixels at perf_report.py:441-470's
             geometry (512 envs x 32 steps, 2 x 4, the default NatureCNN,
             'mixed'; 1 + 3 iterations); and ``train ppo
             dm_control:cheetah-run --num-envs 32`` with the host
             evaluator and checkpoints, then an auto-resume;
8. seed    - the SEED topology (the probe also reports ale_py and zmq;
             spawned workers get the fixture envs through this script's
             last lines, which a spawned child runs as __mp_main__): one
             SEED learn on a fixed chunk on the card against the CPU (f32,
             IMPALA on CartPole [32, 8], PPO on cheetah-run [64, 4]);
             ``SEEDTrainer.run`` with 3 warm-up and 6 timed learns (one
             chunk a learn) for PPO on cheetah-run over 4 worker processes
             x 8 envs on shared-memory slabs (perf_report.py:808-816, chunks
             [64, 4], 4 x 4, 'mixed'; GAE once a learn), IMPALA on CartPole
             over 2 thread workers x 16 envs on the pickle wire (chunks [32,
             8]; V-trace once a learn) and IMPALA with the NatureCNN over 4
             worker processes x 64 pixel envs with jax:pong's specs (a
             fixture: BASELINE config (5)'s 256 envs, chunks [32, 32]), each
             with its serve and wire figures, staleness and lineage gauges,
             host syncs (one a serve, none in a learn) and the same learn
             timed with the data plane stopped; a worker process terminated
             mid-run and respawned, with no slab left in /dev/shm; and
             ``train impala gym:CartPole-v1 --workers 2`` for 3 iterations;
9. profile - profiling and cost accounting: ``train ppo jax:lift`` at the
             north-star geometry with the ``session.profiler`` window
             (iterations 4-5 captured), then a second session resumed in
             the same folder while another process runs ``python -m
             surreal_tpu_torch profile <folder>``; for each capture, from
             its Chrome trace, the window's wall time, the device busy
             share (the union of the CUDA kernel intervals), the GAE
             kernel's launches (one a learn of the window) and the eight
             kernels with the most time, and how much longer a profiled
             iteration took; ``diag <folder>`` listing the program costs
             and both captures; ``perf/mfu`` in (0, 1.05] and
             ``perf/flops_per_s`` within 10% of the counted FLOPs over
             fenced iteration times; the card's ``program_cost`` FLOPs,
             bytes and kernel entries equal to the CPU's for one config
             at 256 x 32 (PPO at 'xla' and 'assoc', IMPALA, prioritized
             DDPG); ``train impala gym:CartPole-v1 --workers 2`` with every
             worker step head-sampled, then ``trace <folder>``: span
             trees, none torn. (The session phase's set_sync_debug_mode
             iteration runs with the cost counting and the profile
             trigger on, their defaults.)
10. precision - the 'bf16' and 'bf16_fp8' policies at the widths of the
             north-star, pong and ddpg cells: (a) one north-star
             iteration at 'mixed' and one at 'bf16' from the same state
             and draws, parameters within 1e-5 (the reference's
             'mixed'-vs-'bf16' rule), loss scale 32768, no overflow, GAE
             once each; the north-star through ``Trainer.run`` at
             'mixed', 'bf16' and 'bf16_fp8' (1 + 2 iterations each, in
             turns), with the aten ops counted in an iteration and the
             rollout and the learn each fenced and one learn profiled
             (its launches and device busy time); (b) IMPALA on pong at
             'mixed', 'bf16' and 'bf16_fp8' in turns, V-trace once a
             learn, one learn of each profiled; (c) prioritized DDPG at 'bf16':
             obs storage half of 'mixed''s, gather and scatter 64 each an
             iteration, the gather kernel bit-exact at the bf16 rows and
             timed there; (d) an inf reward in a north-star 'bf16'
             iteration under set_sync_debug_mode("error"): every
             parameter bit-unchanged, ``health/nonfinite`` 1, 16
             overflows, the scale at its floor of 1.0; (e) ``train ppo
             jax:lift`` at 'bf16' for 2 iterations and a resume, the
             restored state (its loss-scale state included) bit-equal to
             the saved one, then a relaunch at 'mixed' stopped by
             PrecisionMismatchError.
11. publish - live parameter publishing (the parameter service over the
             standard-library sockets, the agents, the actor and eval
             subcommands): ``train ppo jax:lift`` at the north-star
             geometry with ``session_config.publish.enabled`` (every
             iteration; metrics every 2, a checkpoint every 4,
             ``env_config.video`` on) while ``python -m surreal_tpu_torch
             actor --folder F`` (64 envs on the card, a fetch every 10
             acts, from version 2, 768 episodes) and ``eval F --follow
             --rounds 2`` run as processes of their own; the session
             stops at the first boundary after both have exited (4 to 40
             iterations), GAE once a learn, iteration 3 under
             set_sync_debug_mode("error") but for its publish, and every
             publish one host sync; after each boundary a client on the
             card fetches from the session's server, each view bit-equal
             to the one published under its version; the actor must see
             at least 2 versions; then ``eval F --best`` in this process,
             its episode recorded (``.npz`` without imageio) and read
             back; ``train ddpg jax:lift`` at the headline DDPG geometry
             with prioritized replay and publishing every iteration while
             a DDPG actor process acts from the actor-only view (gather
             and scatter 64 each an iteration); and the north-star with
             publishing every 2nd iteration and no consumer, the
             publishing iterations' median against the others' in one
             run. Publish ms p50 (encode and send, the ``param-publish``
             span), fetch ms p50 and the bytes of a fetch are printed.
12. fleet  - the serving tier under SEED (``topology.inference_fleet``):
             ``train impala gym:CartPole-v1 --workers 4`` with 2 replicas
             (thread workers on the pickle wire, chunks [32, 8], each
             iteration paced to at least 50 ms) and one replica killed by
             the ``fleet.replica`` ``kill_replica`` injection (remediation
             off: phase ops holds its scale-up): the replica
             respawned in place, its workers respawned against the
             survivor, 2 replicas live at the end, the last
             ``serving_tier`` event all alive, no slab left, V-trace once a
             learn; the seed-impala-pixels256 geometry (4 worker processes
             x 64 pixel envs, chunks [32, 32]) at 1, 2, 2 and 1 replicas in
             turns, each with its iteration ms, env steps/s, serve p50/p99
             fleet-wide and per replica and syncs a serve; seed-ppo-cheetah
             (4 processes x 8 envs, chunks [64, 4]) at 2 replicas, GAE once
             a learn; autoscale from 1 replica with a threshold every serve
             passes (``fleet/scale_ups``);
13. fanout - the versioned parameter fanout (``publish.fanout``):
             ``train ppo jax:lift`` at the north-star geometry publishing
             every iteration under three arms (f32 without delta, f32
             delta, bf16 delta), then ``train impala jax:pong`` (the
             NatureCNN) under f32 delta with its 4th frame dropped
             (``param.publish`` ``drop_frame``) and bf16 delta, each while
             this script runs itself as a subscriber process
             (``chip_smoke.py fanout-subscriber <folder> <out>``) that
             polls frames, acks them and catches up by fetch; for each arm
             the frames (full, delta, re-keys, bytes of each kind), the
             publish ms p50 (the publisher's share beside it; the
             publisher alone is phase publish's), one host sync a publish,
             the subscriber's applied, stale and fetched counts, and its
             view at each version: f32 without delta bit-equal to the view
             fetched from the session's server, f32 delta equal to the
             publisher's shadow and within one rounding step of the view,
             bf16 delta equal to the shadow; GAE or V-trace once a learn.
14. experience - the sharded experience plane (``replay.kind=remote``,
             fixture gym:Pendulum-v1, 8 envs x 32 steps, 8 updates of 256
             an iteration from 100,000 rows over 2 shards): thread shards
             over shm, tcp and pickle in turns with the in-process host
             DDPG at the same geometry (iteration ms, env steps/s, wire
             bytes a step, sample wait, rows, 0 dropped); the strict loop
             twice (equal final losses and grad norm); prioritized shards
             (one PRIO frame per shard per iteration that learned); the
             device hot tier (the gather kernel once per update on a hit,
             the first request a counted miss; its sample wait against
             the warm-only strict runs; its draw and gather under
             set_sync_debug_mode("error"), bit-equal to UniformReplay and
             to the plain gather, timed); process shards killed by
             ``experience.shard`` ``kill_shard`` and respawned (2 live at
             the end, no slab left, no shard with a CUDA context, the
             process shards' rows in the ops snapshot; the thread shards'
             rows alive in every remote run's); SEED
             through the relay (``train impala gym:CartPole-v1`` and
             ``train ppo dm_control:cheetah-run``, 2 thread workers each;
             V-trace or GAE once a learn);
15. spill  - the disk spill tier (``replay.tiers.spill``) at the
             experience phase's geometry with the hot tier on: one log a
             shard under the session folder, the ``tier/spill_*`` gauges
             equal to the segments, rows and bytes on disk; runs with an
             ``experience.spill`` ``enospc`` plan (errors counted,
             training on) and ``truncate_segment`` (the tear counted by
             the reader); ``OffPolicyTrainer.replay_from_log`` twice over
             the first log on the card (equal digests, the gather kernel
             once per update, every gather of the second bit-equal to its
             plain version);
16. gateway - the session gateway (``topology.gateway.enabled``) in front
             of 2 replicas of ``train impala gym:CartPole-v1`` with 2
             thread workers: the tenant side reads ``gateway.json`` and
             runs ``LoadGenerator(default_mix())`` for 10 s beside a
             probe session; a ``gateway.session`` ``kill_replica`` 5 s in
             (every session of the dead replica migrated, no tenant
             thread died or timed out, the hostile frames counted, the
             replica respawned; remediation off, as in phase fleet);
             V-trace once a learn; the act round trip
             p50/p99 server-side and on the probe, acts/s, cache hits.
17. ops    - the ops plane's acceptance run (tests/test_remediate.py's):
             ``train impala`` on the fixture gym:CartPole-v1 (horizon 8,
             4 envs a worker), 2 thread workers behind 2 replicas and the
             gateway with a ``hotkey`` quota, a steady and a hot-key
             ``LoadGenerator`` tenant, the test's watchdog and remediate
             knobs, a ``fleet.replica`` ``kill_replica`` at 40: the last
             snapshot's tiers and the dead ones, the incident and its top
             cause (must be the fleet), the actions (a ``fleet_scale_up``
             executed, journaled, in the incident's evidence and in
             ``why``'s Actions section) with their baselines, verdicts and
             reverts, ``fleet/replicas_live`` before and after, the
             watchdog's sweep with the incident observe at each cadence
             (p50, p99), V-trace once a learn and one path call [8, 2]
             bit-equal to ``vtrace_fused_plain``; then the north-star PPO
             iteration with the ops plane and its loop on and off, in turns
             on, off, off, on (GAE once an iteration).
18. tune   - the program autotuner: ``tune ppo jax:lift`` through the CLI
             at the north-star geometry over the port's space (precision,
             gae_impl, shuffle; 2 warm-up, 2 throwaway and 4 measured
             iterations a trial), each trial's ms and launches (GAE once a
             learn at 'xla', the reverse scan at 'assoc'); the same command
             again, a pure hit (nothing measured or launched); ``train ppo
             jax:lift`` with ``algo.autotune=cache`` on that cache for 3
             iterations, built with the winner, one ``tune`` event in its
             folder, shown by ``diag``; the default point and the winner
             through ``Trainer.run`` in turns (default, winner, winner,
             default; 1 + 3 iterations each); ``tune impala
             gym:CartPole-v1`` (32 x 32) on the learn surface, V-trace
             once a learn at 'xla'. Artifacts in a temporary folder.
19. chaos  - ``chaos all --seeds 3`` through the CLI: one seeded schedule
             a profile (seed_gateway, seed_experience, ddpg_spill) on the
             fixture envs, every invariant oracle clean, no failure; per
             schedule its seconds, faults injected, sites fired and
             V-trace's launches, once a learn in the SEED profiles.

Each phase's line carries ``elapsed_s``, the seconds since the script
started. Then the kernels summary line (each kernel's launches summed over the
timed train phases of every path that launches it, itemised under
``launches_by_path``), the nvidia-smi line,
and as the last line ``{"ok": true, "device": {...}}``. Any failure raises
and exits non-zero; without CUDA, or outside a checkout, it exits
non-zero before printing.
"""

from __future__ import annotations

import io
import json
import math
import os
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import redirect_stdout

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12          # float32 outside the tensor cores
MAIN_T, MAIN_B = 256, 4096      # GAE's shape on the main path
PONG_T, PONG_B = 32, 1024       # V-trace's shape on the IMPALA path
# the trajectory transformer's PPO geometry (the JAX package's
# perf_report.py::ppo_trajectory_pendulum): GAE's shape on that path
TRAJ_T, TRAJ_B = 128, 1024
TRAJ_ENC = dict(kind="trajectory", features=64, num_layers=2, num_heads=4, head_dim=16, act_impl="kv")
# BASELINE config (2) on the host loops: the JAX package's perf_report.py:672-735 cheetah-run geometry
CHEETAH_B, CHEETAH_T = 32, 64
CARTPOLE_B, CARTPOLE_T = 32, 32
# host DDPG: the ddpg cell's learner settings on gym:Pendulum-v1
HOST_DDPG_B, HOST_DDPG_H = 32, 16
# BASELINE config (4): the JAX package's perf_report.py:441-470 nut_pixels geometry
NUT_B, NUT_T = 512, 32
# the repo's 16x16 pong CNN (tests/test_envs.py, tests/test_trajectory_policy.py)
PONG16_CNN = dict(enabled=True, channels=[8, 16], kernels=[4, 3], strides=[2, 1], dense=32)
# the edges of the scan kernels' ring (ops/scan_tiles.py): T longer than the
# ring, T not a multiple of a stage, B below one tile or not a multiple of
# 4 (the cp.async copy), several waves of blocks, T below one stage
SCAN_EDGE_SHAPES = [(1000, 33), (MAIN_T - 1, MAIN_B), (MAIN_T, 5), (PONG_T, PONG_B - 1), (64, 65536), (3, 1000)]
# GAE's shapes on the host PPO and nut_pixels paths
HOST_GAE_SHAPES = [(CHEETAH_T, CHEETAH_B), (NUT_T, NUT_B), (CARTPOLE_T, CARTPOLE_B)]
# a SEED iteration learns one chunk: with 4 pipelined workers a round of
# the fleet is 8 chunks, so the timed window spans one round (two before
# the script's time limit asked for a cut)
SEED_WARMUP_ITERS, SEED_TIMED_ITERS = 3, 6  # cut from 4, 8 for the time limit
# the JAX package's perf_report.py:808-816 SEED geometry: 4 worker
# processes x 8 envs (the 32-env fleet of host-ppo-cheetah), chunks [64, 4]
SEED_PPO_WORKERS, SEED_PPO_ENVS = 4, 8
# host-impala-cartpole's 32 envs over the 2 thread workers of
# perf_wallclock.py:2201-2208, chunks [32, 8]
SEED_CARTPOLE_WORKERS, SEED_CARTPOLE_ENVS = 2, 16
# BASELINE config (5)'s 256 envs: 4 worker processes x 64, chunks [32, 32]
SEED_PIXEL_WORKERS, SEED_PIXEL_ENVS, SEED_PIXEL_T = 4, 64, 32
SEED_SYNC_SERVES = 16
# the card-versus-CPU SEED learn's bar on params, the learn-level one
SEED_PARAM_ATOL = 1e-5
# the SEED learns' chunks (pipelined workers: half a worker's envs each):
# GAE at PPO's [64, 4], V-trace at IMPALA's [32, 8] and [32, 32]
SEED_GAE_SHAPES = [(CHEETAH_T, SEED_PPO_ENVS // 2)]
SEED_VTRACE_SHAPES = [(CARTPOLE_T, SEED_CARTPOLE_ENVS // 2), (SEED_PIXEL_T, SEED_PIXEL_ENVS // 2)]
KERNEL_SHAPES = [(MAIN_T, MAIN_B), (1, 1), (7, 1000), (MAIN_T, MAIN_B + 1), (TRAJ_T, TRAJ_B), *HOST_GAE_SHAPES,
                 *SEED_GAE_SHAPES, *SCAN_EDGE_SHAPES]
# the reverse scan runs at PPO's and IMPALA's shapes (the 'assoc' forms); its
# 8 KB stages hold all of T = 1000 in the ring at 33 columns, so two shapes
# more wrap the ring, under cp.async and under TMA
REV_SCAN_SHAPES = [*KERNEL_SHAPES, (PONG_T, PONG_B), (2000, 33), (2 * MAIN_T, MAIN_B)]
VTRACE_SHAPES = [(PONG_T, PONG_B), (1, 1), (7, 1000), (PONG_T, PONG_B + 1), (PONG_T, 5), (CARTPOLE_T, CARTPOLE_B),
                 *SEED_VTRACE_SHAPES,
                 *SCAN_EDGE_SHAPES]
# V-trace's float operations per element (csrc/vtrace.cu): rho 2 (sub,
# exp), delta 5, recursion 4, vs 1, successor 4, pg advantage 5
VTRACE_OPS = 21
# DDPG's headline geometry (the JAX package's perf_report.py::ddpg_prioritized_lift)
DDPG_B, DDPG_H, DDPG_K, DDPG_BS = 2048, 16, 64, 256
DDPG_CAPACITY = 200_000
DDPG_ROW_SHAPES = {"obs": (17,), "next_obs": (17,), "action": (4,), "reward": (), "discount": ()}
DDPG_MANY_ROWS = 64 * 256       # uniform sample_many: 64 batches of 256 in one gather
WARMUP_ITERS, TIMED_ITERS = 1, 3  # cut from 4, 8 (then 2, 4) to keep the script inside its time limit
TRAIN_ITERS = WARMUP_ITERS + TIMED_ITERS
ASSOC_WARMUP_ITERS, ASSOC_TIMED_ITERS = 1, 2  # the 'assoc' train phases, shorter
SPIN_CYCLES = 1_000_000         # about 0.5 ms of the card's clock, see time_cuda_ms
KERNEL_SOURCES = ["gae", "vtrace", "replay_rows", "rev_scan"]  # csrc/<name>.cu
KERNEL_REPLACES = {  # the TPU kernel body each CUDA kernel replaces
    "gae": "surreal_tpu/ops/pallas_gae.py:51",
    "vtrace": "surreal_tpu/ops/pallas_vtrace.py:49",
    "replay_gather": "surreal_tpu/ops/pallas_replay.py:40",
    "replay_scatter": "surreal_tpu/ops/pallas_replay.py:45",
    "rev_scan": "surreal_tpu/ops/pallas_returns.py:33",
}

_SCRATCH: list[str] = []  # the run's one temporary root, removed at exit
_T0 = time.perf_counter()


def scratch_dir(tag: str) -> str:
    """A fresh session folder under the run's temporary root."""
    if not _SCRATCH:
        _SCRATCH.append(tempfile.mkdtemp(prefix="chip_smoke_"))
    return tempfile.mkdtemp(prefix=f"{tag}_", dir=_SCRATCH[0])


def emit(obj) -> None:
    """One JSON line; a phase's line also carries the seconds since the
    script started."""
    if "phase" in obj:
        obj = {**obj, "elapsed_s": time.perf_counter() - _T0}
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def gae_inputs(T: int, B: int, seed: int, device: str) -> list[torch.Tensor]:
    """Random GAE inputs with episode ends: 15% dones, half of them true
    terminations and half time-limit truncations."""
    rng = np.random.default_rng(seed)
    gamma, lam = 0.99, 0.97
    done = rng.random((T, B)) < 0.15
    terminated = done & (rng.random((T, B)) < 0.5)
    arrays = [
        rng.normal(size=(T, B)),                 # rewards
        gamma * (1.0 - terminated),              # bootstrap discount
        gamma * lam * (1.0 - done),              # accumulation decay
        rng.normal(size=(T, B)),                 # v_t
        rng.normal(size=(T, B)),                 # v_next
    ]
    return [torch.from_numpy(a.astype(np.float32)).to(device) for a in arrays]


def time_cuda_ms(fn, runs: int, flush: torch.Tensor | None, spin: bool) -> float:
    """Median CUDA-event time of one call, over ``runs`` calls after two
    warm-up calls, with L2 flushed before each by zeroing ``flush`` (the
    50 MB L2 would otherwise hold the whole working set between calls;
    ``None`` leaves it warm).

    With ``spin``, the card then spins for about half a millisecond
    (``torch.cuda._sleep``) before the start event, so that the host has
    enqueued the call before the card reaches it: the events bracket the
    card's time for the call alone. Without it they also take in the
    host's time to issue the call (the wrapper's allocations and the
    ctypes call for a kernel; every launch for the plain versions, whose
    time is mostly that)."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(runs):
        if flush is not None:
            flush.zero_()
        if spin:
            torch.cuda._sleep(SPIN_CYCLES)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def launch_floor_ms(flush: torch.Tensor) -> float:
    """The card time of a one-element ``fill_``, timed as the kernels are
    (spin, L2 flushed): the practical floor that a launch of a kernel this
    small cannot beat."""
    x = torch.empty(1, device="cuda")
    return time_cuda_ms(lambda: x.fill_(1.0), runs=30, flush=flush, spin=True)


def kernel_phase(name: str, wrapper, plain, make_inputs, shapes, reads: int, writes: int, ops: int,
                 tpu_kernel: str | None = None, extra_bytes_per_b: int = 0, plan=None, counter=None,
                 also_timed=()) -> dict:
    """One kernel against its plain version on the card, exactly, at each
    of ``shapes`` (the first is its path's, which is also timed, L2
    flushed and warm, beside one ``copy_`` of as many bytes), each call one
    launch, with its bound from ``reads`` f32 inputs read and ``writes``
    f32 outputs written once each, and ``ops`` f32 operations, per element
    (plus ``extra_bytes_per_b`` bytes per batch column, e.g. a [B] input),
    and the launch floor beside it. ``plan(T, B)``, where given, is how the
    kernel cuts that shape; ``counter`` holds the launch count, where
    ``wrapper`` does not; ``also_timed`` are more shapes timed the same way
    (another path's)."""
    counter = counter or wrapper
    checks = []
    max_abs = 0.0
    for T, B in shapes:
        inputs = make_inputs(T, B, seed=T * 7919 + B, device="cuda")
        before = counter.launches
        got = wrapper(*inputs)
        if counter.launches != before + 1:
            raise AssertionError(f"{name} at [{T}, {B}]: {counter.launches - before} launches, expected 1")
        want = plain(*inputs)
        torch.cuda.synchronize()
        abs_err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        rel_err = max(float(((g - w).abs() / w.abs().clamp_min(1e-30)).max()) for g, w in zip(got, want))
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"{name} kernel != plain at [{T}, {B}]: max abs err {abs_err}")
        max_abs = max(max_abs, abs_err)
        checks.append({"shape": [T, B], "max_abs_err": abs_err, "max_rel_err": rel_err,
                       **({"plan": plan(T, B)} if plan else {})})

    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")

    def bound_ms(T, B):
        bytes_ms = ((reads + writes) * 4 * T * B + extra_bytes_per_b * B) / H100_BYTES_PER_S * 1e3
        ops_ms = ops * T * B / H100_F32_FLOPS * 1e3
        return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"

    def timed(T, B):
        inputs = make_inputs(T, B, seed=0, device="cuda")
        src = torch.empty(((reads + writes) * 4 * T * B + extra_bytes_per_b * B) // 8, device="cuda")
        dst = torch.empty_like(src)
        ms = time_cuda_ms(lambda: wrapper(*inputs), runs=30, flush=flush, spin=True)
        return inputs, {
            "shape": [T, B], "ms": ms, "bound_ms": bound_ms(T, B)[0], "bound_share": bound_ms(T, B)[0] / ms,
            "ms_warm_l2": time_cuda_ms(lambda: wrapper(*inputs), runs=30, flush=None, spin=True),
            "copy_same_bytes_ms": time_cuda_ms(lambda: dst.copy_(src), runs=30, flush=flush, spin=True),
        }

    T, B = shapes[0]
    inputs, main = timed(T, B)
    issued_ms = time_cuda_ms(lambda: wrapper(*inputs), runs=30, flush=flush, spin=False)
    plain_ms = time_cuda_ms(lambda: plain(*inputs), runs=5, flush=flush, spin=False)
    floor_ms = launch_floor_ms(flush)
    bound, bound_by = bound_ms(T, B)
    result = {
        "name": name,
        "route": "cuda",
        "source": f"surreal_tpu_torch/csrc/{name}.cu",
        "replaces": KERNEL_REPLACES[name],
        "tpu_kernel": tpu_kernel or f"ops/pallas_{name}.py::_{name}_kernel",
        "max_abs_err": max_abs,
        "max_err": max_abs,
        "tolerance": "exact (0)",
        "ms": main["ms"],
        "plain_ms": plain_ms,
        "bound_ms": bound,
        "bound_by": bound_by,
        "bound_share": bound / main["ms"],
        "launch_floor_ms": floor_ms,
        "library_ms": None,  # no single PyTorch call computes either
    }
    emit({"phase": "kernels", "kernel": name, "checks": checks, "timed_shape": [T, B],
          "ms_with_host_issue": issued_ms, "ms_warm_l2": main["ms_warm_l2"],
          "copy_same_bytes_ms": main["copy_same_bytes_ms"],
          "also_timed": [timed(*shape)[1] for shape in also_timed], **result})
    return result


def scan_plan_of(arrays: int, **budget):
    """(T, B) -> the tile and stage length ops/scan_tiles.py gives the
    GAE (5 arrays), V-trace (8) or reverse scan (2, with its own stage
    budget) kernel on this card."""
    from surreal_tpu_torch.ops.scan_tiles import multiprocessors, scan_plan

    sms = multiprocessors(torch.device("cuda", torch.cuda.current_device()))
    return lambda T, B: scan_plan(T, B, arrays, sms, **budget)._asdict()


def phase_kernels(ops_gae) -> dict:
    """GAE kernel vs its plain version. Exact equality is required: the
    kernel uses non-contracting _rn intrinsics (csrc/gae.cu), so it rounds
    where the plain version rounds. Per element: mul, add, sub, mul, add,
    add."""
    return kernel_phase(
        "gae", ops_gae.gae_advantages_masked, ops_gae.gae_masked_plain, gae_inputs, KERNEL_SHAPES,
        reads=5, writes=2, ops=6, plan=scan_plan_of(5), also_timed=[(TRAJ_T, TRAJ_B), *HOST_GAE_SHAPES, *SEED_GAE_SHAPES],
    )


def vtrace_inputs(T: int, B: int, seed: int, device: str) -> list[torch.Tensor]:
    """Random V-trace inputs in the kernel's order (bl, tl, r, boot, edge,
    v_t, v_next, done): 15% dones, half of them true terminations, and
    log-ratios of order 0.3, so that every clip level takes effect."""
    rng = np.random.default_rng(seed)
    gamma = 0.99
    done = rng.random((T, B)) < 0.15
    terminated = done & (rng.random((T, B)) < 0.5)
    bl = rng.normal(size=(T, B)) * 0.5 - 1.0
    arrays = [
        bl,                                      # behaviour log-prob
        bl + 0.3 * rng.normal(size=(T, B)),      # target log-prob
        rng.normal(size=(T, B)),                 # rewards
        gamma * (1.0 - terminated),              # boot: TD-delta discount
        gamma * (1.0 - done),                    # edge: recursion coefficient
        rng.normal(size=(T, B)),                 # v_t
        rng.normal(size=(T, B)),                 # v_next
        done,                                    # done mask
    ]
    return [torch.from_numpy(np.asarray(a, np.float32)).to(device) for a in arrays]


def phase_vtrace_kernel(ops_vtrace) -> dict:
    """V-trace kernel vs its plain version, at IMPALA's clip levels (all
    1.0). Exact equality is required: the kernel uses non-contracting _rn
    intrinsics (csrc/vtrace.cu) and takes rho with expf, the function
    torch.exp calls for float32 on the card, so it rounds where the plain
    version rounds (measured bit-equal on an H100 at every shape here)."""
    for T, B in (shape for shape in VTRACE_SHAPES if shape != (1, 1)):
        bl, tl = vtrace_inputs(T, B, seed=T * 7919 + B, device="cpu")[:2]
        rho = torch.exp(tl - bl)
        if not (bool((rho > 1.0).any()) and bool((rho < 1.0).any())):
            raise AssertionError(f"vtrace inputs at [{T}, {B}] do not exercise the clips")
    return kernel_phase(
        "vtrace", ops_vtrace.vtrace_fused, ops_vtrace.vtrace_fused_plain, vtrace_inputs, VTRACE_SHAPES,
        reads=8, writes=2, ops=VTRACE_OPS, plan=scan_plan_of(8), also_timed=[(CARTPOLE_T, CARTPOLE_B), *SEED_VTRACE_SHAPES[:1]],
    )


def count_launches(counters: dict, fn):
    """fn() with every kernel wrapper's launch count set to 0 just before
    and read just after; ``counters`` maps a kernel's name to (wrapper,
    launches expected), and each must have launched exactly that often.
    Returns (fn's result, the counts)."""
    for wrapper, _ in counters.values():
        wrapper.launches = 0
    out = fn()
    launches = {name: wrapper.launches for name, (wrapper, _) in counters.items()}
    for name, (_, expected) in counters.items():
        if launches[name] != expected:
            raise AssertionError(f"{name} kernel launched {launches[name]} times, expected {expected}")
    return out, launches


def phase_parity(Config, base_config, Trainer, gae_impl: str = "xla", counters: dict | None = None) -> None:
    """One small f32 iteration at ``gae_impl`` on the card and on the CPU
    from the same weights and the same injected draws; on the card each
    kernel of ``counters`` (see count_launches) launches as often as it
    says. Tolerances: the rollout is f32
    elementwise physics and small matmuls, whose transcendental functions
    and sums round differently on the two devices (1e-4); the metrics sum
    sixteen Adam steps (1e-3 relative). The update-ratio metric is held
    to 5e-2: obs dims that are constant over the batch normalize to
    rounding noise whose sign can differ between devices, and Adam steps
    those weights by up to lr whatever the noise's size."""
    from surreal_tpu_torch.envs.device.lift import RESET_HIGH, RESET_LOW
    from surreal_tpu_torch.learners.ppo import _block_layout

    B, T, epochs, num_mb = 64, 32, 4, 4
    cfg = Config(
        learner_config=Config(algo=Config(
            name="ppo", horizon=T, epochs=epochs, num_minibatches=num_mb, precision="f32", gae_impl=gae_impl)),
        env_config=Config(name="jax:lift", num_envs=B, time_limit=20),
        session_config=Config(folder="unused"),
    ).extend(base_config())
    gen = torch.Generator().manual_seed(1)
    lo, hi = torch.tensor(RESET_LOW), torch.tensor(RESET_HIGH)
    draws_init = lo + torch.rand((B, 5), generator=gen) * (hi - lo)
    draws = lo + torch.rand((T, B, 5), generator=gen) * (hi - lo)
    noise = torch.randn((T, B, 4), generator=gen)
    bpm = _block_layout(T * B, num_mb, 17 * 4)
    domain = num_mb * bpm if bpm else T * B
    perms = torch.stack([torch.randperm(domain, generator=gen) for _ in range(epochs)])
    out, launches = {}, {}
    for dev in ("cuda", "cpu"):
        tr = Trainer(cfg, device=dev)
        state = tr.learner.init(torch.Generator().manual_seed(0))
        carry = tr.init_loop_state(reset_draws=draws_init.to(dev))
        iteration = lambda: tr._device_train_iter(  # noqa: E731
            state, carry, action_noise=noise.to(dev), reset_draws=draws.to(dev), perms=perms.to(dev),
        )
        if dev == "cuda" and counters:
            (state, carry, metrics), launches = count_launches(counters, iteration)
        else:
            state, carry, metrics = iteration()
        out[dev] = (carry.obs.cpu(), {k: float(v) for k, v in metrics.items()})
    obs_err = float((out["cuda"][0] - out["cpu"][0]).abs().max())
    if obs_err > 1e-4:
        raise AssertionError(f"final obs differ between cuda and cpu by {obs_err}")
    errs = {}
    for k, want in out["cpu"][1].items():
        got = out["cuda"][1][k]
        rtol = 5e-2 if k == "health/update_ratio" else 1e-3
        if not ((math.isnan(want) and math.isnan(got)) or abs(got - want) <= 1e-4 + rtol * abs(want)):
            raise AssertionError(f"metric {k}: cuda {got} vs cpu {want}")
        errs[k] = abs(got - want)
    emit({"phase": "parity", "gae_impl": gae_impl, "launches": launches, "num_envs": B, "horizon": T,
          "final_obs_max_abs_err": obs_err, "metric_abs_err": errs})


def timed_session(Config, **over):
    """The session of a timed train phase: a fresh folder, metrics read
    every iteration, no checkpoint, no eval, no console or TensorBoard
    output, so its iterations compare with those of the plain loops
    before the session runtime."""
    return Config(**over).extend(Config(
        folder=scratch_dir("run"), metrics=Config(every_n_iters=1, console=False, tensorboard=False),
        checkpoint=Config(every_n_iters=0), eval=Config(every_n_iters=0),
    ))


def pong_config(Config, base_config, num_envs: int, horizon: int, precision: str, cnn: dict,
                vtrace_impl: str = "xla", **env):
    return Config(
        learner_config=Config(
            algo=Config(name="impala", horizon=horizon, precision=precision, vtrace_impl=vtrace_impl),
            model=Config(cnn=Config(enabled=True, **cnn)),
        ),
        env_config=Config(name="jax:pong", num_envs=num_envs, **env),
        session_config=timed_session(Config),
    ).extend(base_config())


def phase_parity_impala(Config, base_config, Trainer, vtrace_impl: str = "xla", counters: dict | None = None) -> None:
    """One small f32 IMPALA iteration at ``vtrace_impl`` on jax:pong
    (narrow NatureCNN, dense 64, 8 envs x 16 steps, time limit 6 so envs
    reset mid-rollout) on the card and on the CPU, from the same weights
    and the same injected draws (Gumbel noise, Pong's serve and reset
    draws); on the card each kernel of ``counters`` (see count_launches)
    launches as often as it says. TF32 is off for cuDNN
    and matmuls (utils/device.py), so both devices convolve in f32.
    Tolerances: the pixels are thresholds on f32 positions that the two
    devices compute with the same elementwise operations, and the actions
    an argmax over logits plus Gumbel noise, so the final obs must be
    equal; the metrics come from one Adam step whose convolution sums are
    taken in other orders (1e-3 relative). The update-ratio metric is
    held to 5e-2: Adam's first step is lr * g / (|g| + eps), so a weight
    whose gradient is near zero moves by up to lr on a last-bit difference
    of its gradient sum."""
    B, T = 8, 16
    cfg = pong_config(Config, base_config, B, T, "f32", dict(channels=(16, 32, 32), dense=64),
                      vtrace_impl=vtrace_impl, time_limit=6)
    gen = torch.Generator().manual_seed(2)
    u = lambda *shape: torch.rand(shape, generator=gen)  # noqa: E731
    side = lambda *shape: (u(*shape) < 0.5).float()  # noqa: E731
    init_draws = torch.stack([u(B) * 0.04 - 0.02, side(B)], dim=1)
    reset_draws = torch.stack([u(T, B) * 0.04 - 0.02, side(T, B)], dim=2)
    step_draws = u(T, B, 1) * 0.04 - 0.02
    gumbel = -torch.log(-torch.log(u(T, B, 3).clamp_min(1e-20)))
    out, launches = {}, {}
    for dev in ("cuda", "cpu"):
        tr = Trainer(cfg, device=dev)
        state = tr.learner.init(torch.Generator().manual_seed(0))
        carry = tr.init_loop_state(reset_draws=init_draws.to(dev))
        iteration = lambda: tr._device_train_iter(  # noqa: E731
            state, carry, action_noise=gumbel.to(dev), reset_draws=reset_draws.to(dev),
            step_draws=step_draws.to(dev),
        )
        if dev == "cuda" and counters:
            (state, carry, metrics), launches = count_launches(counters, iteration)
        else:
            state, carry, metrics = iteration()
        out[dev] = (carry.obs.cpu(), {k: float(v) for k, v in metrics.items()})
    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on; the f32 parity phase needs it off")
    if not torch.equal(out["cuda"][0], out["cpu"][0]):
        raise AssertionError("final pong obs differ between cuda and cpu")
    errs = {}
    for k, want in out["cpu"][1].items():
        got = out["cuda"][1][k]
        rtol = 5e-2 if k == "health/update_ratio" else 1e-3
        if not ((math.isnan(want) and math.isnan(got)) or abs(got - want) <= 1e-4 + rtol * abs(want)):
            raise AssertionError(f"impala metric {k}: cuda {got} vs cpu {want}")
        errs[k] = abs(got - want)
    emit({"phase": "parity", "path": "impala", "vtrace_impl": vtrace_impl, "launches": launches,
          "env": "jax:pong", "num_envs": B, "horizon": T,
          "tf32": False, "final_obs_equal": True, "metric_abs_err": errs})


def timed_run(trainer, counters: dict, warmup: int = WARMUP_ITERS, timed: int = TIMED_ITERS):
    """``trainer.run`` for ``warmup + timed`` iterations on the card, with
    every kernel wrapper's launch count set to 0 just before and read just
    after; ``counters`` maps a kernel's name to (wrapper, launches per
    iteration), and each must have launched exactly that often. Checks
    that every metric is finite. Returns (state, timing and count
    fields)."""
    if trainer.device.type != "cuda":
        raise AssertionError(f"Trainer ran on {trainer.device}")
    iters = warmup + timed
    stamps = []

    def on_metrics(iteration, metrics):
        # run() reads the metrics back each iteration: a host sync, so the
        # gaps between these calls are fenced iteration times
        stamps.append((iteration, time.perf_counter(), metrics))

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    (state, _), launches = count_launches(
        {name: (wrapper, per_iter * iters) for name, (wrapper, per_iter) in counters.items()},
        lambda: trainer.run(max_env_steps=iters * trainer.steps_per_iter, on_metrics=on_metrics),
    )
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if len(stamps) != iters:
        raise AssertionError(f"expected {iters} iterations, got {len(stamps)}")
    for _, _, metrics in stamps:
        for k, v in metrics.items():
            if not math.isfinite(v) and not (k == "episode/return" and math.isnan(v)):
                raise AssertionError(f"metric {k} is {v}")
    # iter_ms[i] is iteration i + 2; the median is over the timed ones
    iter_ms = [(b[1] - a[1]) * 1e3 for a, b in zip(stamps, stamps[1:])]
    median_ms = statistics.median(iter_ms[warmup - 1:])
    return state, {
        "first_iter_ms": (stamps[0][1] - t0) * 1e3,
        "iter_ms": iter_ms,
        "warmup_iters": warmup, "timed_iters": timed,
        "iter_ms_median": median_ms,
        "env_steps_per_s": trainer.steps_per_iter / (median_ms / 1e3),
        **{f"{name}_launches": n for name, n in launches.items()},
        "learn_calls": len(stamps),
        "peak_mem_gb": peak_gb,
        # the session tracer's spans per iteration (time/<span>_ms, mean per call)
        "span_ms": [{k[5:-3]: v for k, v in m.items() if k.startswith("time/") and k.endswith("_ms")}
                    for _, _, m in stamps],
        "metrics": stamps[-1][2],
    }


def phase_train(Config, base_config, Trainer, counters: dict, gae_impl: str = "xla",
                warmup: int = WARMUP_ITERS, timed: int = TIMED_ITERS) -> dict:
    """PPO at the north-star geometry (4096 envs x 256 steps, 4 epochs x 4
    minibatches, 'mixed') at ``gae_impl``; ``counters`` as timed_run takes
    them."""
    cfg = Config(
        learner_config=Config(algo=Config(
            name="ppo", horizon=MAIN_T, epochs=4, num_minibatches=4, precision="mixed", gae_impl=gae_impl)),
        env_config=Config(name="jax:lift", num_envs=MAIN_B),
        session_config=timed_session(Config),
    ).extend(base_config())
    trainer = Trainer(cfg)  # the default device: the card
    state, timing = timed_run(trainer, counters, warmup, timed)
    result = {
        "phase": "train",
        "gae_impl": gae_impl,
        "num_envs": MAIN_B, "horizon": MAIN_T, "epochs": 4, "num_minibatches": 4,
        "precision": "mixed",
        **timing,
        **breakdown(trainer, state),
    }
    emit(result)
    return result


def phase_train_impala(Config, base_config, Trainer, counters: dict, vtrace_impl: str = "xla",
                       warmup: int = WARMUP_ITERS, timed: int = TIMED_ITERS) -> dict:
    """IMPALA at the pong geometry: the default NatureCNN, 1024 envs x 32
    steps, 'mixed', IMPALA's defaults (lr 6e-4, clip levels 1.0, value
    coefficient 0.5, entropy coefficient 0.01), at ``vtrace_impl``;
    ``counters`` as timed_run takes them."""
    cfg = pong_config(Config, base_config, PONG_B, PONG_T, "mixed", {}, vtrace_impl=vtrace_impl)
    trainer = Trainer(cfg)  # the default device: the card
    state, timing = timed_run(trainer, counters, warmup, timed)
    result = {
        "phase": "train",
        "path": "impala",
        "vtrace_impl": vtrace_impl,
        "env": "jax:pong",
        "num_envs": PONG_B, "horizon": PONG_T, "precision": "mixed",
        "cnn": {k: list(v) if isinstance(v, tuple) else v for k, v in trainer.learner.model_cfg["cnn"].items()},
        **timing,
        **breakdown(trainer, state),
    }
    emit(result)
    return result


def fenced_ms(fn):
    """(fn(), its host time in ms between two synchronizes)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


LEARN_KEYS = ("obs", "next_obs", "action", "reward", "done", "terminated", "behavior_logp", "behavior")


def breakdown(trainer, state, reps: int = 2) -> dict:
    """Where an iteration's time goes: the rollout and the learn, each
    fenced by synchronize, after the counted run (these launches are not
    counted)."""
    from surreal_tpu_torch.launch.rollout import device_rollout

    generator = torch.Generator(device="cuda").manual_seed(1)
    carry = trainer.init_loop_state(generator)

    rollout_ms, learn_ms = [], []
    for _ in range(reps):
        (carry, batch), ms = fenced_ms(lambda: device_rollout(
            trainer.env, trainer.learner, state, carry, trainer.horizon, generator))
        rollout_ms.append(ms)
        batch = {k: batch[k] for k in LEARN_KEYS}
        (state, _), ms = fenced_ms(lambda: trainer.learner.learn(state, batch, generator))
        learn_ms.append(ms)
    return {"rollout_ms": rollout_ms, "learn_ms": learn_ms}


# -- trajectory transformer policies (PPO and IMPALA) ------------------------

def trajectory_config(Config, base_config, algo: dict, env: str, num_envs: int, encoder: dict,
                      cnn: dict | None = None, session=None, **env_over):
    model = Config(encoder=Config(encoder), **({"cnn": Config(cnn)} if cnn else {}))
    return Config(
        learner_config=Config(algo=Config(algo), model=model),
        env_config=Config(name=env, num_envs=num_envs, **env_over),
        session_config=session if session is not None else Config(folder="unused"),
    ).extend(base_config())


def trajectory_draws(env: str, B: int, T: int, gen: torch.Generator) -> dict:
    """Injected draws for one iteration on ``env``: the initial and the
    per-step reset draws, the env's step draws, and the action noise."""
    u = lambda *shape: torch.rand(shape, generator=gen)  # noqa: E731
    if env == "jax:pendulum":
        lo, span = torch.tensor([-math.pi, -1.0]), torch.tensor([2 * math.pi, 2.0])
        return {"init": lo + u(B, 2) * span, "reset_draws": lo + u(T, B, 2) * span,
                "action_noise": torch.randn((T, B, 1), generator=gen)}
    gumbel = lambda n: -torch.log(-torch.log(u(T, B, n).clamp_min(1e-20)))  # noqa: E731
    if env == "jax:cartpole":
        return {"init": u(B, 4) * 0.1 - 0.05, "reset_draws": u(T, B, 4) * 0.1 - 0.05, "action_noise": gumbel(2)}
    side = lambda *shape: (u(*shape) < 0.5).float()  # noqa: E731
    return {"init": torch.stack([u(B) * 0.04 - 0.02, side(B)], dim=1),
            "reset_draws": torch.stack([u(T, B) * 0.04 - 0.02, side(T, B)], dim=2),
            "step_draws": u(T, B, 1) * 0.04 - 0.02, "action_noise": gumbel(3)}


def phase_parity_trajectory(Config, base_config, Trainer, algo: str, env: str, counters: dict,
                            gae_impl: str = "xla", cnn: dict | None = None) -> None:
    """One small f32 iteration of a trajectory policy (kv acting, then the
    sequence learn) on the card and on the CPU from the same weights and
    the same injected draws, TF32 off; on the card each kernel of
    ``counters`` (see count_launches) launches as often as it says.
    16 envs x 16 steps, time limit 6 (envs reset mid-segment), encoder 32
    wide, 2 layers of 2 heads x 16; PPO 2 epochs x 2 minibatches with row
    shuffling (its permutations given). Tolerances as for the memoryless
    parity phases: vector obs 1e-4 (f32 physics and small matmuls round
    differently on the two devices), pong16's pixels equal, metrics 1e-3
    relative, the update ratio 5e-2."""
    B, T = 16, 16
    algo_cfg = dict(name=algo, horizon=T, precision="f32")
    if algo == "ppo":
        algo_cfg.update(epochs=2, num_minibatches=2, shuffle="row", gae_impl=gae_impl)
    encoder = dict(kind="trajectory", features=32, num_layers=2, num_heads=2, head_dim=16, act_impl="kv")
    cfg = trajectory_config(Config, base_config, algo_cfg, env, B, encoder, cnn, time_limit=6)
    gen = torch.Generator().manual_seed(5)
    draws = trajectory_draws(env, B, T, gen)
    init = draws.pop("init")
    perms = torch.stack([torch.randperm(B, generator=gen) for _ in range(2)]) if algo == "ppo" else None
    out, launches = {}, {}
    for dev in ("cuda", "cpu"):
        tr = Trainer(cfg, device=dev)
        state = tr.learner.init(torch.Generator().manual_seed(0))
        carry = tr.init_loop_state(reset_draws=init.to(dev))
        kw = {k: v.to(dev) for k, v in draws.items()}
        if perms is not None:
            kw["perms"] = perms.to(dev)
        iteration = lambda: tr._device_train_iter(state, carry, **kw)  # noqa: E731
        if dev == "cuda":
            (state, carry, metrics), launches = count_launches(counters, iteration)
        else:
            state, carry, metrics = iteration()
        out[dev] = (carry.obs.cpu(), {k: float(v) for k, v in metrics.items()})
    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on; the f32 parity phase needs it off")
    if out["cpu"][0].dtype == torch.uint8:
        obs_err = float((out["cuda"][0].float() - out["cpu"][0].float()).abs().max())
        if obs_err != 0:
            raise AssertionError(f"final {env} pixels differ between cuda and cpu")
    else:
        obs_err = float((out["cuda"][0] - out["cpu"][0]).abs().max())
        if obs_err > 1e-4:
            raise AssertionError(f"final {env} obs differ between cuda and cpu by {obs_err}")
    errs = {}
    for k, want in out["cpu"][1].items():
        got = out["cuda"][1][k]
        rtol = 5e-2 if k == "health/update_ratio" else 1e-3
        if not ((math.isnan(want) and math.isnan(got)) or abs(got - want) <= 1e-4 + rtol * abs(want)):
            raise AssertionError(f"trajectory {algo} {env} metric {k}: cuda {got} vs cpu {want}")
        errs[k] = abs(got - want)
    emit({"phase": "parity", "path": f"trajectory-{algo}", "env": env, "gae_impl": gae_impl if algo == "ppo" else None,
          "cnn": bool(cnn), "launches": launches, "num_envs": B, "horizon": T, "tf32": False,
          "final_obs_max_abs_err": obs_err, "metric_abs_err": errs})


def phase_kv_vs_padded(Config, base_config, Trainer) -> None:
    """On the card: acting with K/V caches ('kv') against re-encoding the
    padded segment ('padded'), same weights, obs and draws, over 1.5
    segments (the wrap), at the train phase's encoder widths, in f32
    (bar 1e-4: the decode's and the whole segment's sums run in other
    orders) and under 'mixed' (3e-2, bf16's mantissa, as the tests')."""
    B, T = 64, 16
    errs = {}
    for precision, tol in (("f32", 1e-4), ("mixed", 3e-2)):
        learners = {}
        for act_impl in ("kv", "padded"):
            cfg = trajectory_config(Config, base_config, dict(name="ppo", horizon=T, precision=precision),
                                    "jax:pendulum", B, dict(TRAJ_ENC, act_impl=act_impl))
            learners[act_impl] = Trainer(cfg).learner
        state = learners["kv"].init(torch.Generator().manual_seed(0))
        gen = torch.Generator().manual_seed(6)
        obs = torch.randn((T + T // 2, B, 3), generator=gen).cuda()
        noise = torch.randn((T + T // 2, B, 1), generator=gen).cuda()
        carries = {k: lr.act_init(B) for k, lr in learners.items()}
        worst = 0.0
        for t in range(T + T // 2):
            info = {}
            for k, lr in learners.items():
                _, info[k], carries[k] = lr.act_step(state, carries[k], obs[t], noise=noise[t])
            for key in ("logp", "value", "mean"):
                err = float((info["kv"][key] - info["padded"][key]).abs().max())
                bound = tol + tol * float(info["padded"][key].abs().max())
                if not err <= bound:
                    raise AssertionError(f"kv vs padded {precision}: {key} at step {t} differs by {err}")
                worst = max(worst, err)
        errs[precision] = worst
    emit({"phase": "parity", "path": "trajectory kv vs padded acting", "num_envs": B, "horizon": T,
          "steps": T + T // 2, "max_abs_err": errs, "tolerance": {"f32": 1e-4, "mixed": 3e-2}})


def no_sync_iteration(trainer, state, counters: dict) -> dict:
    """One more iteration of ``trainer`` under set_sync_debug_mode("error")
    (which raises on any host sync), with its launches counted."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    carry = trainer.init_loop_state(gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, launches = count_launches(counters, lambda: trainer._device_train_iter(state, carry, gen))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return {"ms": (time.perf_counter() - t0) * 1e3, "host_sync": False, "launches": launches}


def phase_train_trajectory(Config, base_config, Trainer, counters: dict) -> dict:
    """PPO with the trajectory transformer at the JAX package's
    perf_report.py::ppo_trajectory_pendulum geometry: jax:pendulum, 1024
    envs x 128 steps, 2 epochs x 2 minibatches, encoder 64 wide, 2 layers
    of 4 heads x 16, KV-cached acting, 'mixed'; GAE once an iteration, and
    one more iteration under set_sync_debug_mode("error")."""
    algo = dict(name="ppo", horizon=TRAJ_T, epochs=2, num_minibatches=2, precision="mixed")
    cfg = trajectory_config(Config, base_config, algo, "jax:pendulum", TRAJ_B, TRAJ_ENC,
                            session=timed_session(Config))
    trainer = Trainer(cfg)  # the default device: the card
    state, timing = timed_run(trainer, counters)
    result = {
        "phase": "train", "path": "trajectory-ppo", "env": "jax:pendulum",
        "num_envs": TRAJ_B, "horizon": TRAJ_T, "epochs": 2, "num_minibatches": 2, "precision": "mixed",
        "encoder": TRAJ_ENC,
        **timing,
        "gae_launches_per_iter": timing["gae_launches"] / timing["learn_calls"],
        **breakdown(trainer, state),
        "no_sync_iteration": no_sync_iteration(trainer, state, counters),
    }
    emit(result)
    return result


def phase_train_trajectory_impala(Config, base_config, Trainer, counters: dict) -> dict:
    """IMPALA with the trajectory transformer at its default widths
    (encoder 64 wide, 2 layers of 4 heads x 16, kv acting) on jax:cartpole,
    1024 envs x 32 steps, 'mixed': V-trace once an iteration."""
    cfg = trajectory_config(Config, base_config, dict(name="impala", horizon=PONG_T, precision="mixed"),
                            "jax:cartpole", PONG_B, dict(kind="trajectory"), session=timed_session(Config))
    trainer = Trainer(cfg)  # the default device: the card
    state, timing = timed_run(trainer, counters)
    result = {
        "phase": "train", "path": "trajectory-impala", "env": "jax:cartpole",
        "num_envs": PONG_B, "horizon": PONG_T, "precision": "mixed",
        "encoder": trainer.learner.config.model.encoder.to_dict(),
        **timing,
        "vtrace_launches_per_iter": timing["vtrace_launches"] / timing["learn_calls"],
        **breakdown(trainer, state),
    }
    emit(result)
    return result


# -- DDPG + prioritized replay ------------------------------------------------

def phase_replay_gather(RR) -> dict:
    """Replay gather kernel vs its plain version (index_select per leaf),
    bit for bit: at the DDPG path's shape (256 rows of the five leaves,
    160 B a row, from a 200,000-row ring), with repeated indices, with the
    obs leaves in bf16 (34 B rows), at uniform sample_many's 16,384 rows,
    with a uint8 leaf whose base address is odd (1-byte units), and at
    ragged shapes (3-byte and int64 rows, more rows than the ring holds,
    one row of a 7-row ring). Timed at the path's shape, and at 16,384
    rows against that size's byte bound; the library call is index_select
    per leaf, summed over the five leaves; the launch floor is a
    one-element fill_."""
    gen = torch.Generator(device="cuda").manual_seed(3)

    def leaves(capacity, bf16_obs=False):
        out = {}
        for k, shape in DDPG_ROW_SHAPES.items():
            x = torch.randn((capacity, *shape), generator=gen, device="cuda")
            out[k] = x.to(torch.bfloat16) if bf16_obs and "obs" in k else x
        return out

    def indices(capacity, n, duplicates=False):
        idx = torch.randint(0, capacity, (n,), generator=gen, device="cuda", dtype=torch.int32)
        if duplicates:
            idx[n // 2:] = idx[: n - n // 2].flip(0)
        return idx

    ragged = {
        "bytes": torch.randint(0, 256, (1000, 3), generator=gen, device="cuda").to(torch.uint8),
        "ids": torch.randint(0, 2**40, (1000, 2), generator=gen, device="cuda"),
        "reward": torch.randn(1000, generator=gen, device="cuda"),
    }
    odd = torch.randint(0, 256, (1000 * 16 + 1,), generator=gen, device="cuda").to(torch.uint8)
    u8_offset = {"u8": odd[1:].view(1000, 16), "reward": ragged["reward"]}
    if u8_offset["u8"].data_ptr() % 2 != 1:
        raise AssertionError("the u8_offset leaf is not odd-addressed")
    path = (leaves(DDPG_CAPACITY), indices(DDPG_CAPACITY, DDPG_BS))
    many_idx = indices(DDPG_CAPACITY, DDPG_MANY_ROWS)
    cases = [
        ("path", *path),
        ("path_duplicates", path[0], indices(DDPG_CAPACITY, DDPG_BS, duplicates=True)),
        ("bf16_obs", leaves(DDPG_CAPACITY, bf16_obs=True), indices(DDPG_CAPACITY, DDPG_BS)),
        ("sample_many", path[0], many_idx),
        ("u8_offset", u8_offset, indices(1000, 300)),
        ("ragged", ragged, indices(1000, 3000)),
        ("one_row", leaves(7), indices(7, 1)),
    ]
    checks, max_abs = [], 0.0
    for label, lv, idx in cases:
        got, want = RR.gather_rows(lv, idx), RR.gather_rows_plain(lv, idx)
        torch.cuda.synchronize()
        for k in lv:
            if not torch.equal(got[k], want[k]):
                raise AssertionError(f"replay_gather != plain for leaf {k} in case {label}")
        err = max(float((got[k].double() - want[k].double()).abs().max()) for k in lv)
        max_abs = max(max_abs, err)
        checks.append({"case": label, "rows": idx.numel(), "capacity": next(iter(lv.values())).shape[0],
                       "leaves": {k: [list(v.shape[1:]), str(v.dtype)] for k, v in lv.items()}, "max_abs_err": err})

    lv, idx = path
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")
    ms = time_cuda_ms(lambda: RR.gather_rows(lv, idx), runs=30, flush=flush, spin=True)
    issued_ms = time_cuda_ms(lambda: RR.gather_rows(lv, idx), runs=30, flush=flush, spin=False)
    plain_ms = time_cuda_ms(lambda: RR.gather_rows_plain(lv, idx), runs=30, flush=flush, spin=False)
    library_ms = sum(
        time_cuda_ms(lambda x=x: x.index_select(0, idx), runs=30, flush=flush, spin=True) for x in lv.values()
    )
    floor_ms = launch_floor_ms(flush)
    many_ms = time_cuda_ms(lambda: RR.gather_rows(lv, many_idx), runs=30, flush=flush, spin=True)
    row_bytes = sum(x[0].numel() * x.element_size() for x in lv.values())
    nbytes = 2 * DDPG_BS * row_bytes + idx.numel() * idx.element_size()
    many_bytes = 2 * DDPG_MANY_ROWS * row_bytes + many_idx.numel() * many_idx.element_size()
    result = {
        "name": "replay_gather",
        "route": "cuda",
        "source": "surreal_tpu_torch/csrc/replay_rows.cu",
        "replaces": KERNEL_REPLACES["replay_gather"],
        "tpu_kernel": "ops/pallas_replay.py::_copy_row_kernel",
        "max_abs_err": max_abs,
        "max_err": max_abs,
        "tolerance": "exact (0)",
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": nbytes / H100_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
        "bound_share": nbytes / H100_BYTES_PER_S * 1e3 / ms,
        "launch_floor_ms": floor_ms,
        "library_ms": library_ms,
    }
    emit({"phase": "kernels", "kernel": "replay_gather", "checks": checks,
          "timed_shape": {"rows": DDPG_BS, "capacity": DDPG_CAPACITY, "row_bytes": row_bytes},
          "bound_bytes": nbytes, "ms_with_host_issue": issued_ms,
          "sample_many": {"rows": DDPG_MANY_ROWS, "ms": many_ms, "bound_bytes": many_bytes,
                          "bound_ms": many_bytes / H100_BYTES_PER_S * 1e3},
          "library_call": "index_select per leaf, summed over the leaves", **result})
    return result


def phase_replay_scatter(RR) -> dict:
    """Replay scatter kernel vs its plain version (index_copy_ of the last
    occurrence of each index), bit for bit: 256 priorities into a
    200,000-vector with forced duplicates (the path's shape), 256 copies
    of one index, [n, 3] rows with many duplicates, more rows than one
    block takes (the grid-wide kernel) with duplicates, and one row.
    Timed at the path's shape; the library call is index_copy_ with unique
    indices; the launch floor is a one-element fill_."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    path_idx = torch.randint(0, DDPG_CAPACITY, (DDPG_BS,), generator=gen, device="cuda", dtype=torch.int32)
    path_idx[DDPG_BS // 2:: 4] = path_idx[:DDPG_BS // 8]  # forced duplicates
    cases = [
        ("path_duplicates", torch.rand(DDPG_CAPACITY, generator=gen, device="cuda"), path_idx,
         torch.rand(DDPG_BS, generator=gen, device="cuda")),
        ("all_same", torch.rand(DDPG_CAPACITY, generator=gen, device="cuda"),
         torch.full((DDPG_BS,), DDPG_CAPACITY // 3, device="cuda", dtype=torch.int32),
         torch.rand(DDPG_BS, generator=gen, device="cuda")),
        ("rows3", torch.randn(1000, 3, generator=gen, device="cuda"),
         torch.randint(0, 100, (500,), generator=gen, device="cuda", dtype=torch.int32),
         torch.randn(500, 3, generator=gen, device="cuda")),
        ("grid_wide", torch.rand(DDPG_CAPACITY, generator=gen, device="cuda"),
         torch.randint(0, 2 * RR.SCATTER_BLOCK_ROWS, (3 * RR.SCATTER_BLOCK_ROWS,), generator=gen, device="cuda",
                       dtype=torch.int32),
         torch.rand(3 * RR.SCATTER_BLOCK_ROWS, generator=gen, device="cuda")),
        ("one_row", torch.randn(7, generator=gen, device="cuda"),
         torch.randint(0, 7, (1,), generator=gen, device="cuda", dtype=torch.int32),
         torch.randn(1, generator=gen, device="cuda")),
    ]
    checks, max_abs = [], 0.0
    for label, dest, idx, upd in cases:
        got = RR.scatter_rows(dest.clone(), idx, upd)
        want = RR.scatter_rows_plain(dest.clone(), idx, upd)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"replay_scatter != plain in case {label}")
        err = float((got - want).abs().max())
        max_abs = max(max_abs, err)
        dups = idx.numel() - torch.unique(idx).numel()
        checks.append({"case": label, "shape": list(dest.shape), "rows": idx.numel(),
                       "repeated_indices": dups, "max_abs_err": err})
    if checks[0]["repeated_indices"] == 0:
        raise AssertionError("the path case has no repeated indices")

    _, dest, idx, upd = cases[0]
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")
    ms = time_cuda_ms(lambda: RR.scatter_rows(dest, idx, upd), runs=30, flush=flush, spin=True)
    issued_ms = time_cuda_ms(lambda: RR.scatter_rows(dest, idx, upd), runs=30, flush=flush, spin=False)
    plain_ms = time_cuda_ms(lambda: RR.scatter_rows_plain(dest, idx, upd), runs=30, flush=flush, spin=False)
    unique = torch.randperm(DDPG_CAPACITY, generator=gen, device="cuda")[:DDPG_BS]
    library_ms = time_cuda_ms(lambda: dest.index_copy_(0, unique, upd), runs=30, flush=flush, spin=True)
    floor_ms = launch_floor_ms(flush)
    nbytes = 3 * 4 * DDPG_BS  # idx and updates read, rows written
    result = {
        "name": "replay_scatter",
        "route": "cuda",
        "source": "surreal_tpu_torch/csrc/replay_rows.cu",
        "replaces": KERNEL_REPLACES["replay_scatter"],
        "tpu_kernel": "ops/pallas_replay.py::_scatter_row_kernel",
        "max_abs_err": max_abs,
        "max_err": max_abs,
        "tolerance": "exact (0)",
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": nbytes / H100_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
        "bound_share": nbytes / H100_BYTES_PER_S * 1e3 / ms,
        "launch_floor_ms": floor_ms,
        "library_ms": library_ms,
    }
    emit({"phase": "kernels", "kernel": "replay_scatter", "checks": checks,
          "timed_shape": {"rows": DDPG_BS, "capacity": DDPG_CAPACITY}, "bound_bytes": nbytes,
          "ms_with_host_issue": issued_ms, "library_call": "index_copy_ with unique indices", **result})
    return result


def rev_scan_inputs(T: int, B: int, seed: int, device: str) -> list[torch.Tensor]:
    """Random scan inputs (coeffs, deltas, init): discounts 0.99 with 15%
    episode ends, normal deltas and init."""
    rng = np.random.default_rng(seed)
    arrays = [0.99 * (rng.random((T, B)) >= 0.15), rng.normal(size=(T, B)), rng.normal(size=B)]
    return [torch.from_numpy(a.astype(np.float32)).to(device) for a in arrays]


def phase_rev_scan(RS) -> dict:
    """Reverse linear scan kernel vs its plain version, exactly (_rn
    intrinsics, csrc/rev_scan.cu), at PPO's [256, 4096] (the 'assoc' GAE),
    the edges of the ring (KERNEL_SHAPES, and two shapes that wrap it) and
    IMPALA's [32, 1024] (the 'assoc' V-trace), which is timed too. Per
    element: one mul, one add."""
    from surreal_tpu_torch.ops.scan_tiles import REV_SCAN_STAGE_BYTES

    return kernel_phase(
        "rev_scan", lambda *x: (RS.reverse_linear_scan(*x),), lambda *x: (RS.reverse_linear_scan_plain(*x),),
        rev_scan_inputs, REV_SCAN_SHAPES, reads=2, writes=1, ops=2,
        tpu_kernel="ops/pallas_returns.py::_rev_scan_kernel", extra_bytes_per_b=4, counter=RS.reverse_linear_scan,
        plan=scan_plan_of(2, stage_bytes=REV_SCAN_STAGE_BYTES), also_timed=[(PONG_T, PONG_B), (TRAJ_T, TRAJ_B)],
    )


def ddpg_config(Config, base_config, B, H, K, bs, capacity, kind, precision, n_step=1, warmup_steps=0, **env):
    """DDPG on jax:lift with the DDPG defaults (actor and critic 64x64 tanh,
    critic LayerNorm, OU noise sigma 0.2 theta 0.15, tau 0.005), sampling
    from the first iteration's insert on (start_sample_size = B * H)."""
    return Config(
        learner_config=Config(
            algo=Config(name="ddpg", horizon=H, updates_per_iter=K, n_step=n_step, precision=precision,
                        exploration=Config(warmup_steps=warmup_steps)),
            replay=Config(kind=kind, capacity=capacity, start_sample_size=B * H, batch_size=bs),
        ),
        env_config=Config(name="jax:lift", num_envs=B, **env),
        session_config=timed_session(Config),
    ).extend(base_config())


class SampleRecorder:
    """Wraps a prioritized replay's ``sample`` and keeps, per call, the
    indices drawn, the scaled draws and the cdf they were drawn against
    (recomputed with the same expressions), on the host."""

    def __init__(self, replay):
        self.replay, self.inner, self.calls = replay, replay.sample, []
        replay.sample = self

    def __call__(self, state, generator=None, batch_size=None, beta=None, uniforms=None):
        out = self.inner(state, generator, batch_size, beta, uniforms)
        p = state.priorities ** self.replay.alpha
        bs = uniforms.shape[0]
        u = (torch.arange(bs, dtype=torch.float32, device=p.device) + uniforms) / bs * p.sum()
        self.calls.append((out[2]["idx"].cpu(), u.cpu(), torch.cumsum(p, 0).cpu()))
        return out


# a draw this close (in ulps of its value) to a boundary of the CPU cdf may
# pick the neighbouring slot on the card: the two cumsums round differently
# (the card's is a parallel scan), and the priorities differ by the learn's
# rounding
PARITY_BOUNDARY_ULPS = 64


def compare_ddpg_parity(label: str, out: dict, prioritized: bool):
    """Holds two DDPG runs, ``out["cuda"]`` and ``out["cpu"]`` (final obs,
    per-iteration metrics, the ring's rows, the priorities, the recorded
    prioritized samples), to the DDPG parity bars of phase_parity_ddpg.
    Returns (index flips at cdf boundaries, whether the runs were compared
    past the samples, the largest errors)."""
    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on; the f32 parity phase needs it off")
    flips, first_flip = 0, None
    for call, ((gi, _, _), (wi, u, cdf)) in enumerate(zip(out["cuda"]["samples"], out["cpu"]["samples"])):
        for i in torch.nonzero(gi != wi).flatten().tolist():
            a, b = int(gi[i]), int(wi[i])
            gap = abs(float(u[i]) - float(cdf[min(a, b)]))
            ulps = gap / float(np.spacing(np.float32(u[i])))
            if abs(a - b) != 1 or ulps > PARITY_BOUNDARY_ULPS:
                raise AssertionError(f"{label}: sample {call} draw {i} picked {a} on cuda, {b} on cpu "
                                     f"({ulps:.1f} ulps from the boundary)")
            flips += 1
            first_flip = call if first_flip is None else first_flip
    errs = {}
    if first_flip is None:
        obs_err = float(np.abs(np.asarray(out["cuda"]["obs"]) - np.asarray(out["cpu"]["obs"])).max())
        if obs_err > 1e-4:
            raise AssertionError(f"{label}: final obs differ between cuda and cpu by {obs_err}")
        errs["obs"] = obs_err
        for k, want in out["cpu"]["storage"].items():
            err = float((out["cuda"]["storage"][k] - want).abs().max())
            if err > 1e-4:
                raise AssertionError(f"{label}: replay leaf {k} differs by {err}")
            errs[f"replay/{k}"] = err
        if prioritized:
            err = float((out["cuda"]["priorities"] - out["cpu"]["priorities"]).abs().max())
            if err > 1e-4:
                raise AssertionError(f"{label}: priorities differ by {err}")
            errs["priorities"] = err
        for it, (got_m, want_m) in enumerate(zip(out["cuda"]["metrics"], out["cpu"]["metrics"])):
            for k, want in want_m.items():
                got = got_m[k]
                rtol = 5e-2 if k == "health/update_ratio" else 1e-3
                if not ((math.isnan(want) and math.isnan(got)) or abs(got - want) <= 1e-4 + rtol * abs(want)):
                    raise AssertionError(f"{label} iteration {it} metric {k}: cuda {got} vs cpu {want}")
                errs[k] = max(errs.get(k, 0.0), abs(got - want))
    return flips, first_flip is None, errs


def phase_parity_ddpg(Config, base_config, OffPolicyTrainer) -> None:
    """Two small f32 DDPG iterations (64 envs x 8 steps, time limit 5, 4
    updates of 64 per iteration, capacity 2048, the first iteration under
    warm-up actions) on the card and on the CPU, from the same weights and
    the same injected draws (reset draws, OU normals, warm-up actions,
    replay draws): uniform replay with n_step 3, prioritized with n_step 1.
    TF32 is off. Tolerances as in the PPO parity phase: final obs and the
    ring's rows 1e-4; metrics 1e-4 + 1e-3 relative, the update ratio 5e-2
    (constant obs dims normalize to rounding noise whose sign can differ
    between devices, and Adam moves those weights by up to lr); priorities
    1e-4 (|td| at Q-values of ~0.1). Prioritized indices must be equal
    except where a draw lies within PARITY_BOUNDARY_ULPS of a CPU cdf
    boundary between the two slots; after such a draw the runs diverge
    legitimately and the comparisons after it are skipped (and said so)."""
    from surreal_tpu_torch.envs.device.lift import RESET_HIGH, RESET_LOW

    B, H, K, BS, C = 64, 8, 4, 64, 2048
    for kind, n_step in (("uniform", 3), ("prioritized", 1)):
        prioritized = kind == "prioritized"
        cfg = ddpg_config(Config, base_config, B, H, K, BS, C, kind, "f32", n_step=n_step,
                          warmup_steps=B * H, time_limit=5)
        gen = torch.Generator().manual_seed(5)
        lo, hi = torch.tensor(RESET_LOW), torch.tensor(RESET_HIGH)
        draws_init = lo + torch.rand((B, 5), generator=gen) * (hi - lo)
        reset = lo + torch.rand((2, H, B, 5), generator=gen) * (hi - lo)
        normals = torch.randn((2, H, B, 4), generator=gen)
        warm = torch.rand((2, H, B, 4), generator=gen) * 2.0 - 1.0
        if prioritized:
            sample = torch.rand((2, K, BS), generator=gen)
        else:
            sample = torch.stack([torch.randint(0, (it + 1) * B * H, (K, BS), generator=gen) for it in range(2)])
        out = {}
        for dev in ("cuda", "cpu"):
            tr = OffPolicyTrainer(cfg, device=dev)
            recorder = SampleRecorder(tr.replay) if prioritized else None
            state = tr.learner.init(torch.Generator().manual_seed(0))
            carry, replay = tr.init_loop_state(reset_draws=draws_init.to(dev))
            metrics = []
            for it in range(2):
                state, replay, carry, m = tr._device_train_iter(
                    state, replay, carry, beta=tr._beta(it * B * H, 2 * B * H), warmup=it == 0, first=it == 0,
                    action_noise=normals[it].to(dev), warmup_uniforms=warm[it].to(dev),
                    reset_draws=reset[it].to(dev), sample_draws=sample[it].to(dev),
                )
                metrics.append({k: float(v) for k, v in m.items()})
            ring = replay.ring if prioritized else replay
            out[dev] = {
                "obs": carry.obs.cpu(), "metrics": metrics,
                "storage": {k: v.cpu() for k, v in ring.storage.items()},
                "priorities": replay.priorities.cpu() if prioritized else None,
                "samples": recorder.calls if prioritized else [],
            }
        flips, compared, errs = compare_ddpg_parity(f"ddpg {kind}", out, prioritized)
        emit({"phase": "parity", "path": "ddpg", "replay": kind, "n_step": n_step, "env": "jax:lift",
              "num_envs": B, "horizon": H, "updates_per_iter": K, "batch_size": BS, "capacity": C,
              "iterations": 2, "tf32": False, "prioritized_index_flips_at_boundaries": flips,
              "compared": compared, "abs_err": errs})


def device_profile(fn) -> dict:
    """Device busy share and launch count of one call of ``fn``, from a
    torch.profiler trace of CUDA activity only (the CPU ops' events, which
    nothing here reads, took about half a minute to process at DDPG's
    67,000 launches an iteration): the sum of CUDA kernel times over the
    fenced host time of the call (the profiler's own overhead lengthens
    the call, so the share is a lower bound), and the kernels with the
    most time. Returns {"error": ...} where the trace holds no device
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _, wall_ms = fenced_ms(fn)
        kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        launches = sum(e.count for e in kernels)
    except Exception as exc:  # a measurement only: the run goes on without it
        return {"error": f"{type(exc).__name__}: {exc}"}
    if device_ms <= 0:
        return {"error": "the trace holds no device time"}
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    return {
        "wall_ms": wall_ms, "device_ms": device_ms, "busy_share": device_ms / wall_ms,
        "kernel_launches": launches,
        "top_kernels": [{"name": e.key[:80], "count": e.count, "ms": e.self_device_time_total / 1e3} for e in top],
    }


def ddpg_breakdown(trainer, state, reps: int = 1) -> dict:
    """After the counted run (these launches are not counted): one
    iteration to fill a fresh ring to its sampling threshold; one
    iteration under torch.cuda.set_sync_debug_mode("error"), which raises
    on any host sync; then the rollout and the 64-update loop, each fenced
    by synchronize, and a profiler trace of one whole iteration."""
    generator = torch.Generator(device="cuda").manual_seed(1)
    carry, replay = trainer.init_loop_state(generator)
    state, replay, carry, _ = trainer._device_train_iter(
        state, replay, carry, beta=0.4, first=True, generator=generator)

    def sync_free_iteration():
        torch.cuda.set_sync_debug_mode("error")
        try:
            return trainer._device_train_iter(state, replay, carry, beta=0.4, generator=generator)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    (state, replay, carry, _), sync_free_ms = fenced_ms(sync_free_iteration)
    rollout_ms, updates_ms = [], []
    for _ in range(reps):
        (carry, _), ms = fenced_ms(lambda: trainer._rollout(state, carry, False, generator))
        rollout_ms.append(ms)
        (state, replay, _), ms = fenced_ms(lambda: trainer._run_updates(state, replay, 0.4, generator))
        updates_ms.append(ms)
    profile = device_profile(
        lambda: trainer._device_train_iter(state, replay, carry, beta=0.4, generator=generator))
    return {"sync_free_iteration": True, "sync_free_iteration_ms": sync_free_ms,
            "rollout_ms": rollout_ms, "updates_ms": updates_ms, "profile": profile}


def phase_train_ddpg(Config, base_config, OffPolicyTrainer, RR) -> dict:
    """DDPG with prioritized replay at the headline geometry, 'mixed',
    warm-up 0: every iteration samples, learns and refreshes priorities 64
    times, so the gather and the scatter must each launch 64 times per
    iteration."""
    cfg = ddpg_config(Config, base_config, DDPG_B, DDPG_H, DDPG_K, DDPG_BS, DDPG_CAPACITY, "prioritized", "mixed")
    trainer = OffPolicyTrainer(cfg)  # the default device: the card
    state, timing = timed_run(trainer, {
        "replay_gather": (RR.gather_rows, DDPG_K), "replay_scatter": (RR.scatter_rows, DDPG_K),
    })
    result = {
        "phase": "train",
        "path": "ddpg",
        "env": "jax:lift",
        "replay": "prioritized", "capacity": DDPG_CAPACITY,
        "num_envs": DDPG_B, "horizon": DDPG_H, "updates_per_iter": DDPG_K, "batch_size": DDPG_BS,
        "precision": "mixed",
        **timing,
        **ddpg_breakdown(trainer, state),
    }
    emit(result)
    return result

# -- the session runtime (train CLI, hooks, checkpoints, recovery) -----------

def tensors_equal(a, b, tree_flatten) -> bool:
    """Every leaf of two states equal, tensors bit for bit in their dtypes."""
    fa, fb = tree_flatten(a), tree_flatten(b)
    if fa.keys() != fb.keys():
        return False
    return all(
        (x.dtype == fb[k].dtype and torch.equal(x, fb[k])) if isinstance(x, torch.Tensor) else x == fb[k]
        for k, x in fa.items()
    )


def state_bytes(state, tree_flatten) -> int:
    return sum(x.numel() * x.element_size() for x in tree_flatten(state).values() if isinstance(x, torch.Tensor))


def session_events(folder: str, iter_jsonl) -> list[dict]:
    return list(iter_jsonl(os.path.join(folder, "telemetry", "events.jsonl")))


def load_snapshot_of(folder: str) -> dict:
    """The session's last ops snapshot (``telemetry/ops_snapshot.json``)."""
    from surreal_tpu_torch.session.opsplane import load_snapshot

    return load_snapshot(folder) or {}


class Patched:
    """Replace ``owner.name`` with ``wrap(original)`` inside a with block."""

    def __init__(self, owner, name, wrap):
        self.owner, self.name, self.wrap = owner, name, wrap

    def __enter__(self):
        self.orig = getattr(self.owner, self.name)
        setattr(self.owner, self.name, self.wrap(self.orig))

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.orig)


def cli_lines(M, argv: list[str]) -> list[str]:
    """``python -m surreal_tpu_torch ...`` in process, rc 0; its stdout lines."""
    out = io.StringIO()
    with redirect_stdout(out):
        rc = M.launch.main(argv)
    if rc != 0:
        raise AssertionError(f"{argv[0]} CLI exited {rc}")
    return out.getvalue().strip().splitlines()


def run_cli(M, argv: list[str]) -> dict:
    """``python -m surreal_tpu_torch ...`` in process; the JSON of the last
    line it prints (``train``'s final metrics, ``tune``'s summary)."""
    return json.loads(cli_lines(M, argv)[-1])


def session_cli_ppo(M, gae_counters: dict) -> dict:
    """``train ppo jax:lift`` at the north-star geometry for 8 iterations:
    metrics every 2, checkpoint every 4, eval every 4 (5 deterministic
    episodes). The GAE kernel must launch once per iteration. Iteration 3
    (off every cadence) runs under set_sync_debug_mode("error"), from its
    step through its boundary: no host sync. Iteration times are the
    metrics windows (each ends in the metrics read, a fence) over their two
    iterations: the windows ending at 4 and 8 hold the eval and the
    checkpoint, the one ending at 6 holds neither."""
    folder, iters = scratch_dir("cli_ppo"), 8
    argv = ["train", "ppo", "jax:lift", "--folder", folder, "--num-envs", str(MAIN_B),
            "--total-steps", str(iters * MAIN_B * MAIN_T), "--set",
            f"learner_config.algo.horizon={MAIN_T}", "learner_config.algo.epochs=4",
            "learner_config.algo.num_minibatches=4", "learner_config.algo.precision=mixed",
            "session_config.metrics.every_n_iters=2", "session_config.checkpoint.every_n_iters=4",
            "session_config.eval.every_n_iters=4", "session_config.eval.episodes=5",
            "session_config.metrics.console=false", "session_config.metrics.tensorboard=false"]
    window_end = {}

    def stamp_end(orig):
        def end_iteration(self, iteration, *a, **kw):
            out = orig(self, iteration, *a, **kw)
            if out[0] is not None:
                window_end[iteration] = time.perf_counter()
            return out
        return end_iteration

    calls = []

    def guard_iteration_3(orig):
        def train_iter(self, *a, **kw):
            calls.append(iteration := len(calls) + 1)
            torch.cuda.set_sync_debug_mode("error" if iteration == 3 else 0)
            return orig(self, *a, **kw)
        return train_iter

    sweeps = []

    def guard_sweep(orig):
        # every metrics cadence's ops sweep (the learner's row, the
        # snapshot, the watchdog, the incidents, remediation) right after
        # the metrics read, under "error" too
        def sweep(self, *a, **kw):
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                return orig(self, *a, **kw)
            finally:
                torch.cuda.set_sync_debug_mode(mode)
                sweeps.append(self.ops.snapshots)
        return sweep

    try:
        with Patched(M.SessionHooks, "end_iteration", stamp_end), \
                Patched(M.Trainer, "_device_train_iter", guard_iteration_3), \
                Patched(M.SessionHooks, "_ops_sweep", guard_sweep):
            final, launches = count_launches(
                {name: (w, n * iters) for name, (w, n) in gae_counters.items()}, lambda: run_cli(M, argv))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    events = session_events(folder, M.iter_jsonl)
    types = {e["type"] for e in events}
    ckpt_dir = os.path.join(folder, "checkpoints")
    checks = {
        "config_json": os.path.exists(os.path.join(folder, "config.json")),
        "events": {"phases", "precision", "ops_snapshot"} <= types and "unported" not in types,
        "sweeps_under_sync_error": sweeps == [1, 2, 3, 4],
        "checkpoints_4_8_best": all(os.path.isdir(os.path.join(ckpt_dir, d)) for d in ("4", "8", "best")),
        "eval_return_finite": math.isfinite(final.get("eval/return", float("nan"))),
    }
    if not all(checks.values()):
        raise AssertionError(f"train ppo session checks failed: {checks}")
    # restore of the newest step onto the card, fenced
    with open(os.path.join(folder, "config.json")) as f:
        trainer = M.Trainer(M.Config(json.load(f)))
    template = trainer.learner.init()
    (restored, meta), restore_ms = fenced_ms(lambda: M.CheckpointManager(folder).restore(template))
    if meta["iteration"] != iters:
        raise AssertionError(f"restored iteration {meta['iteration']}, expected {iters}")
    spans = lambda name: [e["dur_s"] * 1e3 for e in events if e["type"] == "span" and e["name"] == name]  # noqa: E731
    window_ms = {f"{a}-{b}": (window_end[b] - window_end[a]) * 1e3 / 2 for a, b in ((2, 4), (4, 6), (6, 8))}
    result = {
        "phase": "session", "step": "cli_ppo", "iterations": iters, "num_envs": MAIN_B, "horizon": MAIN_T,
        "launches": launches, "checks": checks, "no_off_cadence_sync": {"iteration": 3, "ok": True},
        "ops_sweeps_without_sync": len(sweeps),
        "ops_tiers": sorted((load_snapshot_of(folder).get("tiers") or {})),
        "state_bytes": state_bytes(restored, M.tree_flatten),
        "checkpoint_save_ms": spans("checkpoint"), "checkpoint_restore_ms": restore_ms,
        "eval_ms": spans("eval"), "eval_return": final["eval/return"],
        "iteration_ms_by_window": window_ms,
        "iteration_ms_without_cadence_work": window_ms["4-6"],
        "iteration_ms_with_eval_and_checkpoint": [window_ms["2-4"], window_ms["6-8"]],
    }
    emit(result)
    return result


def north_star_config(M, folder: str, **session):
    return M.Config(
        learner_config=M.Config(algo=M.Config(
            name="ppo", horizon=MAIN_T, epochs=4, num_minibatches=4, precision="mixed")),
        env_config=M.Config(name="jax:lift", num_envs=MAIN_B),
        session_config=timed_session(M.Config, folder=folder, **session),
    ).extend(M.base_config())


def session_interrupt_resume(M) -> dict:
    """A north-star run that sends itself SIGTERM from on_metrics at
    iteration 2 stops at that boundary with the emergency checkpoint; a
    relaunch into the folder auto-resumes at iteration 2 and its env
    steps, from a state bit-equal to the stopped run's."""
    folder = scratch_dir("interrupt")
    cfg = north_star_config(M, folder, checkpoint=M.Config(every_n_iters=100))
    steps = MAIN_B * MAIN_T
    previous = signal.getsignal(signal.SIGTERM)

    def on_metrics(iteration, metrics):
        if iteration == 2:
            os.kill(os.getpid(), signal.SIGTERM)

    stopped, last = M.Trainer(cfg).run(max_env_steps=10 * steps, on_metrics=on_metrics)
    if signal.getsignal(signal.SIGTERM) is not previous:
        raise AssertionError("the interrupt sentinel did not restore the SIGTERM handler")
    saved_steps = M.CheckpointManager(folder).steps()
    if last["time/env_steps"] != 2 * steps or saved_steps != [2]:
        raise AssertionError(f"SIGTERM at 2: stopped at {last['time/env_steps']} env steps, checkpoints {saved_steps}")
    restored = {}

    def capture(orig):
        def restore(self, init_state):
            restored["out"] = orig(self, init_state)
            return restored["out"]
        return restore

    seen = []
    with Patched(M.SessionHooks, "restore", capture):
        M.Trainer(cfg).run(max_env_steps=3 * steps, on_metrics=lambda i, m: seen.append((i, m["time/env_steps"])))
    state, iteration, env_steps = restored["out"]
    checks = {
        "resumed_at": (iteration, env_steps) == (2, 2 * steps),
        "bit_equal": tensors_equal(state, stopped, M.tree_flatten),
        "continued": seen == [(3, 3 * steps)],
        "interrupt_event": any(e.get("kind") == "interrupt" for e in session_events(folder, M.iter_jsonl)),
    }
    if not all(checks.values()):
        raise AssertionError(f"interrupt/resume checks failed: {checks}")
    result = {"phase": "session", "step": "interrupt_resume", "checks": checks,
              "stopped_at_iteration": 2, "resumed_iterations": [i for i, _ in seen]}
    emit(result)
    return result


def session_rollback(M) -> dict:
    """``nan_state`` at trainer.iteration (call 3) poisons iteration 4's
    learn on 1024 envs x 64 steps; the guard trips, the run rolls back to
    checkpoint 2, backs the LR off by lr_backoff (0.5) and ends six
    iterations later with finite metrics."""
    folder = scratch_dir("rollback")
    cfg = M.Config(
        learner_config=M.Config(algo=M.Config(name="ppo", horizon=64, epochs=4, num_minibatches=4)),
        env_config=M.Config(name="jax:lift", num_envs=1024),
        session_config=timed_session(
            M.Config, folder=folder, checkpoint=M.Config(every_n_iters=2),
            faults=M.Config(plan=[{"site": "trainer.iteration", "kind": "nan_state", "at": 3}])),
    ).extend(M.base_config())
    seen = []
    state, last = M.Trainer(cfg).run(max_env_steps=6 * 1024 * 64, on_metrics=lambda i, m: seen.append(
        (i, m["health/nonfinite"])))
    rec = [e for e in session_events(folder, M.iter_jsonl) if e["type"] == "recovery"]
    checks = {
        "tripped_then_rolled_back": [e["kind"] for e in rec] == ["tripped", "rollback"],
        "to_checkpoint_2": bool(rec) and rec[-1].get("to_iteration") == 2,
        "lr_scale": float(state.opt_state.recovery_scale) == 0.5,
        "finite_at_end": all(math.isfinite(v) for k, v in last.items() if k != "episode/return"),
        "iterations": [i for i, _ in seen] == [1, 2, 3, 4, 3, 4, 5, 6],
    }
    if not all(checks.values()):
        raise AssertionError(f"rollback checks failed: {checks}, windows {seen}")
    result = {"phase": "session", "step": "rollback", "checks": checks, "windows": seen}
    emit(result)
    return result


def session_cli_ddpg(M, replay_counters: dict) -> dict:
    """``train ddpg jax:lift`` at the headline geometry with
    checkpoint.include_replay, 3 iterations, then a relaunch to 4: the
    relaunch's first iteration starts from the saved replay (ring,
    cursor, size, priorities, max priority) bit for bit, and the gather
    and scatter launch 64 times each per iteration in both runs. Reports
    the checkpoint spans (state and replay saved) and the fenced time of
    the replay's restore."""
    folder = scratch_dir("cli_ddpg")
    per_iter = DDPG_B * DDPG_H

    def argv(iters):
        return ["train", "ddpg", "jax:lift", "--folder", folder, "--num-envs", str(DDPG_B),
                "--total-steps", str(iters * per_iter), "--set",
                f"learner_config.algo.horizon={DDPG_H}", f"learner_config.algo.updates_per_iter={DDPG_K}",
                "learner_config.algo.precision=mixed", "learner_config.algo.exploration.warmup_steps=0",
                "learner_config.replay.kind=prioritized", f"learner_config.replay.capacity={DDPG_CAPACITY}",
                f"learner_config.replay.start_sample_size={per_iter}", f"learner_config.replay.batch_size={DDPG_BS}",
                "session_config.checkpoint.every_n_iters=3", "session_config.checkpoint.include_replay=true",
                "session_config.eval.every_n_iters=0", "session_config.metrics.every_n_iters=1",
                "session_config.metrics.console=false", "session_config.metrics.tensorboard=false"]

    seen = []

    def snapshot(replay_state):
        """(host leaves, clones of the tensors): the ring is updated in place."""
        flat = M.tree_flatten(replay_state)
        return ({k: v for k, v in flat.items() if not isinstance(v, torch.Tensor)},
                {k: v.clone() for k, v in flat.items() if isinstance(v, torch.Tensor)})

    def capture(orig):
        def train_iter(self, state, replay_state, carry, **kw):
            seen.append(snapshot(replay_state))
            out = orig(self, state, replay_state, carry, **kw)
            seen.append(snapshot(out[1]))
            return out
        return train_iter

    restore_ms = []

    def timed_restore(orig):
        def restore_extra(self, template, step):
            out, ms = fenced_ms(lambda: orig(self, template, step))
            restore_ms.append(ms)
            return out
        return restore_extra

    counts = lambda n: {name: (w, k * n) for name, (w, k) in replay_counters.items()}  # noqa: E731
    with Patched(M.OffPolicyTrainer, "_device_train_iter", capture), \
            Patched(M.CheckpointManager, "restore_extra", timed_restore):
        _, launches_1 = count_launches(counts(3), lambda: run_cli(M, argv(3)))
        saved = seen[-1]
        seen.clear()
        final, launches_2 = count_launches(counts(1), lambda: run_cli(M, argv(4)))
    resumed = seen[0]
    checks = {
        "host_leaves": saved[0] == resumed[0] and saved[0]["ring/cursor"] == 3 * per_iter,
        "tensors_bit_equal": saved[1].keys() == resumed[1].keys() and all(
            torch.equal(v, resumed[1][k]) and v.dtype == resumed[1][k].dtype for k, v in saved[1].items()),
        "extra_steps": sorted(os.listdir(os.path.join(folder, "checkpoints", "extra"))) == ["3", "4"],
        "finite": all(math.isfinite(v) for k, v in final.items() if k != "episode/return"),
    }
    if not all(checks.values()):
        raise AssertionError(f"train ddpg include_replay checks failed: {checks}")
    save_ms = [e["dur_s"] * 1e3 for e in session_events(folder, M.iter_jsonl)
               if e["type"] == "span" and e["name"] == "checkpoint"]
    result = {"phase": "session", "step": "cli_ddpg_include_replay", "checks": checks,
              "checkpoint_save_ms": save_ms, "replay_restore_ms": restore_ms,
              "replay_host_leaves": saved[0], "launches_first_run": launches_1, "launches_resumed_run": launches_2,
              "replay_bytes": sum(v.numel() * v.element_size() for v in saved[1].values())}
    emit(result)
    return result


def session_learning(M) -> dict:
    """tests/test_envs.py::test_ppo_learns_on_lift's own config on the
    card: 256 envs x 64 steps, 4 epochs x 4 minibatches, 'mixed', metrics
    every 10, at most 5,000,000 env steps, stopped at episode/return >=
    400. Fails if 400 is not reached."""
    cfg = M.Config(
        learner_config=M.Config(algo=M.Config(name="ppo", horizon=64, epochs=4, num_minibatches=4)),
        env_config=M.Config(name="jax:lift", num_envs=256),
        session_config=M.Config(
            folder=scratch_dir("learn"), total_env_steps=5_000_000,
            metrics=M.Config(every_n_iters=10, tensorboard=False, console=False),
            checkpoint=M.Config(every_n_iters=0), eval=M.Config(every_n_iters=0),
        ),
    ).extend(M.base_config())
    best = {"ret": float("-inf"), "iteration": None}
    t0 = time.perf_counter()
    curve = []

    def cb(iteration, m):
        r = m.get("episode/return", float("nan"))
        curve.append([iteration, r])
        if r == r and r > best["ret"]:
            best.update(ret=r, iteration=iteration, seconds=time.perf_counter() - t0)
        return best["ret"] >= 400.0

    M.Trainer(cfg).run(on_metrics=cb)
    if best["ret"] < 400.0:
        raise AssertionError(f"PPO on jax:lift reached {best['ret']} < 400 within 5,000,000 env steps: {curve}")
    result = {"phase": "session", "step": "learning", "target": 400.0, "best_return": best["ret"],
              "iterations_to_target": best["iteration"], "env_steps_to_target": best["iteration"] * 256 * 64,
              "seconds_to_target": best["seconds"], "curve": curve}
    emit(result)
    return result


def session_cli_trajectory(M, step: str, cmd: list[str], num_envs: int, horizon: int, iters: int,
                           counters: dict, sets: list[str]) -> dict:
    """``train <algo> <env> --set learner_config.model.encoder.kind=trajectory``
    through the CLI for ``iters`` iterations with eval on (every 2, 5
    deterministic episodes, each longer than the horizon, so the
    evaluator's act_step wraps the context), metrics every 2, a checkpoint
    at the end; ``counters`` as count_launches takes them, per iteration."""
    folder = scratch_dir(step)
    argv = ["train", *cmd, "--folder", folder, "--num-envs", str(num_envs),
            "--total-steps", str(iters * num_envs * horizon), "--set",
            "learner_config.model.encoder.kind=trajectory", f"learner_config.algo.horizon={horizon}",
            "learner_config.algo.precision=mixed", "session_config.metrics.every_n_iters=2",
            f"session_config.checkpoint.every_n_iters={iters}", "session_config.eval.every_n_iters=2",
            "session_config.eval.episodes=5", "session_config.metrics.console=false",
            "session_config.metrics.tensorboard=false", *sets]
    t0 = time.perf_counter()
    final, launches = count_launches({name: (w, n * iters) for name, (w, n) in counters.items()},
                                     lambda: run_cli(M, argv))
    seconds = time.perf_counter() - t0
    events = session_events(folder, M.iter_jsonl)
    checks = {
        "eval_outran_the_horizon": final.get("eval/length", 0.0) > horizon,
        "eval_return_finite": math.isfinite(final.get("eval/return", float("nan"))),
        "finite": all(math.isfinite(v) for k, v in final.items() if k != "episode/return"),
        "checkpoint": os.path.isdir(os.path.join(folder, "checkpoints", str(iters))),
    }
    if not all(checks.values()):
        raise AssertionError(f"{step} checks failed: {checks}, final metrics {final}")
    eval_ms = [e["dur_s"] * 1e3 for e in events if e["type"] == "span" and e["name"] == "eval"]
    result = {"phase": "session", "step": step, "argv": argv, "iterations": iters, "launches": launches,
              "checks": checks, "seconds": seconds, "eval_ms": eval_ms, "eval_return": final["eval/return"],
              "eval_length": final["eval/length"], "final": final}
    emit(result)
    return result


def phase_session_trajectory(M, gae_counters: dict, vtrace_counters: dict) -> None:
    """The three trajectory commands the README gives for the JAX package,
    on the card: PPO on jax:pendulum at the train phase's geometry (4
    iterations), IMPALA on jax:cartpole (1024 envs x 32 steps, 2
    iterations), PPO with the CNN stem on pixel jax:pong16 (the repo's
    16x16 CNN, 1024 envs x 32 steps, eval capped at 300 steps, 2
    iterations)."""
    session_cli_trajectory(M, "cli_trajectory_ppo_pendulum", ["ppo", "jax:pendulum"], TRAJ_B, TRAJ_T, 4,
                           gae_counters, ["learner_config.algo.epochs=2", "learner_config.algo.num_minibatches=2"])
    session_cli_trajectory(M, "cli_trajectory_impala_cartpole", ["impala", "jax:cartpole"], PONG_B, PONG_T, 2,
                           vtrace_counters, [])
    cnn = [f"learner_config.model.cnn.{k}={json.dumps(v)}" for k, v in PONG16_CNN.items()]
    session_cli_trajectory(M, "cli_trajectory_ppo_pong16", ["ppo", "jax:pong16"], PONG_B, PONG_T, 2, gae_counters,
                           ["learner_config.algo.epochs=2", "learner_config.algo.num_minibatches=2",
                            "session_config.eval.max_steps=300", *cnn])


def phase_session(M, gae_counters: dict, replay_counters: dict) -> None:
    session_cli_ppo(M, gae_counters)
    session_interrupt_resume(M)
    session_rollback(M)
    session_cli_ddpg(M, replay_counters)
    session_learning(M)


# -- host envs (gym, dm_control) and the NutAssembly pixel env ---------------

# the host envs of BASELINE configs (1) and (2) and DDPG's host path, with the
# specs a fixture env takes in place of one whose package the machine lacks:
# (obs dim, discrete actions, continuous action dim, episode length)
HOST_ENVS = {
    "gym:CartPole-v1": (4, 2, None, 500),
    "gym:Pendulum-v1": (3, None, 1, 200),
    "dm_control:cheetah-run": (17, None, 6, 1000),
}
HOST_ENV_PACKAGES = {"gym:CartPole-v1": ("gymnasium",), "gym:Pendulum-v1": ("gymnasium",),
                     "dm_control:cheetah-run": ("dm_control", "mujoco")}
# BASELINE config (5)'s Atari Pong: no ALE or ROMs on either machine, so the
# SEED pixel phase always runs a fixture with jax:pong's specs
PONG_HOST_ENV = "gym:ALE/Pong-v5"
FIXTURE_ENV_VAR = "CHIP_SMOKE_FIXTURE_ENVS"  # spawned env workers read it at import
HOST_WARMUP_ITERS, HOST_TIMED_ITERS = 1, 3  # cut from 2, 4 for the time limit


def phase_env_probe() -> dict:
    """Which of the host env packages import here, with their versions."""
    import importlib
    import importlib.metadata

    found = {}
    for name in ("gymnasium", "dm_control", "mujoco", "ale_py", "zmq"):
        try:
            mod = importlib.import_module(name)
        except Exception as exc:  # a probe: what is missing is the answer
            found[name] = {"imports": False, "error": f"{type(exc).__name__}: {exc}"}
            continue
        try:
            version = importlib.metadata.version(name)
        except importlib.metadata.PackageNotFoundError:
            version = getattr(mod, "__version__", None)
        found[name] = {"imports": True, "version": version}
    env_source = {
        env: "package" if all(found[m]["imports"] for m in mods) else "fixture"
        for env, mods in HOST_ENV_PACKAGES.items()
    }
    emit({"phase": "env_probe", "modules": found, "env_source": env_source})
    return env_source


def fixture_env_class(HostEnv, StepOutput, ArraySpec, DiscreteSpec, EnvSpecs):
    """A seeded numpy host env with a missing host env's specs (a test
    fixture, as tests/test_envs.py defines FakePixelEnv): point masses
    pushed by the action, reward -|x|^2, a discrete env's episodes ending
    when a coordinate leaves [-3, 3], every episode truncated at the
    reference env's length."""

    class FixtureHostEnv(HostEnv):
        def __init__(self, name: str, num_envs: int, seed: int):
            obs_dim, n, act_dim, self._limit = HOST_ENVS[name]
            f32 = np.dtype(np.float32)
            action = (DiscreteSpec(shape=(), dtype=np.dtype(np.int32), name="action", n=n) if n
                      else ArraySpec(shape=(act_dim,), dtype=f32, name="action"))
            self.specs = EnvSpecs(obs=ArraySpec(shape=(obs_dim,), dtype=f32, name="obs"), action=action)
            self.num_envs, self._seed = num_envs, seed
            self._rng = np.random.default_rng(seed)
            self._push = np.random.default_rng(99).normal(0.0, 0.3, (n or act_dim, obs_dim)).astype(np.float32)

        def reset(self, seed=None):
            if seed is not None:
                self._rng = np.random.default_rng(seed)
            self._t = np.zeros(self.num_envs, np.int64)
            self._x = self._rng.normal(0.0, 0.5, (self.num_envs, self._push.shape[1])).astype(np.float32)
            return self._x.copy()

        def step(self, actions):
            force = self._push[actions] if self.specs.discrete else np.clip(actions, -1, 1) @ self._push
            self._x = (0.95 * self._x + force + 0.05 * self._rng.normal(size=self._x.shape)).astype(np.float32)
            reward = -(self._x ** 2).sum(1).astype(np.float32)
            self._t += 1
            failed = (np.abs(self._x) > 3.0).any(1) if self.specs.discrete else np.zeros(self.num_envs, bool)
            truncated = (self._t >= self._limit) & ~failed
            done = failed | truncated
            terminal = self._x.copy()
            if done.any():
                self._x[done] = self._rng.normal(0.0, 0.5, (int(done.sum()), self._x.shape[1])).astype(np.float32)
                self._t[done] = 0
            return StepOutput(obs=self._x.copy(), reward=reward, done=done,
                              info={"terminal_obs": terminal, "truncated": truncated})

    return FixtureHostEnv


def pixel_fixture_env_class(HostEnv, StepOutput, ArraySpec, DiscreteSpec, EnvSpecs):
    """A seeded numpy host env with jax:pong's specs ([42, 42, 2] uint8
    frames, 3 actions): a ball (a point mass in 2-D pushed by the action)
    drawn as a bright 3x3 square over a fixed noise background, the second
    channel the previous frame; reward -|x|^2, an episode ends when the
    ball leaves [-3, 3] or after 1,000 steps."""

    class PixelFixtureEnv(HostEnv):
        def __init__(self, num_envs: int, seed: int):
            self.specs = EnvSpecs(obs=ArraySpec(shape=(42, 42, 2), dtype=np.dtype(np.uint8), name="obs"),
                                  action=DiscreteSpec(shape=(), dtype=np.dtype(np.int32), name="action", n=3))
            self.num_envs = num_envs
            self._rng = np.random.default_rng(seed)
            self._push = np.array([[0.0, 0.0], [0.0, 0.3], [0.0, -0.3]], np.float32)
            self._background = np.random.default_rng(98).integers(0, 40, (42, 42), dtype=np.uint8)

        def _render(self):
            frame = np.broadcast_to(self._background, (self.num_envs, 42, 42)).copy()
            px = np.clip(((self._x + 3.0) / 6.0 * 39).astype(np.int64), 0, 39)
            d = np.arange(3)
            rows = (px[:, 1, None, None] + d[None, :, None])
            cols = (px[:, 0, None, None] + d[None, None, :])
            frame[np.arange(self.num_envs)[:, None, None], rows, cols] = 255
            return frame

        def _obs(self):
            frame = self._render()
            obs = np.stack([frame, self._prev], axis=-1)
            self._prev = frame
            return obs

        def reset(self, seed=None):
            if seed is not None:
                self._rng = np.random.default_rng(seed)
            self._t = np.zeros(self.num_envs, np.int64)
            self._x = self._rng.normal(0.0, 0.5, (self.num_envs, 2)).astype(np.float32)
            self._prev = self._render()
            return self._obs()

        def step(self, actions):
            self._x = (0.95 * self._x + self._push[actions]
                       + 0.05 * self._rng.normal(size=self._x.shape)).astype(np.float32)
            reward = -(self._x ** 2).sum(1).astype(np.float32)
            self._t += 1
            failed = (np.abs(self._x) > 3.0).any(1)
            truncated = (self._t >= 1000) & ~failed
            done = failed | truncated
            terminal = np.stack([self._render(), self._prev], axis=-1)
            if done.any():
                self._x[done] = self._rng.normal(0.0, 0.5, (int(done.sum()), 2)).astype(np.float32)
                self._t[done] = 0
            return StepOutput(obs=self._obs(), reward=reward, done=done,
                              info={"terminal_obs": terminal, "truncated": truncated})

    return PixelFixtureEnv


def make_fixture_env(name: str, num_envs: int, seed: int):
    """The fixture env of ``name``'s specs inside EpisodeStatsWrapper, as
    the factory wraps a host env."""
    from surreal_tpu_torch.envs.base import ArraySpec, DiscreteSpec, EnvSpecs, HostEnv, StepOutput
    from surreal_tpu_torch.envs.wrappers import EpisodeStatsWrapper

    if name == PONG_HOST_ENV:
        Pixels = pixel_fixture_env_class(HostEnv, StepOutput, ArraySpec, DiscreteSpec, EnvSpecs)
        return EpisodeStatsWrapper(Pixels(num_envs, seed))
    Fixture = fixture_env_class(HostEnv, StepOutput, ArraySpec, DiscreteSpec, EnvSpecs)
    return EpisodeStatsWrapper(Fixture(name, num_envs, seed))


def patch_make_env(missing, modules) -> None:
    """``make_env`` of each module builds the fixture env for the names in
    ``missing`` and the real env otherwise."""
    import surreal_tpu_torch.envs.factory as factory

    real = factory.make_env

    def make_env(env_config, device="cuda"):
        if env_config.name in missing:
            return make_fixture_env(env_config.name, env_config.num_envs, env_config.seed)
        return real(env_config, device)

    for mod in modules:
        mod.make_env = make_env


def install_fixture_envs(env_source: dict) -> None:
    """Where a host env's package is missing, make_env builds the fixture
    env of its specs for every trainer, the evaluator and the SEED env
    workers: thread workers through the patched module, spawned ones
    through the module-level hook at the end of this file, which a spawned
    child runs when it imports this script as ``__mp_main__``."""
    missing = {env for env, src in env_source.items() if src == "fixture"} | {PONG_HOST_ENV}
    import surreal_tpu_torch.distributed.env_worker as env_worker
    import surreal_tpu_torch.launch.evaluator as evaluator
    import surreal_tpu_torch.launch.offpolicy_trainer as offpolicy_trainer
    import surreal_tpu_torch.launch.seed_trainer as seed_trainer
    import surreal_tpu_torch.launch.trainer as trainer
    import surreal_tpu_torch.tune.search as tune_search

    patch_make_env(missing, (trainer, offpolicy_trainer, evaluator, seed_trainer, env_worker, tune_search))
    os.environ[FIXTURE_ENV_VAR] = json.dumps(sorted(missing))


def host_config(M, algo: dict, env: str, num_envs: int, session=None, **learner):
    return M.Config(
        learner_config=M.Config(algo=M.Config(algo), **{k: M.Config(v) for k, v in learner.items()}),
        env_config=M.Config(name=env, num_envs=num_envs),
        session_config=session if session is not None else M.Config(folder=scratch_dir("host")),
    ).extend(M.base_config())


def count_syncs(fn, sites: dict | None = None):
    """(fn(), the number of host syncs torch reports while it runs), under
    torch.cuda.set_sync_debug_mode("warn"); ``sites`` gathers the count by
    the file:line that triggered each."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    # the first mode switch of a process also warns "Synchronization debug
    # mode is a prototype feature ...": not a sync
    syncs = [w for w in caught if "synchroniz" in str(w.message) and "prototype" not in str(w.message)]
    if sites is not None:
        for w in syncs:
            site = f"{os.path.relpath(w.filename)}:{w.lineno}"
            sites[site] = sites.get(site, 0) + 1
    return out, len(syncs)


def phase_parity_host_ppo(M, counters: dict, gae_impl: str, env_source: dict) -> dict:
    """One alternate host iteration of PPO on dm_control:cheetah-run (16
    envs x 32 steps, 4 epochs x 4 minibatches, f32) at ``gae_impl`` on the
    card and on the CPU, from the same weights, the same env seed and the
    same injected action noise and epoch permutations; on the card each
    kernel of ``counters`` launches as often as it says. Bars of the PPO
    parity phase: final obs 1e-4 (the actions differ by the devices'
    rounding and the simulator integrates them), metrics 1e-4 + 1e-3
    relative, the update ratio 5e-2."""
    from surreal_tpu_torch.learners.ppo import _block_layout

    env, B, T, epochs, num_mb = "dm_control:cheetah-run", 16, 32, 4, 4
    cfg = host_config(M, dict(name="ppo", horizon=T, epochs=epochs, num_minibatches=num_mb, precision="f32",
                              gae_impl=gae_impl), env, B)
    gen = torch.Generator().manual_seed(11)
    noise = torch.randn((T, B, 6), generator=gen)
    bpm = _block_layout(T * B, num_mb, 17 * 4)
    domain = num_mb * bpm if bpm else T * B
    perms = torch.stack([torch.randperm(domain, generator=gen) for _ in range(epochs)])
    out, launches = {}, {}
    for dev in ("cuda", "cpu"):
        tr = M.Trainer(cfg, device=dev)
        state = tr.learner.init(torch.Generator().manual_seed(0))
        obs0 = tr.env.reset(seed=0)
        iteration = lambda: tr._host_train_iter(  # noqa: E731
            state, obs0, action_noise=noise.to(dev), perms=perms.to(dev))
        if dev == "cuda":
            (state, obs, metrics, _), launches = count_launches(counters, iteration)
        else:
            state, obs, metrics, _ = iteration()
        out[dev] = (obs, {k: float(v) for k, v in metrics.items()})
        tr.env.close()
    obs_err = float(np.abs(out["cuda"][0] - out["cpu"][0]).max())
    if obs_err > 1e-4:
        raise AssertionError(f"host ppo: final obs differ between cuda and cpu by {obs_err}")
    errs = {}
    for k, want in out["cpu"][1].items():
        got = out["cuda"][1][k]
        rtol = 5e-2 if k == "health/update_ratio" else 1e-3
        if not ((math.isnan(want) and math.isnan(got)) or abs(got - want) <= 1e-4 + rtol * abs(want)):
            raise AssertionError(f"host ppo metric {k}: cuda {got} vs cpu {want}")
        errs[k] = abs(got - want)
    emit({"phase": "parity", "path": "host_ppo", "env": env, "env_source": env_source[env], "gae_impl": gae_impl,
          "launches": launches, "num_envs": B, "horizon": T, "final_obs_max_abs_err": obs_err,
          "metric_abs_err": errs})
    return launches


def phase_train_host(M, path: str, algo: dict, env: str, B: int, T: int, counters: dict, env_source: dict,
                     overlap: bool, warmup: int = HOST_WARMUP_ITERS, timed: int = HOST_TIMED_ITERS,
                     sync_check: bool = False, **learner) -> dict:
    """``Trainer.run`` / ``OffPolicyTrainer.run`` on a host env on the card
    (``topology.overlap_rollouts`` = ``overlap``), ``counters`` as timed_run
    takes them; with ``sync_check``, one more alternate iteration counts
    its host syncs against the horizon's action reads."""
    cfg = host_config(M, algo, env, B, session=timed_session(
        M.Config, topology=M.Config(overlap_rollouts=overlap)), **learner)
    trainer_cls = M.OffPolicyTrainer if algo["name"] == "ddpg" else M.Trainer
    trainer = trainer_cls(cfg)  # the default device: the card
    state, timing = timed_run(trainer, counters, warmup, timed)
    spans = timing["span_ms"][warmup:]
    result = {
        "phase": "train", "path": path, "env": env, "env_source": env_source[env],
        "overlap_rollouts": overlap, "num_envs": B, "horizon": T, "algo": algo,
        **timing,
        "rollout_ms": [sp.get("rollout") for sp in spans],
        "learn_ms": [sp.get("learn") for sp in spans],
        "chunk_wait_ms": [sp.get("chunk-wait") for sp in spans],
    }
    if sync_check:
        obs = trainer.env.reset(seed=1)
        gen = torch.Generator(device="cuda").manual_seed(5)
        _, syncs = count_syncs(lambda: trainer._host_train_iter(state, obs, gen))
        result["syncs_per_iteration"] = {"counted": syncs, "expected": T, "what": "one action read per env step"}
        if syncs != T:
            raise AssertionError(f"{path}: {syncs} host syncs in an iteration, expected {T}")
    trainer.env.close()
    emit(result)
    return result


def check_host_ddpg_gather(RR, example: dict, path: str = "host_ddpg_pendulum") -> dict:
    """The replay gather kernel against its plain version, bit for bit, at
    the host DDPG path's rows: the leaves of ``example`` (the trainer's
    ``_replay_example()``) in a 200,000-row ring, 256 indices with and
    without repeats; timed there, with index_select per leaf as the
    library call."""
    gen = torch.Generator(device="cuda").manual_seed(17)
    leaves = {k: torch.randn((DDPG_CAPACITY, *v.shape), generator=gen, device="cuda").to(v.dtype)
              for k, v in example.items()}
    idx = torch.randint(0, DDPG_CAPACITY, (DDPG_BS,), generator=gen, device="cuda", dtype=torch.int32)
    repeated = idx.clone()
    repeated[DDPG_BS // 2:] = idx[: DDPG_BS - DDPG_BS // 2].flip(0)
    checks, max_abs = [], 0.0
    for label, ix in ((path, idx), (f"{path}_duplicates", repeated)):
        got, want = RR.gather_rows(leaves, ix), RR.gather_rows_plain(leaves, ix)
        torch.cuda.synchronize()
        for k in leaves:
            if not torch.equal(got[k], want[k]):
                raise AssertionError(f"replay_gather != plain for leaf {k} in case {label}")
        err = max(float((got[k].double() - want[k].double()).abs().max()) for k in leaves)
        max_abs = max(max_abs, err)
        checks.append({"case": label, "rows": ix.numel(), "capacity": DDPG_CAPACITY,
                       "leaves": {k: [list(v.shape[1:]), str(v.dtype)] for k, v in leaves.items()},
                       "max_abs_err": err})
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")
    row_bytes = sum(x[0].numel() * x.element_size() for x in leaves.values())
    nbytes = 2 * DDPG_BS * row_bytes + idx.numel() * idx.element_size()
    result = {
        "phase": "kernels", "kernel": "replay_gather", "path": path, "checks": checks,
        "tolerance": "exact (0)", "max_abs_err": max_abs, "row_bytes": row_bytes,
        "ms": time_cuda_ms(lambda: RR.gather_rows(leaves, idx), runs=30, flush=flush, spin=True),
        "plain_ms": time_cuda_ms(lambda: RR.gather_rows_plain(leaves, idx), runs=30, flush=flush, spin=False),
        "library_ms": sum(time_cuda_ms(lambda x=x: x.index_select(0, idx), runs=30, flush=flush, spin=True)
                          for x in leaves.values()),
        "bound_ms": nbytes / H100_BYTES_PER_S * 1e3, "bound_by": "bytes",
    }
    emit(result)
    return result


def phase_parity_host_ddpg(M, RR, env_source: dict) -> dict:
    """Two f32 host DDPG iterations on gym:Pendulum-v1 at the host-ddpg
    path's replay geometry (32 envs x 16 steps, 256-row samples from a
    200,000-row prioritized ring), n-step 3 and 4 updates an iteration, the
    first under warm-up actions, the second with OU noise: on the card and
    on the CPU from the same weights, env seed, warm-up actions, OU normals
    and replay draws, at the device DDPG parity bars (compare_ddpg_parity);
    the gather and the scatter launch 4 times an iteration on the card.
    Before that, the gather kernel at this path's rows
    (check_host_ddpg_gather). Returns the gather check."""
    from surreal_tpu_torch.learners.aggregator import to_device

    env, B, H, K = "gym:Pendulum-v1", HOST_DDPG_B, HOST_DDPG_H, 4
    act_dim = HOST_ENVS[env][2]
    algo = dict(name="ddpg", horizon=H, updates_per_iter=K, n_step=3, precision="f32",
                exploration=dict(warmup_steps=B * H))
    replay = dict(kind="prioritized", capacity=DDPG_CAPACITY, start_sample_size=B * H, batch_size=DDPG_BS)
    cfg = host_config(M, algo, env, B, replay=replay)
    gen = torch.Generator().manual_seed(13)
    warm = (torch.rand((H, B, act_dim), generator=gen) * 2 - 1).numpy()
    normals = torch.randn((H, B, act_dim), generator=gen)
    uniforms = torch.rand((2, K, DDPG_BS), generator=gen)
    counters = {"replay_gather": (RR.gather_rows, 2 * K), "replay_scatter": (RR.scatter_rows, 2 * K)}
    out, gather, launches = {}, None, {}
    for dev in ("cuda", "cpu"):
        tr = M.OffPolicyTrainer(cfg, device=dev)
        if dev == "cuda":
            gather = check_host_ddpg_gather(RR, tr._replay_example())
        recorder = SampleRecorder(tr.replay)
        state = tr.learner.init(torch.Generator().manual_seed(0))
        roll = tr.host_roll_state(tr.env.reset(seed=0), 0)
        replay_state, tail = tr.replay.init(tr._replay_example()), tr._fake_tail()
        metrics = []

        def two_iterations():
            nonlocal state, replay_state, tail
            for it in range(2):
                traj, _ = tr._explore_rollout(roll, state, it == 0, warmup_actions=warm,
                                              action_noise=normals)
                state, replay_state, tail, m = tr._host_update(
                    state, replay_state, tail, to_device(traj, tr.device), it == 0, 0.4,
                    sample_draws=uniforms[it].to(dev))
                metrics.append({k: float(v) for k, v in m.items()})

        if dev == "cuda":
            _, launches = count_launches(counters, two_iterations)
        else:
            two_iterations()
        tr.env.close()
        out[dev] = {"obs": roll["obs"], "metrics": metrics,
                    "storage": {k: v.cpu() for k, v in replay_state.ring.storage.items()},
                    "priorities": replay_state.priorities.cpu(), "samples": recorder.calls}
    flips, compared, errs = compare_ddpg_parity("host ddpg", out, True)
    emit({"phase": "parity", "path": "host_ddpg", "env": env, "env_source": env_source[env],
          "replay": "prioritized", "n_step": 3, "num_envs": B, "horizon": H, "updates_per_iter": K,
          "batch_size": DDPG_BS, "capacity": DDPG_CAPACITY, "iterations": 2, "tf32": False,
          "launches": launches, "prioritized_index_flips_at_boundaries": flips, "compared": compared,
          "abs_err": errs})
    return gather


def phase_host_ddpg(M, RR, env_source: dict) -> dict:
    """DDPG with prioritized replay on gym:Pendulum-v1 on the card: 32 envs
    x 16 steps, 64 updates of 256 from a 200,000-row ring (the ddpg cell's
    learner settings), warm-up for the first iteration only, sampling
    from the first insert on: the gather and the scatter launch 64 times
    each per iteration. Then one more exploring iteration counts its host
    syncs against the horizon's action reads."""
    env, B, H = "gym:Pendulum-v1", HOST_DDPG_B, HOST_DDPG_H
    algo = dict(name="ddpg", horizon=H, updates_per_iter=DDPG_K, precision="mixed",
                exploration=dict(warmup_steps=B * H))
    replay = dict(kind="prioritized", capacity=DDPG_CAPACITY, start_sample_size=B * H, batch_size=DDPG_BS)
    counters = {"replay_gather": (RR.gather_rows, DDPG_K), "replay_scatter": (RR.scatter_rows, DDPG_K)}
    cfg = host_config(M, algo, env, B, session=timed_session(M.Config), replay=replay)
    trainer = M.OffPolicyTrainer(cfg)
    state, timing = timed_run(trainer, counters, HOST_WARMUP_ITERS, HOST_TIMED_ITERS)
    roll = trainer.host_roll_state(trainer.env.reset(seed=1), 1)
    (traj, _), syncs = count_syncs(lambda: trainer._explore_rollout(roll, state, False))
    if syncs != H:
        raise AssertionError(f"host ddpg: {syncs} host syncs in an exploring rollout, expected {H}")
    spans = timing["span_ms"][HOST_WARMUP_ITERS:]
    trainer.env.close()
    result = {
        "phase": "train", "path": "host_ddpg", "env": env, "env_source": env_source[env], "replay": "prioritized",
        "capacity": DDPG_CAPACITY, "num_envs": B, "horizon": H, "updates_per_iter": DDPG_K,
        "batch_size": DDPG_BS, "precision": "mixed", **timing,
        "rollout_ms": [sp.get("rollout") for sp in spans], "learn_ms_per_update": [sp.get("learn") for sp in spans],
        "syncs_per_exploring_rollout": {"counted": syncs, "expected": H},
    }
    emit(result)
    return result


def session_cli_host_ddpg(M, replay_counters: dict) -> dict:
    """``train ddpg gym:Pendulum-v1`` with prioritized replay and
    checkpoint.include_replay for 2 iterations, then a relaunch to 3: the
    relaunch starts from the saved replay (ring, cursor, size,
    priorities) bit for bit; the gather and the scatter launch 64 times
    each per iteration in both runs."""
    folder, B, H = scratch_dir("cli_host_ddpg"), HOST_DDPG_B, HOST_DDPG_H

    def argv(iters):
        return ["train", "ddpg", "gym:Pendulum-v1", "--folder", folder, "--num-envs", str(B),
                "--total-steps", str(iters * B * H), "--set", f"learner_config.algo.horizon={H}",
                f"learner_config.algo.updates_per_iter={DDPG_K}", "learner_config.algo.precision=mixed",
                f"learner_config.algo.exploration.warmup_steps={B * H}", "learner_config.replay.kind=prioritized",
                f"learner_config.replay.capacity={DDPG_CAPACITY}", f"learner_config.replay.start_sample_size={B * H}",
                f"learner_config.replay.batch_size={DDPG_BS}", "session_config.checkpoint.every_n_iters=2",
                "session_config.checkpoint.include_replay=true", "session_config.eval.every_n_iters=0",
                "session_config.metrics.every_n_iters=1", "session_config.metrics.console=false",
                "session_config.metrics.tensorboard=false"]

    seen = []

    def snapshot(replay_state):
        flat = M.tree_flatten(replay_state)
        return {k: v.clone() if isinstance(v, torch.Tensor) else v for k, v in flat.items()}

    def capture(orig):
        def host_update(self, state, replay_state, *a, **kw):
            seen.append(snapshot(replay_state))
            out = orig(self, state, replay_state, *a, **kw)
            seen.append(snapshot(out[1]))
            return out
        return host_update

    counts = lambda n: {name: (w, k * n) for name, (w, k) in replay_counters.items()}  # noqa: E731
    with Patched(M.OffPolicyTrainer, "_host_update", capture):
        _, launches_1 = count_launches(counts(2), lambda: run_cli(M, argv(2)))
        saved = seen[-1]
        seen.clear()
        final, launches_2 = count_launches(counts(1), lambda: run_cli(M, argv(3)))
    resumed = seen[0]
    checks = {
        "cursor": saved["ring/cursor"] == 2 * B * H,
        "bit_equal": saved.keys() == resumed.keys() and all(
            torch.equal(v, resumed[k]) and v.dtype == resumed[k].dtype if isinstance(v, torch.Tensor)
            else v == resumed[k] for k, v in saved.items()),
        "finite": all(math.isfinite(v) for k, v in final.items() if k != "episode/return"),
    }
    if not all(checks.values()):
        raise AssertionError(f"train ddpg gym:Pendulum-v1 include_replay checks failed: {checks}")
    result = {"phase": "session", "step": "cli_host_ddpg_include_replay", "checks": checks,
              "launches_first_run": launches_1, "launches_resumed_run": launches_2}
    emit(result)
    return result


def phase_nut_pixels_parity(M) -> dict:
    """jax:nut_pixels on the card and on the CPU from the same reset draws,
    the same actions and the same per-step reset draws (64 envs, 40 steps,
    time limit 16 so envs reset): the [64, 64, 4] uint8 pixels equal, bit
    for bit, at every step."""
    from surreal_tpu_torch.envs.device.nut_assembly import RESET_HIGH, RESET_LOW

    B, T = 64, 40
    gen = torch.Generator().manual_seed(7)
    lo, hi = torch.tensor(RESET_LOW), torch.tensor(RESET_HIGH)
    init = lo + torch.rand((B, 5), generator=gen) * (hi - lo)
    resets = lo + torch.rand((T, B, 5), generator=gen) * (hi - lo)
    actions = torch.rand((T, B, 4), generator=gen) * 2.4 - 1.2
    frames = {}
    for dev in ("cuda", "cpu"):
        env = M.make_env(M.Config(name="jax:nut_pixels", time_limit=16).extend(M.BASE_ENV_CONFIG), dev)
        state, obs = env.reset(B, draws=init.to(dev))
        seq = [obs.cpu()]
        for t in range(T):
            state, obs, _, _, _ = env.step(state, actions[t].to(dev), reset_draws=resets[t].to(dev))
            seq.append(obs.cpu())
        frames[dev] = torch.stack(seq)
    differing = int((frames["cuda"] != frames["cpu"]).sum())
    if differing:
        raise AssertionError(f"nut_pixels: {differing} pixels differ between cuda and cpu")
    result = {"phase": "parity", "path": "nut_pixels_render", "num_envs": B, "steps": T, "pixels_equal": True,
              "lit_pixels": int((frames["cpu"] > 0).sum())}
    emit(result)
    return result


def phase_train_nut_pixels(M, counters: dict) -> dict:
    """PPO on jax:nut_pixels at the JAX package's perf_report.py:441-470
    geometry: 512 envs x 32 steps, 2 epochs x 4 minibatches, the default
    NatureCNN on [64, 64, 4] uint8, 'mixed'; GAE once an iteration."""
    cfg = M.Config(
        learner_config=M.Config(algo=M.Config(name="ppo", horizon=NUT_T, epochs=2, num_minibatches=4,
                                              precision="mixed"),
                                model=M.Config(cnn=M.Config(enabled=True))),
        env_config=M.Config(name="jax:nut_pixels", num_envs=NUT_B),
        session_config=timed_session(M.Config),
    ).extend(M.base_config())
    trainer = M.Trainer(cfg)  # the default device: the card
    state, timing = timed_run(trainer, counters)
    result = {"phase": "train", "path": "nut_pixels", "env": "jax:nut_pixels", "num_envs": NUT_B,
              "horizon": NUT_T, "epochs": 2, "num_minibatches": 4, "precision": "mixed", **timing,
              **breakdown(trainer, state)}
    emit(result)
    return result


def session_cli_cheetah(M, gae_counters: dict, env_source: dict) -> dict:
    """``train ppo dm_control:cheetah-run --num-envs 32`` through the CLI
    (horizon 64, overlap on, 'mixed'): 4 iterations with the host evaluator
    every 2 (2 deterministic episodes of the full 1,000 steps) and a
    checkpoint every 2, then a relaunch to 6 that auto-resumes at
    iteration 4; GAE once an iteration in both runs."""
    folder, T = scratch_dir("cli_cheetah"), CHEETAH_T

    def argv(iters):
        return ["train", "ppo", "dm_control:cheetah-run", "--folder", folder, "--num-envs", str(CHEETAH_B),
                "--total-steps", str(iters * CHEETAH_B * T), "--set", f"learner_config.algo.horizon={T}",
                "learner_config.algo.epochs=4", "learner_config.algo.num_minibatches=4",
                "learner_config.algo.precision=mixed", "session_config.metrics.every_n_iters=1",
                "session_config.checkpoint.every_n_iters=2", "session_config.eval.every_n_iters=2",
                "session_config.eval.episodes=2", "session_config.metrics.console=false",
                "session_config.metrics.tensorboard=false"]

    counts = lambda n: {name: (w, k * n) for name, (w, k) in gae_counters.items()}  # noqa: E731
    t0 = time.perf_counter()
    first, launches_1 = count_launches(counts(4), lambda: run_cli(M, argv(4)))
    seconds_first = time.perf_counter() - t0
    final, launches_2 = count_launches(counts(2), lambda: run_cli(M, argv(6)))
    events = session_events(folder, M.iter_jsonl)
    steps = [e["step"] for e in events if e["type"] == "metrics"]
    ckpt = os.path.join(folder, "checkpoints")
    checks = {
        "eval_full_episodes": first.get("eval/length") == 1000.0 and final.get("eval/length") == 1000.0,
        "eval_return_finite": math.isfinite(final.get("eval/return", float("nan"))),
        "resumed_at_4": steps[4] == 5 * CHEETAH_B * T and final["time/env_steps"] == 6 * CHEETAH_B * T,
        "checkpoints": all(os.path.isdir(os.path.join(ckpt, d)) for d in ("4", "6")),
        "finite": all(math.isfinite(v) for k, v in final.items() if k != "episode/return"),
    }
    if not all(checks.values()):
        raise AssertionError(f"train ppo dm_control:cheetah-run checks failed: {checks}, steps {steps}")
    eval_ms = [e["dur_s"] * 1e3 for e in events if e["type"] == "span" and e["name"] == "eval"]
    result = {"phase": "session", "step": "cli_cheetah", "env_source": env_source["dm_control:cheetah-run"],
              "checks": checks, "launches_first_run": launches_1, "launches_resumed_run": launches_2,
              "seconds_first_run": seconds_first, "eval_ms": eval_ms, "eval_return": final["eval/return"],
              "final": final}
    emit(result)
    return result


def phase_host(M, ops_gae, ops_vtrace, RS, RR) -> dict:
    """The host-env paths and config (4); returns each kernel's launches by
    path for the summary line, and the gather check at host DDPG's rows."""
    env_source = phase_env_probe()
    install_fixture_envs(env_source)
    gae = {"gae": (ops_gae.gae_advantages_masked, 1), "rev_scan": (RS.reverse_linear_scan, 0)}
    gae_assoc = {"gae": (ops_gae.gae_advantages_masked, 0), "rev_scan": (RS.reverse_linear_scan, 1)}
    vtrace = {"vtrace": (ops_vtrace.vtrace_fused, 1), "rev_scan": (RS.reverse_linear_scan, 0)}
    parity = phase_parity_host_ppo(M, gae, "xla", env_source)
    parity_assoc = phase_parity_host_ppo(M, gae_assoc, "assoc", env_source)
    cheetah = dict(name="ppo", horizon=CHEETAH_T, epochs=4, num_minibatches=4, precision="mixed")
    runs = {}
    for overlap in (False, True):
        runs[f"host_ppo_cheetah_{'overlap' if overlap else 'alternate'}"] = phase_train_host(
            M, f"host_ppo_cheetah_{'overlap' if overlap else 'alternate'}", cheetah, "dm_control:cheetah-run",
            CHEETAH_B, CHEETAH_T, gae, env_source, overlap, sync_check=not overlap)
    runs["host_impala_cartpole"] = phase_train_host(
        M, "host_impala_cartpole", dict(name="impala", horizon=CARTPOLE_T, precision="mixed"), "gym:CartPole-v1",
        CARTPOLE_B, CARTPOLE_T, vtrace, env_source, True)
    runs["host_ppo_cartpole"] = phase_train_host(
        M, "host_ppo_cartpole", dict(name="ppo", horizon=CARTPOLE_T, epochs=4, num_minibatches=4, precision="mixed"),
        "gym:CartPole-v1", CARTPOLE_B, CARTPOLE_T, gae, env_source, True)
    gather_check = phase_parity_host_ddpg(M, RR, env_source)
    runs["host_ddpg_pendulum"] = phase_host_ddpg(M, RR, env_source)
    session_cli_host_ddpg(M, {"replay_gather": (RR.gather_rows, DDPG_K), "replay_scatter": (RR.scatter_rows, DDPG_K)})
    phase_nut_pixels_parity(M)
    runs["nut_pixels"] = phase_train_nut_pixels(M, gae)
    session_cli_cheetah(M, gae, env_source)
    return {
        "gae": {"host_ppo_cheetah_parity": parity["gae"], **{k: runs[k]["gae_launches"] for k in (
            "host_ppo_cheetah_alternate", "host_ppo_cheetah_overlap", "host_ppo_cartpole", "nut_pixels")}},
        "rev_scan": {"host_ppo_cheetah_assoc_parity": parity_assoc["rev_scan"]},
        "vtrace": {"host_impala_cartpole": runs["host_impala_cartpole"]["vtrace_launches"]},
        "replay_gather": {"host_ddpg_pendulum": runs["host_ddpg_pendulum"]["replay_gather_launches"]},
        "replay_scatter": {"host_ddpg_pendulum": runs["host_ddpg_pendulum"]["replay_scatter_launches"]},
        "replay_gather_check": gather_check,
        "env_source": env_source,
    }


# -- the SEED topology ----------------------------------------------------------



def seed_config(M, algo: dict, env: str, workers: int, num_envs: int, mode: str, fleet: dict | None = None,
                xp: dict | None = None, **learner):
    """A SEED session; ``fleet``: its ``topology.inference_fleet``; ``xp``:
    its ``topology.experience_plane`` (the chunk relay)."""
    topology = M.Config(num_env_workers=workers, worker_mode=mode)
    if fleet is not None:
        topology.inference_fleet = M.Config(fleet)
    if xp is not None:
        topology.experience_plane = M.Config(xp)
    return M.Config(
        learner_config=M.Config(algo=M.Config(algo), **{k: M.Config(v) for k, v in learner.items()}),
        env_config=M.Config(name=env, num_envs=num_envs),
        session_config=timed_session(M.Config, topology=topology),
    ).extend(M.base_config())


def keep_last_chunk(trainer) -> list:
    """The trainer's last staged chunk, as the server assembled it (a
    shallow copy taken before staging pops its host-side columns)."""
    kept = []
    stage = trainer._stage

    def keeping(chunk, tracer):
        kept[:] = [dict(chunk)]
        return stage(chunk, tracer)

    trainer._stage = keeping
    return kept


def seed_sync_check(trainer, state, chunk: dict, width: int) -> dict:
    """Host syncs of the SEED path on the card: the server's act function
    over ``width`` rows, SEED_SYNC_SERVES times (one read of actions and
    info each), staging one chunk, and one learn on it (none)."""
    from surreal_tpu_torch.session.telemetry import Tracer

    act_fn = trainer._make_act_fn(trainer.learner.acting_copy(), state,
                                  torch.Generator(device="cuda").manual_seed(3))
    rows = chunk["obs"].reshape(-1, *chunk["obs"].shape[2:])
    obs = rows[np.arange(width) % len(rows)]
    act_fn(obs)
    sites = {}
    _, serve = count_syncs(lambda: [act_fn(obs) for _ in range(SEED_SYNC_SERVES)], sites)
    (batch, *_), stage = count_syncs(lambda: trainer._stage(dict(chunk), Tracer(None)), sites)
    gen = torch.Generator(device="cuda").manual_seed(4)
    _, learn = count_syncs(lambda: trainer._learn(state, batch, gen), sites)
    # the same learn with the data plane stopped: the run's learn spans
    # against this show what serving beside it costs
    alone = [fenced_ms(lambda: trainer._learn(state, batch, gen))[1] for _ in range(3)]
    out = {"serves": SEED_SYNC_SERVES, "width": width, "serve_syncs": serve, "stage_syncs": stage,
           "learn_syncs": learn, "syncs_per_serve": serve / SEED_SYNC_SERVES, "sites": sites,
           "learn_ms_alone": alone}
    if serve != SEED_SYNC_SERVES or learn != 0:
        emit({"phase": "seed", "sync_check_failed": out})
        raise AssertionError(f"SEED host syncs: {out}; expected one a serve and none in a learn")
    return out


def phase_seed_train(M, path: str, algo: dict, env: str, workers: int, num_envs: int, mode: str,
                     counters: dict, env_source: dict, fleet: dict | None = None, phase: str = "seed",
                     iters: tuple[int, int] = (SEED_WARMUP_ITERS, SEED_TIMED_ITERS), xp: dict | None = None,
                     **learner) -> dict:
    """``SEEDTrainer.run`` on the card (``timed_run``: SEED_WARMUP_ITERS +
    SEED_TIMED_ITERS learns, kernel launches counted, every metric finite),
    then the serve and wire figures of its server, the staleness and
    lineage gauges of its last row and the host syncs of its paths. With
    ``fleet`` (a ``topology.inference_fleet``), the server is the fleet:
    its hop windows are read as it closes, fleet-wide and per replica."""
    from surreal_tpu_torch.distributed.fleet import InferenceFleet

    trainer = M.SEEDTrainer(seed_config(M, algo, env, workers, num_envs, mode, fleet, xp, **learner))
    kept = keep_last_chunk(trainer)
    closing = {}

    def keep_hops(close):
        def closing_fleet(self):
            closing["replicas"] = {str(i): s.hop_stats() for i, s in enumerate(self._replicas)
                                   if s is not None and s.alive}
            closing["fleet"] = self.hop_stats()
            closing["tier"] = self.tier_event()
            close(self)
        return closing_fleet

    with Patched(InferenceFleet, "close", keep_hops):
        state, timing = timed_run(trainer, counters, *iters)
    m = timing["metrics"]
    hops = closing["fleet"] if fleet is not None else trainer._server.hop_stats()
    spans = timing["span_ms"][iters[0]:]
    chunk_wait = [sp.get("chunk-wait", 0.0) for sp in spans]
    timed_iter_ms = timing["iter_ms"][iters[0] - 1:]
    result = {
        "phase": phase, "path": path, "env": env, "env_source": env_source.get(env, "fixture"),
        "workers": workers, "worker_mode": mode, "transport": trainer.worker_transport,
        "pipeline": trainer.pipeline_workers, "envs_per_worker": num_envs,
        "chunk": [trainer.algo.horizon, trainer.chunk_width], "algo": algo, **timing,
        "serve_ms": hops.get("serve_batch_ms"), "worker_to_server_ms": hops.get("worker_to_server_ms"),
        "serve_batch_width": m.get("server/serve_batch"), "wire_bytes_per_step": m.get("server/wire_bytes_per_step"),
        "shm_workers": m.get("server/shm_workers"), "pickle_workers": m.get("server/pickle_workers"),
        "chunk_wait_ms": chunk_wait, "chunk_wait_share": sum(chunk_wait) / max(sum(timed_iter_ms), 1e-9),
        "learn_ms": [sp.get("learn") for sp in spans], "h2d_ms": [sp.get("h2d-transfer") for sp in spans],
        "staleness_updates_behind": m.get("staleness/updates_behind"),
        "lineage": {k: v for k, v in m.items() if k.startswith("lineage/")},
        "evicted_chunks": m.get("server/evicted_chunks"), "queue_depth": m.get("server/queue_depth"),
        "syncs": seed_sync_check(trainer, state, kept[0], max(1, round(m.get("server/serve_batch", 1.0)))),
    }
    if fleet is not None:
        result["fleet"] = {"config": fleet, **{k: v for k, v in m.items() if k.startswith("fleet/")},
                           "replica_hops": closing["replicas"], "tier": closing["tier"]}
    emit(result)
    return result


def numpy_policy(specs):
    """A numpy policy for collecting a fixed chunk: actions and the
    behaviour info (the learner head's keys) from each row's obs."""
    discrete = specs.discrete

    def act_fn(obs):
        b = obs.shape[0]
        s = np.tanh(obs.reshape(b, -1).astype(np.float32).mean(axis=1))
        if discrete:
            n = specs.action.n
            logits = np.stack([s * (k - n / 2) for k in range(n)], axis=1).astype(np.float32)
            action = np.argmax(logits, axis=1).astype(np.int32)
            logp = logits[np.arange(b), action] - np.log(np.exp(logits).sum(axis=1))
            return action, {"logp": logp.astype(np.float32), "logits": logits}
        dim = specs.action.shape[0]
        mean = np.tile(0.5 * s[:, None], (1, dim)).astype(np.float32)
        log_std = np.full((b, dim), -0.5, np.float32)
        action = (mean + 0.3 * np.sin(np.arange(dim) + 5.0 * s[:, None])).astype(np.float32)
        z = (action - mean) / np.exp(log_std)
        logp = (-0.5 * z ** 2 - log_std - 0.5 * np.log(2 * np.pi)).sum(axis=1)
        return action, {"logp": logp.astype(np.float32), "mean": mean, "log_std": log_std}

    return act_fn


def fixed_chunk(M, env: str, num_envs: int, horizon: int) -> dict:
    """One chunk assembled by the port's server from one pipelined worker
    thread under ``numpy_policy``."""
    import threading

    import surreal_tpu_torch.distributed.env_worker as env_worker
    from surreal_tpu_torch.distributed import InferenceServer

    env_cfg = M.Config(name=env, num_envs=num_envs).extend(M.BASE_ENV_CONFIG)
    probe = env_worker.make_env(env_cfg)  # the workers' make_env: the fixture where one stands in
    server = InferenceServer(act_fn=numpy_policy(probe.specs), unroll_length=horizon)
    probe.close()
    stop = threading.Event()
    worker = threading.Thread(target=env_worker.run_env_worker, args=(env_cfg, server.address, 0),
                              kwargs=dict(stop_event=stop, pipeline=True), daemon=True)
    worker.start()
    try:
        chunk = server.chunks.get(timeout=60)
    finally:
        stop.set()
        server.close()
        worker.join(timeout=10)
    chunk.pop("_t_ready")
    return chunk


def phase_seed_parity(M, counters: dict, env_source: dict) -> dict:
    """One SEED learn on the same fixed chunk on the card and on the CPU
    (f32, TF32 off), from the same weights: IMPALA on a CartPole chunk
    [32, 8], and PPO on a cheetah-run chunk [64, 4] (4 x 4, the same epoch
    permutations) at gae_impl 'xla' and 'assoc'; on the card each learn
    launches the kernels of ``counters[case]`` as often as it says. Bars of
    the memoryless parity phases: metrics 1e-4 + 1e-3 relative, the update
    ratio 5e-2; params SEED_PARAM_ATOL, the learn-level bar."""
    from surreal_tpu_torch.learners.ppo import _block_layout
    from surreal_tpu_torch.session.telemetry import Tracer

    out, chunks = {}, {}
    ppo = dict(name="ppo", horizon=64, epochs=4, num_minibatches=4, precision="f32")
    cases = [("impala", dict(name="impala", horizon=32, precision="f32"), "gym:CartPole-v1", 16),
             ("ppo", ppo, "dm_control:cheetah-run", 8),
             ("ppo_assoc", dict(ppo, gae_impl="assoc"), "dm_control:cheetah-run", 8)]
    for name, algo, env, num_envs in cases:
        if env not in chunks:
            chunks[env] = fixed_chunk(M, env, num_envs, algo["horizon"])
        chunk = chunks[env]
        T, B = chunk["reward"].shape
        draws = {}
        if algo["name"] == "ppo":
            gen = torch.Generator().manual_seed(11)
            bpm = _block_layout(T * B, 4, chunk["obs"].shape[-1] * 4)
            domain = 4 * bpm if bpm else T * B
            draws["perms"] = torch.stack([torch.randperm(domain, generator=gen) for _ in range(4)])
        res, launches = {}, {}
        for dev in ("cuda", "cpu"):
            tr = M.SEEDTrainer(seed_config(M, algo, env, 1, num_envs, "thread"), device=dev)
            state = tr.learner.init(torch.Generator().manual_seed(0))
            batch = tr._stage(dict(chunk), Tracer(None))[0]
            learn = lambda: tr._learn(state, batch, None, **{k: v.to(dev) for k, v in draws.items()})  # noqa: E731
            if dev == "cuda":
                (new, metrics), launches = count_launches(counters[name], learn)
            else:
                new, metrics = learn()
            res[dev] = ({k: v.float().cpu() for k, v in new.params.items()}, {k: float(v) for k, v in metrics.items()})
        errs, refs = {}, {}
        for k, want in res["cpu"][1].items():
            got = res["cuda"][1][k]
            rtol = 5e-2 if k == "health/update_ratio" else 1e-3
            if not ((math.isnan(want) and math.isnan(got)) or abs(got - want) <= 1e-4 + rtol * abs(want)):
                raise AssertionError(f"seed {name} parity metric {k}: cuda {got} vs cpu {want}")
            errs[k], refs[k] = abs(got - want), want
        param_err = max(float((res["cuda"][0][k] - v).abs().max()) for k, v in res["cpu"][0].items())
        out[name] = {"env": env, "env_source": env_source.get(env, "fixture"), "chunk": [T, B],
                     "gae_impl": algo.get("gae_impl", "xla") if algo["name"] == "ppo" else None, "launches": launches, "metric_abs_err": errs,
                     "metric_cpu": refs, "param_max_abs_err": param_err, "param_atol": SEED_PARAM_ATOL}
        if not param_err <= SEED_PARAM_ATOL:
            emit({"phase": "parity", "path": "seed_learn", "failed": name, **out[name]})
            raise AssertionError(f"seed {name} parity params: max abs err {param_err} > {SEED_PARAM_ATOL}")
    emit({"phase": "parity", "path": "seed_learn", "tf32": False, **out})
    return out


def phase_seed_respawn(M, vtrace, env_source: dict) -> dict:
    """SEED IMPALA on CartPole with 2 worker processes x 8 envs on shm:
    worker 0 is terminated after the 4th learn; it is respawned, the run
    completes its 24 learns, and after ``close`` no slab of this process is
    left in /dev/shm."""
    import glob

    from surreal_tpu_torch.distributed.shm_transport import SLAB_PREFIX

    iters = 24
    trainer = M.SEEDTrainer(seed_config(M, dict(name="impala", horizon=32, precision="mixed"),
                                        "gym:CartPole-v1", 2, 8, "process"))
    killed = []

    def on_metrics(iteration, metrics):
        if iteration >= 4 and not killed:
            deadline = time.monotonic() + 60  # both workers on their slabs first
            while trainer._server.transport_stats()["shm_workers"] < 2 and time.monotonic() < deadline:
                time.sleep(0.05)
            w = trainer._workers[0]
            killed.append(w.pid)
            w.terminate()
            w.join(timeout=10)

    (_, final), launches = count_launches(
        {"vtrace": (vtrace, iters)},
        lambda: trainer.run(max_env_steps=iters * trainer.steps_per_iter, on_metrics=on_metrics))
    residue = glob.glob(f"/dev/shm/{SLAB_PREFIX}*_{os.getpid()}_*")
    checks = {
        "killed": bool(killed), "respawned": final["workers/respawns"] >= 1.0,
        "new_pid": bool(killed) and trainer._workers[0].pid != killed[0],
        "completed": final["time/env_steps"] == iters * trainer.steps_per_iter,
        "shm_workers": final["server/shm_workers"] == 2.0, "no_shm_residue": not residue,
        "workers_stopped": not any(w.is_alive() for w in trainer._workers),
    }
    result = {"phase": "seed", "path": "seed_respawn", "env_source": env_source.get("gym:CartPole-v1", "fixture"),
              "checks": checks, "respawns": final["workers/respawns"], "launches": launches, "residue": residue}
    emit(result)
    if not all(checks.values()):
        raise AssertionError(f"SEED respawn checks failed: {checks}")
    return result


def seed_cli(M, vtrace, env_source: dict) -> dict:
    """``train impala gym:CartPole-v1 --workers 2`` through the CLI (64
    envs, so pipelined chunks [64, 32]) for 3 iterations: V-trace once a
    learn, finite losses."""
    folder, T, width = scratch_dir("cli_seed"), 64, 32
    argv = ["train", "impala", "gym:CartPole-v1", "--folder", folder, "--workers", "2",
            "--total-steps", str(3 * T * width), "--set", "session_config.metrics.every_n_iters=1",
            "session_config.metrics.console=false", "session_config.metrics.tensorboard=false"]
    final, launches = count_launches({"vtrace": (vtrace, 3)}, lambda: run_cli(M, argv))
    checks = {"steps": final["time/env_steps"] == 3 * T * width,
              "finite": all(math.isfinite(final[k]) for k in ("loss/pg", "loss/value", "health/grad_norm"))}
    result = {"phase": "session", "step": "cli_seed", "env_source": env_source.get("gym:CartPole-v1", "fixture"),
              "checks": checks, "launches": launches, "final": final}
    emit(result)
    if not all(checks.values()):
        raise AssertionError(f"train impala --workers 2 checks failed: {checks}")
    return result


def phase_seed(M, ops_gae, ops_vtrace, RS, env_source: dict) -> dict:
    """The SEED topology (BASELINE config 5): PPO on cheetah-run over 4
    worker processes on shm, IMPALA on CartPole over 2 thread workers on
    the pickle wire, IMPALA with the NatureCNN over 4 worker processes x 64
    pixel envs on shm; the card-versus-CPU learn on a fixed chunk; a
    terminated worker respawned; the CLI. Returns each kernel's launches
    by path."""
    gae = {"gae": (ops_gae.gae_advantages_masked, 1), "rev_scan": (RS.reverse_linear_scan, 0)}
    gae_assoc = {"gae": (ops_gae.gae_advantages_masked, 0), "rev_scan": (RS.reverse_linear_scan, 1)}
    vtrace = {"vtrace": (ops_vtrace.vtrace_fused, 1), "rev_scan": (RS.reverse_linear_scan, 0)}
    parity = phase_seed_parity(M, {"impala": vtrace, "ppo": gae, "ppo_assoc": gae_assoc}, env_source)
    ppo = phase_seed_train(M, "seed_ppo_cheetah", dict(name="ppo", horizon=CHEETAH_T, epochs=4, num_minibatches=4,
                                                       precision="mixed"),
                           "dm_control:cheetah-run", SEED_PPO_WORKERS, SEED_PPO_ENVS, "process", gae, env_source)
    cartpole = phase_seed_train(M, "seed_impala_cartpole", dict(name="impala", horizon=CARTPOLE_T, precision="mixed"),
                                "gym:CartPole-v1", SEED_CARTPOLE_WORKERS, SEED_CARTPOLE_ENVS, "thread", vtrace,
                                env_source)
    pixels = phase_seed_train(M, "seed_impala_pixels256", dict(name="impala", horizon=SEED_PIXEL_T,
                                                               precision="mixed"),
                              PONG_HOST_ENV, SEED_PIXEL_WORKERS, SEED_PIXEL_ENVS, "process", vtrace, env_source,
                              model=dict(cnn=dict(enabled=True)))
    respawn = phase_seed_respawn(M, ops_vtrace.vtrace_fused, env_source)
    cli = seed_cli(M, ops_vtrace.vtrace_fused, env_source)
    return {
        "gae": {"seed_learn_parity": parity["ppo"]["launches"]["gae"], "seed_ppo_cheetah": ppo["gae_launches"]},
        "vtrace": {"seed_learn_parity": parity["impala"]["launches"]["vtrace"],
                   "seed_impala_cartpole": cartpole["vtrace_launches"],
                   "seed_impala_pixels256": pixels["vtrace_launches"], "seed_respawn": respawn["launches"]["vtrace"],
                   "seed_cli": cli["launches"]["vtrace"]},
        "rev_scan": {"seed_learn_parity_assoc": parity["ppo_assoc"]["launches"]["rev_scan"]},
    }


# -- profiling and cost accounting -------------------------------------------

# run A: iterations 1-8 with the session.profiler window at iteration 3 for
# 2 (it captures iterations 4 and 5); run B: iterations 9-14 in the same
# folder, resumed, profiled through the `profile` subcommand
PROFILE_ITERS, PROFILE_START, PROFILE_WINDOW, PROFILE_RESUMED_ITERS = 8, 3, 2, 6  # B cut from 10
PROFILE_GAUGE_ITERS = (6, 7, 8)  # run A's iterations after the window, timed against the gauges
COUNT_B, COUNT_T = 256, 32       # the geometry of the card-versus-CPU counts
TOP_KERNELS = 8


# the cost counter off: a run's first iteration is then not counted under
# the OpCounter (about 14 s at the north-star geometry), for the sessions
# that time only later iterations; phases train, session, profile and
# precision's first turns keep it on, as by default
PERF_OFF = "session_config.perf.enabled=false"


def north_star_argv(folder: str, iters: int, *sets: str) -> list[str]:
    """``train ppo jax:lift`` at the north-star geometry, metrics every
    iteration, no periodic checkpoint or eval (the run-end checkpoint is
    saved, so a second session resumes)."""
    return ["train", "ppo", "jax:lift", "--folder", folder, "--num-envs", str(MAIN_B),
            "--total-steps", str(iters * MAIN_B * MAIN_T), "--set",
            f"learner_config.algo.horizon={MAIN_T}", "learner_config.algo.epochs=4",
            "learner_config.algo.num_minibatches=4", "learner_config.algo.precision=mixed",
            "session_config.metrics.every_n_iters=1", "session_config.checkpoint.every_n_iters=1000",
            "session_config.eval.every_n_iters=0", "session_config.metrics.console=false",
            "session_config.metrics.tensorboard=false", *sets]


def capture_summary(trace_path: str, kernel_name: str) -> dict:
    """One Chrome trace of ``session/profile.py``: the capture's wall time
    (first event to last), the device busy share (the union of the CUDA
    kernel intervals over that time), the launches of ``kernel_name`` and
    the kernels with the most time."""
    with open(trace_path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X" and "dur" in e]
    t0 = min(e["ts"] for e in events)
    t1 = max(e["ts"] + e["dur"] for e in events)
    kernels = sorted((e for e in events if e.get("cat") == "kernel"), key=lambda e: e["ts"])
    busy, end = 0.0, t0
    for e in kernels:
        a, b = max(e["ts"], end), e["ts"] + e["dur"]
        if b > a:
            busy += b - a
            end = b
    by_name: dict[str, list] = {}
    for e in kernels:
        s = by_name.setdefault(e["name"], [0, 0.0])
        s[0] += 1
        s[1] += e["dur"]
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:TOP_KERNELS]
    return {
        "wall_ms": (t1 - t0) / 1e3, "kernel_busy_ms": busy / 1e3, "busy_share": busy / (t1 - t0),
        "kernel_launches": len(kernels),
        "memcpy_memset_ms": sum(e["dur"] for e in events if e.get("cat") in ("gpu_memcpy", "gpu_memset")) / 1e3,
        f"{kernel_name}_launches": sum(n for name, (n, _) in by_name.items() if kernel_name in name),
        "top_kernels": [{"name": name[:100], "launches": n, "ms": us / 1e3} for name, (n, us) in top],
    }


def stamped_cli(M, argv: list[str], stamps: dict) -> dict:
    """``run_cli`` with the host clock read after each metrics boundary
    (every iteration here): each boundary ends in the metrics read, a
    fence, so the gaps are fenced iteration times."""
    def stamp_end(orig):
        def end_iteration(self, iteration, *a, **kw):
            out = orig(self, iteration, *a, **kw)
            if out[0] is not None:
                stamps[iteration] = time.perf_counter()
            return out
        return end_iteration

    with Patched(M.SessionHooks, "end_iteration", stamp_end):
        return run_cli(M, argv)


def profile_sessions(M, gae) -> dict:
    """(a)-(d): run A with the profiler window, run B resumed in the same
    folder with ``profile <folder>`` written from another process while it
    runs; each capture summarised; ``diag`` of the folder; the perf gauges
    against fenced iteration times."""
    folder = scratch_dir("profile")
    stamps: dict[int, float] = {}
    argv_a = north_star_argv(folder, PROFILE_ITERS, "session_config.profiler.enabled=true",
                             f"session_config.profiler.start_iter={PROFILE_START}",
                             f"session_config.profiler.num_iters={PROFILE_WINDOW}")
    started = {"a": time.perf_counter()}
    _, launches_a = count_launches({"gae": (gae, PROFILE_ITERS)}, lambda: stamped_cli(M, argv_a, stamps))
    total = PROFILE_ITERS + PROFILE_RESUMED_ITERS
    argv_b = north_star_argv(folder, total)
    # the user's other shell: the profile subcommand, started with run B
    cli = subprocess.Popen(
        [sys.executable, "-m", "surreal_tpu_torch", "profile", folder, "--iters", str(PROFILE_WINDOW)],
        cwd=os.path.dirname(os.path.abspath(__file__)), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    started["b"] = time.perf_counter()
    try:
        _, launches_b = count_launches({"gae": (gae, PROFILE_RESUMED_ITERS)}, lambda: stamped_cli(M, argv_b, stamps))
    finally:
        cli_out, cli_err = cli.communicate(timeout=120)
    if cli.returncode != 0 or "profile trigger written" not in cli_out:
        raise AssertionError(f"profile subcommand rc {cli.returncode}: {cli_out} {cli_err}")

    events = session_events(folder, M.iter_jsonl)
    profiles = [e for e in events if e["type"] == "profile"]
    if any("error" in p for p in profiles):
        raise AssertionError(f"a profile capture failed: {profiles}")
    reasons = [p["reason"] for p in profiles]
    if reasons != ["profiler_knob", "trigger_file"]:
        raise AssertionError(f"profile captures {reasons}, expected the window and the trigger file's")
    unprofiled = [(stamps[i] - stamps[i - 1]) * 1e3 for i in PROFILE_GAUGE_ITERS]
    captures = []
    for p in profiles:
        learns = p["end_iter"] - p["start_iter"]
        summary = capture_summary(os.path.join(p["dir"], "trace.json"), "gae_masked_kernel")
        if summary["gae_masked_kernel_launches"] != learns:
            raise AssertionError(f"capture {p['reason']}: {summary['gae_masked_kernel_launches']} GAE launches in "
                                 f"{learns} learns")
        # the last boundary's gap also holds stopping the profiler and
        # writing the trace
        inside = [(stamps[i] - stamps[i - 1]) * 1e3 for i in range(p["start_iter"] + 1, p["end_iter"] + 1)]
        per_iter = summary["wall_ms"] / learns
        captures.append({
            "reason": p["reason"], "start_iter": p["start_iter"], "end_iter": p["end_iter"], "learns": learns,
            "profiled_iteration_ms": inside, "window_ms_per_iteration": per_iter,
            "slowdown_in_window": per_iter / statistics.median(unprofiled),
            "kernel_ms_per_iteration": summary["kernel_busy_ms"] / learns,
            # the kernels' time is the card's, which the profiler's host
            # records do not lengthen: over the unprofiled iterations
            "busy_share_unprofiled": summary["kernel_busy_ms"] / learns / statistics.median(unprofiled),
            "trace_mb": os.path.getsize(os.path.join(p["dir"], "trace.json")) / 1e6, **summary,
        })

    # (c) diag of the folder: the program costs and both captures
    out = io.StringIO()
    with redirect_stdout(out):
        rc = M.launch.main(["diag", folder])
    report = out.getvalue()
    perf = report[report.index("Performance"):] if "Performance" in report else ""
    if rc != 0 or "train_iter" not in perf or not all(p["dir"] in perf for p in profiles):
        raise AssertionError(f"diag rc {rc}; its Performance section lacks the program or a capture:\n{report}")

    # (d) the gauges against fenced iteration times, run A after the window
    (cost_a, *_) = [e for e in events if e["type"] == "program_cost" and e["name"] == "train_iter"]
    rows = {e["step"] // (MAIN_B * MAIN_T): e["values"] for e in events if e["type"] == "metrics"}
    fenced_s = [stamps[i] - stamps[i - 1] for i in PROFILE_GAUGE_ITERS]
    gauge_s = [cost_a["flops"] / rows[i]["perf/flops_per_s"] for i in PROFILE_GAUGE_ITERS]
    measured = cost_a["flops"] * len(fenced_s) / sum(fenced_s)
    gauged = cost_a["flops"] * len(gauge_s) / sum(gauge_s)
    mfu = [rows[i]["perf/mfu"] for i in sorted(rows)]
    result = {
        "phase": "profile", "step": "north_star", "folder_iterations": total, "gae_launches": launches_a["gae"] +
        launches_b["gae"], "captures": captures, "profile_cli": cli_out.strip().splitlines()[0],
        "program_cost": {k: cost_a[k] for k in ("flops", "bytes_accessed", "transcendentals", "arithmetic_intensity",
                                                 "kernels", "device_kind", "peak_flops", "peak_membw")},
        "perf_flops_per_s": gauged, "fenced_flops_per_s": measured, "gauge_over_fenced": gauged / measured,
        "perf_mfu": mfu, "perf_membw_util": [rows[i]["perf/membw_util"] for i in sorted(rows)],
        "iteration_ms_unprofiled": unprofiled,
        # from the CLI call to the first boundary: building the session and
        # the counted first iteration
        "first_iteration_ms": [(stamps[1] - started["a"]) * 1e3,
                               (stamps[PROFILE_ITERS + 1] - started["b"]) * 1e3],
        "diag_rc": rc,
    }
    emit(result)
    if not all(0.0 < m <= 1.05 for m in mfu):
        raise AssertionError(f"perf/mfu out of (0, 1.05]: {mfu}")
    if abs(gauged / measured - 1.0) > 0.10:
        raise AssertionError(f"perf/flops_per_s {gauged:.4g} vs fenced {measured:.4g}: more than 10% apart")
    return result


def counted_costs(M, config, device: str, iters: int) -> dict:
    """The ``program_cost`` record of a short session of ``config`` on
    ``device``."""
    trainer = (M.OffPolicyTrainer if config.learner_config.algo.name == "ddpg" else M.Trainer)(config, device=device)
    trainer.run(max_env_steps=iters * trainer.steps_per_iter)
    (rec,) = [e for e in session_events(config.session_config.folder, M.iter_jsonl)
              if e["type"] == "program_cost" and e["name"] == "train_iter"]
    return rec


def profile_counts(M) -> dict:
    """(e): the card's program costs equal the CPU's for one config, at
    256 x 32: PPO at 'xla' and 'assoc', IMPALA (NatureCNN on jax:pong),
    prioritized DDPG (its second iteration, the first to update)."""
    def ppo(gae_impl):
        return lambda: M.Config(
            learner_config=M.Config(algo=M.Config(name="ppo", horizon=COUNT_T, epochs=4, num_minibatches=4,
                                                  precision="mixed", gae_impl=gae_impl)),
            env_config=M.Config(name="jax:lift", num_envs=COUNT_B),
            session_config=timed_session(M.Config),
        ).extend(M.base_config())

    configs = {
        "ppo_xla": (ppo("xla"), 1),
        "ppo_assoc": (ppo("assoc"), 1),
        "impala": (lambda: pong_config(M.Config, M.base_config, COUNT_B, COUNT_T, "mixed", {}), 1),
        "ddpg_prioritized": (lambda: ddpg_config(M.Config, M.base_config, COUNT_B, COUNT_T, DDPG_K, DDPG_BS,
                                                 DDPG_CAPACITY, "prioritized", "mixed"), 2),
    }
    keys = ("flops", "bytes_accessed", "transcendentals", "kernels")
    out = {}
    for name, (make, iters) in configs.items():
        card, cpu = counted_costs(M, make(), "cuda", iters), counted_costs(M, make(), "cpu", iters)
        out[name] = {"card": {k: card[k] for k in keys}, "cpu_equal": {k: card[k] == cpu[k] for k in keys},
                     "ops": [card["ops"], cpu["ops"]]}
        if not all(out[name]["cpu_equal"].values()):
            raise AssertionError(f"{name}: card and CPU counts differ: card {card} cpu {cpu}")
    emit({"phase": "profile", "step": "counts_card_vs_cpu", "shape": [COUNT_T, COUNT_B], "programs": out})
    return out


def profile_trace(M, env_source: dict) -> dict:
    """(f): ``train impala gym:CartPole-v1 --workers 2`` with every worker
    step head-sampled, then ``trace <folder>``: span trees, none torn."""
    folder = scratch_dir("trace")
    T, width = 64, 32  # seed_cli's chunks: 64 envs over 2 pipelined workers, the impala horizon
    argv = ["train", "impala", "gym:CartPole-v1", "--folder", folder, "--workers", "2",
            "--total-steps", str(2 * T * width), "--set", "session_config.telemetry.trace.sample_n=1",
            "session_config.metrics.every_n_iters=1", "session_config.metrics.console=false",
            "session_config.metrics.tensorboard=false"]
    run_cli(M, argv)
    out = io.StringIO()
    with redirect_stdout(out):
        rc = M.launch.main(["trace", folder])
    report = out.getvalue()
    trees = sum(1 for line in report.splitlines() if line.startswith("exemplar "))
    events = session_events(folder, M.iter_jsonl)
    programs = sorted(e["name"] for e in events if e["type"] == "program_cost")
    result = {"phase": "profile", "step": "trace", "env_source": env_source.get("gym:CartPole-v1", "fixture"),
              "trace_rc": rc, "exemplar_trees": trees, "missing_parents": report.count("MISSING"),
              "programs": programs, "first_tree": report.split("\n\n")[1].splitlines()[:6] if trees else []}
    emit(result)
    if rc != 0 or trees < 1 or "MISSING" in report or programs != ["act", "learn"]:
        raise AssertionError(f"trace checks failed: rc {rc}, {trees} trees, programs {programs}:\n{report[:2000]}")
    return result


def phase_profile(M, gae, env_source: dict) -> dict:
    """Profiling and cost accounting: (a)-(d) on the north-star sessions,
    (e) the counts on the card against the CPU, (f) a SEED trace. The
    session phase's set_sync_debug_mode("error") iteration ran with perf
    and the profile trigger on, their defaults (g)."""
    sessions = profile_sessions(M, gae)
    counts = profile_counts(M)
    trace = profile_trace(M, env_source)
    return {"gae_launches": sessions["gae_launches"], "sessions": sessions, "counts": counts, "trace": trace}


# -- precision: the 'bf16' and 'bf16_fp8' policies -----------------------------

PRECISION_POLICIES = ("mixed", "bf16", "bf16_fp8")
PRECISION_WARMUP_ITERS, PRECISION_TIMED_ITERS = 1, 2  # cut from 2, 4 for the time limit
# the reference's own 'mixed'-vs-'bf16' rule (tests/test_precision.py:289-294)
PRECISION_PARAM_ATOL = 1e-5
LS_INIT, LS_MIN = 2.0**15, 1.0  # the loss-scale schedule's defaults


def north_star_policy_config(M, precision: str):
    cfg = north_star_config(M, scratch_dir("precision"))
    cfg.learner_config.algo.precision = precision
    return cfg


def program_ops(folder: str, iter_jsonl, name: str = "train_iter"):
    """The aten ops the cost counter counted in one call of a session's
    program (its ``program_cost`` event), or None."""
    for e in session_events(folder, iter_jsonl):
        if e.get("type") == "program_cost" and e.get("name") == name:
            return e.get("ops")
    return None


def precision_parity(M, gae) -> dict:
    """(a) One north-star iteration at 'mixed' and one at 'bf16' on the card
    from the same state, reset draws, action noise and epoch permutations:
    parameters within PRECISION_PARAM_ATOL, the loss scale at its initial
    value with no overflow, one GAE launch each."""
    from surreal_tpu_torch.envs.device.lift import RESET_HIGH, RESET_LOW
    from surreal_tpu_torch.learners.ppo import _block_layout

    gen = torch.Generator().manual_seed(3)
    lo, hi = torch.tensor(RESET_LOW), torch.tensor(RESET_HIGH)
    draws_init = (lo + torch.rand((MAIN_B, 5), generator=gen) * (hi - lo)).cuda()
    draws = (lo + torch.rand((MAIN_T, MAIN_B, 5), generator=gen) * (hi - lo)).cuda()
    noise = torch.randn((MAIN_T, MAIN_B, 4), generator=gen).cuda()
    domain = 4 * _block_layout(MAIN_T * MAIN_B, 4, 17 * 4)
    perms = torch.stack([torch.randperm(domain, generator=gen) for _ in range(4)]).cuda()
    out = {}
    for precision in ("mixed", "bf16"):
        tr = M.Trainer(north_star_policy_config(M, precision))
        state = tr.learner.init(torch.Generator().manual_seed(0))
        carry = tr.init_loop_state(reset_draws=draws_init)
        (new, _, metrics), launches = count_launches({"gae": (gae, 1)}, lambda: tr._device_train_iter(
            state, carry, action_noise=noise, reset_draws=draws, perms=perms))
        out[precision] = (new.params, {k: float(v) for k, v in metrics.items()}, launches["gae"])
    (pm, mm, _), (p16, m16, _) = out["mixed"], out["bf16"]
    err = max(float((p16[k] - v).abs().max()) for k, v in pm.items())
    checks = {
        "params_within_1e-5": err <= PRECISION_PARAM_ATOL,
        "loss_scale": m16["precision/loss_scale"] == LS_INIT,
        "no_overflow": m16["precision/overflows"] == 0.0,
        "gae_once_a_learn": out["mixed"][2] == out["bf16"][2] == 1,
        "mixed_has_no_scale": "precision/loss_scale" not in mm,
    }
    if not all(checks.values()):
        raise AssertionError(f"precision parity checks failed: {checks}, params max abs err {err}")
    result = {"phase": "precision", "step": "bf16_vs_mixed", "num_envs": MAIN_B, "horizon": MAIN_T,
              "checks": checks, "params_max_abs_err": err, "tolerance": PRECISION_PARAM_ATOL,
              "metric_abs_err": {k: abs(m16[k] - v) for k, v in mm.items()}}
    emit(result)
    return result


def profiled_learn(trainer, state, kernel_name: str) -> dict:
    """One learn on a fresh rollout's batch under ``torch.profiler``, after
    the counted run (not counted): its CUDA kernel launches, the device's
    busy time (the union of the kernel intervals) and the kernels with the
    most time, from the Chrome trace (``capture_summary``)."""
    from surreal_tpu_torch.launch.rollout import device_rollout

    generator = torch.Generator(device="cuda").manual_seed(1)
    carry = trainer.init_loop_state(generator)
    _, batch = device_rollout(trainer.env, trainer.learner, state, carry, trainer.horizon, generator)
    batch = {k: batch[k] for k in LEARN_KEYS}
    path = os.path.join(scratch_dir("learn_trace"), "trace.json")
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        trainer.learner.learn(state, batch, generator)
        torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    summary = capture_summary(path, kernel_name)
    return {k: summary[k] for k in ("wall_ms", "kernel_busy_ms", "kernel_launches", f"{kernel_name}_launches")} | {
        "top_kernels": summary["top_kernels"][:3]}


def precision_timed(M, gae) -> dict:
    """North-star at each policy through ``Trainer.run`` (1 warm-up, 2 timed
    iterations, one GAE launch each), one turn a policy ('mixed', 'bf16',
    'bf16_fp8'; the turns back were cut for the script's time limit), with
    the aten ops the cost counter counted in its first iteration and,
    after the run, the rollout and the learn each fenced once and one
    learn profiled."""
    rows = {p: {"iter_ms_medians": [], "iter_ms": [], "gae_launches": 0} for p in PRECISION_POLICIES}
    for precision in PRECISION_POLICIES:
        cfg = north_star_policy_config(M, precision)
        trainer = M.Trainer(cfg)
        state, timing = timed_run(trainer, {"gae": (gae, 1)}, PRECISION_WARMUP_ITERS, PRECISION_TIMED_ITERS)
        last, row = timing["metrics"], rows[precision]
        row.update(breakdown(trainer, state, reps=1))
        row["profiled_learn"] = profiled_learn(trainer, state, "gae")
        row["counted_ops_per_iter"] = program_ops(cfg.session_config.folder, M.iter_jsonl)
        row["iter_ms_medians"].append(timing["iter_ms_median"])
        row["iter_ms"].append(timing["iter_ms"])
        row["gae_launches"] += timing["gae_launches"]
        row["peak_mem_gb"] = timing["peak_mem_gb"]
        row["loss_scale"], row["overflows"] = last.get("precision/loss_scale"), last.get("precision/overflows")
        if precision != "mixed" and row["loss_scale"] != LS_INIT:
            raise AssertionError(f"{precision}: loss scale {row['loss_scale']} after the run")
    for row in rows.values():
        row["iter_ms_median"] = statistics.mean(row["iter_ms_medians"])
        row["env_steps_per_s"] = MAIN_B * MAIN_T / (row["iter_ms_median"] / 1e3)
    base = rows["mixed"]
    result = {"phase": "precision", "step": "north_star_timed", "num_envs": MAIN_B, "horizon": MAIN_T,
              "warmup_iters": PRECISION_WARMUP_ITERS, "timed_iters": PRECISION_TIMED_ITERS, "policies": rows,
              "iter_ms_vs_mixed": {k: v["iter_ms_median"] / base["iter_ms_median"] for k, v in rows.items()},
              "ops_vs_mixed": {k: v["counted_ops_per_iter"] / base["counted_ops_per_iter"] for k, v in rows.items()
                               if v["counted_ops_per_iter"] and base["counted_ops_per_iter"]},
              "learn_launches_vs_mixed": {k: v["profiled_learn"]["kernel_launches"]
                                          / base["profiled_learn"]["kernel_launches"] for k, v in rows.items()}}
    emit(result)
    return result


def precision_pong(M, vtrace) -> dict:
    """(b) IMPALA at the pong geometry at each policy in turns ('mixed',
    'bf16', 'bf16_fp8'; 2 warm-up, 4 timed iterations each): V-trace once
    a learn, every metric finite (timed_run), the loss scale in the rows
    of the loss-scaled policies, and one learn profiled."""
    rows = {}
    for precision in PRECISION_POLICIES:
        trainer = M.Trainer(pong_config(M.Config, M.base_config, PONG_B, PONG_T, precision, {}))
        state, timing = timed_run(trainer, {"vtrace": (vtrace, 1)}, PRECISION_WARMUP_ITERS, PRECISION_TIMED_ITERS)
        scale = timing["metrics"].get("precision/loss_scale")
        if scale != (None if precision == "mixed" else LS_INIT):
            raise AssertionError(f"pong {precision}: loss scale {scale}")
        rows[precision] = {**{k: timing[k] for k in ("iter_ms_median", "iter_ms", "env_steps_per_s",
                                                     "vtrace_launches", "peak_mem_gb")},
                           "loss_scale": scale, "overflows": timing["metrics"].get("precision/overflows"),
                           "profiled_learn": profiled_learn(trainer, state, "vtrace")}
    base = rows["mixed"]
    result = {"phase": "precision", "step": "pong_timed", "num_envs": PONG_B, "horizon": PONG_T, "policies": rows,
              "vtrace_launches": sum(r["vtrace_launches"] for r in rows.values()),
              "iter_ms_vs_mixed": {k: v["iter_ms_median"] / base["iter_ms_median"] for k, v in rows.items()},
              "learn_launches_vs_mixed": {k: v["profiled_learn"]["kernel_launches"]
                                          / base["profiled_learn"]["kernel_launches"] for k, v in rows.items()}}
    emit(result)
    return result


def precision_ddpg(M, RR) -> dict:
    """(c) DDPG with prioritized replay at the headline geometry under
    'bf16': obs and next_obs stored in bf16 (half of 'mixed''s bytes,
    reward and discount still float32), gather and scatter 64 launches an
    iteration, and the gather kernel bit-exact at the bf16 rows."""
    def obs_bytes(trainer):
        ex = trainer._replay_example()
        return {k: DDPG_CAPACITY * x.numel() * x.element_size() for k, x in ex.items()}

    mixed = M.OffPolicyTrainer(ddpg_config(M.Config, M.base_config, DDPG_B, DDPG_H, DDPG_K, DDPG_BS, DDPG_CAPACITY,
                                           "prioritized", "mixed"))
    trainer = M.OffPolicyTrainer(ddpg_config(M.Config, M.base_config, DDPG_B, DDPG_H, DDPG_K, DDPG_BS,
                                             DDPG_CAPACITY, "prioritized", "bf16"))
    b16, b32 = obs_bytes(trainer), obs_bytes(mixed)
    storage = trainer.replay.init(trainer._replay_example()).ring.storage
    checks = {
        "obs_half": b16["obs"] + b16["next_obs"] == (b32["obs"] + b32["next_obs"]) // 2,
        "obs_bf16": storage["obs"].dtype == storage["next_obs"].dtype == torch.bfloat16,
        "reward_f32": storage["reward"].dtype == storage["discount"].dtype == torch.float32,
    }
    del storage
    _, timing = timed_run(trainer, {"replay_gather": (RR.gather_rows, DDPG_K),
                                    "replay_scatter": (RR.scatter_rows, DDPG_K)},
                          PRECISION_WARMUP_ITERS, PRECISION_TIMED_ITERS)
    checks["loss_scale"] = timing["metrics"].get("precision/loss_scale") == LS_INIT
    if not all(checks.values()):
        raise AssertionError(f"ddpg bf16 checks failed: {checks}")
    gather = check_host_ddpg_gather(RR, trainer._replay_example(), path="ddpg_lift_bf16")
    result = {"phase": "precision", "step": "ddpg_bf16", "checks": checks,
              "obs_storage_bytes": {"bf16": b16["obs"] + b16["next_obs"], "mixed": b32["obs"] + b32["next_obs"]},
              "storage_bytes": {"bf16": sum(b16.values()), "mixed": sum(b32.values())},
              **{k: timing[k] for k in ("iter_ms_median", "iter_ms", "env_steps_per_s", "replay_gather_launches",
                                        "replay_scatter_launches", "peak_mem_gb")},
              "gather_check": {k: gather[k] for k in ("max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms",
                                                     "row_bytes")}}
    emit(result)
    return {**result, "gather": gather}


def precision_poisoned(M) -> dict:
    """(d) An inf reward in the batch of a north-star 'bf16' iteration run
    under set_sync_debug_mode("error") (after one clean iteration): every
    minibatch step is skipped, so each parameter is bit-unchanged,
    ``health/nonfinite`` is 1, the overflows rise by the 16 minibatches
    and the scale backs off to ls_min."""
    tr = M.Trainer(north_star_policy_config(M, "bf16"))
    state = tr.learner.init(torch.Generator().manual_seed(0))
    carry = tr.init_loop_state()
    state, carry, _ = tr._device_train_iter(state, carry)
    torch.cuda.synchronize()
    learn = tr.learner.learn

    def poisoned(st, batch, *a, **kw):
        reward = batch["reward"].clone()
        reward[0, 0].fill_(float("inf"))  # a fill: item assignment copies from the host
        return learn(st, {**batch, "reward": reward}, *a, **kw)

    before = {k: v.clone() for k, v in state.params.items()}
    overflows_before = state.opt_state.overflows.clone()
    tr.learner.learn = poisoned
    torch.cuda.set_sync_debug_mode("error")
    try:
        new, _, metrics = tr._device_train_iter(state, carry)
    finally:
        torch.cuda.set_sync_debug_mode(0)
        tr.learner.learn = learn
    m = {k: float(v) for k, v in metrics.items()}
    minibatches = 4 * 4
    checks = {
        "params_bit_unchanged": all(torch.equal(new.params[k], v) for k, v in before.items()),
        "nonfinite": m["health/nonfinite"] == 1.0,
        "overflows": int(new.opt_state.overflows - overflows_before) == minibatches,
        "scale_at_floor": m["precision/loss_scale"] == LS_MIN,
    }
    if not all(checks.values()):
        raise AssertionError(f"poisoned-batch checks failed: {checks}")
    result = {"phase": "precision", "step": "poisoned_batch", "checks": checks, "sync_debug_mode": "error",
              "overflows": m["precision/overflows"], "loss_scale": m["precision/loss_scale"]}
    emit(result)
    return result


def precision_checkpoint(M) -> dict:
    """(e) ``train ppo jax:lift`` under 'bf16' for 2 iterations (the run-end
    checkpoint), resumed for a third: the restored state, its loss-scale
    state included, bit-equal to the saved one; then a relaunch under
    'mixed' in the same folder stops with PrecisionMismatchError."""
    from surreal_tpu_torch.session.checkpoint import PrecisionMismatchError

    folder = scratch_dir("precision_ckpt")
    run_cli(M, north_star_argv(folder, 2, "learner_config.algo.precision=bf16"))
    template = M.Trainer(north_star_policy_config(M, "bf16")).learner.init()
    saved, _ = M.CheckpointManager(folder).restore(template)
    restored = {}

    def capture(orig):
        def restore(self, init_state):
            restored["out"] = orig(self, init_state)
            return restored["out"]
        return restore

    with Patched(M.SessionHooks, "restore", capture):
        run_cli(M, north_star_argv(folder, 3, "learner_config.algo.precision=bf16"))
    state, iteration, _ = restored["out"]
    mismatch = None
    try:
        run_cli(M, north_star_argv(folder, 4, "learner_config.algo.precision=mixed"))
    except PrecisionMismatchError as e:
        mismatch = str(e)
    ls = state.opt_state
    checks = {
        "resumed_at": iteration == 2,
        "loss_scale_state_bit_equal": all(
            torch.equal(getattr(ls, f), getattr(saved.opt_state, f)) for f in ("scale", "good_steps", "overflows")),
        "state_bit_equal": tensors_equal(state, saved, M.tree_flatten),
        "good_steps": int(ls.good_steps) == 2 * 16,
        "mismatch_raised": mismatch is not None and "algo.precision" in mismatch,
    }
    if not all(checks.values()):
        raise AssertionError(f"precision checkpoint checks failed: {checks}")
    result = {"phase": "precision", "step": "checkpoint", "checks": checks, "mismatch_error": mismatch[:200]}
    emit(result)
    return result


def phase_precision(M, gae, vtrace, RR) -> dict:
    """The 'bf16' and 'bf16_fp8' policies at the widths of the north-star,
    pong and ddpg cells: (a)-(e), see each step."""
    parity = precision_parity(M, gae)
    timed = precision_timed(M, gae)
    pong = precision_pong(M, vtrace)
    ddpg = precision_ddpg(M, RR)
    poisoned = precision_poisoned(M)
    ckpt = precision_checkpoint(M)
    return {
        "gae_launches": sum(r["gae_launches"] for r in timed["policies"].values()),
        "vtrace_launches": pong["vtrace_launches"],
        "replay_gather_launches": ddpg["replay_gather_launches"],
        "replay_scatter_launches": ddpg["replay_scatter_launches"],
        "gather": ddpg["gather"], "parity": parity, "poisoned": poisoned, "checkpoint": ckpt,
    }


# -- live parameter publishing: the parameter service, agents, actor and eval

PUBLISH_MIN_ITERS, PUBLISH_MAX_ITERS = 4, 40  # a live session's iterations: at least, at most
PUBLISH_ACTOR_ENVS, PUBLISH_ACTOR_EPISODES = 64, 768  # the actor: 64 jax:lift envs, 12 episodes each
PUBLISH_EVAL_EPISODES = 64
PUBLISH_CONSUMER_S = 240  # each consumer's --wait, and this script's wait for it to exit
PUBLISH_TIMED_ITERS = 4  # the on/off timing run: publish every 2nd of 2 warm-up + 4 timed iterations (cut from 8)


def port_process(argv: list[str], log: str) -> subprocess.Popen:
    """``python -m surreal_tpu_torch <argv>`` from this checkout, stdout
    and stderr to ``log`` (a file, so a full pipe can never stall it)."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [root, os.environ.get("PYTHONPATH")])))
    with open(log, "w") as f:
        return subprocess.Popen([sys.executable, "-m", "surreal_tpu_torch", *argv], cwd=root, env=env,
                                stdout=f, stderr=subprocess.STDOUT, text=True)


def finish_process(proc: subprocess.Popen, log: str, name: str) -> list[dict]:
    """Wait (bounded) for ``proc``; its JSON lines, or an error with the
    end of its log. A process still running at the deadline is killed."""
    try:
        proc.wait(timeout=PUBLISH_CONSUMER_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    with open(log) as f:
        text = f.read()
    if proc.returncode != 0:
        raise AssertionError(f"{name} exited {proc.returncode}:\n{text[-3000:]}")
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


def live_session(M, tag: str, argv: list[str], consumers: dict, counters: dict, guard_iteration: int | None = None):
    """The ``train`` CLI in this process with publishing on, while each of
    ``consumers`` (name -> argv of a subcommand) runs as its own process
    against the session. The session stops at the first metrics window
    after every consumer has exited (after at least PUBLISH_MIN_ITERS
    iterations; the CLI's --total-steps bounds it). Every publish is
    wrapped: its host syncs counted (under set_sync_debug_mode("warn")) and
    a clone of its view kept by version. After each boundary, a
    ParameterClient on the card fetches from the session's server, and
    each fetched view must be bit-equal to the view published under its
    version. ``guard_iteration``: that iteration runs under
    set_sync_debug_mode("error") from its step through its boundary,
    the publish excepted. ``counters``: kernel -> (wrapper, launches an
    iteration)."""
    import warnings

    from surreal_tpu_torch.distributed.param_service import ParameterClient, ParameterPublisher
    from surreal_tpu_torch.utils.tree import tree_map

    views, publish_syncs, fetched, consumer_procs = {}, [], [], {}
    client, iterations = [], []

    def record_publish(orig):
        def publish(self, params):
            mode = torch.cuda.get_sync_debug_mode()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    version = orig(self, params)
                finally:
                    torch.cuda.set_sync_debug_mode(mode)
            publish_syncs.append(sum("synchroniz" in str(w.message) and "prototype" not in str(w.message)
                                     for w in caught))
            views[version] = tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor) else x, params)
            return version
        return publish

    def boundary(orig):
        def end_iteration(self, iteration, *a, **kw):
            m, stop = orig(self, iteration, *a, **kw)
            iterations.append(iteration)
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode(0)
            if not client and views:
                client.append(ParameterClient(self._param_server.address, next(iter(views.values()))))
            if client:
                t0 = time.perf_counter()
                view = client[0].fetch(timeout_ms=10_000)
                ms = (time.perf_counter() - t0) * 1e3
                if view is not None:
                    v = client[0].version
                    fetched.append({"version": v, "ms": ms,
                                    "bit_equal": tensors_equal(view, views[v], M.tree_flatten),
                                    "on_card": all(x.device.type == "cuda" for x in M.tree_flatten(view).values()
                                                   if isinstance(x, torch.Tensor))})
            torch.cuda.set_sync_debug_mode(mode)
            done = all(p.poll() is not None for p, _ in consumer_procs.values())
            return m, stop or (done and iteration >= PUBLISH_MIN_ITERS)
        return end_iteration

    calls = []

    def guard(orig):
        def train_iter(self, *a, **kw):
            calls.append(iteration := len(calls) + 1)
            torch.cuda.set_sync_debug_mode("error" if iteration == guard_iteration else 0)
            return orig(self, *a, **kw)
        return train_iter

    folder = argv[argv.index("--folder") + 1]
    trainer_cls = M.OffPolicyTrainer if argv[1] == "ddpg" else M.Trainer
    for name, consumer in consumers.items():
        log = os.path.join(_SCRATCH[0], f"{tag}_{name}.log")
        consumer_procs[name] = (port_process(consumer, log), log)
    for wrapper, _ in counters.values():
        wrapper.launches = 0
    t0 = time.perf_counter()
    try:
        with Patched(ParameterPublisher, "publish", record_publish), Patched(M.SessionHooks, "end_iteration", boundary), \
                Patched(trainer_cls, "_device_train_iter", guard):
            final = run_cli(M, argv)
    except BaseException:
        for proc, _ in consumer_procs.values():
            proc.kill()
            proc.wait()
        raise
    finally:
        torch.cuda.set_sync_debug_mode(0)
        for c in client:
            c.close()
    train_s = time.perf_counter() - t0
    outputs = {name: finish_process(proc, log, name) for name, (proc, log) in consumer_procs.items()}
    n = len(iterations)
    launches = {name: wrapper.launches for name, (wrapper, _) in counters.items()}
    for name, (_, per_iter) in counters.items():
        if launches[name] != per_iter * n:
            raise AssertionError(f"{tag}: {name} launched {launches[name]} times in {n} iterations, "
                                 f"expected {per_iter} an iteration")
    events = session_events(folder, M.iter_jsonl)
    publish_ms = [e["dur_s"] * 1e3 for e in events if e["type"] == "span" and e["name"] == "param-publish"]
    fetch_bytes = [e["bytes"] for e in events if e["type"] == "param_fetch" and not e["unchanged"]]
    checks = {
        "publishes": len(publish_ms) == len(publish_syncs) == len(views) >= n - 1,
        "one_sync_a_publish": set(publish_syncs) == {1},
        "fetched_bit_equal": bool(fetched) and all(f["bit_equal"] and f["on_card"] for f in fetched),
        "discovery_retracted": not os.path.exists(os.path.join(folder, "param_server.json")),
        "finite": all(math.isfinite(v) for k, v in final.items() if k != "episode/return"),
    }
    if guard_iteration is not None:
        checks["guarded_iteration_ran"] = len(calls) >= guard_iteration
    if not all(checks.values()):
        raise AssertionError(f"{tag} checks failed: {checks}")
    return {
        "folder": folder, "iterations": n, "train_s": train_s, "launches": launches, "checks": checks,
        "publish_ms_p50": statistics.median(publish_ms), "publish_ms": publish_ms,
        "fetch_ms_p50": statistics.median(f["ms"] for f in fetched),
        "fetch_bytes": statistics.median(fetch_bytes) if fetch_bytes else None,
        "fetched_versions": [f["version"] for f in fetched], "outputs": outputs, "final": final,
    }


def actor_argv(folder: str, *extra: str) -> list[str]:
    return ["actor", "--folder", folder, "--num-envs", str(PUBLISH_ACTOR_ENVS), "--episodes",
            str(PUBLISH_ACTOR_EPISODES), "--fetch-every", "10", "--min-version", "2",
            "--wait", str(PUBLISH_CONSUMER_S), *extra]


def check_actor(summary_lines: list[dict], tag: str) -> dict:
    summary = summary_lines[-1]
    episodes = [line for line in summary_lines if "episode" in line]
    ok = (summary["actor/versions_seen"] >= 2 and summary["actor/episodes"] >= PUBLISH_ACTOR_EPISODES
          and all(math.isfinite(e["return"]) and e["param_version"] >= 2 for e in episodes))
    if not ok:
        raise AssertionError(f"{tag} actor: {summary}")
    return summary


def publish_ppo(M, gae) -> dict:
    """``train ppo jax:lift`` at the north-star geometry with
    ``publish.enabled`` and every_n_iters=1 (metrics every 2, a checkpoint
    every 4, keep-best on episode/return, ``env_config.video`` on), while
    ``actor --folder F`` (64 envs on the card, a fetch every 10 acts, from
    version 2) and ``eval F --follow --rounds 2`` run as processes of their
    own; iteration 3 under set_sync_debug_mode("error") but for its
    publish; GAE once a learn. Then ``eval F --best`` in this process:
    the best checkpoint scored, its episode recorded to the video dir."""
    folder = scratch_dir("publish_ppo")
    vdir = os.path.join(folder, "videos")
    argv = ["train", "ppo", "jax:lift", "--folder", folder, "--num-envs", str(MAIN_B),
            "--total-steps", str(PUBLISH_MAX_ITERS * MAIN_B * MAIN_T), "--set",
            f"learner_config.algo.horizon={MAIN_T}", "learner_config.algo.epochs=4",
            "learner_config.algo.num_minibatches=4", "learner_config.algo.precision=mixed",
            "session_config.publish.enabled=true", "session_config.publish.every_n_iters=1",
            "session_config.metrics.every_n_iters=2", "session_config.checkpoint.every_n_iters=4",
            "session_config.eval.every_n_iters=0", "session_config.metrics.console=false",
            "session_config.metrics.tensorboard=false", "env_config.video.enabled=true",
            f"env_config.video.dir={vdir}", "env_config.video.every_n_episodes=1"]
    consumers = {
        "actor": actor_argv(folder),
        "eval_follow": ["eval", folder, "--follow", "--rounds", "2", "--episodes", str(PUBLISH_EVAL_EPISODES),
                        "--wait", str(PUBLISH_CONSUMER_S)],
    }
    live = live_session(M, "publish_ppo", argv, consumers, {"gae": (gae, 1)}, guard_iteration=3)
    actor = check_actor(live["outputs"]["actor"], "ppo")
    rounds = live["outputs"]["eval_follow"]
    if not (len(rounds) == 2 and all(math.isfinite(r["eval/return"]) for r in rounds)
            and 1 <= rounds[0]["param_version"] <= rounds[1]["param_version"]):
        raise AssertionError(f"eval --follow rounds: {rounds}")
    shutil.rmtree(vdir, ignore_errors=True)  # what eval --follow recorded
    out = io.StringIO()
    with redirect_stdout(out):
        (rc, best_ms) = fenced_ms(lambda: M.launch.main(["eval", folder, "--best", "--episodes", "64"]))
    if rc != 0:
        raise AssertionError(f"eval --best exited {rc}")
    best = json.loads(out.getvalue().strip().splitlines()[-1])
    (video,) = os.listdir(vdir)
    if video.endswith(".npz"):
        frames = np.load(os.path.join(vdir, video))["frames"]
    else:
        import imageio.v2 as imageio

        frames = np.stack(imageio.mimread(os.path.join(vdir, video), memtest=False))
    video_ok = bool(video.startswith("episode_000000") and frames.dtype == np.uint8 and frames.ndim == 4
                    and frames.shape[-1] == 3 and 2 <= frames.shape[0] <= 201 and frames.std() > 0)
    if not video_ok:
        raise AssertionError(f"eval --best video {video}: {frames.shape} {frames.dtype}")
    result = {
        "phase": "publish", "step": "ppo_lift", "num_envs": MAIN_B, "horizon": MAIN_T,
        "iterations": live["iterations"], "train_s": live["train_s"], "gae_launches": live["launches"]["gae"],
        "checks": {**live["checks"], "actor_versions_seen": actor["actor/versions_seen"], "video": video_ok},
        "publish_ms_p50": live["publish_ms_p50"], "fetch_ms_p50": live["fetch_ms_p50"],
        "fetch_bytes": live["fetch_bytes"], "fetched_versions": live["fetched_versions"],
        "actor": actor, "eval_follow": rounds,
        "eval_best": {**best, "ms": best_ms, "video": video, "frames": list(frames.shape)},
    }
    emit(result)
    return result


def publish_ddpg(M, RR) -> dict:
    """``train ddpg jax:lift`` at the headline DDPG geometry, prioritized
    replay, publishing every iteration (metrics every iteration), while a
    DDPG ``actor`` process acts from the actor-only view (OU noise,
    masked at resets); gather and scatter 64 times each an iteration."""
    folder = scratch_dir("publish_ddpg")
    per_iter = DDPG_B * DDPG_H
    argv = ["train", "ddpg", "jax:lift", "--folder", folder, "--num-envs", str(DDPG_B),
            "--total-steps", str(PUBLISH_MAX_ITERS * per_iter), "--set",
            f"learner_config.algo.horizon={DDPG_H}", f"learner_config.algo.updates_per_iter={DDPG_K}",
            "learner_config.algo.precision=mixed", "learner_config.algo.exploration.warmup_steps=0",
            "learner_config.replay.kind=prioritized", f"learner_config.replay.capacity={DDPG_CAPACITY}",
            f"learner_config.replay.start_sample_size={per_iter}", f"learner_config.replay.batch_size={DDPG_BS}",
            "session_config.publish.enabled=true", "session_config.metrics.every_n_iters=1",
            "session_config.checkpoint.every_n_iters=1000", "session_config.eval.every_n_iters=0",
            "session_config.metrics.console=false", "session_config.metrics.tensorboard=false"]
    live = live_session(M, "publish_ddpg", argv, {"actor": actor_argv(folder)},
                        {"replay_gather": (RR.gather_rows, DDPG_K), "replay_scatter": (RR.scatter_rows, DDPG_K)})
    actor = check_actor(live["outputs"]["actor"], "ddpg")
    result = {
        "phase": "publish", "step": "ddpg_lift", "num_envs": DDPG_B, "horizon": DDPG_H,
        "updates_per_iter": DDPG_K, "iterations": live["iterations"], "train_s": live["train_s"],
        "replay_gather_launches": live["launches"]["replay_gather"],
        "replay_scatter_launches": live["launches"]["replay_scatter"],
        "checks": {**live["checks"], "actor_versions_seen": actor["actor/versions_seen"]},
        "publish_ms_p50": live["publish_ms_p50"], "fetch_ms_p50": live["fetch_ms_p50"],
        "fetch_bytes": live["fetch_bytes"], "actor": actor,
    }
    emit(result)
    return result


def publish_timing(M, gae) -> dict:
    """The north-star through ``Trainer.run`` with publishing every 2nd
    iteration and no consumer: metrics every iteration (a fence), so each
    iteration's time is fenced; the publishing iterations' median against
    the others', in one run (2 warm-up, 6 timed: 3 of each)."""
    cfg = north_star_config(M, scratch_dir("publish_timing"), publish=M.Config(enabled=True, every_n_iters=2),
                            perf=M.Config(enabled=False))
    _, timing = timed_run(M.Trainer(cfg), {"gae": (gae, 1)}, warmup=2, timed=PUBLISH_TIMED_ITERS)
    # iter_ms[i] is iteration i + 2; iterations 2, 4, ... publish
    timed = [(i + 2, ms) for i, ms in enumerate(timing["iter_ms"])][1:]
    on = [ms for it, ms in timed if it % 2 == 0]
    off = [ms for it, ms in timed if it % 2 == 1]
    result = {"phase": "publish", "step": "north_star_on_off", "iterations": {"on": len(on), "off": len(off)},
              "iter_ms_publishing": statistics.median(on), "iter_ms_not_publishing": statistics.median(off),
              "iter_ms": timing["iter_ms"], "gae_launches": timing["gae_launches"]}
    emit(result)
    return result


def phase_publish(M, gae, RR) -> dict:
    ppo = publish_ppo(M, gae)
    ddpg = publish_ddpg(M, RR)
    timing = publish_timing(M, gae)
    return {
        "gae": {"publish_ppo_lift": ppo["gae_launches"]},
        "replay_gather": {"publish_ddpg_lift": ddpg["replay_gather_launches"]},
        "replay_scatter": {"publish_ddpg_lift": ddpg["replay_scatter_launches"]},
        "ppo": ppo, "ddpg": ddpg, "timing": timing,
    }


# -- the serving tier: the inference fleet and the parameter fanout -----------

FLEET_KILL_AT = 40        # the kill: the 41st serve-loop turn of the two replicas
FLEET_PACING_MS = 50      # each kill-run iteration at least this long: the run outlasts the orphan's 2 s budget
FLEET_KILL_ITERS = 32     # learns of the kill run: IMPALA CartPole chunks [32, 8]
FLEET_TURNS = (1, 2, 2, 1)  # replicas of the pixels256 runs, in turns
FLEET_SEED_ITERS = (2, 3)   # warm-up and timed learns of each fleet SEED run (process workers start in ~10 s)
FANOUT_NS_ITERS = 5       # north-star iterations an arm, each publishing
FANOUT_PONG_ITERS = 8     # pong iterations an arm
FANOUT_DROP_AT = 3        # the drop run swallows its 4th frame
FANOUT_WAIT_S = 180       # the subscriber's wait for the session, and the session's for the subscriber


def slab_residue() -> list[str]:
    import glob

    from surreal_tpu_torch.distributed.shm_transport import SLAB_PREFIX

    return glob.glob(f"/dev/shm/{SLAB_PREFIX}*_{os.getpid()}_*")


def fleet_kill_cli(M, vtrace, env_source: dict) -> dict:
    """``train impala gym:CartPole-v1 --workers 4`` with
    ``inference_fleet.replicas=2`` (thread workers on the pickle wire, 16
    envs each: chunks [32, 8]), one replica killed by the
    ``fleet.replica`` ``kill_replica`` injection: its workers time out (2 s
    silence budget) and are respawned against the survivor, the replica
    respawns in place, the budget completes, V-trace once a learn; the
    last ``serving_tier`` event all alive; no slab left."""
    folder, T, width = scratch_dir("fleet_kill"), CARTPOLE_T, SEED_CARTPOLE_ENVS // 2
    plan = [{"site": "fleet.replica", "kind": "kill_replica", "at": FLEET_KILL_AT},
            {"site": "trainer.iteration", "kind": "delay", "ms": FLEET_PACING_MS, "times": 10**6}]
    argv = ["train", "impala", "gym:CartPole-v1", "--folder", folder, "--workers", "4",
            "--num-envs", str(SEED_CARTPOLE_ENVS), "--total-steps", str(FLEET_KILL_ITERS * T * width), "--set",
            f"learner_config.algo.horizon={T}", "learner_config.algo.precision=mixed",
            "session_config.topology.inference_fleet.replicas=2",
            "session_config.topology.inference_fleet.respawn_backoff_s=0.05",
            "session_config.topology.worker_silence_s=2.0", "session_config.topology.respawn_backoff_s=0.05",
            # the kill's incident would scale the fleet up: phase ops holds that
            "session_config.remediate.enabled=false",
            f"session_config.faults.plan={json.dumps(plan)}", "session_config.metrics.every_n_iters=1",
            "session_config.metrics.console=false", "session_config.metrics.tensorboard=false"]
    t0 = time.perf_counter()
    final, launches = count_launches({"vtrace": (vtrace, FLEET_KILL_ITERS)}, lambda: run_cli(M, argv))
    seconds = time.perf_counter() - t0
    events = session_events(folder, M.iter_jsonl)
    tiers = [e for e in events if e["type"] == "serving_tier"]
    residue = slab_residue()
    checks = {
        "replica_respawned": final["fleet/respawns"] >= 1.0, "replicas_live_2": final["fleet/replicas_live"] == 2.0,
        "workers_respawned": final["workers/respawns"] >= 1.0,
        "budget": final["time/env_steps"] == FLEET_KILL_ITERS * T * width,
        "kill_fired": any(e["type"] == "fault" and e.get("site") == "fleet.replica" for e in events),
        "last_tier_all_alive": bool(tiers) and all(r["state"] == "alive" for r in tiers[-1]["replicas"].values()),
        "no_shm_residue": not residue,
    }
    result = {"phase": "fleet", "step": "kill_replica_cli", "env_source": env_source.get("gym:CartPole-v1", "fixture"),
              "workers": 4, "chunk": [T, width], "seconds": seconds, "checks": checks, "launches": launches,
              "fleet": {k: v for k, v in final.items() if k.startswith(("fleet/", "workers/"))},
              "last_tier": tiers[-1] if tiers else None, "residue": residue}
    emit(result)
    if not all(checks.values()):
        raise AssertionError(f"fleet kill-replica checks failed: {checks}")
    return result


def fleet_autoscale(M, vtrace, env_source: dict) -> dict:
    """``inference_fleet.autoscale`` from one replica (IMPALA CartPole, 2
    thread workers x 16 envs): a scale-up threshold every serve passes,
    no cooldown, so the first metrics cadence adds the second replica."""
    fleet = dict(replicas=1, autoscale=True, min_replicas=1, max_replicas=2, scale_up_serve_ms=0.0,
                 scale_down_serve_ms=0.0, scale_cooldown_s=0.0)
    trainer = M.SEEDTrainer(seed_config(M, dict(name="impala", horizon=CARTPOLE_T, precision="mixed"),
                                        "gym:CartPole-v1", SEED_CARTPOLE_WORKERS, SEED_CARTPOLE_ENVS, "thread", fleet))
    _, timing = timed_run(trainer, {"vtrace": (vtrace, 1)}, 2, 6)
    m = timing["metrics"]
    checks = {"scaled_up": m["fleet/scale_ups"] >= 1.0, "replicas_live_2": m["fleet/replicas_live"] == 2.0}
    result = {"phase": "fleet", "step": "autoscale", "env_source": env_source.get("gym:CartPole-v1", "fixture"),
              "config": fleet, "checks": checks, "iter_ms_median": timing["iter_ms_median"],
              "vtrace_launches": timing["vtrace_launches"],
              "fleet": {k: v for k, v in m.items() if k.startswith("fleet/")}}
    emit(result)
    if not all(checks.values()):
        raise AssertionError(f"fleet autoscale checks failed: {checks}")
    return result


def phase_fleet(M, ops_gae, ops_vtrace, RS, env_source: dict) -> dict:
    """The replicated inference fleet under SEED: the kill-and-respawn CLI
    run; the seed-impala-pixels256 geometry at 1 and 2 replicas in turns
    (iteration ms, env steps/s, serve p50/p99 fleet-wide and per replica,
    syncs a serve); seed-ppo-cheetah at 2 replicas (GAE once a learn);
    autoscale. Each kernel's shapes here (V-trace [32, 8] and [32, 32],
    GAE [64, 4]) are the seed cells', held against their plain versions in
    the kernels phase. Returns each kernel's launches by path."""
    gae = {"gae": (ops_gae.gae_advantages_masked, 1), "rev_scan": (RS.reverse_linear_scan, 0)}
    vtrace = {"vtrace": (ops_vtrace.vtrace_fused, 1), "rev_scan": (RS.reverse_linear_scan, 0)}
    kill = fleet_kill_cli(M, ops_vtrace.vtrace_fused, env_source)
    turns = []
    for k, replicas in enumerate(FLEET_TURNS):
        fleet = dict(replicas=replicas) if replicas > 1 else None
        turns.append(phase_seed_train(
            M, f"fleet_impala_pixels256_r{replicas}_{k}", dict(name="impala", horizon=SEED_PIXEL_T, precision="mixed"),
            PONG_HOST_ENV, SEED_PIXEL_WORKERS, SEED_PIXEL_ENVS, "process", vtrace, env_source, fleet=fleet,
            phase="fleet", iters=FLEET_SEED_ITERS, model=dict(cnn=dict(enabled=True))))
    ppo = phase_seed_train(M, "fleet_ppo_cheetah_r2", dict(name="ppo", horizon=CHEETAH_T, epochs=4,
                                                           num_minibatches=4, precision="mixed"),
                           "dm_control:cheetah-run", SEED_PPO_WORKERS, SEED_PPO_ENVS, "process", gae, env_source,
                           fleet=dict(replicas=2), phase="fleet", iters=FLEET_SEED_ITERS)
    autoscale = fleet_autoscale(M, ops_vtrace.vtrace_fused, env_source)
    by_replicas = {r: [t["iter_ms_median"] for t, n in zip(turns, FLEET_TURNS) if n == r] for r in set(FLEET_TURNS)}
    emit({"phase": "fleet", "step": "summary", "pixels256_iter_ms_by_replicas": by_replicas,
          "pixels256_env_steps_per_s": [t["env_steps_per_s"] for t in turns],
          "pixels256_serve_ms": [t["serve_ms"] for t in turns], "ppo_cheetah_r2_iter_ms": ppo["iter_ms_median"]})
    return {
        "gae": {"fleet_ppo_cheetah_r2": ppo["gae_launches"]},
        "vtrace": {"fleet_kill_cli": kill["launches"]["vtrace"], "fleet_autoscale": autoscale["vtrace_launches"],
                   **{t["path"]: t["vtrace_launches"] for t in turns}},
    }


def fanout_leaves(tree) -> list[np.ndarray]:
    """A view's leaves on the host as a subscriber holds them: floating
    leaves float32, the others (bfloat16 as 16-bit patterns) raw."""
    from surreal_tpu_torch.distributed.param_fanout import _host_leaf, _leaves

    out = []
    for x in _leaves(tree):
        arr, is_bf16 = _host_leaf(x)
        out.append(np.asarray(arr, np.float32) if np.issubdtype(arr.dtype, np.floating) and not is_bf16 else arr)
    return out


def leaves_digest(leaves) -> str:
    import hashlib

    h = hashlib.sha256()
    for x in leaves:
        h.update(np.ascontiguousarray(x).tobytes())
    return h.hexdigest()


def fanout_subscriber(folder: str, out: str) -> int:
    """The subscriber process of the fanout phase (``python chip_smoke.py
    fanout-subscriber <folder> <out>``): reads the session's config.json
    and param_server.json, subscribes to the fanout (its template a CPU
    learner's acting view), writes ``<out>.ready``, then polls frames,
    acks them, catches up by fetch when a delta cannot apply, and writes
    one JSON line a version it holds (its leaves' digest, and whether a
    frame or a fetch brought it) until the session retracts its discovery
    file; then its gauges."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from surreal_tpu_torch.agents import make_agent
    from surreal_tpu_torch.distributed import ParameterClient, ParameterSubscriber
    from surreal_tpu_torch.envs import make_env
    from surreal_tpu_torch.learners import build_learner
    from surreal_tpu_torch.main.launch import _load_session_config
    from surreal_tpu_torch.session.config import Config

    config = _load_session_config(folder, wait_s=FANOUT_WAIT_S)
    env = make_env(Config(num_envs=1).extend(config.env_config), "cpu")
    learner = build_learner(config.learner_config, env.specs, "cpu")
    template = make_agent(learner).acting_view(learner.init(torch.Generator().manual_seed(0)))
    discovery = os.path.join(folder, "param_server.json")
    deadline = time.monotonic() + FANOUT_WAIT_S
    while not os.path.exists(discovery) and time.monotonic() < deadline:
        time.sleep(0.1)
    with open(discovery) as f:
        info = json.load(f)
    sub = ParameterSubscriber(info["fanout"], info["fanout_ack"], template, ident="chip-smoke")
    client = ParameterClient(info["addresses"][0], template)
    time.sleep(0.3)  # the subscription reaches the PUB's thread
    with open(out + ".ready", "w"):
        pass
    with open(out, "w") as f:
        def record(via):
            f.write(json.dumps({"version": sub.version, "digest": leaves_digest(sub._leaves), "via": via}) + "\n")
            f.flush()

        while os.path.exists(discovery) and time.monotonic() < deadline + FANOUT_WAIT_S:
            if sub.poll(timeout_ms=200) is not None:
                record("frame")
            if sub.needs_resync and sub.catch_up(client):
                record("fetch")
        f.write(json.dumps({"gauges": sub.gauges(), "version": sub.version}) + "\n")
    sub.close()
    client.close()
    return 0


def start_subscriber(folder: str, tag: str) -> tuple:
    """``fanout_subscriber`` on ``folder`` as a process of its own (it
    waits for the session): (the process, its output path, its log)."""
    out = os.path.join(_SCRATCH[0], f"{tag}_subscriber.jsonl")
    log = out + ".log"
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [root, os.environ.get("PYTHONPATH")])))
    with open(log, "w") as f:
        proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "fanout-subscriber", folder, out],
                                cwd=root, env=env, stdout=f, stderr=subprocess.STDOUT)
    return proc, out, log


def fanout_session(M, tag: str, argv: list[str], subscriber: tuple, wire: str, delta: bool,
                   drop_at: int | None = None) -> dict:
    """The ``train`` CLI in this process with ``publish.fanout`` on (every
    iteration), while ``subscriber`` (``start_subscriber``'s) runs.
    At the first boundary the session waits for the subscriber to be
    subscribed; after each boundary a ParameterClient fetches the view
    from the session's ParameterServer. Every ``publish_view`` is wrapped:
    its host syncs counted and its time taken; every fanout publish: its
    frame's kind and bytes, the published view and the publisher's shadow
    kept by version. Checks the subscriber's leaves at each version it
    holds: f32 wire without delta, bit-equal to the fetched view; f32
    delta, bit-equal to the shadow and the fetched view; bf16 without
    delta, equal to the view cast to bf16 and back; bf16 delta, equal to
    the shadow (from a chain a full frame started); and one host sync a
    publish. ``drop_at``: the fanout's publish of that index (0-based) is
    swallowed on the wire (``param.publish`` ``drop_frame``)."""
    import warnings

    from surreal_tpu_torch.distributed.param_fanout import ParameterFanout, from_bf16_bits, to_bf16_bits
    from surreal_tpu_torch.distributed.param_service import ParameterClient, ParameterPublisher

    folder = argv[argv.index("--folder") + 1]
    argv = argv + [
        "session_config.publish.enabled=true", "session_config.publish.every_n_iters=1",
        "session_config.publish.fanout.enabled=true", f"session_config.publish.fanout.wire={wire}",
        f"session_config.publish.fanout.delta={'true' if delta else 'false'}",
    ]
    if drop_at is not None:
        argv.append("session_config.faults.plan=" + json.dumps(
            [{"site": "param.publish", "kind": "drop_frame", "at": drop_at}]))
    proc, out, log = subscriber
    frames, publishes, fetched, client = {}, [], {}, []

    def record_fanout(orig):
        def publish(self, params):
            info = orig(self, params)
            # references only (each publish has a fresh host view and shadow);
            # the digests are taken after the run, outside the timed publish
            frames[info["version"]] = {**info, "_view": fanout_leaves(params), "_shadow": self._shadow}
            return info
        return publish

    def record_publish_view(orig):
        def publish_view(self, state):
            mode = torch.cuda.get_sync_debug_mode()
            publisher = self._publisher.publish
            t = {}

            def timed_publisher(view):
                t0 = time.perf_counter()
                out = publisher(view)
                t["publisher_ms"] = (time.perf_counter() - t0) * 1e3
                return out

            self._publisher.publish = timed_publisher
            torch.cuda.synchronize()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                t0 = time.perf_counter()
                try:
                    version = orig(self, state)
                finally:
                    torch.cuda.set_sync_debug_mode(mode)
                    del self._publisher.publish
            publishes.append({"version": version, "ms": (time.perf_counter() - t0) * 1e3, **t,
                              "syncs": sum("synchroniz" in str(w.message) and "prototype" not in str(w.message)
                                           for w in caught)})
            return version
        return publish_view

    waited = []

    def boundary(orig):
        def end_iteration(self, iteration, *a, **kw):
            m, stop = orig(self, iteration, *a, **kw)
            if not waited:
                t0 = time.perf_counter()
                deadline = time.monotonic() + FANOUT_WAIT_S
                while not os.path.exists(out + ".ready") and proc.poll() is None and time.monotonic() < deadline:
                    time.sleep(0.1)
                waited.append(time.perf_counter() - t0)
            if not client:
                state = a[1]() if callable(a[1]) else a[1]
                client.append(ParameterClient(self._param_server.address,
                                              M.host_tree(self._pub_agent.acting_view(state))))
            view = client[0].fetch(timeout_ms=10_000)
            if view is not None:
                fetched[client[0].version] = leaves_digest(fanout_leaves(view))
            return m, stop
        return end_iteration

    try:
        with Patched(ParameterFanout, "publish", record_fanout), \
                Patched(M.SessionHooks, "publish_view", record_publish_view), \
                Patched(M.SessionHooks, "end_iteration", boundary):
            final = run_cli(M, argv)
        proc.wait(timeout=FANOUT_WAIT_S)
    except BaseException:
        proc.kill()
        proc.wait()
        raise
    finally:
        for c in client:
            c.close()
    with open(log) as f:
        text = f.read()
    if proc.returncode != 0 or not os.path.exists(out):
        raise AssertionError(f"{tag} subscriber exited {proc.returncode}:\n{text[-3000:]}")
    with open(out) as f:
        lines = [json.loads(line) for line in f if line.strip()]
    held, gauges = lines[:-1], lines[-1]["gauges"]
    for fr in frames.values():
        view, shadow = fr.pop("_view"), fr.pop("_shadow")
        fr["view"], fr["shadow"] = leaves_digest(view), leaves_digest(shadow)
        fr["bf16_view"] = leaves_digest([from_bf16_bits(to_bf16_bits(x)) if x.dtype == np.float32 else x
                                         for x in view])
        floats = [(a, b) for a, b in zip(shadow, view) if a.dtype == np.float32]
        fr["shadow_vs_view_elems"] = int(sum(np.count_nonzero(a != b) for a, b in floats))
        fr["float_elems"] = int(sum(b.size for _, b in floats))
        # the largest difference, in rounding steps of its leaf's largest magnitude
        fr["shadow_vs_view_steps"] = max((float(np.abs(a - b).max() / (np.spacing(np.abs(b).max()) or 1.0))
                                          for a, b in floats if a.size), default=0.0)
    # a delta applied on a fetched start holds neither the view nor the
    # shadow: compare the versions a chain of frames from a full frame brought
    kinds = {v: fr["kind"] for v, fr in frames.items()}
    comparisons, from_full, prev = [], False, 0
    for h in held:
        v = h["version"]
        if h["via"] == "fetch":
            from_full, want = False, frames[v]["view"]  # a fetch installs the published view, in f32
        else:
            from_full = from_full or any(kinds.get(u) == "full" for u in range(prev + 1, v + 1))
            want = frames[v]["shadow"] if delta else frames[v]["bf16_view" if wire == "bf16" else "view"]
        prev = v
        if h["via"] == "frame" and delta and not from_full:
            continue
        comparisons.append({"version": v, "via": h["via"], "equal": h["digest"] == want,
                            "equal_fetched": h["digest"] == fetched[v] if wire == "f32" and v in fetched else None})
    kinds_list = [frames[v]["kind"] for v in sorted(frames)]
    dropped = [v for v, fr in frames.items() if fr.get("dropped")]
    checks = {
        "subscriber_views": len(comparisons) >= 2 and all(c["equal"] for c in comparisons),
        # f32 without delta: bit-equal to the fetched view; f32 delta holds the
        # shadow, which a delta brings within one rounding step of the view
        # (shadow + fl(view - shadow) rounds twice), so it is held to that
        "f32_equal_fetched": wire != "f32" or delta or (any(c["equal_fetched"] for c in comparisons)
                                                         and all(c["equal_fetched"] is not False for c in comparisons)),
        "f32_delta_within_a_step": wire != "f32" or not delta
                                   or max(fr["shadow_vs_view_steps"] for fr in frames.values()) <= 1.0,
        "fetched_equal_published": all(fetched[v] == frames[v]["view"] for v in fetched if v in frames),
        "one_sync_a_publish": {p["syncs"] for p in publishes} == {1},
        "delta_frames": not delta or "delta" in kinds_list,
        "discovery_retracted": not os.path.exists(os.path.join(folder, "param_server.json")),
    }
    if drop_at is not None:
        after = [frames[v]["kind"] for v in sorted(frames) if v > min(dropped, default=10**9)]
        checks.update({"dropped_one": len(dropped) == 1, "rekeyed_full_after_drop": bool(after) and after[0] == "full",
                       "rekeys": final.get("param/rekeys", 0.0) >= 1.0})
    full_bytes = [fr["bytes"] for fr in frames.values() if fr["kind"] == "full"]
    delta_bytes = [fr["bytes"] for fr in frames.values() if fr["kind"] == "delta"]
    result = {
        "wire": wire, "delta": delta, "drop_at": drop_at, "iterations": len(publishes), "checks": checks,
        "frames": len(frames), "full_frames": kinds_list.count("full"), "delta_frames": kinds_list.count("delta"),
        "kinds": kinds_list, "rekeys": final.get("param/rekeys"), "dropped_versions": dropped,
        "bytes_full_frame": statistics.median(full_bytes) if full_bytes else None,
        "bytes_delta_frame": statistics.median(delta_bytes) if delta_bytes else None,
        "publish_ms_p50": statistics.median(p["ms"] for p in publishes),
        "publisher_ms_p50": statistics.median(p["publisher_ms"] for p in publishes),
        "publish_ms": [p["ms"] for p in publishes], "syncs": [p["syncs"] for p in publishes],
        "subscriber": gauges, "held": [(h["version"], h["via"]) for h in held], "comparisons": comparisons,
        "shadow_vs_view_elems": [frames[v]["shadow_vs_view_elems"] for v in sorted(frames)],
        "shadow_vs_view_steps": [frames[v]["shadow_vs_view_steps"] for v in sorted(frames)],
        "float_elems": max((fr["float_elems"] for fr in frames.values()), default=None),
        "fetched_versions": sorted(fetched), "wait_for_subscriber_s": waited[0] if waited else None,
        "launches": None, "final_param": {k: v for k, v in final.items() if k.startswith("param/")},
    }
    if not all(checks.values()):
        emit({"phase": "fanout", "step": tag, "failed": result})
        raise AssertionError(f"{tag} checks failed: {checks}")
    return result


def phase_fanout(M, gae, vtrace, publish_ref_ms: float | None) -> dict:
    """The parameter fanout: the north-star (``train ppo jax:lift``) under
    three arms, f32 without delta, f32 delta and bf16 delta, then pong
    (``train impala jax:pong``, the NatureCNN, a full f32 frame of 437 KB)
    under f32 delta with one frame dropped and bf16 delta; GAE or V-trace
    once a learn. ``publish_ref_ms``: the publish p50 of the parameter
    publisher alone on the north-star (phase publish, this run)."""
    arms = [("ns_f32_full", "f32", False, None), ("ns_f32_delta", "f32", True, None),
            ("ns_bf16_delta", "bf16", True, None)]
    pong = [("pong_f32_delta_drop", "f32", True, FANOUT_DROP_AT), ("pong_bf16_delta", "bf16", True, None)]
    argvs = {tag: north_star_argv(scratch_dir(tag), FANOUT_NS_ITERS, PERF_OFF) for tag, *_ in arms}
    for tag, *_ in pong:
        argvs[tag] = ["train", "impala", "jax:pong", "--folder", scratch_dir(tag), "--num-envs", str(PONG_B),
                      "--total-steps", str(FANOUT_PONG_ITERS * PONG_B * PONG_T), "--set",
                      f"learner_config.algo.horizon={PONG_T}", "learner_config.algo.precision=mixed",
                      "learner_config.model.cnn.enabled=true", "session_config.metrics.every_n_iters=1",
                      "session_config.checkpoint.every_n_iters=1000", "session_config.eval.every_n_iters=0",
                      "session_config.metrics.console=false", "session_config.metrics.tensorboard=false",
                      PERF_OFF]
    # every subscriber starts now and waits for its session: their start-up
    # overlaps the sessions before theirs
    subscribers = {tag: start_subscriber(argv[argv.index("--folder") + 1], tag) for tag, argv in argvs.items()}
    out = {}
    try:
        for (tag, wire, delta, drop), (kernel, wrapper, iters) in (
            [(arm, ("gae", gae, FANOUT_NS_ITERS)) for arm in arms]
            + [(arm, ("vtrace", vtrace, FANOUT_PONG_ITERS)) for arm in pong]
        ):
            res, launches = count_launches({kernel: (wrapper, iters)}, lambda: fanout_session(
                M, tag, argvs[tag], subscribers[tag], wire, delta, drop))
            res["launches"] = launches
            out[tag] = res
            emit({"phase": "fanout", "step": tag, "publish_ref_ms": publish_ref_ms, **res})
    finally:
        for proc, _, _ in subscribers.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return {
        "gae": {f"fanout_{t}": out[t]["launches"]["gae"] for t, *_ in arms},
        "vtrace": {f"fanout_{t}": out[t]["launches"]["vtrace"] for t, *_ in pong},
        "arms": out,
    }


# -- the sharded experience plane ---------------------------------------------

# remote DDPG: the ddpg cell's learner settings at 8 envs x 32 steps on
# gym:Pendulum-v1, 8 updates of 256 an iteration from 100,000 rows over 2
# shards
XP_B, XP_H, XP_K, XP_BS, XP_CAPACITY, XP_SHARDS = 8, 32, 8, 256, 100_000, 2
XP_WARMUP_ITERS, XP_TIMED_ITERS = 2, 4  # cut from 2, 6 for the time limit
XP_HOT_MIN_FILL = 2 * XP_H * XP_B  # the first request misses (one chunk held), the rest hit
XP_KILL_AT = 30                    # the kill: each process shard's 31st loop pass
XP_KILL_ITERS, XP_KILL_PACING_MS = 30, 100
XP_RELAY_ITERS = (2, 4)
XP_LOSS_KEYS = ("loss/critic", "loss/actor", "health/grad_norm")


def xp_config(M, tag: str, replay: dict, overlap: bool = True, plan: list | None = None, **plane):
    """Host DDPG at the experience phase's geometry; ``replay`` completes
    its replay config, ``plane`` its topology.experience_plane."""
    algo = dict(name="ddpg", horizon=XP_H, updates_per_iter=XP_K, exploration=dict(warmup_steps=0))
    topology = M.Config(overlap_rollouts=overlap,
                        experience_plane=M.Config({"num_shards": XP_SHARDS, "shard_mode": "thread", **plane}))
    session = timed_session(M.Config, topology=topology)
    session.folder = scratch_dir(tag)
    if plan is not None:
        session.faults = M.Config(plan=plan)
    return host_config(M, algo, "gym:Pendulum-v1", XP_B, session=session,
                       replay=dict(capacity=XP_CAPACITY, start_sample_size=XP_BS, batch_size=XP_BS, **replay))


def xp_run(M, RR, tag: str, replay: dict, gathers: int, iters: tuple[int, int] = (XP_WARMUP_ITERS, XP_TIMED_ITERS),
           env_source: dict | None = None, **kw) -> dict:
    """One host DDPG run on the card (``timed_run``), the replay gather
    kernel launched exactly ``gathers`` times in it; its timing, the
    experience gauges of its last metrics row, and the plane's last
    ``experience_plane`` and ``experience_close`` events."""
    cfg = xp_config(M, tag, replay, **kw)
    trainer = M.OffPolicyTrainer(cfg)
    (state, timing), launches = count_launches({"replay_gather": (RR.gather_rows, gathers)},
                                               lambda: timed_run(trainer, {}, *iters))
    trainer.env.close()
    m = timing["metrics"]
    events = session_events(cfg.session_config.folder, M.iter_jsonl)
    planes = [e for e in events if e["type"] == "experience_plane"]
    closes = [e for e in events if e["type"] == "experience_close"]
    result = {
        "phase": "experience", "path": tag, "folder": cfg.session_config.folder, "env": "gym:Pendulum-v1",
        "env_source": (env_source or {}).get("gym:Pendulum-v1"), "replay": replay, "num_envs": XP_B, "horizon": XP_H, "updates_per_iter": XP_K,
        "batch_size": XP_BS, "capacity": XP_CAPACITY, "iter_ms_median": timing["iter_ms_median"],
        "env_steps_per_s": timing["env_steps_per_s"], "iter_ms": timing["iter_ms"],
        "first_iter_ms": timing["first_iter_ms"], "peak_mem_gb": timing["peak_mem_gb"],
        "replay_gather_launches": launches["replay_gather"],
        "span_ms_last": timing["span_ms"][-1],
        "final": {k: m.get(k) for k in XP_LOSS_KEYS},
        "experience": {k: v for k, v in m.items() if k.startswith(("experience/", "tier/"))},
        "plane_event": {k: planes[-1].get(k) for k in ("transports", "sender", "sampler", "shards", "tiers")}
        if planes else None,
        "close": {k: v for k, v in closes[-1].items() if k not in ("type", "t", "trace", "seq")} if closes else None,
        # the shards' own rows in the session's last ops snapshot
        "ops_shards": {name: {"dead": row.get("dead"), "age_s": row.get("age_s")}
                       for name, row in (load_snapshot_of(cfg.session_config.folder).get("tiers") or {}).items()
                       if name.startswith("experience.shard")},
    }
    emit(result)
    return result


def check_hot_gather(M, RR, example: dict) -> dict:
    """The hot tier's draw and gather at the hot path's rows (the
    trainer's replay leaves in a 100,000-row device ring, 256 rows a
    draw): 8 draws under torch.cuda.set_sync_debug_mode("error") (no host
    sync), one gather launch each, each bit-equal to UniformReplay.sample
    from a generator seeded the same way and to the gather's plain version
    on the same indices; the draw and the gather timed against the plain
    version and index_select per leaf."""
    from surreal_tpu_torch.replay.tiers import HotTier
    from surreal_tpu_torch.replay.uniform import UniformReplay

    gen = torch.Generator(device="cuda").manual_seed(21)
    hot = HotTier(capacity=XP_CAPACITY, batch_size=XP_BS, example=example)
    replay = UniformReplay(M.Config(capacity=XP_CAPACITY, batch_size=XP_BS, start_sample_size=XP_BS))
    state = replay.init(example)
    for _ in range(4):
        rows = {k: torch.randn((XP_CAPACITY // 3, *v.shape), generator=gen, device="cuda").to(v.dtype)
                for k, v in example.items()}
        hot.append(rows)
        state = replay.insert(state, rows)
    seeds = list(range(100, 108))
    torch.cuda.synchronize()
    RR.gather_rows.launches = 0
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = [hot.sample(s) for s in seeds]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    launches = RR.gather_rows.launches
    if launches != len(seeds):
        raise AssertionError(f"hot tier: {launches} gather launches for {len(seeds)} draws")
    max_abs = 0.0
    for s, batch in zip(seeds, got):
        _, want, info = replay.sample(state, torch.Generator(device="cuda").manual_seed(s))
        plain = RR.gather_rows_plain(hot._state.storage, info["idx"])
        for k in want:
            if not (torch.equal(batch[k], want[k]) and torch.equal(batch[k], plain[k])):
                raise AssertionError(f"hot tier sample != UniformReplay / plain gather for leaf {k}")
            max_abs = max(max_abs, float((batch[k].double() - plain[k].double()).abs().max()))
    idx = torch.randint(0, XP_CAPACITY, (XP_BS,), generator=gen, device="cuda", dtype=torch.int32)
    leaves = hot._state.storage
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")
    row_bytes = sum(x[0].numel() * x.element_size() for x in leaves.values())
    result = {
        "phase": "kernels", "kernel": "replay_gather", "path": "xp_hot_pendulum", "draws": len(seeds),
        "launches": launches, "sync_debug_mode": "error", "tolerance": "exact (0)", "max_abs_err": max_abs,
        "row_bytes": row_bytes, "capacity": XP_CAPACITY, "rows": XP_BS,
        "sample_ms": time_cuda_ms(lambda: hot.sample(7), runs=30, flush=flush, spin=True),
        "ms": time_cuda_ms(lambda: RR.gather_rows(leaves, idx), runs=30, flush=flush, spin=True),
        "plain_ms": time_cuda_ms(lambda: RR.gather_rows_plain(leaves, idx), runs=30, flush=flush, spin=False),
        "library_ms": sum(time_cuda_ms(lambda x=x: x.index_select(0, idx), runs=30, flush=flush, spin=True)
                          for x in leaves.values()),
        "bound_ms": (2 * XP_BS * row_bytes + idx.numel() * idx.element_size()) / H100_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
    }
    emit(result)
    return result


def compute_app_pids() -> list[int] | None:
    """The pids nvidia-smi lists with a CUDA context (None if it cannot
    say)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    if out.returncode != 0:
        return None
    return [int(x) for x in out.stdout.split() if x.strip().isdigit()]


def xp_respawn(M, RR, env_source: dict) -> dict:
    """Uniform remote DDPG on 2 process shards with a ``kill_shard`` fault:
    the plan reaches each shard on its first spawn, so both die at their
    31st loop pass and are respawned at their addresses while the learner
    waits; iterations paced at 100 ms. Checks: respawns >= 1 and 2 shards
    live at the end, finite training past the kills, no
    /dev/shm/surreal_pt_xp_* left, and no shard process with a CUDA
    context (their stats, and nvidia-smi's compute apps during the run)."""
    import glob

    from surreal_tpu_torch.experience.plane import ExperiencePlane

    pids, listed = [], set()
    done = threading.Event()

    def recording(spawn):
        def spawn_shard(self, i):
            w = spawn(self, i)
            pids.append(w.pid)
            return w
        return spawn_shard

    def watch_compute_apps():
        # which processes hold a CUDA context while the shards run
        while not done.wait(1.0):
            got = compute_app_pids()
            if got is not None:
                listed.update(got)

    plan = [{"site": "experience.shard", "kind": "kill_shard", "at": XP_KILL_AT},
            {"site": "trainer.iteration", "kind": "delay", "at": 0, "times": 10_000, "ms": XP_KILL_PACING_MS}]
    watcher = threading.Thread(target=watch_compute_apps, daemon=True)
    watcher.start()
    try:
        with Patched(ExperiencePlane, "_spawn_shard", recording):
            res = xp_run(M, RR, "xp_respawn_process", dict(kind="remote", remote_kind="uniform"), 0,
                         iters=(2, XP_KILL_ITERS - 2), env_source=env_source, plan=plan, shard_mode="process",
                         transport="shm", ack_timeout_s=0.5, sample_timeout_s=1.0, watermark_timeout_s=0.5,
                         respawn_backoff_s=0.05)
    finally:
        done.set()
        watcher.join()
    xp = res["experience"]
    shards = (res["plane_event"] or {}).get("shards") or {}
    residue = glob.glob("/dev/shm/surreal_pt_xp_*")
    checks = {
        "respawned": xp.get("experience/respawns", 0.0) >= 1.0,
        "shards_live": xp.get("experience/shards_live") == float(XP_SHARDS),
        "trained": all(math.isfinite(res["final"][k]) for k in XP_LOSS_KEYS),
        "no_slab_residue": not residue,
        "shards_never_opened_the_card": bool(shards) and all(s.get("cuda_initialized") is False
                                                            for s in shards.values()),
        "no_shard_in_compute_apps": not set(pids) & listed,
        "process_shards_in_ops_snapshot": sorted(res["ops_shards"]) == [f"experience.shard{i}"
                                                                        for i in range(XP_SHARDS)],
    }
    out = {"phase": "experience", "path": "xp_respawn_checks", "shard_pids": pids, "compute_apps": sorted(listed),
           "trainer_pid": os.getpid(), "residue": residue, "checks": checks}
    emit(out)
    if not all(checks.values()):
        raise AssertionError(f"experience respawn checks failed: {checks}")
    return res


def phase_experience(M, RR, ops_gae, ops_vtrace, RS, env_source: dict) -> dict:
    """The sharded experience plane on the card: uniform remote DDPG over
    thread shards on shm, tcp and pickle in turns with the in-process host
    DDPG (A, shm, tcp, pickle, A); the strict loop twice (equal final
    losses and grad norm); prioritized shards (one PRIO frame per shard
    per iteration that learned); the hot tier (the gather kernel once per
    update on a hit, its first request a counted miss) beside its
    warm-only strict run; process shards killed by a fault and respawned;
    SEED through the relay (IMPALA CartPole, PPO cheetah; V-trace or GAE
    once a learn). Returns each kernel's launches by path."""
    iters = XP_WARMUP_ITERS + XP_TIMED_ITERS
    uniform = dict(kind="remote", remote_kind="uniform")
    runs = {}
    for tag, replay, gathers, plane in (
        ("xp_inproc_a", dict(kind="uniform"), XP_K * iters, {}),
        ("xp_remote_shm", uniform, 0, dict(transport="shm")),
        ("xp_remote_tcp", uniform, 0, dict(transport="tcp")),
        ("xp_remote_pickle", uniform, 0, dict(transport="pickle")),
        ("xp_inproc_b", dict(kind="uniform"), XP_K * iters, {}),
    ):
        runs[tag] = xp_run(M, RR, tag, replay, gathers, env_source=env_source, **plane)
        if tag.startswith("xp_remote"):
            got = runs[tag]["experience"]
            transports = runs[tag]["plane_event"]["transports"]
            if got["experience/dropped_rows"] != 0.0 or transports != [plane["transport"]] * XP_SHARDS:
                raise AssertionError(f"{tag}: dropped {got['experience/dropped_rows']}, transports {transports}")
            shards = runs[tag]["ops_shards"]
            if sorted(shards) != [f"experience.shard{i}" for i in range(XP_SHARDS)] or any(
                    r["dead"] for r in shards.values()):
                raise AssertionError(f"{tag}: the ops snapshot's shard rows {shards}")
    strict = [xp_run(M, RR, f"xp_strict_{i}", uniform, 0, env_source=env_source, overlap=False, transport="shm")
              for i in range(2)]
    equal = {k: strict[0]["final"][k] == strict[1]["final"][k] for k in XP_LOSS_KEYS}
    emit({"phase": "experience", "path": "xp_strict_determinism", "equal": equal,
          "finals": [s["final"] for s in strict]})
    if not all(equal.values()):
        raise AssertionError(f"strict remote runs differ: {[s['final'] for s in strict]}")
    prio = xp_run(M, RR, "xp_remote_prioritized", dict(kind="remote", remote_kind="prioritized"), 0,
                  env_source=env_source, transport="shm")
    prio_frames = prio["plane_event"]["sampler"]["prio_frames"]
    if prio_frames != XP_SHARDS * (iters - 1):
        raise AssertionError(f"prioritized: {prio_frames} PRIO frames, expected {XP_SHARDS * (iters - 1)}")
    hot = xp_run(M, RR, "xp_hot_pendulum", dict(uniform, tiers=dict(hot=dict(
        enabled=True, capacity=XP_CAPACITY, min_fill=XP_HOT_MIN_FILL))), XP_K * (iters - 1),
        env_source=env_source, overlap=False, transport="shm")
    tier = hot["experience"]
    if tier["tier/hot_hits"] != XP_K * (iters - 1) or tier["tier/hot_misses"] != XP_K:
        raise AssertionError(f"hot tier: hits {tier['tier/hot_hits']}, misses {tier['tier/hot_misses']}")
    emit({"phase": "experience", "path": "xp_hot_vs_warm", "hot_sample_wait_ms": tier["experience/sample_wait_ms"],
          "warm_sample_wait_ms": [s["experience"]["experience/sample_wait_ms"] for s in strict],
          "hot_iter_ms_median": hot["iter_ms_median"], "warm_iter_ms_median": [s["iter_ms_median"] for s in strict],
          "hits": tier["tier/hot_hits"], "misses": tier["tier/hot_misses"],
          "gather_launches": hot["replay_gather_launches"]})
    trainer = M.OffPolicyTrainer(xp_config(M, "xp_hot_example", dict(uniform)))
    hot_check = check_hot_gather(M, RR, trainer._replay_example())
    trainer.env.close()
    respawn = xp_respawn(M, RR, env_source)
    gae = {"gae": (ops_gae.gae_advantages_masked, 1), "rev_scan": (RS.reverse_linear_scan, 0)}
    vtrace = {"vtrace": (ops_vtrace.vtrace_fused, 1), "rev_scan": (RS.reverse_linear_scan, 0)}
    relay = dict(enabled=True, num_shards=XP_SHARDS, shard_mode="thread", transport="tcp")
    impala = phase_seed_train(M, "seed_relay_impala_cartpole", dict(name="impala", horizon=CARTPOLE_T,
                                                                    precision="mixed"),
                              "gym:CartPole-v1", 2, SEED_CARTPOLE_ENVS, "thread", vtrace, env_source,
                              phase="experience", iters=XP_RELAY_ITERS, xp=relay)
    ppo = phase_seed_train(M, "seed_relay_ppo_cheetah", dict(name="ppo", horizon=CHEETAH_T, epochs=4,
                                                             num_minibatches=4, precision="mixed"),
                           "dm_control:cheetah-run", 2, SEED_PPO_ENVS, "thread", gae, env_source,
                           phase="experience", iters=XP_RELAY_ITERS, xp=relay)
    for res in (impala, ppo):
        rows = res["metrics"].get("experience/rows", 0.0)
        if not rows or res["metrics"].get("experience/dropped_rows") != 0.0:
            raise AssertionError(f"{res['path']}: relay rows {rows}, dropped {res['metrics'].get('experience/dropped_rows')}")
    return {
        "replay_gather": {"xp_inproc_a": runs["xp_inproc_a"]["replay_gather_launches"],
                          "xp_inproc_b": runs["xp_inproc_b"]["replay_gather_launches"],
                          "xp_hot_pendulum": hot["replay_gather_launches"]},
        "replay_gather_check": hot_check,
        "gae": {"seed_relay_ppo_cheetah": ppo["gae_launches"]},
        "vtrace": {"seed_relay_impala_cartpole": impala["vtrace_launches"]},
        "runs": {**runs, "strict": strict, "prioritized": prio, "hot": hot, "respawn": respawn},
    }


# -- the disk spill tier and replay from its log ----------------------------------

SPILL_FAULT_ITERS = (1, 3)  # warm-up and timed iterations of each fault run


def spill_on_disk(folder: str) -> dict:
    """The spill log under ``folder``/spill as the port's reader sees it."""
    from surreal_tpu_torch.experience.spill import SpillLog

    d = os.path.join(folder, "spill")
    log = SpillLog(d)
    sizes = [n for _h, _rows, n in log.segments()]
    return {"dir": d, "files": sorted(os.listdir(d)), "segments": len(sizes), "rows": sum(sizes), "sizes": sizes,
            "bytes": sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d)),
            "torn_segments": log.torn_segments}


def spill_gauges(run: dict) -> dict:
    return {k: v for k, v in run["experience"].items() if k.startswith("tier/spill") or k == "tier/cold_bytes_per_row"}


def replay_log(M, RR, trainer, log_dir: str, sizes: list[int], check: bool) -> dict:
    """``trainer.replay_from_log(log_dir)`` on the card, fenced and timed,
    the gather kernel launched once per update (the updates the log's
    segment sizes give); with ``check``, every gather also held against
    its plain version on the same ring and indices, exactly."""
    import surreal_tpu_torch.replay.base as replay_base

    cfg = trainer.learner.config.replay
    size, updates = 0, 0
    for n in sizes:
        size = min(size + n, int(cfg.capacity))
        updates += int(trainer.algo.updates_per_iter) if size >= int(cfg.start_sample_size) else 0
    errs = []

    def checking(gather):
        def gather_rows(leaves, idx):
            out = gather(leaves, idx)
            plain = RR.gather_rows_plain(leaves, idx)
            errs.append(max(float((out[k].double() - plain[k].double()).abs().max()) if out[k].numel() else 0.0
                            for k in out))
            return out
        return gather_rows

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if check:
        with Patched(replay_base, "gather_rows", checking):
            out, launches = count_launches({"replay_gather": (RR.gather_rows, updates)},
                                           lambda: trainer.replay_from_log(log_dir))
    else:
        out, launches = count_launches({"replay_gather": (RR.gather_rows, updates)},
                                       lambda: trainer.replay_from_log(log_dir))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if out["updates"] != updates:
        raise AssertionError(f"replay_from_log ran {out['updates']} updates, the log gives {updates}")
    return {"updates": out["updates"], "rows": out["rows"], "segments": out["segments"],
            "torn_segments": out["torn_segments"], "params_digest": out["params_digest"],
            "gather_launches": launches["replay_gather"], "seconds": seconds, "ms_per_update": seconds * 1e3 / updates,
            "checked_gathers": len(errs), "max_abs_err": max(errs) if errs else 0.0, "metrics": out["metrics"]}


def phase_spill(M, RR, env_source: dict) -> dict:
    """The disk spill tier on the card: remote DDPG at the experience
    phase's geometry (fixture gym:Pendulum-v1, 8 envs x 32 steps, 8
    updates of 256 from 100,000 rows over 2 thread shards, the hot tier
    on, strict loop) with ``replay.tiers.spill`` on: one log a shard under
    the session folder, the ``tier/spill_*`` gauges equal to the segments,
    rows and bytes on disk, no error, no tear, the hot tier's gathers once
    a hit; a run with an ``experience.spill`` ``enospc`` plan (3 appends
    fail: counted, the log without them, training on) and one with
    ``truncate_segment`` (the tear skipped and counted by the reader);
    then ``OffPolicyTrainer.replay_from_log`` twice over the first run's
    log on the card: equal digests, the gather kernel once per update, and
    in the second every gather bit-equal to its plain version."""
    iters = XP_WARMUP_ITERS + XP_TIMED_ITERS
    uniform = dict(kind="remote", remote_kind="uniform")
    hot = dict(enabled=True, capacity=XP_CAPACITY, min_fill=XP_HOT_MIN_FILL)
    run = xp_run(M, RR, "spill_hot_pendulum", dict(uniform, tiers=dict(hot=hot, spill=dict(enabled=True))),
                 XP_K * (iters - 1), env_source=env_source, overlap=False, transport="shm")
    disk, g = spill_on_disk(run["folder"]), run["experience"]
    checks = {
        "files": disk["files"] == [f"shard{i}.log" for i in range(XP_SHARDS)],
        "segments": g["tier/spill_segments"] == disk["segments"] > 0,
        "rows": g["tier/spill_rows"] == disk["rows"] == g["experience/rows"],
        "bytes": g["tier/spill_bytes"] == disk["bytes"],
        "no_errors": g["tier/spill_errors"] == 0.0 and g["tier/spill_failed"] == 0.0,
        "no_tear": disk["torn_segments"] == 0,
        "hot_hits": g["tier/hot_hits"] == XP_K * (iters - 1),
    }
    faulted = {}
    for kind, at, times in (("enospc", 2, 3), ("truncate_segment", 3, 1)):
        res = xp_run(M, RR, f"spill_{kind}", dict(uniform, tiers=dict(spill=dict(enabled=True))), 0,
                     iters=SPILL_FAULT_ITERS, env_source=env_source, overlap=False, transport="shm",
                     plan=[{"site": "experience.spill", "kind": kind, "at": at, "times": times}])
        fd, fg = spill_on_disk(res["folder"]), res["experience"]
        faulted[kind] = {"gauges": spill_gauges(res), "disk": {k: v for k, v in fd.items() if k != "sizes"},
                         "final": res["final"], "iter_ms_median": res["iter_ms_median"]}
        checks[f"{kind}_trained"] = all(math.isfinite(v) for v in res["final"].values())
        checks[f"{kind}_segments"] = fg["tier/spill_segments"] == fd["segments"] > 0
        if kind == "enospc":
            checks["enospc_counted"] = fg["tier/spill_errors"] == float(times) and fg["tier/spill_failed"] == 0.0
            checks["enospc_rows_missing"] = fd["rows"] < fg["experience/rows"] and fd["torn_segments"] == 0
        else:
            checks["truncate_torn_counted"] = fd["torn_segments"] >= 1 and fg["tier/spill_errors"] == 0.0
    trainer = M.OffPolicyTrainer(xp_config(M, "spill_replay", dict(uniform)))
    trainer.env.close()
    replays = [replay_log(M, RR, trainer, disk["dir"], disk["sizes"], check) for check in (False, True)]
    checks["replay_digests_equal"] = replays[0]["params_digest"] == replays[1]["params_digest"]
    checks["replay_rows"] = all(r["rows"] == disk["rows"] and r["torn_segments"] == 0 for r in replays)
    checks["replay_gather_exact"] = replays[1]["checked_gathers"] == replays[1]["updates"] and replays[1][
        "max_abs_err"] == 0.0
    out = {"phase": "spill", "path": "spill_checks", "run": {"gauges": spill_gauges(run), "disk": {
        k: v for k, v in disk.items() if k != "sizes"}, "iter_ms_median": run["iter_ms_median"],
        "gather_launches": run["replay_gather_launches"]}, "faulted": faulted,
        "replay_from_log": replays, "checks": checks}
    emit(out)
    if not all(checks.values()):
        raise AssertionError(f"spill checks failed: {checks}")
    return {
        "replay_gather": {"spill_hot_pendulum": run["replay_gather_launches"],
                          "spill_replay_from_log": replays[0]["gather_launches"] + replays[1]["gather_launches"]},
        "max_abs_err": replays[1]["max_abs_err"],
    }


# -- the session gateway behind the fleet -----------------------------------------

GATEWAY_ITERS = 80        # learns of the gateway run (IMPALA CartPole, chunks [32, 8]), 2 of them warm-up
GATEWAY_WARM_LEARNS = 3   # learns before the load starts (the first ones count costs and warm the card up)
GATEWAY_PACING_MS = 200   # each learn at least this long: the run outlasts the load
GATEWAY_LOAD_S = 10.0     # the load generator's run, from the discovery file's appearance
GATEWAY_KILL_AT_S = 5.0   # the gateway.session kill_replica, this far into the load
GATEWAY_PROBE_HZ = 50     # the probe session's acts a second


def phase_gateway(M, vtrace, RS, env_source: dict) -> dict:
    """The session gateway on the card: ``train impala gym:CartPole-v1``
    (fixture) with 2 thread workers behind 2 replicas and
    ``topology.gateway.enabled``, each learn paced to at least 200 ms. A
    tenant side, as a user runs it, finds the gateway through
    ``<folder>/gateway.json`` and, once the run has learned 3 times,
    drives it with ``LoadGenerator(default_mix())`` (2 steady tenants, an
    attach storm, a hot key, act bursts and hostile frames) for 10 s
    beside a probe
    session timing its own round trips; 5 s in, a ``gateway.session``
    ``kill_replica``. Checks: every session the killed replica held
    migrated (the migrations gauge equals them, none left on a dead
    replica after the heal), no tenant thread died or timed out, the
    hostile frames counted and the serve thread never respawned, the
    replica respawned in place, V-trace once a learn, the discovery file
    gone at the end. Prints the act round trip p50/p99 server-side and on
    the probe, the load generator's mean, acts/s and cache hits."""
    from surreal_tpu_torch.gateway import GatewaySession, GatewayServer
    from surreal_tpu_torch.gateway.loadgen import LoadGenerator, default_mix
    from surreal_tpu_torch.utils import faults

    folder = scratch_dir("gateway")
    pace = [{"site": "trainer.iteration", "kind": "delay", "at": 0, "times": 10**6, "ms": GATEWAY_PACING_MS}]
    cfg = seed_config(M, dict(name="impala", horizon=CARTPOLE_T, precision="mixed"), "gym:CartPole-v1", 2,
                      SEED_CARTPOLE_ENVS, "thread", fleet=dict(replicas=2, respawn_backoff_s=0.05))
    cfg.session_config.folder = folder
    cfg.session_config.faults = M.Config(plan=pace)
    topo = cfg.session_config.topology
    topo.gateway.enabled = True
    topo.worker_silence_s = 5.0  # the killed replica's workers respawn against a survivor
    topo.respawn_backoff_s = 0.05
    # the kill's incident may scale the fleet up (phase ops holds that):
    # this phase holds the migrations onto the 2 replicas
    cfg.session_config.remediate = M.Config(enabled=False)
    trainer = M.SEEDTrainer(cfg)
    tenant = {}
    kills, heals = [], []

    def recording_fault(apply):
        def apply_fault(self, f):
            if f["kind"] == "kill_replica":
                # the acting session's replica: the probe's, so the victim
                # holds at least one long-lived session
                self._last_replica = tenant["probe_replica"]
                before = [(r.tenant, r.replica) for r in self.table.records()]
            apply(self, f)
            if f["kind"] == "kill_replica":
                victim = tenant["probe_replica"]
                srv = self.fleet._replicas[victim]
                deadline = time.monotonic() + 10
                while srv.alive and time.monotonic() < deadline:
                    time.sleep(0.01)  # a serve thread mid-forward ends after close's join
                kills.append({"at_s": time.monotonic() - tenant["t0"], "dead": [] if srv.alive else [victim],
                              "sessions_on_dead": sum(1 for _, r in before if r == victim),
                              "tenants_on_dead": sorted(t for t, r in before if r == victim),
                              "sessions": len(before), "migrations_before": self.table.migrations})
        return apply_fault

    def recording_heal(heal):
        def heal_after_kill(self, sock):
            heal(self, sock)
            if kills and not heals:
                # the first heal after the kill: no session left on a dead replica
                heals.append(sum(1 for r in self.table.records() if r.replica in kills[0]["dead"]))
        return heal_after_kill

    def tenant_side():
        try:
            path = os.path.join(folder, "gateway.json")
            deadline = time.monotonic() + 300
            while not os.path.exists(path):
                if time.monotonic() > deadline:
                    raise TimeoutError("no gateway.json")
                time.sleep(0.05)
            with open(path) as f:
                address = json.load(f)["address"]
            while len(learns) < GATEWAY_WARM_LEARNS:  # the load meets a warm run, as a live deployment's would
                if time.monotonic() > deadline:
                    raise TimeoutError("the run never learned")
                time.sleep(0.05)
            gen = LoadGenerator(address, tenants=default_mix(), obs_shape=(1, 4), timeout_s=10.0, retries=5)
            probe = GatewaySession(address, tenant="probe", obs_shape=(1, 4), timeout_s=10.0, retries=5)
            tenant["probe_replica"] = probe.replica
            rng = np.random.default_rng(7)
            rtt = []
            gen.start()
            t0 = tenant["t0"] = time.monotonic()
            tenant["window"] = [time.perf_counter()]
            while time.monotonic() - t0 < GATEWAY_LOAD_S:
                if not kills and not tenant.get("kill_at") and time.monotonic() - t0 >= GATEWAY_KILL_AT_S:
                    tenant["kill_at"] = time.monotonic() - t0
                    faults.configure(pace + [{"site": "gateway.session", "kind": "kill_replica", "at": 0}])
                a = time.perf_counter()
                probe.act(rng.standard_normal((1, 4)).astype(np.float32))
                rtt.append((time.perf_counter() - a) * 1e3)
                time.sleep(1.0 / GATEWAY_PROBE_HZ)
            tenant["report"] = gen.stop()
            tenant["window"].append(time.perf_counter())
            tenant["load_s"] = time.monotonic() - t0
            tenant["probe_ms"] = rtt
            probe.close()
        except Exception as e:  # raised on the main thread after the run
            tenant["error"] = f"{type(e).__name__}: {e}"

    learns = []  # (host clock at the call, the learn's dispatch ms)
    learn = trainer._learn

    def timed_learn(*args, **kwargs):
        t = time.perf_counter()
        out = learn(*args, **kwargs)
        learns.append((t, (time.perf_counter() - t) * 1e3))
        return out

    trainer._learn = timed_learn
    watcher = threading.Thread(target=tenant_side, daemon=True)
    watcher.start()
    counters = {"vtrace": (vtrace, 1), "rev_scan": (RS.reverse_linear_scan, 0)}
    with Patched(GatewayServer, "_apply_fault", recording_fault), Patched(GatewayServer, "_heal", recording_heal):
        _, timing = timed_run(trainer, counters, 2, GATEWAY_ITERS - 2)
    watcher.join(timeout=60)
    if "error" in tenant or "report" not in tenant:
        raise AssertionError(f"gateway tenant side failed: {tenant.get('error', 'did not finish')}")
    gateway = trainer._gateway
    g, m, rep = gateway.gauges(), timing["metrics"], tenant["report"]
    hops = gateway.hop_stats()
    probe = tenant["probe_ms"]
    kill = kills[0] if kills else {}
    lo, hi = tenant["window"]
    under = [ms for t, ms in learns[2:] if lo <= t <= hi]
    after = [ms for t, ms in learns[2:] if t > hi]
    checks = {
        "kill_fired": len(kills) == 1 and len(kill["dead"]) == 1 and kill["sessions_on_dead"] >= 1
        and kill["at_s"] < GATEWAY_LOAD_S,
        "every_session_migrated": bool(kills) and g["gateway/migrations"] == kill["sessions_on_dead"] + kill[
            "migrations_before"] and heals == [0],
        "no_tenant_died": all(t["error"] is None for t in rep["tenants"].values()),
        "no_timeouts": rep["loadgen/timeouts"] == 0.0,
        "served": rep["loadgen/acts"] > 0 and g["gateway/acts"] > 0 and g["gateway/cache_hits"] > 0,
        "hostile_counted": rep["loadgen/hostile_frames"] > 0 and g["gateway/bad_frames"] > 0,
        "serve_thread_never_died": g["gateway/respawns"] == 0.0,
        "replica_respawned": m["fleet/respawns"] >= 1.0 and m["fleet/replicas_live"] == 2.0,
        "discovery_file_gone": not os.path.exists(os.path.join(folder, "gateway.json")),
    }
    result = {
        "phase": "gateway", "path": "gateway_impala_cartpole", "env_source": env_source.get("gym:CartPole-v1"),
        "workers": 2, "replicas": 2, "chunk": [CARTPOLE_T, SEED_CARTPOLE_ENVS // 2], "learns": GATEWAY_ITERS,
        "pacing_ms": GATEWAY_PACING_MS, "load_s": tenant["load_s"], "kill_at_s": tenant.get("kill_at"),
        "kill": kill, "vtrace_launches": timing["vtrace_launches"],
        "learn_dispatch_ms_under_load": {"median": statistics.median(under) if under else None, "n": len(under)},
        "learn_dispatch_ms_after_load": {"median": statistics.median(after) if after else None, "n": len(after)},
        "act_ms_server": hops.get("gateway_act_ms"), "transit_ms": hops.get("gateway_transit_ms"),
        "attach_ms": hops.get("gateway_attach_ms"),
        "act_ms_probe": {"p50": float(np.percentile(probe, 50)), "p99": float(np.percentile(probe, 99)),
                         "n": len(probe)},
        "act_ms_loadgen_mean": rep["loadgen/act_rtt_ms"], "acts_per_s": rep["loadgen/acts"] / tenant["load_s"],
        "gateway": g, "loadgen": rep, "fleet": {k: v for k, v in m.items() if k.startswith(("fleet/", "workers/"))},
        "checks": checks,
    }
    emit(result)
    if not all(checks.values()):
        raise AssertionError(f"gateway checks failed: {checks}")
    return {"vtrace": {"gateway_impala_cartpole": timing["vtrace_launches"]}}


# -- the ops plane and its control loop -------------------------------------------

OPS_TOTAL_STEPS = 1200     # the reference's acceptance run (tests/test_remediate.py:501-612)
OPS_KILL_AT = 40           # its fleet.replica kill_replica, the 41st serve-loop turn of the two replicas
OPS_WATCHDOG = dict(warmup=4, sustain=1, mad_k=3.0, min_rel=0.2, close_windows=6, capture_cooldown_s=0.0)
OPS_REMEDIATE = dict(cooldown_s=0.5, verify_windows=2)
OPS_TURN_ITERS = (1, 2)    # warm-up and timed iterations of each north-star turn, ops on and off (cut from 1, 3)
OPS_OFF = dict(ops=dict(enabled=False), slo=dict(enabled=False), watchdog=dict(enabled=False),
               remediate=dict(enabled=False))


def pct(xs: list[float], q: float) -> float | None:
    return float(np.percentile(xs, q)) if xs else None


def timed_sweeps(M):
    """Patches that time, at every metrics cadence, the watchdog's sweep
    with the incident observe (their sum a cadence) and the whole ops
    sweep (the learner's row, the snapshot and its file, the watchdog,
    the incidents, remediation), and each flight-recorder dump (an
    incident's opening writes one); the lists they fill."""
    from surreal_tpu_torch.session.incidents import IncidentEngine
    from surreal_tpu_torch.session.opsplane import FlightRecorder
    from surreal_tpu_torch.session.watchdog import Watchdog

    got = {"watchdog_ms": [], "observe_ms": [], "ops_sweep_ms": [], "flightrec_dump_ms": []}

    def timing(key):
        def wrap(orig):
            def timed(*a, **kw):
                t = time.perf_counter()
                try:
                    return orig(*a, **kw)
                finally:
                    got[key].append((time.perf_counter() - t) * 1e3)
            return timed
        return wrap

    patches = [Patched(Watchdog, "evaluate", timing("watchdog_ms")),
               Patched(IncidentEngine, "observe", timing("observe_ms")),
               Patched(M.SessionHooks, "_ops_sweep", timing("ops_sweep_ms")),
               Patched(FlightRecorder, "dump", timing("flightrec_dump_ms"))]
    return patches, got


def sweep_stats(got: dict) -> dict:
    both = [a + b for a, b in zip(got["watchdog_ms"], got["observe_ms"])]
    return {"cadences": len(both),
            "watchdog_and_observe_ms": {"p50": pct(both, 50), "p99": pct(both, 99), "max": max(both, default=None),
                                        "over_1ms": sum(1 for ms in both if ms > 1.0)},
            "ops_sweep_ms": {"p50": pct(got["ops_sweep_ms"], 50), "p99": pct(got["ops_sweep_ms"], 99)},
            "flightrec_dump_ms": got["flightrec_dump_ms"]}


def ops_acceptance(M, vtrace, env_source: dict) -> dict:
    """tests/test_remediate.py's acceptance run on the card: ``train
    impala`` on the fixture gym:CartPole-v1 (horizon 8, 4 envs a worker),
    2 thread workers behind 2 replicas and the gateway with the ``hotkey``
    quota, 1200 env steps, metrics every iteration, that test's watchdog
    and remediate knobs, a ``fleet.replica`` ``kill_replica`` at 40, and
    ``LoadGenerator`` traffic from a steady and a hot-key tenant. Checks:
    an incident whose top cause is the fleet; a ``fleet_scale_up``
    executed (one more replica live), journaled, in the incident's
    evidence and in ``why``'s Actions section; V-trace once a learn, one
    path call bit-equal to its plain version."""
    import surreal_tpu_torch.ops.vtrace as ops_vtrace
    from surreal_tpu_torch.gateway.loadgen import LoadGenerator
    from surreal_tpu_torch.session.incidents import incidents_report, load_incidents
    from surreal_tpu_torch.session.opsplane import load_snapshot
    from surreal_tpu_torch.session.remediate import actions_report_lines, load_actions

    folder = scratch_dir("ops")
    cfg = M.Config(
        learner_config=M.Config(algo=M.Config(name="impala", horizon=8)),
        env_config=M.Config(name="gym:CartPole-v1", num_envs=4),
        session_config=M.Config(
            folder=folder, total_env_steps=OPS_TOTAL_STEPS,
            metrics=M.Config(every_n_iters=1, tensorboard=False, console=False),
            checkpoint=M.Config(every_n_iters=0), eval=M.Config(every_n_iters=0),
            topology=M.Config(num_env_workers=2, inference_fleet=M.Config(replicas=2),
                              gateway=M.Config(enabled=True, lease_s=10.0, tenant_quotas=M.Config(
                                  hotkey=M.Config(rate=50.0, burst=20.0, queue_depth=8)))),
            watchdog=M.Config(OPS_WATCHDOG), remediate=M.Config(OPS_REMEDIATE),
            faults=M.Config(plan=[{"site": "fleet.replica", "kind": "kill_replica", "at": OPS_KILL_AT}]),
        ),
    ).extend(M.base_config())
    trainer = M.SEEDTrainer(cfg)
    gen_holder, stop = [], threading.Event()

    def traffic():
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline and not stop.is_set():
            gateway = getattr(trainer, "_gateway", None)
            if gateway is not None:
                break
            time.sleep(0.05)
        else:
            return
        gen_holder.append(LoadGenerator(
            gateway.address, tenants=[{"tenant": "steady-0", "profile": "steady", "rate_hz": 10.0},
                                      {"tenant": "hotkey", "profile": "hot_key"}],
            obs_shape=(1, 4), timeout_s=5.0, retries=3,
        ).start())
        stop.wait(300)

    learns = []
    learn = trainer._learn

    def counted_learn(*a, **kw):
        learns.append(1)
        return learn(*a, **kw)

    trainer._learn = counted_learn
    path_call = {}

    def keep_first(launch):
        def kept(inputs, clips, plan=None):
            out = launch(inputs, clips, plan)
            if not path_call:
                path_call.update(inputs=[x.detach().clone() for x in inputs], clips=clips,
                                 out=[x.clone() for x in out])
            return out
        return kept

    rows = []
    patches, sweeps = timed_sweeps(M)
    t = threading.Thread(target=traffic, daemon=True)
    t.start()
    vtrace.launches = 0
    t0 = time.perf_counter()
    try:
        with Patched(ops_vtrace, "_launch", keep_first), patches[0], patches[1], patches[2], patches[3]:
            _, final = trainer.run(on_metrics=lambda i, m: rows.append(
                (i, m.get("fleet/replicas_live"), m.get("remediation/actions", 0.0))))
    finally:
        stop.set()
        report = gen_holder[0].stop() if gen_holder else None
        t.join(timeout=15)
    seconds = time.perf_counter() - t0
    launches = vtrace.launches
    want = ops_vtrace.vtrace_fused_plain(*path_call["inputs"], *path_call["clips"])
    torch.cuda.synchronize()
    equal = all(torch.equal(g, w) for g, w in zip(path_call["out"], want))
    abs_err = max(float((g - w).abs().max()) for g, w in zip(path_call["out"], want))
    snap = load_snapshot(folder) or {}
    tiers = snap.get("tiers") or {}
    incidents, actions = load_incidents(folder), load_actions(folder)
    inc = incidents[0] if incidents else {}
    top = (inc.get("causes") or [{}])[0]
    act = next((a for a in actions if a["kind"] == "fleet_scale_up"), {})
    before = [live for _, live, n in rows if not n]
    why_actions = actions_report_lines(folder)
    why = incidents_report(folder) or ""
    checks = {
        "budget": final["time/env_steps"] >= OPS_TOTAL_STEPS,
        "served_tenants": bool(report) and report["loadgen/acts"] > 0,
        "incident_top_cause_fleet": top.get("tier") == "fleet",
        "fleet_scale_up_executed": bool(act) and final["fleet/scale_ups"] >= 1.0
        and final["fleet/replicas_live"] > (before[-1] if before else 2.0),
        "journaled": bool(act) and os.path.exists(os.path.join(folder, "telemetry", "actions",
                                                               f"action-{act.get('action')}.json")),
        "in_incident_evidence": any(a.get("kind") == "fleet_scale_up"
                                    for i in incidents for a in (i.get("evidence") or {}).get("actions") or []),
        "in_why_actions": any("fleet_scale_up" in ln for ln in why_actions)
        and "actions taken (cause -> action -> verdict)" in why,
        "vtrace_once_a_learn": launches == len(learns) and launches > 0,
        "vtrace_path_call_bit_equal": equal and list(path_call["inputs"][0].shape) == [8, 2],
    }
    result = {
        "phase": "ops", "step": "acceptance", "path": "ops_seed_impala_cartpole",
        "env_source": env_source.get("gym:CartPole-v1"), "seconds": seconds, "learns": len(learns),
        "vtrace_launches": launches,
        "vtrace_check": {"shape": list(path_call["inputs"][0].shape), "bit_equal": equal, "max_abs_err": abs_err},
        "snapshot": {"seq": snap.get("seq"), "tiers": sorted(tiers), "dead": sorted(n for n, r in tiers.items()
                                                                                 if r.get("dead"))},
        "incidents": [{"id": i["id"], "status": i["status"], "top_cause": (i.get("causes") or [{}])[0],
                       "detectors": sorted(i.get("detector_counts") or {}),
                       "evidence": {k: len(v) for k, v in (i.get("evidence") or {}).items()}} for i in incidents],
        "actions": [{k: a.get(k) for k in ("action", "incident", "kind", "detail", "baseline", "verdict", "reverted",
                                           "samples")} for a in actions],
        "replicas_live_before": before[-1] if before else None, "replicas_live_after": final["fleet/replicas_live"],
        "fleet": {k: v for k, v in final.items() if k.startswith(("fleet/", "workers/"))},
        "ops": {k: v for k, v in final.items() if k.startswith(("ops/", "slo/", "remediation/"))},
        "sweep": sweep_stats(sweeps), "why_actions": why_actions, "loadgen": report, "checks": checks,
    }
    emit(result)
    if not all(checks.values()):
        raise AssertionError(f"ops acceptance checks failed: {checks}")
    return result


def ops_on_off(M, gae, RS) -> dict:
    """The north-star PPO iteration with the ops plane and its control
    loop on (the defaults) and off (``ops``, ``slo``, ``watchdog`` and
    ``remediate`` disabled), in turns on, off, off, on; GAE once an
    iteration; the sweep's time at each cadence of the on turns."""
    counters = {"gae": (gae, 1), "rev_scan": (RS.reverse_linear_scan, 0)}
    turns = []
    patches, sweeps = timed_sweeps(M)
    for arm in ("on", "off", "off", "on"):
        folder = scratch_dir(f"ops_{arm}")
        trainer = M.Trainer(north_star_config(M, folder, perf=M.Config(enabled=False),
                                              **(OPS_OFF if arm == "off" else {})))
        with patches[0], patches[1], patches[2], patches[3]:
            _, timing = timed_run(trainer, counters, *OPS_TURN_ITERS)
        turns.append({"arm": arm, "iter_ms": timing["iter_ms"], "iter_ms_median": timing["iter_ms_median"],
                      "gae_launches": timing["gae_launches"],
                      "watchdog_evals": timing["metrics"].get("ops/watchdog_evals")})
    timed = {arm: [ms for tr in turns if tr["arm"] == arm for ms in tr["iter_ms"][OPS_TURN_ITERS[0] - 1:]]
             for arm in ("on", "off")}
    result = {
        "phase": "ops", "step": "north_star_on_off", "num_envs": MAIN_B, "horizon": MAIN_T, "turns": turns,
        "iter_ms_median": {arm: statistics.median(v) for arm, v in timed.items()},
        "iter_ms_spread": {arm: [min(v), max(v)] for arm, v in timed.items()},
        "sweep": sweep_stats(sweeps),
    }
    emit(result)
    if not all(tr["watchdog_evals"] == sum(OPS_TURN_ITERS) for tr in turns if tr["arm"] == "on"):
        raise AssertionError(f"ops on/off: the on turns did not sweep every cadence: {turns}")
    if any(tr["watchdog_evals"] is not None for tr in turns if tr["arm"] == "off"):
        raise AssertionError(f"ops on/off: an off turn swept: {turns}")
    return result


def phase_ops(M, gae, vtrace, RS, env_source: dict) -> dict:
    acceptance = ops_acceptance(M, vtrace, env_source)
    on_off = ops_on_off(M, gae, RS)
    return {"vtrace": {"ops_seed_impala_cartpole": acceptance["vtrace_launches"]},
            "gae": {f"ops_ppo_lift_{i}_{tr['arm']}": tr["gae_launches"] for i, tr in enumerate(on_off["turns"])}}


TUNE_WARMUP, TUNE_ITERS = 2, 4   # a north-star trial: 2 warm-up, 2 throwaway (search.THROWAWAY), 4 measured
TUNE_IMPALA_ITERS = 8            # the reference's 8 measured learns a trial on the IMPALA learn surface
TUNE_TURN_ITERS = (1, 3)         # warm-up and timed iterations of each default/winner turn
TUNE_CACHE_ITERS = 3             # iterations of the cache-mode train session
CHAOS_SEEDS = 3                  # seed i -> profile i % 3: one schedule a profile


def tune_search(M, argv: list[str], wrappers: dict, per_learn) -> dict:
    """``tune`` through the CLI with every kernel's launch count set to 0
    just before and read just after, and each trial's own launches, config
    and ms (``tune.search.measure_point`` wrapped). ``per_learn(point)``
    gives each kernel's launches a learn at that point: every trial must
    launch them once a learn of its warm-up, throwaway and measured
    iterations."""
    import surreal_tpu_torch.tune.search as search

    trials = []

    def wrap(measure):
        def counted(config, point, warmup, throwaway, iters, **kw):
            for w in wrappers.values():
                w.launches = 0
            ms = measure(config, point, warmup, throwaway, iters, **kw)
            trials.append({"config": dict(point), "iter_ms": ms, "learns": warmup + throwaway + iters,
                           "launches": {n: w.launches for n, w in wrappers.items()}})
            return ms
        return counted

    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    with Patched(search, "measure_point", wrap):
        row = run_cli(M, argv)
    seconds = time.perf_counter() - t0
    for t in trials:
        want = {n: per_learn(t["config"]).get(n, 0) * t["learns"] for n in wrappers}
        if t["launches"] != want:
            raise AssertionError(f"tune trial {t['config']} launched {t['launches']}, expected {want}")
    if not row["cache_hit"] and [t["iter_ms"] for t in trials] != [t["iter_ms"] for t in row["trials"]]:
        raise AssertionError("the tune CLI's trials are not the measured ones")
    return {"row": row, "trials": trials, "seconds": seconds,
            "launches": {n: sum(t["launches"][n] for t in trials) for n in wrappers}}


def tune_turn(M, point: dict, counters: dict) -> dict:
    """The north-star through ``Trainer.run`` with ``point`` pinned
    (``timed_run``: metrics every iteration); the trainer and the card's
    cached blocks are released after it."""
    import gc

    cfg = M.Config(learner_config=M.Config(algo=M.Config(point))).extend(
        north_star_config(M, scratch_dir("tune_turn"), perf=M.Config(enabled=False)))
    trainer = M.Trainer(cfg)
    _, timing = timed_run(trainer, counters, *TUNE_TURN_ITERS)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return timing


def phase_tune(M, ops_gae, ops_vtrace, RS, env_source: dict) -> dict:
    """The program autotuner on the card: ``tune ppo jax:lift`` at the
    north-star geometry over the port's space (precision, gae_impl,
    shuffle), each trial's ms and launches (GAE once a learn at 'xla', the
    reverse scan at 'assoc'); the same command again, a pure hit (nothing
    measured, nothing launched); ``train ppo jax:lift`` with
    ``algo.autotune=cache`` on the tuned cache, built with the winner, one
    ``tune`` event in its folder, rendered by ``diag``; the default point
    and the winner through ``Trainer.run`` in turns (default, winner,
    winner, default); then ``tune impala gym:CartPole-v1`` on the learn
    surface (V-trace once a learn at 'xla'). Artifacts go to a temporary
    folder."""
    wrappers = {"gae": ops_gae.gae_advantages_masked, "rev_scan": RS.reverse_linear_scan,
                "vtrace": ops_vtrace.vtrace_fused}
    artifact = os.path.join(scratch_dir("tune_out"), "tune.json")
    folder = scratch_dir("tune_ppo")
    argv = ["tune", "ppo", "jax:lift", "--folder", folder, "--num-envs", str(MAIN_B), "--set",
            f"learner_config.algo.horizon={MAIN_T}", "learner_config.algo.epochs=4",
            "learner_config.algo.num_minibatches=4", "--warmup", str(TUNE_WARMUP), "--iters", str(TUNE_ITERS),
            "--out", artifact]

    def ppo_learn(point):
        return {"gae": int(point["gae_impl"] == "xla"), "rev_scan": int(point["gae_impl"] == "assoc")}

    search = tune_search(M, argv, wrappers, ppo_learn)
    row = search["row"]
    winner, default = row["config"], row["default"]
    checks = {
        "searched": not row["cache_hit"] and row["measured"] == len(search["trials"]) >= 5,
        "port_space": set(default) == {"precision", "gae_impl", "shuffle"},
        "assoc_trial": any(t["config"]["gae_impl"] == "assoc" for t in search["trials"]),
        "on_the_card": row["platform"] == "gpu" and row["device_kind"] == torch.cuda.get_device_name(0),
    }
    emit({"phase": "tune", "step": "north_star_search", "num_envs": MAIN_B, "horizon": MAIN_T, "epochs": 4,
          "num_minibatches": 4, "warmup": TUNE_WARMUP, "iters": TUNE_ITERS, "seconds": search["seconds"],
          "trials": search["trials"], "default": default, "winner": winner, "default_ms": row["default_ms"],
          "chosen_ms": row["chosen_ms"], "speedup": row["speedup"], "launches": search["launches"],
          "checks": checks})

    hit = tune_search(M, argv, wrappers, ppo_learn)
    checks["pure_hit"] = (hit["row"]["cache_hit"] and hit["row"]["measured"] == 0 and not hit["trials"]
                          and not any(hit["launches"].values()) and hit["row"]["config"] == winner)
    emit({"phase": "tune", "step": "north_star_pure_hit", "seconds": hit["seconds"], "cache_hit": hit["row"]["cache_hit"],
          "measured": hit["row"]["measured"], "launches": hit["launches"]})

    train_folder = scratch_dir("tune_train")
    counters = {n: (wrappers[n], k * TUNE_CACHE_ITERS) for n, k in ppo_learn(winner).items()}
    t0 = time.perf_counter()
    final, launches = count_launches(counters, lambda: run_cli(M, north_star_argv(
        train_folder, TUNE_CACHE_ITERS, "learner_config.algo.autotune=cache",
        f"session_config.tuning_cache_dir={folder}/tuning_cache", PERF_OFF)))
    seconds = time.perf_counter() - t0
    events = [e for e in M.iter_jsonl(os.path.join(train_folder, "telemetry", "events.jsonl")) if e["type"] == "tune"]
    diag = "\n".join(cli_lines(M, ["diag", train_folder]))
    checks["cache_train"] = (len(events) == 1 and events[0]["hit"] is True and events[0]["mode"] == "cache"
                             and events[0]["config"] == winner and "Autotuner" in diag
                             and final["time/env_steps"] == TUNE_CACHE_ITERS * MAIN_B * MAIN_T)
    emit({"phase": "tune", "step": "cache_train", "seconds": seconds, "tune_event": events[0] if events else None,
          "diag": [ln for ln in diag.splitlines() if "Autotuner" in ln or "tune" in ln.lower()][:4],
          "launches": launches, "metrics": {k: final[k] for k in sorted(final) if k.startswith(("loss/", "time/"))}})

    turns = []
    for arm in ("default", "winner", "winner", "default"):
        point = default if arm == "default" else winner
        counters = {n: (wrappers[n], k) for n, k in ppo_learn(point).items()}
        timing = tune_turn(M, point, counters)
        turns.append({"arm": arm, "config": point, "iter_ms": timing["iter_ms"],
                      "iter_ms_median": timing["iter_ms_median"],
                      "gae_launches": timing["gae_launches"], "rev_scan_launches": timing["rev_scan_launches"]})
    arm_ms = {a: [ms for t in turns if t["arm"] == a for ms in t["iter_ms"]] for a in ("default", "winner")}
    emit({"phase": "tune", "step": "turns", "turns": turns,
          "default_range": [min(arm_ms["default"]), max(arm_ms["default"])],
          "winner_range": [min(arm_ms["winner"]), max(arm_ms["winner"])],
          "median": {a: statistics.median(v) for a, v in arm_ms.items()},
          "adopted": winner != default,
          "holds_beyond_spread": max(arm_ms["winner"]) < min(arm_ms["default"])})

    impala = tune_search(M, [
        "tune", "impala", "gym:CartPole-v1", "--folder", scratch_dir("tune_impala"), "--num-envs", str(CARTPOLE_B),
        "--set", f"learner_config.algo.horizon={CARTPOLE_T}", "--warmup", "2", "--iters", str(TUNE_IMPALA_ITERS),
        "--out", artifact,
    ], wrappers, lambda p: {"vtrace": int(p["vtrace_impl"] == "xla"), "rev_scan": int(p["vtrace_impl"] == "assoc")})
    irow = impala["row"]
    with open(artifact) as f:
        written = json.load(f)
    checks["impala_searched"] = (not irow["cache_hit"] and irow["measured"] == len(impala["trials"]) >= 4
                                 and impala["launches"]["vtrace"] > 0)
    checks["artifact"] = (len(written["workloads"]) == 2 and written["platform"] == "gpu")
    emit({"phase": "tune", "step": "impala_search", "env": "gym:CartPole-v1",
          "env_source": env_source.get("gym:CartPole-v1"), "num_envs": CARTPOLE_B, "horizon": CARTPOLE_T,
          "seconds": impala["seconds"], "trials": impala["trials"], "default": irow["default"],
          "winner": irow["config"], "surface": "learn", "launches": impala["launches"], "checks": checks})
    if not all(checks.values()):
        raise AssertionError(f"tune checks failed: {checks}")
    return {
        "gae": {"tune_ppo_lift": search["launches"]["gae"], "tune_cache_train": launches.get("gae", 0),
                **{f"tune_turn_{i}_{t['arm']}": t["gae_launches"] for i, t in enumerate(turns)}},
        "rev_scan": {"tune_ppo_lift": search["launches"]["rev_scan"], "tune_impala_cartpole":
                     impala["launches"]["rev_scan"], "tune_cache_train": launches.get("rev_scan", 0),
                     **{f"tune_turn_{i}_{t['arm']}": t["rev_scan_launches"] for i, t in enumerate(turns)}},
        "vtrace": {"tune_impala_cartpole": impala["launches"]["vtrace"]},
    }


def phase_chaos(M, ops_vtrace, env_source: dict) -> dict:
    """``chaos all --seeds 3`` through the CLI on the card: one schedule a
    profile (seed_gateway, seed_experience, ddpg_spill) on the fixture
    envs, every oracle clean, no failure; per schedule its seconds, the
    faults injected, the sites fired and V-trace's launches, once a learn
    in the SEED profiles (``chaos.campaign.run_once`` and
    ``IMPALALearner.learn`` wrapped to count). The artifact goes to a
    temporary folder."""
    import surreal_tpu_torch.chaos.campaign as campaign
    from surreal_tpu_torch.learners.impala import IMPALALearner

    vtrace = ops_vtrace.vtrace_fused
    learns = [0]
    runs = []

    def wrap_learn(learn):
        def counted(self, *a, **kw):
            learns[0] += 1
            return learn(self, *a, **kw)
        return counted

    def wrap_run_once(run_once):
        def counted(sched, folder, **kw):
            vtrace.launches, learns[0] = 0, 0
            t0 = time.perf_counter()
            rec = run_once(sched, folder, **kw)
            delivered = rec.delivered()
            runs.append({
                "seed": sched["seed"], "profile": sched["profile"], "seconds": time.perf_counter() - t0,
                "plan": sched["plan"], "faults_injected": sum(
                    min(rec.counts.get(e["site"], 0) - e["at"], e.get("times", 1)) for e in delivered),
                "fired_sites": sorted({e["site"] for e in delivered}), "learns": learns[0],
                "vtrace_launches": vtrace.launches, "error": rec.error,
                "final": {k: rec.metrics.get(k) for k in ("time/env_steps", "fleet/replicas_live",
                                                          "workers/respawns", "fleet/respawns")},
            })
            return rec
        return counted

    out = os.path.join(scratch_dir("chaos_out"), "campaign.json")
    t0 = time.perf_counter()
    with Patched(campaign, "run_once", wrap_run_once), Patched(IMPALALearner, "learn", wrap_learn):
        lines = cli_lines(M, ["chaos", "all", "--seeds", str(CHAOS_SEEDS), "--dir", scratch_dir("chaos"),
                              "--out", out])
    seconds = time.perf_counter() - t0
    with open(out) as f:
        artifact = json.load(f)
    seed_runs = [r for r in runs if r["profile"] != "ddpg_spill"]
    checks = {
        "schedules": artifact["gauges"]["chaos/schedules"] == CHAOS_SEEDS == len(runs),
        "every_profile": {r["profile"] for r in runs} == set(artifact["profiles"]) and len(artifact["profiles"]) == 3,
        "zero_violations": artifact["gauges"]["chaos/violations"] == 0 and all(
            s["violations"] == 0 for s in artifact["schedules"]),
        "no_failures": artifact["failures"] == [] and not any(r["error"] for r in runs),
        "vtrace_once_a_learn": all(r["vtrace_launches"] == r["learns"] > 0 for r in seed_runs),
        "faults_injected": artifact["gauges"]["chaos/faults_injected"] > 0,
    }
    for r in runs:
        emit({"phase": "chaos", "step": "schedule", **r,
              "oracles": next(s["oracles"] for s in artifact["schedules"] if s["seed"] == r["seed"])})
    emit({"phase": "chaos", "step": "campaign", "seconds": seconds, "gauges": artifact["gauges"],
          "sites_covered": artifact["sites_covered"], "summary": lines[-1], "checks": checks})
    if not all(checks.values()):
        raise AssertionError(f"chaos checks failed: {checks}")
    return {"vtrace": {f"chaos_{r['profile']}": r["vtrace_launches"] for r in seed_runs}}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs a CUDA card", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["fanout-subscriber"]:
        return fanout_subscriber(*sys.argv[2:4])
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from surreal_tpu_torch.launch.offpolicy_trainer import OffPolicyTrainer
    from surreal_tpu_torch.launch.trainer import Trainer
    from surreal_tpu_torch.ops import gae as ops_gae
    from surreal_tpu_torch.ops import replay_rows as RR
    from surreal_tpu_torch.ops import rev_scan as RS
    from surreal_tpu_torch.ops import vtrace as ops_vtrace
    from surreal_tpu_torch.session.config import Config
    from surreal_tpu_torch.session.default_configs import base_config
    from surreal_tpu_torch.utils.kernel_build import build_kernel

    try:
        return run_phases(Config, base_config, Trainer, OffPolicyTrainer, ops_gae, RR, RS, ops_vtrace, build_kernel)
    finally:
        for root in _SCRATCH:
            shutil.rmtree(root, ignore_errors=True)


def run_phases(Config, base_config, Trainer, OffPolicyTrainer, ops_gae, RR, RS, ops_vtrace, build_kernel) -> int:
    from types import SimpleNamespace

    import surreal_tpu_torch.main.launch as launch
    from surreal_tpu_torch.launch.hooks import SessionHooks
    from surreal_tpu_torch.session.checkpoint import CheckpointManager
    from surreal_tpu_torch.session.telemetry import _iter_jsonl
    from surreal_tpu_torch.utils.tree import tree_flatten

    from surreal_tpu_torch.envs import make_env
    from surreal_tpu_torch.distributed.module_dict import host_tree
    from surreal_tpu_torch.launch.seed_trainer import SEEDTrainer
    from surreal_tpu_torch.session.default_configs import BASE_ENV_CONFIG

    M = SimpleNamespace(
        Config=Config, base_config=base_config, Trainer=Trainer, OffPolicyTrainer=OffPolicyTrainer, launch=launch,
        SEEDTrainer=SEEDTrainer, host_tree=host_tree,
        SessionHooks=SessionHooks, CheckpointManager=CheckpointManager, iter_jsonl=_iter_jsonl,
        tree_flatten=tree_flatten, make_env=make_env, BASE_ENV_CONFIG=BASE_ENV_CONFIG,
    )
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "name": kind, "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:  # one nvcc per source, all at once
        list(pool.map(build_kernel, KERNEL_SOURCES))
    emit({"phase": "build", "kernels": KERNEL_SOURCES, "seconds": time.perf_counter() - t0})

    gae = phase_kernels(ops_gae)
    vtrace = phase_vtrace_kernel(ops_vtrace)
    gather = phase_replay_gather(RR)
    scatter = phase_replay_scatter(RR)
    rev_scan = phase_rev_scan(RS)
    # which scan kernel each form of GAE and V-trace launches, per learn
    gae_xla = {"gae": (ops_gae.gae_advantages_masked, 1), "rev_scan": (RS.reverse_linear_scan, 0)}
    gae_assoc = {"gae": (ops_gae.gae_advantages_masked, 0), "rev_scan": (RS.reverse_linear_scan, 1)}
    vtrace_xla = {"vtrace": (ops_vtrace.vtrace_fused, 1), "rev_scan": (RS.reverse_linear_scan, 0)}
    vtrace_assoc = {"vtrace": (ops_vtrace.vtrace_fused, 0), "rev_scan": (RS.reverse_linear_scan, 1)}
    phase_parity(Config, base_config, Trainer, "xla", gae_xla)
    phase_parity(Config, base_config, Trainer, "assoc", gae_assoc)
    phase_parity_impala(Config, base_config, Trainer, "xla", vtrace_xla)
    phase_parity_impala(Config, base_config, Trainer, "assoc", vtrace_assoc)
    phase_parity_ddpg(Config, base_config, OffPolicyTrainer)
    train = phase_train(Config, base_config, Trainer, gae_xla)
    train_assoc = phase_train(Config, base_config, Trainer, gae_assoc, "assoc", ASSOC_WARMUP_ITERS, ASSOC_TIMED_ITERS)
    train_impala = phase_train_impala(Config, base_config, Trainer, vtrace_xla)
    train_impala_assoc = phase_train_impala(Config, base_config, Trainer, vtrace_assoc, "assoc",
                                            ASSOC_WARMUP_ITERS, ASSOC_TIMED_ITERS)
    train_ddpg = phase_train_ddpg(Config, base_config, OffPolicyTrainer, RR)
    # the trajectory transformer: PPO's sequence learn launches GAE (the
    # reverse scan at 'assoc'), IMPALA's V-trace
    phase_parity_trajectory(Config, base_config, Trainer, "ppo", "jax:pendulum", gae_xla, "xla")
    phase_parity_trajectory(Config, base_config, Trainer, "ppo", "jax:pendulum", gae_assoc, "assoc")
    phase_parity_trajectory(Config, base_config, Trainer, "impala", "jax:cartpole", vtrace_xla)
    phase_parity_trajectory(Config, base_config, Trainer, "ppo", "jax:pong16", gae_xla, cnn=PONG16_CNN)
    phase_kv_vs_padded(Config, base_config, Trainer)
    train_traj = phase_train_trajectory(Config, base_config, Trainer, gae_xla)
    train_traj_impala = phase_train_trajectory_impala(Config, base_config, Trainer, vtrace_xla)
    phase_session(M, gae_xla, {"replay_gather": (RR.gather_rows, DDPG_K), "replay_scatter": (RR.scatter_rows, DDPG_K)})
    phase_session_trajectory(M, gae_xla, vtrace_xla)
    host = phase_host(M, ops_gae, ops_vtrace, RS, RR)
    seed = phase_seed(M, ops_gae, ops_vtrace, RS, host["env_source"])
    profile = phase_profile(M, ops_gae.gae_advantages_masked, host["env_source"])
    precision = phase_precision(M, ops_gae.gae_advantages_masked, ops_vtrace.vtrace_fused, RR)
    publish = phase_publish(M, ops_gae.gae_advantages_masked, RR)
    fleet = phase_fleet(M, ops_gae, ops_vtrace, RS, host["env_source"])
    fanout = phase_fanout(M, ops_gae.gae_advantages_masked, ops_vtrace.vtrace_fused, publish["ppo"]["publish_ms_p50"])
    experience = phase_experience(M, RR, ops_gae, ops_vtrace, RS, host["env_source"])
    spill = phase_spill(M, RR, host["env_source"])
    gateway = phase_gateway(M, ops_vtrace.vtrace_fused, RS, host["env_source"])
    ops = phase_ops(M, ops_gae.gae_advantages_masked, ops_vtrace.vtrace_fused, RS, host["env_source"])
    tune = phase_tune(M, ops_gae, ops_vtrace, RS, host["env_source"])
    chaos = phase_chaos(M, ops_vtrace, host["env_source"])

    # each kernel's launches in the timed train phases of every path that
    # launches it (each phase counted from 0 just before it, read just after)
    gae["launches_by_path"] = {"ppo_lift": train["gae_launches"], "trajectory_ppo_pendulum": train_traj["gae_launches"],
                               **host["gae"], **seed["gae"], "profile_ppo_lift": profile["gae_launches"],
                               "precision_ppo_lift": precision["gae_launches"], **publish["gae"], **fleet["gae"],
                               **fanout["gae"], **experience["gae"], **ops["gae"], **tune["gae"]}
    vtrace["launches_by_path"] = {"impala_pong": train_impala["vtrace_launches"],
                                  "trajectory_impala_cartpole": train_traj_impala["vtrace_launches"], **host["vtrace"],
                                  **seed["vtrace"], "precision_impala_pong": precision["vtrace_launches"],
                                  **fleet["vtrace"], **fanout["vtrace"], **experience["vtrace"], **gateway["vtrace"],
                                  **ops["vtrace"], **tune["vtrace"], **chaos["vtrace"]}
    gather["launches_by_path"] = {"ddpg_lift": train_ddpg["replay_gather_launches"], **host["replay_gather"],
                                  "precision_ddpg_lift": precision["replay_gather_launches"],
                                  **publish["replay_gather"], **experience["replay_gather"], **spill["replay_gather"]}
    gather["max_abs_err"] = max(gather["max_abs_err"], host["replay_gather_check"]["max_abs_err"],
                                precision["gather"]["max_abs_err"], experience["replay_gather_check"]["max_abs_err"],
                                spill["max_abs_err"])
    gather["bf16_rows"] = {k: precision["gather"][k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "row_bytes")}
    gather["hot_tier_rows"] = {k: experience["replay_gather_check"][k]
                               for k in ("ms", "plain_ms", "library_ms", "bound_ms", "row_bytes", "sample_ms")}
    scatter["launches_by_path"] = {"ddpg_lift": train_ddpg["replay_scatter_launches"], **host["replay_scatter"],
                                   "precision_ddpg_lift": precision["replay_scatter_launches"],
                                   **publish["replay_scatter"]}
    rev_scan["launches_by_path"] = {"ppo_lift_assoc": train_assoc["rev_scan_launches"],
                                    "impala_pong_assoc": train_impala_assoc["rev_scan_launches"], **host["rev_scan"],
                                    **seed["rev_scan"], **tune["rev_scan"]}
    for k in (gae, vtrace, gather, scatter, rev_scan):
        k["launches"] = sum(k["launches_by_path"].values())

    emit({"kernels": [gae, vtrace, gather, scatter, rev_scan]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__mp_main__" and os.environ.get(FIXTURE_ENV_VAR):
    # a spawned SEED env worker imports this script as __mp_main__ before
    # it runs: give its make_env the parent's fixture envs
    import surreal_tpu_torch.distributed.env_worker as _env_worker

    patch_make_env(set(json.loads(os.environ[FIXTURE_ENV_VAR])), (_env_worker,))

if __name__ == "__main__":
    sys.exit(main())
