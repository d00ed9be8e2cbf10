"""Off-policy trainer (DDPG), the port of
``surreal_tpu/launch/offpolicy_trainer.py`` in device mode on one device:
per iteration, H env steps with OU (or Gaussian) exploration noise, n-step
folding, a replay insert, then ``updates_per_iter`` sample + learn steps,
with a priority refresh after each under prioritized replay.

Two update loops, as in the reference:

- uniform replay (``batched_uniform_sampling``, the default): all K index
  sets are drawn at once and gathered by ONE gather launch of K * bs rows;
- prioritized replay: K sequential samples (one gather launch each), each
  followed by ``update_priorities`` (one scatter launch), since every draw
  depends on the priorities the previous update wrote.

The reference's ``lax.cond(can_sample)`` and its traced warm-up and
first-chunk flags are host decisions here: the ring's cursor and size are
host ints (see ``replay/base.py``), ``warmup`` and ``first`` host bools.
Between metrics reads an iteration makes no host sync. The replay and the
env carry are updated in place.

Randomness is explicit. ``_device_train_iter`` takes, optionally, every
draw the reference makes from its keys: env reset (and step) draws, the
exploration normals, the warm-up actions, and the per-update sample draws
(uniform indices, or prioritized uniforms); the parity tests replay JAX's
key tree into them.

``run`` is the reference's: ``SessionHooks`` around a ``LoopEngine`` whose
step is ``_device_train_iter``. With ``checkpoint.include_replay`` every
checkpoint also saves the replay (ring, cursor, size, priorities) as the
step's extra tree, and a resume or a rollback restores it from the same
step; the boundary is then pinned inline, since the snapshot must read
the iteration's own ring.

Host mode (gym, dm_control, robosuite; ``_run_host``): per iteration, an
H-step exploration rollout on the host env (``_explore_rollout``:
warm-up, OU or Gaussian actions, acting on the card with one action read
back per step), stacked time-major and copied to the card once per leaf,
then the n-step fold with the carried tail, the insert, the obs-filter
update and ``updates_per_iter`` sample -> learn -> priority-refresh steps
(``_host_update``). With ``topology.overlap_rollouts`` (the default) the
rollout and its copy run on a ``Prefetcher`` staging thread, with their
own generators, acting from the newest published state (up to two
updates behind). The warm-up actions, the OU normals (kept on the host,
as the reference keeps the noise) and the per-update sample draws each
have an explicit input for the parity tests.

Remote mode (``replay.kind='remote'`` on a host env;
``_run_host_remote``, the twin of the reference's): the replay lives in
the shard servers of the sharded experience plane (``experience/``).
The collector folds each chunk on the card as the host path does, copies
the folded rows to the host once, and the ExperienceSender hash-routes
them to the shards; the learner trains on the batches the ShardedSampler
prefetched during the previous iteration's drain (one chunk of sampling
staleness), and prioritized runs send their priorities back as one PRIO
frame per shard per iteration. ``replay.remote_kind`` picks uniform or
prioritized shards; ``replay.tiers.hot.enabled`` (uniform only) puts the
device hot tier (``replay/tiers.py``) in front of the shards, fed with
the fold's rows on the card and drawn through the replay gather kernel.
With ``overlap_rollouts=false`` the training record is the same from run
to run (the shards defer each sample to its watermark).
``replay.tiers.spill.enabled`` makes every shard append its ingested
rows to a write-ahead log (``experience/spill.py``), under
``<folder>/spill`` unless ``replay.tiers.spill.dir`` names another place.

Replay from the log (``replay_from_log``): the spill tier's segments, in
their global ``(seq, shard)`` order, streamed into a ``UniformReplay``
ring on the trainer's device, with ``updates_per_iter`` sample + learn
steps after each segment once the ring holds ``start_sample_size`` rows.
Its draws come from one generator seeded from the session seed (or are
given), so two runs over one log give equal parameters; on the card each
sample launches the replay gather kernel.

Not ported yet: the learner group (``topology.learner_group``), the dp
mesh and the autotuner.
"""

from __future__ import annotations

import functools
import hashlib
import os
import queue
from collections import deque
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from surreal_tpu_torch.engine import (
    EngineConfig, LoopEngine, LoopState, Outcome, StageSpec, overlap_collect, sideband_stages,
)
from surreal_tpu_torch.envs import is_jax_env, make_env
from surreal_tpu_torch.experience import wire
from surreal_tpu_torch.launch.hooks import HOST_METRICS_WINDOW, SessionHooks, host_metrics, training_env_config
from surreal_tpu_torch.launch.rollout import successor_and_termination
from surreal_tpu_torch.launch.trainer import derive_seed
from surreal_tpu_torch.learners import EVAL_DETERMINISTIC, TRAINING, build_learner
from surreal_tpu_torch.learners.aggregator import nstep_transitions, to_device
from surreal_tpu_torch.learners.base import check_scan_unroll
from surreal_tpu_torch.learners.ddpg import LEARN_METRIC_KEYS, ou_noise_step
from surreal_tpu_torch.learners.prefetch import Prefetcher
from surreal_tpu_torch.ops.precision import LOSS_SCALE_KEYS, torch_dtype
from surreal_tpu_torch.replay import build_replay
from surreal_tpu_torch.session.config import Config
from surreal_tpu_torch.session.telemetry import Tracer
from surreal_tpu_torch.tune import resolve_autotune
from surreal_tpu_torch.utils import faults
from surreal_tpu_torch.utils.device import resolve_device


class OffPolicyCarry(NamedTuple):
    env_state: Any
    obs: torch.Tensor
    noise: torch.Tensor      # [B, act_dim] OU state (zeros when gaussian)
    ep_return: torch.Tensor  # [B]
    ep_length: torch.Tensor  # [B] int32
    tail: dict | None        # last n_step-1 steps of the previous chunk (None if n=1)


TRANS_KEYS = ("obs", "next_obs", "action", "reward", "done", "terminated")


def scrub_fake_prefix_windows(trans: dict, n: int, B: int) -> dict:
    """Overwrite the n-1 fictitious leading windows of the run's FIRST
    folded chunk with its first real window.

    ``nstep_transitions`` flattens [S, B] windows row-major, so window s of
    env b is flat row ``s*B+b``: the fabricated rows (windows starting in
    the all-zero tail that seeds the cross-chunk carry) occupy
    ``[0, (n-1)*B)`` and the first real window block is ``[(n-1)*B, n*B)``.
    Tiling that block over the fake rows keeps per-env alignment; replay
    never holds made-up transitions.
    """
    nb = (n - 1) * B
    return {
        k: torch.cat([x[nb : nb + B].repeat(n - 1, *([1] * (x.dim() - 1))), x[nb:]])
        for k, x in trans.items()
    }


def _step_slice(draws: torch.Tensor | None, t: int) -> torch.Tensor | None:
    return None if draws is None else draws[t]


def _tiers_config(replay_cfg) -> dict | None:
    """``replay.tiers`` as a plain dict (None when absent)."""
    tiers = replay_cfg.get("tiers", None)
    if tiers is None:
        return None
    return tiers.to_dict() if hasattr(tiers, "to_dict") else dict(tiers)


def host_rows(trans: dict, example: dict) -> dict[str, np.ndarray]:
    """The folded rows on the host in ONE device->host copy, each leaf cast
    on its device to its replay dtype (``example``'s); a bfloat16 leaf
    arrives as its 16-bit words (uint16), as ``experience/wire.py`` moves
    it."""
    n = next(iter(trans.values())).shape[0]
    leaves = {k: trans[k].to(example[k].dtype).contiguous().reshape(n, -1) for k in example}
    flat = torch.cat([x.view(torch.uint8) for x in leaves.values()], dim=1).cpu().numpy()
    out, off = {}, 0
    for k, x in leaves.items():
        dtype = np.dtype(np.uint16) if x.dtype == torch.bfloat16 else np.dtype(str(x.dtype).removeprefix("torch."))
        width = x.shape[1] * dtype.itemsize
        out[k] = flat[:, off:off + width].copy().view(dtype).reshape(n, *example[k].shape)
        off += width
    return out


class OffPolicyTrainer:
    """DDPG trainer with device replay on one device; ``device`` defaults to
    the card and raises without it."""

    def __init__(self, config, device: str | torch.device = "cuda"):
        self.config = config
        self.device = resolve_device(device)
        self.env = make_env(training_env_config(config.env_config), self.device)
        self.device_mode = is_jax_env(self.env)
        self.learner = build_learner(config.learner_config, self.env.specs, self.device)
        # the program autotuner: the same build-time cache consult as
        # Trainer's; applied knobs rewrite the learner overrides
        self.tune_decision = resolve_autotune(config, self.learner.config, self.device)
        if self.tune_decision.applied:
            self.learner = build_learner(config.learner_config, self.env.specs, self.device)
        algo = self.learner.config.algo
        self.algo = algo
        replay_cfg = self.learner.config.replay
        # remote experience plane (experience/): the replay lives in shard
        # servers, so there is no in-process replay object; host path only,
        # since the device path's replay IS device memory
        self.remote = replay_cfg.kind == "remote"
        if self.remote and self.device_mode:
            raise ValueError(
                "replay.kind='remote' (the sharded experience plane) runs "
                "the host off-policy path; device (jax:*) envs keep "
                "in-process device-resident replay — use a host env, or "
                "replay.kind='uniform'|'prioritized'"
            )
        if replay_cfg.kind == "fifo":
            raise ValueError(
                "replay.kind='fifo' is the on-policy trajectory queue; DDPG samples transitions: use "
                "replay.kind='uniform'|'prioritized'|'remote'"
            )
        if self.remote:
            if config.session_config.topology.get("learner_group", None) is not None:
                raise NotImplementedError(
                    "session_config.topology.learner_group: the learner group is not ported to PyTorch yet"
                )
        # the rollout and update scans' unrolls in the JAX package: accepted,
        # nothing to unroll in the port's loops (learners/base.py)
        check_scan_unroll(algo, "rollout_unroll")
        check_scan_unroll(algo, "update_unroll")
        # replay_gather is injected into the replay build config so the
        # replay layer stays algo-agnostic (both values reach the kernel)
        self.replay = None if self.remote else build_replay(
            Config(gather_impl=algo.get("replay_gather", "xla")).extend(replay_cfg)
        )
        self.prioritized = replay_cfg.kind == "prioritized" or (
            self.remote and replay_cfg.get("remote_kind", "uniform") == "prioritized"
        )
        self._batched_sampling = (
            not self.prioritized
            and bool(algo.get("batched_uniform_sampling", True))
            and hasattr(self.replay, "sample_many")
        )
        self.horizon = int(algo.horizon)
        self.num_envs = int(config.env_config.num_envs)
        self.act_dim = int(self.env.specs.action.shape[0])
        self.seed = config.session_config.seed
        self.steps_per_iter = self.horizon * self.num_envs

    # -- loop state ----------------------------------------------------------
    def _init_carry(
        self, generator: torch.Generator | None = None, reset_draws: torch.Tensor | None = None
    ) -> OffPolicyCarry:
        """Fresh rollout carry for ``num_envs`` envs; with n_step > 1 a tail
        of n-1 fake steps (done and terminated, so windows starting there
        die at once with reward 0 and discount 0)."""
        B, dev, f32 = self.num_envs, self.device, torch.float32
        env_state, obs = self.env.reset(B, generator=generator, draws=reset_draws)
        return OffPolicyCarry(
            env_state=env_state,
            obs=obs,
            noise=torch.zeros((B, self.act_dim), dtype=f32, device=dev),
            ep_return=torch.zeros(B, dtype=f32, device=dev),
            ep_length=torch.zeros(B, dtype=torch.int32, device=dev),
            tail=self._fake_tail(),
        )

    def init_loop_state(
        self, generator: torch.Generator | None = None, reset_draws: torch.Tensor | None = None
    ):
        """(carry, replay_state): one constructor for ``run`` and the tests."""
        return self._init_carry(generator, reset_draws), self.replay.init(self._replay_example())

    def _replay_example(self) -> dict:
        """Single-transition example sizing the replay storage: obs-class
        leaves in the policy's staging dtype, reward and discount float32."""
        obs_dtype = torch_dtype(self.learner.policy.data_dtype)
        obs_shape = tuple(self.env.specs.obs.shape)
        dev = self.device
        return {
            "obs": torch.zeros(obs_shape, dtype=obs_dtype, device=dev),
            "next_obs": torch.zeros(obs_shape, dtype=obs_dtype, device=dev),
            "action": torch.zeros((self.act_dim,), dtype=torch.float32, device=dev),
            "reward": torch.zeros((), dtype=torch.float32, device=dev),
            "discount": torch.zeros((), dtype=torch.float32, device=dev),
        }

    # -- one iteration -------------------------------------------------------
    @torch.no_grad()
    def _rollout(
        self,
        state,
        carry: OffPolicyCarry,
        warmup: bool,
        generator: torch.Generator | None = None,
        action_noise: torch.Tensor | None = None,
        warmup_uniforms: torch.Tensor | None = None,
        reset_draws: torch.Tensor | None = None,
        step_draws: torch.Tensor | None = None,
    ):
        """H exploration steps. ``action_noise`` [H, B, A] are standard
        normals (the OU diffusion draws, or the Gaussian exploration noise);
        ``warmup_uniforms`` [H, B, A] are the uniform [-1, 1) actions taken
        while ``warmup``. The OU state advances during warm-up too, as in
        the reference. Returns (carry, traj of [H, B, ...] tensors)."""
        explo = self.algo.exploration
        c = carry
        steps = []
        for t in range(self.horizon):
            if explo.noise == "ou":
                noise = ou_noise_step(
                    c.noise, explo.ou_theta, explo.sigma, explo.ou_dt, generator,
                    normals=_step_slice(action_noise, t),
                )
            else:
                noise = c.noise
            if warmup:
                # exploration warm-up: uniform-random actions
                u = _step_slice(warmup_uniforms, t)
                if u is None:
                    u = torch.rand(noise.shape, generator=generator, device=self.device) * 2.0 - 1.0
                action = u.to(device=self.device, dtype=torch.float32)
            elif explo.noise == "ou":
                a_det, _ = self.learner.act(state, c.obs, EVAL_DETERMINISTIC)
                action = torch.clamp(a_det + noise, -1.0, 1.0)
            else:
                action, _ = self.learner.act(
                    state, c.obs, TRAINING, generator, noise=_step_slice(action_noise, t)
                )
            env_state, obs2, reward, done, info = self.env.step(
                c.env_state, action, generator,
                reset_draws=_step_slice(reset_draws, t), step_draws=_step_slice(step_draws, t),
            )
            next_obs, terminated = successor_and_termination(obs2, done, info)
            ep_return = c.ep_return + reward
            ep_length = c.ep_length + 1
            steps.append({
                "obs": c.obs,
                "next_obs": next_obs,
                "action": action,
                "reward": reward,
                "done": done,
                "terminated": terminated,
                "ep_return": torch.where(done, ep_return, 0.0),
                "ep_done": done,
            })
            c = c._replace(
                env_state=env_state,
                obs=obs2,
                # the OU state restarts at episode boundaries
                noise=torch.where(done[:, None], 0.0, noise),
                ep_return=torch.where(done, 0.0, ep_return),
                ep_length=torch.where(done, torch.zeros_like(ep_length), ep_length),
            )
        return c, {k: torch.stack([s[k] for s in steps]) for k in steps[0]}

    def _run_updates(self, state, replay_state, beta: float, generator=None, sample_draws=None):
        """``updates_per_iter`` sample + learn steps (+ priority refreshes).
        ``sample_draws`` [K, bs]: uniform replay's indices, or prioritized
        replay's uniforms. Returns (state, replay_state, mean metrics)."""
        K = int(self.algo.updates_per_iter)
        per_update = []
        if self._batched_sampling:
            replay_state, batches, idx = self.replay.sample_many(
                replay_state, K, generator, idx=sample_draws
            )
            for k in range(K):
                state, metrics = self.learner.learn(state, {n: x[k] for n, x in batches.items()})
                metrics.pop("priority/td_abs")
                metrics["replay/sample_age_frac"] = self.replay.age_frac(replay_state, idx[k])
                per_update.append(metrics)
        else:
            for k in range(K):
                draws = _step_slice(sample_draws, k)
                if self.prioritized:
                    replay_state, batch, info = self.replay.sample(
                        replay_state, generator, beta=beta, uniforms=draws
                    )
                    batch = dict(batch, is_weights=info["is_weights"])
                else:
                    replay_state, batch, info = self.replay.sample(replay_state, generator, idx=draws)
                state, metrics = self.learner.learn(state, batch)
                td_abs = metrics.pop("priority/td_abs")
                metrics["replay/sample_age_frac"] = self.replay.age_frac(replay_state, info["idx"])
                if self.prioritized:
                    replay_state = self.replay.update_priorities(replay_state, info["idx"], td_abs)
                per_update.append(metrics)
        mean = {k: torch.stack([m[k] for m in per_update]).mean() for k in per_update[0]}
        return state, replay_state, mean

    def _device_train_iter(
        self,
        state,
        replay_state,
        carry: OffPolicyCarry,
        beta: float = 0.0,
        warmup: bool = False,
        first: bool = False,
        generator: torch.Generator | None = None,
        action_noise: torch.Tensor | None = None,
        warmup_uniforms: torch.Tensor | None = None,
        reset_draws: torch.Tensor | None = None,
        step_draws: torch.Tensor | None = None,
        sample_draws: torch.Tensor | None = None,
    ):
        """One iteration: rollout, n-step fold, replay insert, obs-filter
        update, then the update loop once the replay holds
        ``start_sample_size`` rows (zero metrics before). ``first`` marks
        the run's first chunk, whose fake n-step prefix windows are
        scrubbed. Returns (state, replay_state, carry, metrics)."""
        carry, traj = self._rollout(
            state, carry, warmup, generator, action_noise, warmup_uniforms, reset_draws, step_draws
        )
        state, replay_state, tail = self._fold_insert(state, replay_state, carry.tail, traj, first)
        carry = carry._replace(tail=tail)

        if self.replay.can_sample(replay_state):
            state, replay_state, metrics = self._run_updates(
                state, replay_state, beta, generator, sample_draws
            )
        else:
            # zeros under the keys an update reports, as the reference's
            # skip branch gives them (the loss-scale keys with loss scaling)
            loss_scale_keys = LOSS_SCALE_KEYS if self.learner.policy.loss_scaling else ()
            metrics = {
                k: torch.zeros((), dtype=torch.float32, device=self.device)
                for k in (*LEARN_METRIC_KEYS, "replay/sample_age_frac", *loss_scale_keys)
            }
        metrics.update(self.replay.gauges(replay_state))
        n_done = traj["ep_done"].sum()
        ep_return_sum = traj["ep_return"].sum()
        metrics["episode/return"] = torch.where(
            n_done > 0, ep_return_sum / torch.clamp_min(n_done, 1), torch.nan
        )
        metrics["episode/count"] = n_done.to(torch.float32)
        return state, replay_state, carry, metrics

    def _beta(self, env_steps: int, total: int) -> float:
        """Prioritized IS beta, annealed beta0 -> 1.0 over training."""
        if not self.prioritized:
            return 0.0
        frac = min(env_steps / max(total, 1), 1.0)
        b0 = self.learner.config.replay.priority_beta0
        return b0 + (1.0 - b0) * frac

    # -- main loop -----------------------------------------------------------
    def run(
        self,
        max_env_steps: int | None = None,
        on_metrics: Callable[[int, dict], object] | None = None,
    ):
        """Train until ``max_env_steps`` (default: session total_env_steps).

        Returns (final_state, last_metrics). ``on_metrics(iteration, dict)``
        fires every ``metrics.every_n_iters`` iterations with host floats;
        returning truthy from it stops training.
        """
        cfg = self.config.session_config
        total = max_env_steps or cfg.total_env_steps
        state = self.learner.init(torch.Generator().manual_seed(self.seed))
        faults.configure_from(cfg)  # install (or reset) the run's fault plan
        hooks = SessionHooks(self.config, self.learner)
        try:
            state, iteration, env_steps = hooks.restore(state)
            hooks.begin_run(iteration, env_steps)
            if self.tune_decision.mode != "off":
                hooks.tune_event(**self.tune_decision.telemetry())
            if not self.device_mode:
                run_host = self._run_host_remote if self.remote else self._run_host
                return run_host(total, on_metrics, hooks, state, iteration, env_steps)
            generator = torch.Generator(device=self.device).manual_seed(self.seed)
            carry, replay_state = self.init_loop_state(generator)
            include_replay = bool(cfg.checkpoint.get("include_replay", False)) and hooks.ckpt is not None
            if include_replay and iteration > 0:
                # resume the buffer saved with the restored step, so that
                # learning continues without a warm-up refill
                restored = hooks.ckpt.restore_extra({"replay": replay_state}, step=iteration)
                if restored is not None:
                    replay_state = restored["replay"]
            # the replay and the env carry are updated in place: a deferred
            # boundary reads a clone of the state, and a replay-inclusive
            # checkpoint pins the boundary inline (the snapshot reads the
            # live ring)
            stages = (
                StageSpec("collect", donate=True),
                StageSpec("stage", donate=True),
                StageSpec("learn", donate=True),
            ) + sideband_stages()
            engine_cfg = EngineConfig.from_session(cfg)
            if include_replay and engine_cfg.pipeline_sidebands:
                hooks.log.warning("engine.pipeline_sidebands is pinned off: checkpoint.include_replay snapshots the live ring")
                engine_cfg = engine_cfg.inline()
            ls = LoopState(
                state=state, key=generator, iteration=iteration, env_steps=env_steps,
                extras={"replay": replay_state, "carry": carry, "first_call": True, "nonce": 0},
            )
            if include_replay:
                hooks.extra_state_fn = lambda: {"replay": ls.extras["replay"]}

            def step(ls):
                # the counted call is the first that runs the update loop
                # (one the replay can already sample from, past warm-up):
                # the steady-state iteration the gauges stand for
                warmup = ls.env_steps < self.algo.exploration.warmup_steps
                train_iter = self._device_train_iter
                if not warmup and self.replay.can_sample(ls.extras["replay"]):
                    train_iter = functools.partial(hooks.count_program, "train_iter", train_iter, phase="train_iter")
                with hooks.tracer.span("train_iter"):
                    ls.state, ls.extras["replay"], ls.extras["carry"], metrics = train_iter(
                        ls.state, ls.extras["replay"], ls.extras["carry"],
                        beta=self._beta(ls.env_steps, total),
                        warmup=warmup,
                        first=ls.extras["first_call"],
                        generator=ls.key,
                    )
                ls.extras["first_call"] = False
                return Outcome(
                    metrics=metrics, steps=self.steps_per_iter,
                    hook_key=derive_seed(self.seed, ls.extras["nonce"], ls.iteration + 1),
                )

            def apply_fault(ls, f):
                ls.state = faults.apply_trainer_fault(f, ls.state)

            def on_rollback(ls):
                rb = hooks.recovery.rollback(
                    ls.state, fresh=self._fresh_init,
                    # the replay rides the rollback when it was saved;
                    # otherwise the buffer is kept (it is data, not params)
                    extra_template={"replay": ls.extras["replay"]} if include_replay else None,
                )
                ls.state, ls.iteration, ls.env_steps = rb.state, rb.iteration, rb.env_steps
                if rb.extra is not None:
                    ls.extras["replay"] = rb.extra["replay"]
                ls.extras["nonce"] = rb.nonce
                ls.key = torch.Generator(device=self.device).manual_seed(derive_seed(self.seed, rb.nonce))
                ls.extras["carry"] = self._init_carry(ls.key)

            engine = LoopEngine(
                hooks, total, step, stages, engine_cfg,
                on_metrics=on_metrics, apply_fault=apply_fault, on_rollback=on_rollback,
            )
            ls = engine.run(ls)
            hooks.final_checkpoint(ls.iteration, ls.env_steps, ls.state)
            return ls.state, hooks.last_metrics
        finally:
            hooks.close()

    # -- host path -----------------------------------------------------------
    def host_roll_state(self, obs: np.ndarray, seed: int, learner=None) -> dict:
        """The rollout-side mutable state of the host path, owned by
        whichever thread collects: the learner it acts through (``learner``,
        an acting copy for a thread other than the main one; else the
        trainer's), the env obs, the OU noise [B, A] (host float32), a
        generator on the card for the Gaussian action draws and one on the
        CPU for the OU normals and warm-up actions."""
        return {
            "learner": learner if learner is not None else self.learner,
            "obs": obs,
            "noise": np.zeros((self.num_envs, self.act_dim), np.float32),
            "gen": torch.Generator(device=self.device).manual_seed(derive_seed(seed, 1)),
            "host_gen": torch.Generator().manual_seed(derive_seed(seed, 2)),
        }

    @torch.no_grad()
    def _explore_rollout(
        self,
        roll: dict,
        a_state,
        warmup: bool,
        warmup_actions: np.ndarray | None = None,
        action_noise: torch.Tensor | None = None,
        tracer=None,
    ):
        """One H-step exploration rollout on the host env: uniform [-1, 1)
        actions while ``warmup`` (``warmup_actions`` [H, B, A] replaces
        them), else OU noise around the deterministic action
        (``action_noise`` [H, B, A]: the OU normals) or the learner's
        Gaussian training actions (the act noise). The OU state stays as it
        is during warm-up and restarts at episode ends. Mutates ``roll``;
        returns (time-major numpy trajectory, finished-episode returns)."""
        explo = self.algo.exploration
        steps: list[dict] = []
        chunk_returns: list[float] = []
        obs, noise = roll["obs"], roll["noise"]
        shape = (self.num_envs, self.act_dim)
        span = (tracer or Tracer(None)).span  # a disabled tracer is a no-op
        with span("rollout"):
            for t in range(self.horizon):
                draws = None if action_noise is None else action_noise[t]
                if warmup:
                    if warmup_actions is not None:
                        action = np.asarray(warmup_actions[t], np.float32)
                    else:
                        u = torch.rand(shape, generator=roll["host_gen"])
                        action = (u * 2.0 - 1.0).numpy()
                else:
                    obs_t = torch.from_numpy(np.ascontiguousarray(obs)).to(self.device, non_blocking=True)
                    if explo.noise == "ou":
                        a_det, _ = roll["learner"].act(a_state, obs_t, EVAL_DETERMINISTIC)
                        noise = ou_noise_step(
                            torch.from_numpy(noise), explo.ou_theta, explo.sigma, explo.ou_dt,
                            roll["host_gen"], normals=None if draws is None else draws.cpu(),
                        ).numpy()
                        action = np.clip(a_det.cpu().numpy() + noise, -1.0, 1.0)  # the step's one read
                    else:
                        a, _ = roll["learner"].act(a_state, obs_t, TRAINING, roll["gen"], noise=draws)
                        action = a.cpu().numpy()  # the step's one read
                out = self.env.step(action)
                term_obs = out.info.get("terminal_obs", out.obs)
                done_b = out.done.reshape(out.done.shape + (1,) * (out.obs.ndim - 1))
                truncated = np.asarray(out.info.get("truncated", np.zeros(len(out.done), bool)))
                steps.append({
                    "obs": obs,
                    "next_obs": np.where(done_b, term_obs, out.obs),
                    "action": action,
                    "reward": out.reward,
                    "done": out.done,
                    "terminated": out.done & ~truncated,
                })
                if out.done.any():
                    noise = np.where(out.done[:, None], np.float32(0.0), noise)
                if "episode_returns" in out.info:
                    chunk_returns.extend(np.asarray(out.info["episode_returns"]).tolist())
                obs = out.obs
        roll["obs"], roll["noise"] = obs, noise
        traj = {k: np.stack([s[k] for s in steps]) for k in steps[0]}
        return traj, chunk_returns

    def _fake_tail(self):
        """The n-1 fake steps that seed the cross-chunk n-step carry (None at
        n_step 1): done and terminated, so windows starting there die at
        once with reward 0 and discount 0."""
        n = self.algo.n_step
        if n == 1:
            return None
        B, dev, f32 = self.num_envs, self.device, torch.float32
        obs_shape = tuple(self.env.specs.obs.shape)
        return {
            "obs": torch.zeros((n - 1, B, *obs_shape), dtype=f32, device=dev),
            "next_obs": torch.zeros((n - 1, B, *obs_shape), dtype=f32, device=dev),
            "action": torch.zeros((n - 1, B, self.act_dim), dtype=f32, device=dev),
            "reward": torch.zeros((n - 1, B), dtype=f32, device=dev),
            "done": torch.ones((n - 1, B), dtype=torch.bool, device=dev),
            "terminated": torch.ones((n - 1, B), dtype=torch.bool, device=dev),
        }

    def _fold(self, tail, traj: dict, first: bool):
        """Fold a [H, B] trajectory on its device into n-step transitions
        behind the previous chunk's ``tail`` (so the n-1 steps at every
        chunk boundary still become window starts; the run's first chunk
        has its fake windows scrubbed). Returns (flat [H * B] transitions,
        the new tail); row ``s * B + b`` is env slot ``b``'s."""
        n = self.algo.n_step
        chunk = {k: traj[k] for k in TRANS_KEYS}
        full = chunk
        if tail is not None:
            full = {k: torch.cat([tail[k], chunk[k]]) for k in TRANS_KEYS}
            tail = {k: v[-(n - 1):] for k, v in full.items()}
        trans = nstep_transitions(full, self.algo.gamma, n)
        if tail is not None and first:
            trans = scrub_fake_prefix_windows(trans, n, chunk["reward"].shape[1])
        return trans, tail

    def _fold_insert(self, state, replay_state, tail, traj: dict, first: bool):
        """``_fold``, the insert of its transitions, and the fresh obs
        folded into the obs filter once. Returns (state, replay_state, the
        new tail)."""
        trans, tail = self._fold(tail, traj, first)
        replay_state = self.replay.insert(replay_state, trans)
        state = self.learner.update_obs_stats(state, traj["obs"])
        return state, replay_state, tail

    def _host_update(
        self,
        state,
        replay_state,
        tail,
        traj: dict,
        first: bool,
        beta: float,
        generator: torch.Generator | None = None,
        sample_draws: torch.Tensor | None = None,
        tracer=None,
        hooks=None,
    ):
        """The host path's learner side of one iteration, on a trajectory
        already on the card: ``_fold_insert``, then, once the replay can sample,
        ``updates_per_iter`` sample -> learn -> priority-refresh steps
        (``sample_draws`` [K, bs]: uniform indices or prioritized
        uniforms). Metrics are the last update's, as in the reference.
        With ``hooks``, the learn goes through its cost counting.
        Returns (state, replay_state, tail, metrics)."""
        span = (tracer or Tracer(None)).span  # a disabled tracer is a no-op
        learn = self.learner.learn
        if hooks is not None:
            learn = functools.partial(hooks.count_program, "learn", learn, phase="learn")
        with span("replay-insert"):
            state, replay_state, tail = self._fold_insert(state, replay_state, tail, traj, first)
        metrics: dict = {}
        if self.replay.can_sample(replay_state):
            for k in range(int(self.algo.updates_per_iter)):
                draws = _step_slice(sample_draws, k)
                with span("replay-sample"):
                    if self.prioritized:
                        replay_state, batch, info = self.replay.sample(
                            replay_state, generator, beta=beta, uniforms=draws
                        )
                        batch = dict(batch, is_weights=info["is_weights"])
                    else:
                        replay_state, batch, info = self.replay.sample(replay_state, generator, idx=draws)
                with span("learn"):
                    state, metrics = learn(state, batch)
                td_abs = metrics.pop("priority/td_abs")
                if self.prioritized:
                    replay_state = self.replay.update_priorities(replay_state, info["idx"], td_abs)
            metrics["replay/sample_age_frac"] = self.replay.age_frac(replay_state, info["idx"])
        metrics.update(self.replay.gauges(replay_state))
        return state, replay_state, tail, metrics

    def _run_host(self, total, on_metrics, hooks, state, iteration, env_steps):
        """Host-env loop. With ``topology.overlap_rollouts`` (the default)
        the exploration rollout and its copy to the card run on a
        ``Prefetcher`` staging thread while the main thread drains chunk
        k's updates; the staging thread acts from the newest PUBLISHED
        state, up to two iterations behind (off-policy by construction;
        the warm-up flag shares the bound). Otherwise collect and update
        alternate with zero policy lag."""
        cfg = self.config.session_config
        replay_state = self.replay.init(self._replay_example())
        include_replay = bool(cfg.checkpoint.get("include_replay", False)) and hooks.ckpt is not None
        if include_replay and iteration > 0:
            restored = hooks.ckpt.restore_extra({"replay": replay_state}, step=iteration)
            if restored is not None:
                replay_state = restored["replay"]
        explo = self.algo.exploration
        recent_returns: deque = deque(maxlen=HOST_METRICS_WINDOW)
        overlap = overlap_collect(cfg)
        # the staging thread acts through its own module copies, made here
        # before it starts
        roll = self.host_roll_state(self.env.reset(seed=self.config.env_config.seed), self.seed,
                                    self.learner.acting_copy() if overlap else None)
        act_holder = [state]
        steps_holder = [env_steps]

        def collect_chunk():
            traj, chunk_returns = self._explore_rollout(
                roll, act_holder[0],  # one coherent policy per chunk
                steps_holder[0] < explo.warmup_steps, tracer=hooks.tracer,
            )
            with hooks.tracer.span("h2d-transfer"):
                return to_device(traj, self.device), chunk_returns

        prefetch = Prefetcher(collect_chunk, name="offpolicy-stage") if overlap else None
        stages = (
            StageSpec("collect", donate=False, overlap=overlap),
            StageSpec("stage", donate=False, overlap=overlap),
            StageSpec("learn", donate=False),
        ) + sideband_stages()
        engine_cfg = EngineConfig.from_session(cfg)
        if include_replay and engine_cfg.pipeline_sidebands:
            hooks.log.warning("engine.pipeline_sidebands is pinned off: checkpoint.include_replay snapshots the live ring")
            engine_cfg = engine_cfg.inline()
        ls = LoopState(
            state=state, key=torch.Generator(device=self.device).manual_seed(self.seed),
            iteration=iteration, env_steps=env_steps,
            extras={"replay": replay_state, "tail": self._fake_tail(), "first_chunk": True, "nonce": 0},
        )
        if include_replay:
            hooks.extra_state_fn = lambda: {"replay": ls.extras["replay"]}

        def step(ls):
            if prefetch is not None:
                with hooks.tracer.span("chunk-wait"):
                    traj, ep_returns = prefetch.get()
            else:
                traj, ep_returns = collect_chunk()
            recent_returns.extend(ep_returns)
            ls.state, ls.extras["replay"], ls.extras["tail"], metrics = self._host_update(
                ls.state, ls.extras["replay"], ls.extras["tail"], traj, ls.extras["first_chunk"],
                self._beta(ls.env_steps, total), ls.key, tracer=hooks.tracer, hooks=hooks,
            )
            ls.extras["first_chunk"] = False
            # publish the acting state and the consumed-step count to the
            # staging thread (its next chunk explores with them)
            act_holder[0] = ls.state
            steps_holder[0] = ls.env_steps + self.steps_per_iter
            return Outcome(
                metrics=host_metrics(metrics, recent_returns), steps=self.steps_per_iter,
                hook_key=derive_seed(self.seed, ls.extras["nonce"], ls.iteration + 1),
            )

        def apply_fault(ls, f):
            ls.state = faults.apply_trainer_fault(f, ls.state)
            act_holder[0] = ls.state

        def on_rollback(ls):
            rb = hooks.recovery.rollback(
                ls.state, fresh=self._fresh_init,
                extra_template={"replay": ls.extras["replay"]} if include_replay else None,
            )
            ls.state, ls.iteration, ls.env_steps = rb.state, rb.iteration, rb.env_steps
            if rb.extra is not None:
                ls.extras["replay"] = rb.extra["replay"]
            # the staging thread keeps collecting: hand it the restored
            # acting state and step count; chunks already staged from the
            # poisoned policy are data the replay (and the bounded guard)
            # absorb
            act_holder[0] = ls.state
            steps_holder[0] = ls.env_steps
            ls.extras["nonce"] = rb.nonce
            ls.key = torch.Generator(device=self.device).manual_seed(derive_seed(self.seed, rb.nonce))

        try:
            engine = LoopEngine(
                hooks, total, step, stages, engine_cfg,
                on_metrics=on_metrics, apply_fault=apply_fault, on_rollback=on_rollback,
            )
            ls = engine.run(ls)
            hooks.final_checkpoint(ls.iteration, ls.env_steps, ls.state)
            return ls.state, hooks.last_metrics
        finally:
            if prefetch is not None:
                prefetch.close()

    # -- remote experience plane (host path) ---------------------------------
    def _run_host_remote(self, total, on_metrics, hooks, state, iteration, env_steps):
        """Host loop over the sharded experience plane: the collector (the
        staging thread under ``overlap_rollouts``) folds each chunk on the
        card, copies the rows to the host once and hash-routes them to the
        shard servers through the ExperienceSender; the learner consumes
        batches the ShardedSampler prefetched from ALL shards during the
        PREVIOUS iteration's updates (the residue is the
        ``experience/sample_wait_ms`` gauge).

        Pipeline: iteration k requests its batches (watermarked at chunk
        k's per-shard row counts) and trains on the batches requested at
        iteration k-1, one chunk of bounded sampling staleness. Under
        ``overlap_rollouts=false`` the record is the same from run to run
        (the shards defer each sample to its watermark)."""
        from surreal_tpu_torch.experience import ExperiencePlane, TieredSampler

        cfg = self.config.session_config
        replay_cfg = self.learner.config.replay
        tiers_cfg = _tiers_config(replay_cfg)
        spill_cfg = dict((tiers_cfg or {}).get("spill") or {})
        if spill_cfg.get("enabled") and not spill_cfg.get("dir"):
            # beside telemetry and checkpoints, where replay_from_log finds it
            tiers_cfg["spill"] = dict(spill_cfg, dir=os.path.join(cfg.folder, "spill"))
        if cfg.checkpoint.get("include_replay", False):
            hooks.log.warning(
                "checkpoint.include_replay is not supported with replay.kind='remote' (the buffer lives in the "
                "shard servers); resumes refill through warmup"
            )
        explo = self.algo.exploration
        B, steps_per_iter = self.num_envs, self.steps_per_iter
        example = self._replay_example()
        plane = ExperiencePlane(
            kind="prioritized" if self.prioritized else "uniform",
            example=example,
            capacity=int(replay_cfg.capacity),
            batch_size=int(replay_cfg.batch_size),
            updates_per_iter=int(self.algo.updates_per_iter),
            num_slots=B,
            # the most rows one chunk routes to ONE shard: every folded
            # window (the tail prepend keeps the window count at horizon)
            max_insert_rows=self.horizon * B,
            priority_alpha=float(replay_cfg.priority_alpha),
            priority_beta0=float(replay_cfg.priority_beta0),
            priority_eps=float(replay_cfg.priority_eps),
            cfg=cfg.topology.get("experience_plane", None),
            base_seed=derive_seed(self.seed, 2),
            trace_id=hooks.trace_id,
            device=self.device,
            tiers=tiers_cfg,
            # every shard pushes its own row to the run's ops plane
            ops_address=hooks.ops.address,
        )
        tiered = None
        hot_cfg = dict((tiers_cfg or {}).get("hot") or {})
        if hot_cfg.get("enabled"):
            if self.prioritized:
                hooks.log.warning("replay.tiers.hot ignored: it requires uniform replay")
            else:
                from surreal_tpu_torch.replay.tiers import HotTier

                hot = HotTier(
                    capacity=int(hot_cfg.get("capacity", replay_cfg.capacity)),
                    batch_size=int(replay_cfg.batch_size),
                    gather_impl=hot_cfg.get("gather_impl"),
                    min_fill=hot_cfg.get("min_fill"),
                    # storage in the replay's staging dtypes: a hot sample
                    # has a warm fan-in batch's dtypes
                    example=example,
                )
                tiered = TieredSampler(plane.sampler, hot)
                plane.attach_tiers(tiered)
        sampler = plane.sampler
        recent_returns: deque = deque(maxlen=HOST_METRICS_WINDOW)
        overlap = overlap_collect(cfg)
        roll = self.host_roll_state(self.env.reset(seed=self.config.env_config.seed), self.seed,
                                    self.learner.acting_copy() if overlap else None)
        fold = {"tail": self._fake_tail(), "first": True}
        act_holder = [state]
        steps_holder = [env_steps]
        row_slots = np.arange(self.horizon * B, dtype=np.int64) % B  # flat fold row s*B+b is env slot b's
        learn = functools.partial(hooks.count_program, "learn", self.learner.learn, phase="learn")

        def collect_and_send():
            """One exploration chunk: rollout, its copy to the card, the
            n-step fold there, one copy of the rows to the host, the
            hash-routed send, and the hot tier's append of the card rows.
            Returns (per-shard watermarks after this chunk, the chunk's obs
            on the card, the finished episodes' returns)."""
            traj, chunk_returns = self._explore_rollout(
                roll, act_holder[0], steps_holder[0] < explo.warmup_steps, tracer=hooks.tracer,
            )
            with hooks.tracer.span("h2d-transfer"):
                chunk = to_device({k: traj[k] for k in TRANS_KEYS}, self.device)
            trans, fold["tail"] = self._fold(fold["tail"], chunk, fold["first"])
            fold["first"] = False
            with hooks.tracer.span("experience-send"):
                wm = plane.sender.send_rows(host_rows(trans, example), row_slots)
            if tiered is not None:
                tiered.append(trans)
            return wm, chunk["obs"], chunk_returns

        prefetch = Prefetcher(collect_and_send, name="offpolicy-xp-stage") if overlap else None
        pending_jobs = [0]

        def wait_supervised(prefetcher):
            """The staged chunk, with the shards supervised while the staging
            thread's sends wait on a dead one."""
            while True:
                try:
                    return prefetcher.get(timeout=0.25)
                except queue.Empty:
                    plane.supervise()

        stages = (
            StageSpec("collect", donate=False, overlap=overlap),
            StageSpec("stage", donate=False, overlap=overlap),
            StageSpec("learn", donate=False),
        ) + sideband_stages()
        ls = LoopState(
            state=state, key=torch.Generator(device=self.device).manual_seed(self.seed),
            iteration=iteration, env_steps=env_steps, extras={"nonce": 0},
        )

        def step(ls):
            # consume the batches prefetched during the PREVIOUS iteration;
            # in strict mode this runs before the next chunk is sent, so the
            # shard serves every sample at the ring state its watermark names
            staged = None
            if pending_jobs[0]:
                with hooks.tracer.span("sample-wait"):
                    # a shard that died is respawned while the learner waits
                    staged = sampler.get_iteration(on_wait=plane.supervise)
                pending_jobs[0] -= 1
            if prefetch is not None:
                with hooks.tracer.span("chunk-wait"):
                    wm, obs_chunk, ep_returns = wait_supervised(prefetch)
            else:
                wm, obs_chunk, ep_returns = collect_and_send()
            recent_returns.extend(ep_returns)
            ls.state = self.learner.update_obs_stats(ls.state, obs_chunk)
            if sum(wm) >= int(replay_cfg.start_sample_size):
                sampler.request_iteration(wm, self._beta(ls.env_steps, total))
                pending_jobs[0] += 1
            metrics: dict = {}
            if staged:
                infos, tds = [], []
                for batch, _seed, info in staged:
                    with hooks.tracer.span("learn"):
                        ls.state, metrics = learn(ls.state, batch)
                    infos.append(info)
                    tds.append(metrics.pop("priority/td_abs"))
                if self.prioritized:
                    # ONE batched priority frame per shard per iteration,
                    # after one read of every update's |td|
                    sampler.update_priorities(infos, torch.stack(tds).cpu().numpy())
            plane.supervise()
            act_holder[0] = ls.state
            steps_holder[0] = ls.env_steps + steps_per_iter
            base = host_metrics(metrics, recent_returns)

            def build_metrics():
                # plane.gauges() polls the shards' stats over the wire: run
                # only when the metrics cadence fires
                return dict(base(), **plane.gauges())

            return Outcome(
                metrics=build_metrics, steps=steps_per_iter,
                hook_key=derive_seed(self.seed, ls.extras["nonce"], ls.iteration + 1),
                post_metrics=lambda m_row: hooks.experience_event(**plane.telemetry_event()),
            )

        def apply_fault(ls, f):
            ls.state = faults.apply_trainer_fault(f, ls.state)
            act_holder[0] = ls.state

        def on_rollback(ls):
            rb = hooks.recovery.rollback(ls.state, fresh=self._fresh_init)
            ls.state, ls.iteration, ls.env_steps = rb.state, rb.iteration, rb.env_steps
            # shard contents are data, kept; the restored state re-arms
            # acting and the generator chain re-seeds
            act_holder[0] = ls.state
            steps_holder[0] = ls.env_steps
            ls.extras["nonce"] = rb.nonce
            ls.key = torch.Generator(device=self.device).manual_seed(derive_seed(self.seed, rb.nonce))

        try:
            engine = LoopEngine(
                hooks, total, step, stages, EngineConfig.from_session(cfg),
                on_metrics=on_metrics, apply_fault=apply_fault, on_rollback=on_rollback,
            )
            ls = engine.run(ls)
            hooks.final_checkpoint(ls.iteration, ls.env_steps, ls.state)
            return ls.state, hooks.last_metrics
        finally:
            # the exactly-once accounting before the plane stops; it is
            # quiesced only when the sends ran on this thread (a staging
            # thread may still be inside send_rows)
            try:
                hooks.tracer.event("experience_close", quiesced=float(prefetch is None), **plane.accounting())
            except Exception:
                hooks.log.warning("experience_close accounting failed", exc_info=True)
            # unblock any bounded sender or sampler wait on the staging
            # thread FIRST, so its join succeeds before plane.close() closes
            # the sockets that thread uses
            plane._stop.set()
            if prefetch is not None:
                prefetch.close()
            plane.close()

    # -- replay from the spill tier's log ------------------------------------
    def replay_from_log(self, log_path: str, max_updates: int | None = None, state=None, sample_draws=None) -> dict:
        """Offline training from the spill tier's write-ahead log.

        Reads every ``shard*.log`` under ``log_path`` (or one file) in the
        global segment order ``(seq, shard)``, streams the rows into a
        ``UniformReplay`` ring on the trainer's device, and once the ring
        holds ``start_sample_size`` rows follows each segment with
        ``updates_per_iter`` sample + learn steps. The draws come from one
        generator seeded from the session seed, and the parameters from
        ``learner.init`` on the session seed, so two runs over one log give
        equal ``params_digest``. ``state`` replaces the initial state and
        ``sample_draws`` [updates, batch_size] the sample indices (the
        tests inject JAX's; the DDPG learn draws nothing). On the card each
        sample launches the replay gather kernel.

        Torn segments are skipped by the reader and counted in
        ``torn_segments``. Returns {"state", "params_digest", "updates",
        "rows", "segments", "torn_segments", "metrics"}.
        """
        from surreal_tpu_torch.experience.sampler import batch_to_device
        from surreal_tpu_torch.experience.spill import SpillLog
        from surreal_tpu_torch.replay.uniform import UniformReplay
        from surreal_tpu_torch.utils.tree import tree_flatten

        if self.device_mode:
            raise ValueError("replay-from-log is a host-path mode (the log is written by the remote plane's shard servers)")
        replay = UniformReplay(Config(gather_impl=self.algo.get("replay_gather", "xla")).extend(self.learner.config.replay))
        rstate = replay.init(self._replay_example())
        generator = torch.Generator(device=self.device).manual_seed(self.seed)
        if state is None:
            state = self.learner.init(torch.Generator().manual_seed(self.seed))
        log = SpillLog(log_path)
        upi = int(self.algo.updates_per_iter)
        updates = rows = segments = 0
        metrics: dict = {}
        for header, flat, n in log.segments():
            spec = wire.PlaneSpec.from_json(header["spec"])
            rstate = replay.insert(rstate, batch_to_device(flat, spec, self.device))
            rows += n
            segments += 1
            if not replay.can_sample(rstate):
                continue
            done = False
            for _ in range(upi):
                if max_updates is not None and updates >= max_updates:
                    done = True
                    break
                rstate, batch, _ = replay.sample(rstate, generator, idx=_step_slice(sample_draws, updates))
                state, metrics = self.learner.learn(state, batch)
                updates += 1
            if done:
                break
        digest = hashlib.sha256()
        for leaf in tree_flatten(state).values():
            if isinstance(leaf, torch.Tensor):
                digest.update(leaf.detach().reshape(-1).view(torch.uint8).cpu().numpy().tobytes())
        return {
            "state": state,
            "params_digest": digest.hexdigest(),
            "updates": updates,
            "rows": rows,
            "segments": segments,
            "torn_segments": int(log.torn_segments),
            "metrics": {k: float(v.float().mean()) for k, v in metrics.items()},
        }

    def _fresh_init(self, nonce: int):
        """The divergence guard's fallback when no finite checkpoint exists."""
        return self.learner.init(torch.Generator().manual_seed(derive_seed(self.seed, nonce)))
