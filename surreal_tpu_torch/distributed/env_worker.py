"""Env worker, the port of ``surreal_tpu/distributed/env_worker.py``
(``run_env_worker``) on the DEALER of ``distributed/sockets.py`` in place
of zmq. It builds its envs with the port's ``envs/factory.py::make_env``
and never touches CUDA: a host env lives on the CPU, and a spawned worker
imports the port without initialising the card.

The reference's design notes follow (its ``run_agent`` actor process,
minus the policy — inference moved to the central server).

Each worker steps a *vectorized slice* of host envs and ships one
(obs, reward, done) batch per step to the inference server, receiving the
action batch back. Runs as a thread (tests, small runs) or a subprocess
(real deployments — MuJoCo releases the GIL poorly); both use the same
function.

Data plane (shm_transport.py): the worker negotiates its transport at a
hello handshake — a preallocated shared-memory slab when the server is
local and grants it, the original pickle wire otherwise — and may split
its env slice into two sub-slices, keeping one sub-slice's request in
flight while stepping the other (the double-buffered acting of Stooke &
Abbeel, 1803.02811). The steady-state loop therefore hides the server
round trip behind env stepping instead of idling through it, and never
touches the serializer when the slab transport is active.
"""

from __future__ import annotations

import threading
import time
from typing import Any

import numpy as np

from surreal_tpu_torch.distributed import shm_transport as dp
from surreal_tpu_torch.distributed.sockets import Dealer
from surreal_tpu_torch.envs.factory import make_env
from surreal_tpu_torch.session.config import Config
from surreal_tpu_torch.utils import faults


def _recv_reply(sock, stop_event, silence_s: float, steady: bool):
    """Wait for one reply frame under the server-silence budget.

    Returns the payload, or None when ``stop_event`` fires (set while we
    wait on a server that already shut down — exit cleanly, don't raise).
    Poll slices are 100 ms before the first-ever reply (the server's
    first replies can wait on a slow first forward, and a stop request
    must still interrupt promptly) and coarsen to
    500 ms in the steady state, where replies land in milliseconds and
    the slice width only bounds stop-request latency.
    """
    slice_ms = 500 if steady else 100
    deadline = time.monotonic() + silence_s
    while not sock.poll(slice_ms):
        if stop_event is not None and stop_event.is_set():
            return None
        if time.monotonic() >= deadline:
            raise TimeoutError(
                f"inference server silent for {silence_s:.0f}s"
            )
    return sock.recv()


def run_env_worker(
    env_config: Any,
    server_address: str,
    worker_id: int,
    max_steps: int | None = None,
    stop_event: threading.Event | None = None,
    transport: str = "auto",
    pipeline: bool = False,
    server_silence_s: float = 120.0,
    fault_plan: list | None = None,
    trace_id: str | None = None,
) -> int:
    """Step envs against the inference server until ``max_steps`` or
    ``stop_event``. Returns total env steps executed.

    Runs unchanged as a thread or a spawned subprocess; in the latter case
    ``env_config`` arrives as a plain picklable dict and is rehydrated.

    ``transport``: 'auto' (negotiate shm against a local server, pickle
    otherwise) | 'shm' (require the slab grant) | 'pickle'.
    ``pipeline``: split the env slice into two sub-slices and keep one
    sub-slice's request in flight while stepping the other.
    ``server_silence_s``: per-step liveness budget.
    ``fault_plan``: chaos-harness plan for SPAWNED workers (their process
    starts with an empty registry; thread workers share the trainer's and
    must NOT pass one — reconfiguring would reset the shared counters).
    ``trace_id``: the session's run-scoped trace id (SessionHooks mints
    it; spawn kwargs forward it) — carried in the shm hello / the pickle
    priming message, and every STEP frame stamps a per-worker span
    sequence + send timestamp so the server can measure the
    frame-in-flight hop.
    """
    if fault_plan:
        faults.configure(fault_plan)
    env_config = Config(env_config)
    num_envs = int(env_config.num_envs)
    n_slots = 2 if (pipeline and num_envs >= 2) else 1
    widths = (
        [num_envs] if n_slots == 1
        else [num_envs - num_envs // 2, num_envs // 2]
    )
    # every exit — stop request, timeout, socket-setup or env exception,
    # normal end — must release the envs and the DEALER socket: the
    # supervisor respawns workers under the SAME identity, and a leaked
    # socket is exactly the stale connection the handover must displace
    envs: list = []
    tr = None
    # bounded sends: a wedged server eventually fills the socket's buffers,
    # and an unbounded blocking send would hang this worker FOREVER — past
    # every supervision signal. Bounding it by the same silence budget turns
    # that hang into TimeoutError -> worker death -> supervisor respawn (the
    # recovery path that actually exists).
    sock = Dealer(f"worker-{worker_id}".encode(), send_timeout_s=max(1e-3, server_silence_s))
    try:
        sock.connect(server_address)

        for s, w in enumerate(widths):
            # seed decorrelation that also reaches adapters whose seeding
            # is fixed at construction (dm_control). Adapters seed sub-env
            # i as slot_seed + i, so slots/workers must stride by their
            # ENV WIDTH (a stride of 1 would hand most envs in the fleet
            # duplicated RNG streams): worker w's envs get the contiguous
            # block [seed + w*num_envs, seed + (w+1)*num_envs).
            slot_seed = (
                int(env_config.seed) + worker_id * num_envs + sum(widths[:s])
            )
            envs.append(
                make_env(Config(num_envs=w, seed=slot_seed).extend(env_config))
            )
        tr = dp.negotiate_worker_transport(
            sock, transport, widths, envs[0].specs, server_address,
            stop_event, timeout_s=server_silence_s, trace=trace_id,
        )
        if tr is None:
            return 0  # stop requested mid-handshake

        steps = 0
        span = 0                # per-worker span sequence (trace stitching)
        # the server derives the frame-in-flight hop as recv - t_send,
        # which is only meaningful on a SHARED clock: a remote worker's
        # wall clock can skew by more than the hop itself, so only
        # same-host workers stamp t_send (0.0 = "don't measure me", the
        # server skips it)
        stamp_clock = dp.local_address(server_address)
        act_latency_ms = None   # EWMA of the server round trip (telemetry)
        occupancy = 0.0         # EWMA: env-step time / (step + reply wait)
        sent_at = [0.0] * n_slots
        # prime every slot with its obs-only hello; from here exactly one
        # request per slot is outstanding at all times, so while we step
        # (or wait on) one sub-slice the other's round trip is in flight
        for s in range(n_slots):
            # first reset seeds from the slot config (adapters fall back
            # to their construction seed when none is passed). The pickle
            # transport has no hello handshake, so the priming message
            # carries the inherited trace id instead.
            span += 1
            tr.send(s, {
                "obs": envs[s].reset(), "trace": trace_id,
                "span": span, "t_send": time.time() if stamp_clock else 0.0,
            })
            sent_at[s] = time.monotonic()
        steady = False
        while not (stop_event is not None and stop_event.is_set()):
            fault = faults.fire("env_worker.step")
            if fault is not None:
                if fault["kind"] == "kill_worker":
                    # die like a real crash: the finally below releases the
                    # socket/envs and the trainer's supervisor must respawn
                    raise faults.FaultInjected(
                        f"chaos: kill_worker (worker {worker_id})"
                    )
                if fault["kind"] == "delay":
                    faults.sleep_ms(fault)
            t_wait0 = time.monotonic()
            payload = _recv_reply(sock, stop_event, server_silence_s, steady)
            if payload is None:
                return steps
            steady = True
            slot, actions = tr.decode_reply(payload)
            now = time.monotonic()
            wait_s = now - t_wait0
            rt_ms = (now - sent_at[slot]) * 1e3
            act_latency_ms = (
                rt_ms if act_latency_ms is None
                else 0.1 * rt_ms + 0.9 * act_latency_ms
            )
            out = envs[slot].step(actions)
            step_s = time.monotonic() - now
            occupancy = 0.1 * (step_s / max(step_s + wait_s, 1e-9)) + 0.9 * occupancy
            steps += envs[slot].num_envs
            span += 1
            msg = {
                "obs": out.obs,
                "reward": out.reward,
                "done": out.done,
                "truncated": np.asarray(
                    out.info.get("truncated", np.zeros_like(out.done))
                ),
                # round-trip latency + pipeline occupancy ride with the
                # next request so the server can expose fleet-wide gauges
                # (inference_server.queue_stats 'server/act_latency_ms',
                # 'server/pipeline_occupancy')
                "act_latency_ms": act_latency_ms,
                "pipeline_occupancy": occupancy,
                # span sequence + send stamp: the server measures the
                # frame-in-flight hop as recv - t_send (same-host workers
                # only — see stamp_clock above)
                "span": span,
                "t_send": time.time() if stamp_clock else 0.0,
            }
            if out.done.any():
                # only meaningful (and only shipped — an obs-sized copy
                # per step otherwise) when an episode actually ended; the
                # server's record path defaults terminal_obs to the step
                # obs, which np.where ignores on no-done rows anyway
                msg["terminal_obs"] = out.info.get("terminal_obs", out.obs)
            if "episode_returns" in out.info:
                # completed-episode stats ride with the observations
                # (SURVEY.md §5.5 — the reference's agents pushed these to
                # tensorplex; here the server aggregates them)
                msg["episode_returns"] = np.asarray(out.info["episode_returns"])
                msg["episode_lengths"] = np.asarray(out.info["episode_lengths"])
            if max_steps is not None and steps >= max_steps:
                # flush the final step's outcome (transition + any episode
                # stats riding on it) fire-and-forget — without this the
                # last env.step before exit would be silently lost. The
                # 'final' tag tells the server not to act on it or install
                # pending state for a worker that is about to be gone.
                try:
                    tr.send(slot, msg, final=True, noblock=True)
                except TimeoutError:
                    pass  # the server is not reading: the flush is lost
                return steps
            tr.send(slot, msg)
            sent_at[slot] = time.monotonic()
        return steps
    finally:
        if tr is not None:
            tr.close()
        # the final fire-and-forget flush is in the kernel's send buffer and
        # still leaves after the close
        sock.close()
        for env in envs:
            env.close()
