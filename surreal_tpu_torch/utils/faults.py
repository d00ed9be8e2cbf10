"""Deterministic fault injection for the trainer, SEED data-plane,
serving-tier, parameter-service, experience-plane, spill-tier and
gateway sites, the port of ``surreal_tpu/utils/faults.py``'s registry
(``FaultInjector``, ``configure_from``, ``fire``, ``drain_fired``,
``sleep_ms``, ``corrupt_array``, ``FaultInjected``, ``poison_state``,
``apply_trainer_fault``).

A plan is a list of specs ``{"site": ..., "kind": ..., "at": K, "times":
N, ...}``: the fault fires on calls ``K .. K+N-1`` (0-based) to its site,
so a plan is deterministic for a deterministic program. The sites the
port has:

    trainer.iteration   once per loop iteration (engine/core.py)
                        ``sigterm``: deliver SIGTERM to this process;
                        ``nan_state``: poison the train state with NaN;
                        ``delay``: sleep ``ms``
    engine.stage        once per boundary, before ``end_iteration``
                        ``delay_stage``: sleep ``ms``;
                        ``kill_stage``: raise FaultInjected in the
                        boundary (counted, training goes on)
    env_worker.step     once per SEED env-worker loop turn
                        ``kill_worker``: raise FaultInjected (the worker
                        dies; the trainer respawns it); ``delay``
    transport.send      once per worker request frame
                        ``drop_frame``: swallow it (the silence budget
                        recovers); ``delay_frame``: sleep ``ms``;
                        ``corrupt_slab``: NaN-stomp the obs payload
    server.serve        once per inference-server micro-batch
                        ``delay``: sleep ``ms``
    param_service.reply once per parameter-server reply
                        ``delay_reply``: sleep ``ms`` before replying
                        (past the client's timeout: the client replaces
                        its socket, the late reply is dropped)
    fleet.replica       once per inference-fleet replica serve-loop turn
                        ``kill_replica``: raise FaultInjected (the serve
                        thread dies like a crash; the fleet respawns it
                        in place); ``delay``: sleep ``ms``
    param.publish       once per parameter-fanout publish
                        ``delay_publish``: sleep ``ms``; ``drop_frame``:
                        swallow the frame on the wire (the stale acks
                        re-key the next publish with a full frame)
    experience.shard    once per replay-shard server loop pass
                        ``kill_shard``: raise FaultInjected (the shard
                        dies; the plane respawns it at the same address);
                        ``delay``: sleep ``ms``
    experience.sample   once per sample or pop a shard serves
                        ``delay_sample``: sleep ``ms`` before serving
    experience.send     once per ExperienceSender wire frame
                        ``corrupt_wire_frame``: scramble the frame (the
                        shard counts and drops it, the sender resends);
                        ``drop_frame``: swallow it; ``delay_frame``
    experience.spill    once per spill-tier segment append
                        (``experience/spill.py``)
                        ``truncate_segment``: write only a prefix of the
                        segment (a crash mid-write; the reader skips the
                        torn frame by resyncing on the next magic, and
                        counts it); ``enospc``: raise ENOSPC at the
                        append (the writer counts the error and degrades,
                        the ring keeps serving); ``delay_fsync``: sleep
                        ``ms`` before the fsync
    gateway.session     once per gateway serve-loop pass
                        ``drop_frame``: swallow the next act reply (the
                        client's bounded resend re-serves the same
                        session and seq); ``kill_replica``: kill the
                        acting session's bound fleet replica (the gateway
                        rebinds every session it held to survivors,
                        counted as migrations); ``delay``: sleep ``ms``

The reference's other sites belong to subsystems the port does not have
yet (the ops plane, causal-span emission, the watchdog, the learner
group): a plan entry for one of them raises
``NotImplementedError`` naming the site. A spawned env worker or
experience shard starts with an empty registry; its trainer or plane
forwards the plan to it. ``session_config.faults.plan`` (a list, or a JSON
string for ``--set``) configures the registry at run start, which also
resets it. ``SessionHooks`` drains the record of fired faults into
``fault`` telemetry events.
"""

from __future__ import annotations

import json
import os
import signal
import threading
import time
from typing import Any

import torch

from surreal_tpu_torch.utils.tree import tree_map

SITE_KINDS: dict[str, frozenset[str]] = {
    "trainer.iteration": frozenset({"sigterm", "nan_state", "delay"}),
    "engine.stage": frozenset({"delay_stage", "kill_stage"}),
    "env_worker.step": frozenset({"kill_worker", "delay"}),
    "transport.send": frozenset({"drop_frame", "delay_frame", "corrupt_slab"}),
    "server.serve": frozenset({"delay"}),
    "param_service.reply": frozenset({"delay_reply"}),
    "fleet.replica": frozenset({"kill_replica", "delay"}),
    "param.publish": frozenset({"delay_publish", "drop_frame"}),
    "experience.shard": frozenset({"kill_shard", "delay"}),
    "experience.sample": frozenset({"delay_sample"}),
    "experience.send": frozenset({"corrupt_wire_frame", "drop_frame", "delay_frame"}),
    "experience.spill": frozenset({"truncate_segment", "enospc", "delay_fsync"}),
    "gateway.session": frozenset({"drop_frame", "kill_replica", "delay"}),
}
SITES = frozenset(SITE_KINDS)
# the reference's sites on paths the port does not have yet
UNPORTED_SITES = frozenset({"ops.push", "trace.emit", "watchdog.eval", "lgroup.member"})


class FaultInjected(RuntimeError):
    """Raised by kill-type injections; handled like any crash."""


class FaultInjector:
    """One registry of scheduled faults (thread-safe)."""

    def __init__(self, plan: list[dict] | None = None):
        self.plan: list[dict] = []
        for entry in plan or []:
            entry = dict(entry)
            site = entry.get("site")
            if site in UNPORTED_SITES:
                raise NotImplementedError(
                    f"fault site {site!r} is on a path the PyTorch port does not have yet; "
                    f"ported sites: {sorted(SITES)}"
                )
            if site not in SITES:
                raise ValueError(f"fault site {site!r} unknown; sites: {sorted(SITES)}")
            if "kind" not in entry:
                raise ValueError(f"fault spec {entry!r} has no 'kind'")
            if entry["kind"] not in SITE_KINDS[site]:
                raise ValueError(
                    f"fault kind {entry['kind']!r} unknown for site {site!r}; kinds: {sorted(SITE_KINDS[site])}"
                )
            entry["at"] = int(entry.get("at", 0))
            entry["times"] = int(entry.get("times", 1))
            self.plan.append(entry)
        self._counts: dict[str, int] = {}
        self._fired: list[dict] = []
        self._lock = threading.Lock()

    def fire(self, site: str) -> dict | None:
        """Count one pass through ``site``; the spec scheduled for this
        call, or None."""
        if not self.plan:
            return None
        with self._lock:
            n = self._counts.get(site, 0)
            self._counts[site] = n + 1
            for f in self.plan:
                if f["site"] == site and f["at"] <= n < f["at"] + f["times"]:
                    self._fired.append({"site": site, "kind": f["kind"], "call": n})
                    return f
        return None

    def drain_fired(self) -> list[dict]:
        """Hand out (and clear) the record of fired faults."""
        with self._lock:
            out, self._fired = self._fired, []
        return out

    def counts(self) -> dict[str, int]:
        with self._lock:
            return dict(self._counts)


_injector = FaultInjector()


def configure(plan: list[dict] | None) -> FaultInjector:
    """Install a fresh registry (None or [] = no faults)."""
    global _injector
    _injector = FaultInjector(plan)
    return _injector


def configure_from(session_config) -> FaultInjector:
    """Install ``session_config.faults.plan``; a config without one resets
    the registry."""
    fc = session_config.get("faults", None)
    plan = fc.get("plan", None) if fc is not None else None
    if isinstance(plan, str):
        plan = json.loads(plan)
    return configure(plan)


def get() -> FaultInjector:
    """The installed registry."""
    return _injector


def fire(site: str) -> dict | None:
    return _injector.fire(site)


def drain_fired() -> list[dict]:
    return _injector.drain_fired()


def sleep_ms(spec: dict) -> None:
    time.sleep(float(spec.get("ms", 10.0)) / 1e3)


def corrupt_array(arr):
    """Overwrite a payload array in place with NaN (floating) or the dtype
    max (integral): the 'corrupt a slab slot' injection. Returns arr."""
    import numpy as np

    if np.issubdtype(arr.dtype, np.floating):
        arr[...] = np.nan
    elif np.issubdtype(arr.dtype, np.integer):
        arr[...] = np.iinfo(arr.dtype).max
    else:  # bool payloads: flip everything
        arr[...] = True
    return arr


def poison_state(state: Any) -> Any:
    """``state`` with its first floating leaf (in tree order) replaced by
    NaN: the next learn's gradients, params and ``health/nonfinite`` all
    go nonfinite."""
    done = [False]

    def poison(x):
        if not done[0] and isinstance(x, torch.Tensor) and x.is_floating_point():
            done[0] = True
            return torch.full_like(x, float("nan"))
        return x

    return tree_map(poison, state)


def apply_trainer_fault(spec: dict, state: Any) -> Any:
    """Interpret a ``trainer.iteration`` firing; returns the (possibly
    poisoned) state."""
    kind = spec["kind"]
    if kind == "sigterm":
        os.kill(os.getpid(), signal.SIGTERM)
        return state
    if kind == "nan_state":
        return poison_state(state)
    if kind == "delay":
        sleep_ms(spec)
        return state
    raise ValueError(f"trainer.iteration cannot apply fault kind {kind!r}")
