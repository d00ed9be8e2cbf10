"""Tenant load generator, the port of ``surreal_tpu/gateway/loadgen.py``:
the gateway's fault sites replayed as TRAFFIC instead of injected faults.

    profile        traffic shape
    ------------   -------------------------------------------------------
    steady         paced acts on one session (the healthy baseline)
    attach_storm   attach -> few acts -> detach, in a tight loop
    hot_key        max-rate acts of ONE repeated observation (the act
                   cache's hot key and the rate limit's worst case)
    act_burst      idle, then a back-to-back burst past the token bucket
    adversarial    garbage, truncated and wrong-size frames

Everything a generator does or suffers is counted (the ``loadgen/*``
gauges and one ``loadgen`` summary event): acts, rejections, act errors,
timeouts, hostile frames sent. A rejection is an EXPECTED outcome for the
abusive profiles: the generator records it and keeps going, never
retrying itself into a second storm.

Client side only: real :class:`GatewaySession` handles over the port's
wire, plus one bare DEALER for the adversarial profile (hostile bytes
must not come from the well-formed codec). No pickling, no device work.
"""

from __future__ import annotations

import threading
import time
import uuid

import numpy as np

from surreal_tpu_torch.distributed import sockets
from surreal_tpu_torch.gateway.protocol import ACT, MAGIC, GatewayError, GatewaySession

PROFILES = (
    "steady", "attach_storm", "hot_key", "act_burst", "adversarial",
)


def default_mix(n_steady: int = 2) -> list[dict]:
    """The production-shaped tenant mix: a floor of well-behaved steady
    tenants plus one of each abusive profile (the e2e chaos run's
    traffic side)."""
    mix = [
        {"tenant": f"steady-{i}", "profile": "steady", "rate_hz": 20.0}
        for i in range(max(1, int(n_steady)))
    ]
    mix += [
        {"tenant": "churner", "profile": "attach_storm", "acts_per_life": 2},
        {"tenant": "hotkey", "profile": "hot_key"},
        {"tenant": "bursty", "profile": "act_burst",
         "burst_n": 32, "idle_s": 0.25},
        {"tenant": "mallory", "profile": "adversarial", "rate_hz": 50.0},
    ]
    return mix


class _Worker:
    """One tenant thread's counters (read without a lock: single-writer
    ints, torn reads impossible in CPython)."""

    __slots__ = ("spec", "thread", "attaches", "detaches", "acts",
                 "rejected", "act_errors", "timeouts", "hostile",
                 "rtt_ms_sum", "alive_error")

    def __init__(self, spec: dict):
        self.spec = spec
        self.thread: threading.Thread | None = None
        self.attaches = 0
        self.detaches = 0
        self.acts = 0
        self.rejected = 0
        self.act_errors = 0
        self.timeouts = 0
        self.hostile = 0
        self.rtt_ms_sum = 0.0
        self.alive_error: str | None = None


class LoadGenerator:
    """Drives a tenant mix against one gateway address.

    ``start()`` launches one daemon thread per tenant spec; ``stop()``
    joins them and emits the ``loadgen`` summary event. Specs are dicts:
    ``{"tenant", "profile", ...profile knobs...}`` (see
    :func:`default_mix`); unknown profiles fail fast at ``start()`` —
    a load test that silently idles is worse than one that errors."""

    def __init__(self, address: str, *, tenants: list[dict] | None = None,
                 obs_shape=(1, 4), obs_dtype: str = "<f4", seed: int = 0,
                 timeout_s: float = 2.0, retries: int = 2, on_event=None):
        self.address = str(address)
        self.obs_shape = tuple(int(d) for d in obs_shape)
        self.obs_dtype = str(obs_dtype)
        self.timeout_s = float(timeout_s)
        self.retries = max(1, int(retries))
        self._on_event = on_event
        self._seed = int(seed)
        self._stop = threading.Event()
        specs = tenants if tenants is not None else default_mix()
        for s in specs:
            if s.get("profile") not in PROFILES:
                raise ValueError(
                    f"unknown loadgen profile {s.get('profile')!r} "
                    f"(tenant {s.get('tenant')!r}); choose from {PROFILES}"
                )
        self._workers = [_Worker(dict(s)) for s in specs]
        self._started = False

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "LoadGenerator":
        if self._started:
            return self
        self._started = True
        self._stop.clear()
        for i, w in enumerate(self._workers):
            w.thread = threading.Thread(
                target=self._run, args=(w, i),
                name=f"loadgen-{w.spec.get('tenant', i)}", daemon=True,
            )
            w.thread.start()
        return self

    def stop(self, timeout_s: float = 10.0) -> dict:
        """Signal every tenant thread, join, emit the summary event, and
        return the summary dict (also what ``report()`` serves)."""
        self._stop.set()
        for w in self._workers:
            if w.thread is not None:
                w.thread.join(timeout_s)
        rep = self.report()
        if self._on_event is not None:
            self._on_event("loadgen", **rep)
        return rep

    # -- the per-tenant loops ------------------------------------------------
    def _session(self, w: _Worker) -> GatewaySession:
        s = GatewaySession(
            self.address, tenant=str(w.spec.get("tenant", "loadgen")),
            obs_shape=self.obs_shape, obs_dtype=self.obs_dtype,
            timeout_s=self.timeout_s, retries=self.retries,
        )
        w.attaches += 1
        return s

    def _act(self, w: _Worker, session: GatewaySession, obs) -> bool:
        """One counted act; False = the session is no longer usable and
        the profile loop should re-attach (or give up this life)."""
        t0 = time.monotonic()
        try:
            session.act(obs)
        except GatewayError:
            w.act_errors += 1  # throttle/eviction/quota: the expected
            # outcome for abusive profiles — counted, loop continues
            return True
        except TimeoutError:
            w.timeouts += 1
            return False
        w.acts += 1
        w.rtt_ms_sum += (time.monotonic() - t0) * 1e3
        return True

    def _run(self, w: _Worker, index: int) -> None:
        rng = np.random.default_rng(self._seed + index)
        profile = w.spec["profile"]
        try:
            if profile == "adversarial":
                self._run_adversarial(w)
            else:
                getattr(self, f"_run_{profile}")(w, rng)
        except (GatewayError, TimeoutError, OSError) as e:
            # a tenant thread dying early is a RESULT, not a crash: the
            # generator records why and the report carries it
            w.alive_error = f"{type(e).__name__}: {e}"

    def _obs(self, rng) -> np.ndarray:
        return rng.standard_normal(self.obs_shape).astype(np.float32)

    def _run_steady(self, w: _Worker, rng) -> None:
        period = 1.0 / max(1e-3, float(w.spec.get("rate_hz", 20.0)))
        session = self._session(w)
        try:
            while not self._stop.is_set():
                if not self._act(w, session, self._obs(rng)):
                    session.close()
                    session = self._session(w)
                self._stop.wait(period)
        finally:
            session.close()
            w.detaches += 1

    def _run_attach_storm(self, w: _Worker, rng) -> None:
        acts_per_life = int(w.spec.get("acts_per_life", 2))
        pause = float(w.spec.get("pause_s", 0.0))
        while not self._stop.is_set():
            try:
                session = self._session(w)
            except GatewayError:
                w.rejected += 1  # quota says no: the storm IS the test
                self._stop.wait(max(pause, 0.01))
                continue
            for _ in range(acts_per_life):
                if self._stop.is_set():
                    break
                if not self._act(w, session, self._obs(rng)):
                    break
            session.close()
            w.detaches += 1
            if pause:
                self._stop.wait(pause)

    def _run_hot_key(self, w: _Worker, rng) -> None:
        hot = self._obs(rng)  # ONE observation, hammered forever — the
        # act-cache hot key and the rate-limit worst case in one tenant
        session = self._session(w)
        try:
            while not self._stop.is_set():
                if not self._act(w, session, hot):
                    session.close()
                    session = self._session(w)
        finally:
            session.close()
            w.detaches += 1

    def _run_act_burst(self, w: _Worker, rng) -> None:
        burst_n = int(w.spec.get("burst_n", 32))
        idle_s = float(w.spec.get("idle_s", 0.25))
        session = self._session(w)
        try:
            while not self._stop.is_set():
                for _ in range(burst_n):  # no pacing: the burst must
                    # outrun the token bucket to mean anything
                    if self._stop.is_set():
                        break
                    if not self._act(w, session, self._obs(rng)):
                        session.close()
                        session = self._session(w)
                self._stop.wait(idle_s)
        finally:
            session.close()
            w.detaches += 1

    def _run_adversarial(self, w: _Worker) -> None:
        """The frame boundary under fire: hostile payloads straight onto
        the wire (garbage, truncated header, unknown kind, wrong-size
        body). Every frame the server must count-and-drop, sent on a bare
        DEALER so the codec cannot accidentally make them well-formed."""
        period = 1.0 / max(1e-3, float(w.spec.get("rate_hz", 50.0)))
        hostile = (
            b"",
            b"garbage that is not a gateway frame",
            MAGIC,                      # magic alone: truncated header
            MAGIC + bytes([0xEE]),      # unknown frame kind
            MAGIC + bytes([ACT]) + b"\x01",  # act frame, body too short
        )
        sock = sockets.Dealer(f"loadgen-{w.spec.get('tenant', 'adversarial')}-{uuid.uuid4().hex[:8]}".encode(),
                              self.timeout_s, reconnect=True)
        sock.connect(self.address)
        try:
            i = 0
            while not self._stop.is_set():
                sock.send(hostile[i % len(hostile)])
                w.hostile += 1
                i += 1
                # drain whatever the server answered (ERR frames) so the
                # socket's queue stays bounded
                while sock.poll(0):
                    sock.recv()
                self._stop.wait(period)
        finally:
            sock.close()

    # -- reporting -----------------------------------------------------------
    def gauges(self) -> dict[str, float]:
        """The generator-side ``loadgen/*`` counters (GAUGE_REGISTRY
        documents each) — the traffic half of the control-plane story,
        next to the gateway's server-side admission gauges."""
        acts = sum(w.acts for w in self._workers)
        rtt = sum(w.rtt_ms_sum for w in self._workers)
        return {
            "loadgen/tenants": float(len(self._workers)),
            "loadgen/attaches": float(
                sum(w.attaches for w in self._workers)
            ),
            "loadgen/detaches": float(
                sum(w.detaches for w in self._workers)
            ),
            "loadgen/acts": float(acts),
            "loadgen/act_errors": float(
                sum(w.act_errors for w in self._workers)
            ),
            "loadgen/rejected": float(
                sum(w.rejected for w in self._workers)
            ),
            "loadgen/timeouts": float(
                sum(w.timeouts for w in self._workers)
            ),
            "loadgen/hostile_frames": float(
                sum(w.hostile for w in self._workers)
            ),
            "loadgen/act_rtt_ms": (rtt / acts) if acts else 0.0,
        }

    def report(self) -> dict:
        """Per-tenant breakdown + the aggregate gauges (the ``loadgen``
        event body and the bench campaign's raw material)."""
        tenants = {}
        for w in self._workers:
            tenants[str(w.spec.get("tenant"))] = {
                "profile": w.spec["profile"],
                "attaches": w.attaches, "detaches": w.detaches,
                "acts": w.acts, "act_errors": w.act_errors,
                "rejected": w.rejected, "timeouts": w.timeouts,
                "hostile_frames": w.hostile,
                "error": w.alive_error,
            }
        return {"tenants": tenants, **self.gauges()}
