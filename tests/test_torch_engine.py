"""The port's loop engine (``surreal_tpu_torch/engine``) against the JAX
package's (``surreal_tpu/engine``): the same fake hooks and step closures
drive both, inline and pipelined, and every scenario must record the
same boundary sequence (iteration, env steps, state), the same stop
decisions, the same skipped and killed boundary counts and the same
interrupt and rollback handling. All comparisons are exact. The
scenarios mirror tests/test_engine.py."""

import time

import jax.numpy as jnp
import pytest
import torch

from surreal_tpu import engine as jax_engine
from surreal_tpu.utils import faults as jax_faults
from surreal_tpu_torch import engine as torch_engine
from surreal_tpu_torch.utils import faults as torch_faults

PACKAGES = {"jax": (jax_engine, jax_faults), "torch": (torch_engine, torch_faults)}


@pytest.fixture(autouse=True)
def _reset_registries():
    yield
    jax_faults.configure(None)
    torch_faults.configure(None)


class _FakeRecovery:
    def __init__(self):
        self.pending = None


class _FakeLog:
    def __init__(self):
        self.warnings = []

    def warning(self, msg, *args):
        self.warnings.append(msg % args if args else msg)


class _FakeTracer:
    def __init__(self):
        self.events = []

    def event(self, kind, **fields):
        self.events.append(kind)


class _FakeOps:
    def push_local(self, tier, **kw):
        pass


class FakeHooks:
    """The SessionHooks surface the engines touch, recorded. ``trip_at``:
    the boundary of that iteration sets the recovery's ``pending``;
    ``stop_at``: its boundary returns stop."""

    def __init__(self, trip_at=None, stop_at=None):
        self.recovery = _FakeRecovery()
        self.log = _FakeLog()
        self.tracer = _FakeTracer()
        self.ops = _FakeOps()  # the JAX engine pushes a row to its ops plane
        self.interrupted = False
        self.trip_at, self.stop_at = trip_at, stop_at
        self.boundaries = []

    def end_iteration(self, iteration, env_steps, state, key, metrics=None, on_metrics=None):
        row = metrics() if callable(metrics) else metrics
        self.boundaries.append((iteration, env_steps, int(state), row["loss"]))
        if iteration == self.trip_at:
            self.trip_at = None
            self.recovery.pending = "nonfinite"
        return row, iteration == self.stop_at


def _stages(eng, donate=False):
    return (eng.StageSpec("collect", donate=donate), eng.StageSpec("learn", donate=donate)) + eng.sideband_stages()


def _run(pkg, scenario):
    """Run one scenario under one package; the record it leaves."""
    eng, faults = PACKAGES[pkg]
    hooks = FakeHooks(trip_at=scenario.get("trip_at"), stop_at=scenario.get("stop_at"))
    faults.configure(scenario.get("plan"))
    steps, rollbacks, votes = [], [], []

    def step(ls):
        steps.append((ls.iteration, ls.env_steps))
        if ls.iteration == scenario.get("interrupt_at"):
            hooks.interrupted = True
        ls.state = ls.iteration + 1
        skip = scenario.get("skip_odd", False) and ls.env_steps % 2 == 0
        return eng.Outcome(metrics={"loss": 0.5 * ls.iteration}, hook_key=None, steps=1, skip_boundary=skip)

    def on_rollback(ls):
        rollbacks.append(ls.iteration)
        hooks.recovery.pending = None
        ls.iteration, ls.env_steps = 1, 1

    def agree(iteration, stop):
        votes.append((iteration, stop))
        return stop or iteration >= scenario["agree_at"]

    engine = eng.LoopEngine(
        None if scenario.get("no_hooks") else hooks, scenario["total"], step, _stages(eng),
        eng.EngineConfig(pipeline_sidebands=scenario.get("pipelined", False),
                         stage_timeout_s=scenario.get("timeout", 30.0)),
        on_rollback=on_rollback, agree_stop=agree if "agree_at" in scenario else None,
    )
    ls = engine.run(eng.LoopState(state=0, key=None, iteration=0, env_steps=0))
    gauges = engine.gauge_row()
    return {
        "pipelined": engine.pipelined,
        "final": (ls.iteration, ls.env_steps, int(ls.state)),
        "steps": steps,
        "boundaries": sorted(hooks.boundaries),
        "rollbacks": rollbacks,
        "votes": votes,
        "deferred": gauges["engine/deferred_boundaries"],
        "skipped": gauges["engine/skipped_boundaries"],
        "kills": gauges["engine/stage_kills"],
        "engine_events": hooks.tracer.events.count("engine"),
        "warned": bool(hooks.log.warnings),
        "pending": engine._pending,
    }


SCENARIOS = {
    "inline": dict(total=5),
    "pipelined": dict(total=8, pipelined=True),
    "inline_stop": dict(total=10, stop_at=4),
    "pipelined_stop": dict(total=10, stop_at=4, pipelined=True),
    "inline_interrupt": dict(total=100, interrupt_at=3),
    "pipelined_interrupt": dict(total=100, interrupt_at=3, pipelined=True),
    "inline_rollback": dict(total=6, trip_at=3),
    "pipelined_rollback": dict(total=6, trip_at=3, pipelined=True),
    "inline_kill_stage": dict(total=3, plan=[{"site": "engine.stage", "kind": "kill_stage", "at": 0}]),
    "pipelined_kill_stage": dict(
        total=6, pipelined=True, plan=[{"site": "engine.stage", "kind": "kill_stage", "at": 1}]
    ),
    "skip_boundary": dict(total=6, skip_odd=True),
    "agree_stop": dict(total=100, agree_at=3),
    "agree_stop_no_hooks": dict(total=100, agree_at=3, no_hooks=True),
    # the boundary of iteration 2 is wedged for 1 s against a 50 ms bound:
    # the eight after it are skipped and counted, the wedged one drains
    "pipelined_wedged": dict(
        total=10, pipelined=True, timeout=0.05,
        plan=[{"site": "engine.stage", "kind": "delay_stage", "at": 1, "ms": 1000}],
    ),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_engine_boundary_sequence_matches_jax(name):
    scenario = SCENARIOS[name]
    want, got = _run("jax", scenario), _run("torch", scenario)
    assert got == want
    # and the scenario exercised what it names
    if name == "pipelined_interrupt":  # inline, the real hooks turn the latch into stop
        assert want["final"][0] == 4
    if "rollback" in name:
        assert want["rollbacks"]
    if "kill" in name:
        assert want["kills"] == 1.0
    if name == "pipelined_wedged":
        assert want["skipped"] == 8.0 and want["warned"] and want["pending"] is None


def test_engine_pins_a_clone_when_a_stage_updates_in_place():
    """The port's counterpart of the reference's donation pin: a deferred
    boundary behind an in-place stage reads clones of the state's tensors
    (equal values, other storage); without such a stage, or inline, it
    reads the state itself."""
    eng = torch_engine
    state = {"w": torch.arange(4.0), "n": 3}
    ls = eng.LoopState(state=state, key=None, iteration=0, env_steps=0)
    out = eng.Outcome(metrics={}, hook_key=None, steps=1)
    step = lambda ls: out  # noqa: E731

    def engine(donate, pipelined):
        return eng.LoopEngine(
            FakeHooks(), 1, step, _stages(eng, donate=donate), eng.EngineConfig(pipeline_sidebands=pipelined)
        )

    pinned = engine(True, True)._pin_state(ls, out)
    assert pinned["w"].data_ptr() != state["w"].data_ptr() and torch.equal(pinned["w"], state["w"])
    assert pinned["n"] == 3
    assert engine(False, True)._pin_state(ls, out) is state
    assert engine(True, False)._pin_state(ls, out) is state
    # the reference pins alike
    jstate = jnp.arange(4.0)
    jls = jax_engine.LoopState(state=jstate, key=None, iteration=0, env_steps=0)
    jout = jax_engine.Outcome(metrics={}, hook_key=None, steps=1)
    jeng = jax_engine.LoopEngine(
        FakeHooks(), 1, lambda ls: jout, _stages(jax_engine, donate=True),
        jax_engine.EngineConfig(pipeline_sidebands=True),
    )
    assert jeng._pin_state(jls, jout) is not jstate


def test_engine_config_and_stages_match_jax():
    """``EngineConfig.from_session``, ``overlap_collect`` and the side-band
    stage declarations read one config tree the same way."""
    from surreal_tpu.session.config import Config as JaxConfig
    from surreal_tpu_torch.session.config import Config

    for tree in (
        {"topology": {"overlap_rollouts": True}},
        {"engine": {"pipeline_sidebands": True, "stage_timeout_s": 2, "queue_depth": 0},
         "topology": {"overlap_rollouts": False}},
        {"engine": {"overlap_collect": False}, "topology": {}},
    ):
        j, t = JaxConfig(tree), Config(tree)
        assert jax_engine.EngineConfig.from_session(j) == jax_engine.EngineConfig(
            **vars(torch_engine.EngineConfig.from_session(t))
        )
        assert jax_engine.overlap_collect(j) == torch_engine.overlap_collect(t)
    assert [s.describe() for s in jax_engine.sideband_stages()] == [
        s.describe() for s in torch_engine.sideband_stages()
    ]
    with pytest.raises(TypeError):
        torch_engine.StageSpec("collect")  # donate has no default


def test_wedged_boundary_does_not_stall_the_loop():
    """The port alone, timed: ten iterations against a 1 s wedge and a
    50 ms bound finish in well under the time the wedge would take ten
    times over."""
    t0 = time.perf_counter()
    rec = _run("torch", SCENARIOS["pipelined_wedged"])
    assert rec["final"][0] == 10
    assert time.perf_counter() - t0 < 5.0
