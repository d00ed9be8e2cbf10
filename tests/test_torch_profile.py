"""The port's on-demand profiling (``surreal_tpu_torch/session/profile.py``
on ``torch.profiler``) and its ``profile`` subcommand, against the
reference's (``surreal_tpu/session/profile.py`` on ``jax.profiler``, whose
start and stop are stubbed here).

- The CLI writes the same trigger file, with the same messages and exit
  codes (the program's name aside).
- The slow-iteration trigger, on the reference test's fake clock.
- The trigger file, the legacy ``session.profiler`` window, ``request``
  and a close mid-capture: the same ``profile`` event sequences, and one
  Chrome trace per port capture; a capture that cannot start is the same
  event with ``error`` in both. Exact."""

import json
import os

import jax
import pytest

import surreal_tpu.main.launch as jax_launch
import surreal_tpu_torch.main.launch as torch_launch
from surreal_tpu.session import profile as jax_profile
from surreal_tpu.session.config import Config as JaxConfig
from surreal_tpu_torch.session import profile as torch_profile
from surreal_tpu_torch.session.config import Config


class Log:
    def __init__(self):
        self.warnings = []

    def info(self, *a):
        pass

    def warning(self, *a):
        self.warnings.append(a[0] % a[1:])


class Sink:
    def __init__(self):
        self.events = []

    def event(self, type_, **kw):
        self.events.append((type_, kw))


@pytest.fixture
def clock(monkeypatch):
    """One fake monotonic clock for both managers (they read the same
    ``time`` module), starting past the trigger file's first stat, and the
    reference's jax.profiler stubbed."""
    now = [100.0]
    monkeypatch.setattr(torch_profile.time, "monotonic", lambda: now[0])
    monkeypatch.setattr(jax.profiler, "start_trace", lambda d: None)
    monkeypatch.setattr(jax.profiler, "stop_trace", lambda: None)
    return now


def test_profile_cli_writes_trigger(tmp_path, capsys):
    outs = []
    for launch, tag in ((jax_launch, "jax"), (torch_launch, "torch")):
        folder = tmp_path / tag
        os.makedirs(folder)
        assert launch.main(["profile", str(folder), "--iters", "3"]) == 0
        with open(folder / "profile.trigger") as f:
            assert json.load(f) == {"num_iters": 3}
        assert launch.main(["profile", str(tmp_path / "nope")]) == 2
        out = capsys.readouterr()
        outs.append((out.out.replace(str(folder), "F"), out.err))
    want, got = outs
    assert got[0] == want[0].replace("surreal_tpu diag", "surreal_tpu_torch diag")
    assert got[1] == want[1] and "no session folder" in got[1]
    assert torch_launch.main(["profile", str(tmp_path / "torch")]) == 0  # no --iters: an empty body
    with open(tmp_path / "torch" / "profile.trigger") as f:
        assert json.load(f) == {}


def _managers(tmp_path, session: dict):
    sinks = Sink(), Sink()
    ref = jax_profile.ProfileManager(JaxConfig(session), str(tmp_path / "ref"), sinks[0], Log())
    port = torch_profile.ProfileManager(Config(session), str(tmp_path / "port"), sinks[1], Log())
    return (ref, port), sinks


def _profile_events(sink: Sink, folder) -> list[dict]:
    out = []
    for t, kw in sink.events:
        assert t == "profile"
        kw = dict(kw, dir=os.path.relpath(kw["dir"], str(folder)))
        kw.pop("error", None)
        out.append(kw)
    return out


def _drive(tmp_path, clock, session: dict, ticks, before_tick=None, after=None):
    """Both managers through the same (dt, iteration) ticks; returns the
    port's and the reference's profile events (dirs relative to each
    folder) and the port's manager."""
    (ref, port), sinks = _managers(tmp_path, session)
    for dt, i in ticks:
        clock[0] += dt
        for pm, side in ((ref, "ref"), (port, "port")):
            if before_tick is not None:
                before_tick(pm, tmp_path / side, i)
            pm.tick(i)
    for pm in (ref, port):
        if after is not None:
            after(pm)
        pm.close()
    return (_profile_events(sinks[1], tmp_path / "port"), _profile_events(sinks[0], tmp_path / "ref"), port)


def test_slow_iteration_auto_trigger(tmp_path, clock):
    """As the reference's test: 13 ticks of 10 ms seed the EWMA, one of
    250 ms (25x, factor 3) fires a capture, the budget of one is then
    spent."""
    session = {"profile": {"slow_iter_factor": 3.0, "num_iters": 1, "max_auto_captures": 1,
                           "trigger_file": False}, "profiler": {"enabled": False}}
    ticks = [(0.01, i) for i in range(1, 14)] + [(0.25, 14), (0.01, 15), (0.01, 16), (0.01, 17), (0.5, 18)]
    got, want, port = _drive(tmp_path, clock, session, ticks)
    assert got == want and len(got) == 1
    assert got[0]["reason"].startswith("slow_iter(0.250s/") and (got[0]["start_iter"], got[0]["end_iter"]) == (14, 15)
    assert port._pending is None
    assert os.path.getsize(os.path.join(port.last_capture_dir, torch_profile.TRACE_FILE)) > 0


@pytest.mark.parametrize("case", ["trigger_file", "legacy_window", "close_mid_capture", "request"])
def test_event_sequences_match_the_reference(case, tmp_path, clock):
    session = {"profile": {"num_iters": 3}}
    before_tick = after = None
    if case == "trigger_file":
        # a trigger with num_iters 2 before iteration 2, one without a
        # body before iteration 9; the stat is throttled to once a second
        def before_tick(pm, folder, i):
            os.makedirs(folder, exist_ok=True)
            if i == 2:
                torch_profile.write_trigger(str(folder), num_iters=2)
            if i == 9:
                torch_profile.write_trigger(str(folder))
        ticks = [(0.6, i) for i in range(1, 16)]
    elif case == "legacy_window":
        session["profiler"] = {"enabled": True, "start_iter": 4, "num_iters": 2}
        session["profile"]["trigger_file"] = False
        ticks = [(0.01, i) for i in range(1, 10)]
    elif case == "close_mid_capture":
        session["profiler"] = {"enabled": True, "start_iter": 3, "num_iters": 10}
        ticks = [(0.01, i) for i in range(1, 7)]
    else:
        def before_tick(pm, folder, i):
            if i == 2:
                assert pm.request("incident-7", num_iters=2)
            if i in (3, 4):
                assert not pm.request("again")  # one window at a time
        ticks = [(0.01, i) for i in range(1, 8)]

        def after(pm):
            assert pm.request("at-close")  # queued, never started: no event
    got, want, port = _drive(tmp_path, clock, session, ticks, before_tick, after)
    assert got == want and got
    for ev in got:
        assert os.path.getsize(os.path.join(tmp_path, "port", ev["dir"], torch_profile.TRACE_FILE)) > 0
    assert not os.path.exists(tmp_path / "port" / torch_profile.TRIGGER_FILE)


def test_a_capture_that_cannot_start_is_an_error_event(tmp_path, clock):
    """A folder that is a file: both managers log it and write the same
    ``profile`` event with ``error``; training would go on."""
    blocker = tmp_path / "blocker"
    blocker.write_text("not a folder")
    session = {"profiler": {"enabled": True, "start_iter": 1, "num_iters": 1}}
    sinks, logs = (Sink(), Sink()), (Log(), Log())
    ref = jax_profile.ProfileManager(JaxConfig(session), str(blocker), sinks[0], logs[0])
    port = torch_profile.ProfileManager(Config(session), str(blocker), sinks[1], logs[1])
    for pm in (ref, port):
        pm.tick(1)
        pm.tick(2)
        pm.close()
    (wt, want), = sinks[0].events
    (gt, got), = sinks[1].events
    assert (gt, set(got), got["dir"], got["reason"]) == (wt, set(want), want["dir"], want["reason"])
    assert got["error"] and logs[1].warnings[0].startswith("profiler start failed (profiler_knob)")
