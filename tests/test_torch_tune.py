"""The port's program autotuner (``surreal_tpu_torch/tune/``, the ``tune``
subcommand, ``algo.autotune`` in the three trainers) against the JAX
package's ``surreal_tpu/tune/``, on the CPU:

- ``fingerprint_dict`` of one config tree is the reference's, given the
  same platform and device kind, but for the framework-version key
  (``torch`` where the reference has ``jax``); exact. The key is stable,
  moves with the geometry and not with the tuned knobs.
- a cache entry written by the reference reads back in the port; a
  corrupt one reads as a miss; ``resolve_tuning_cache_dir`` is the
  reference's.
- ``candidate_space``, ``search_space_for`` and ``default_point`` are the
  reference's restricted to the port's knobs (no unroll dimension, no
  'pallas', no ``replay_gather``: they change nothing in the port), for
  PPO, IMPALA and DDPG on device and host envs; exact.
- ``_synthetic_learn_batch`` is element-equal to the reference's.
- with ``measure_point`` replaced in both packages by one timing table,
  ``tune_workload`` makes the reference's trials in its order, minus the
  reference-only ones (timed equal to the incumbent, so never adopted),
  and adopts the same winner; the second run is a pure hit.
- ``resolve_autotune`` decides as the reference's in each mode; an
  unknown mode raises the reference's message.
- real searches at a tiny size (2 envs x 8 steps, one measured
  iteration), then ``Trainer``, ``OffPolicyTrainer`` and ``SEEDTrainer``
  in 'cache' mode build with the winner and write one ``tune`` event; the
  ``tune`` CLI writes the cache, the artifact and the event, its second
  run is a pure hit, and ``diag`` renders it."""

import json
import os

import numpy as np
import pytest

import surreal_tpu.main.launch as jax_launch
import surreal_tpu.tune.search as jax_search
import surreal_tpu_torch.main.launch as torch_launch
import surreal_tpu_torch.tune.search as torch_search
from surreal_tpu.envs import make_env as jax_make_env
from surreal_tpu.learners import build_learner as jax_build_learner
from surreal_tpu.session.config import Config as JaxConfig
from surreal_tpu.session.default_configs import base_config as jax_base_config
from surreal_tpu.tune import TuningCache as JaxTuningCache
from surreal_tpu.tune import resolve_autotune as jax_resolve_autotune
from surreal_tpu.tune import resolve_tuning_cache_dir as jax_resolve_tuning_cache_dir
from surreal_tpu.tune import space as jax_space
from surreal_tpu.tune.fingerprint import fingerprint_dict as jax_fingerprint_dict
from surreal_tpu_torch.envs import make_env
from surreal_tpu_torch.launch.offpolicy_trainer import OffPolicyTrainer
from surreal_tpu_torch.launch.seed_trainer import SEEDTrainer
from surreal_tpu_torch.launch.trainer import Trainer
from surreal_tpu_torch.learners import build_learner
from surreal_tpu_torch.session.config import Config
from surreal_tpu_torch.session.default_configs import base_config
from surreal_tpu_torch.session.telemetry import _iter_jsonl, diag_report, diag_summary
from surreal_tpu_torch.tune import (
    TuningCache,
    resolve_autotune,
    resolve_tuning_cache_dir,
    workload_fingerprint,
)
from surreal_tpu_torch.tune import space as torch_space
from surreal_tpu_torch.tune.fingerprint import fingerprint_dict
from surreal_tpu_torch.utils import faults

# the knobs the port searches, and the reference's values of them that
# the port leaves out ('pallas' launches the 'xla' kernel on the card)
PORT_KNOBS = ("precision", "gae_impl", "shuffle", "vtrace_impl")
PORT_DROPS = ("pallas",)


def _tree(folder, algo="ppo", env="jax:pendulum", num_envs=8, session=None, **algo_over):
    return {
        "learner_config": {"algo": {"name": algo, **algo_over}},
        "env_config": {"name": env, "num_envs": num_envs},
        "session_config": {
            "folder": str(folder),
            "metrics": {"every_n_iters": 1, "tensorboard": False, "console": False},
            "checkpoint": {"every_n_iters": 0},
            "eval": {"every_n_iters": 0},
            **(session or {}),
        },
    }


def _bundles(folder, *args, **kw):
    """(the reference's config, the port's) from one tree; the port's on
    the CPU backend."""
    tree = _tree(folder, *args, **kw)
    port = json.loads(json.dumps(tree))
    port["session_config"]["backend"] = "cpu"
    return JaxConfig(tree).extend(jax_base_config()), Config(port).extend(base_config())


def _extended(jcfg, tcfg):
    """Each package's fully extended learner tree."""
    jenv = jax_make_env(jcfg.env_config)
    jext = jax_build_learner(jcfg.learner_config, jenv.specs).config
    tenv = make_env(tcfg.env_config, "cpu")
    text = build_learner(tcfg.learner_config, tenv.specs, "cpu").config
    for env in (jenv, tenv):
        if hasattr(env, "close"):
            env.close()
    return jext, text


WORKLOADS = {
    "ppo-pendulum": dict(algo="ppo", env="jax:pendulum", horizon=8),
    "impala-cartpole": dict(algo="impala", env="jax:cartpole", horizon=8),
    "ddpg-lift": dict(algo="ddpg", env="jax:lift", horizon=8, updates_per_iter=4),
    "ppo-gym-cartpole": dict(algo="ppo", env="gym:CartPole-v1", horizon=8),
    "impala-gym-cartpole": dict(algo="impala", env="gym:CartPole-v1", horizon=8),
    "ddpg-gym-pendulum": dict(algo="ddpg", env="gym:Pendulum-v1", horizon=8),
}


# -- fingerprint --------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_fingerprint_matches_reference_but_framework_key(name, tmp_path):
    jcfg, tcfg = _bundles(tmp_path, **WORKLOADS[name])
    jext, text = _extended(jcfg, tcfg)
    want = jax_fingerprint_dict(jext, jcfg.env_config, platform="gpu", device_kind="NVIDIA H100", jax_version="v")
    got = fingerprint_dict(text, tcfg.env_config, platform="gpu", device_kind="NVIDIA H100", torch_version="v")
    assert want.pop("jax") == got.pop("torch") == "v"
    assert json.loads(json.dumps(got)) == json.loads(json.dumps(want))


def test_fingerprint_stable_geometry_sensitive_and_blind_to_tuned_knobs(tmp_path):
    _, cfg = _bundles(tmp_path, horizon=8)
    _, ext = _extended(*_bundles(tmp_path, horizon=8))
    k1, fp1 = workload_fingerprint(ext, cfg.env_config, device="cpu")
    k2, _ = workload_fingerprint(ext, cfg.env_config, device="cpu")
    assert k1 == k2 and len(k1) == 16
    assert fp1["backend"] == fp1["device_kind"] == "cpu" and fp1["env"]["num_envs"] == 8
    _, wide = _bundles(tmp_path, horizon=8, num_envs=16)
    assert workload_fingerprint(ext, wide.env_config, device="cpu")[0] != k1
    _, ext_h = _extended(*_bundles(tmp_path, horizon=16))
    assert workload_fingerprint(ext_h, cfg.env_config, device="cpu")[0] != k1
    _, ext_tuned = _extended(*_bundles(tmp_path, horizon=8, gae_impl="assoc", shuffle="row", precision="bf16",
                                       rollout_unroll=8, autotune="cache"))
    assert workload_fingerprint(ext_tuned, cfg.env_config, device="cpu")[0] == k1


# -- cache --------------------------------------------------------------------

def test_reference_cache_entry_reads_back_and_corrupt_is_a_miss(tmp_path):
    entry = {"config": {"precision": "f32", "gae_impl": "assoc"}, "chosen_ms": 1.5, "trials": []}
    path = JaxTuningCache(str(tmp_path / "tc")).store("abc", entry)
    cache = TuningCache(str(tmp_path / "tc"))
    assert cache.lookup("abc") == json.loads(json.dumps(entry))
    assert cache.lookup("missing") is None
    with open(path, "w") as f:
        f.write("{torn json")
    assert cache.lookup("abc") is None
    for cache_dir in (None, "rel", "/abs/tc"):
        s = {"folder": str(tmp_path), "tuning_cache_dir": cache_dir}
        assert resolve_tuning_cache_dir(Config(s)) == jax_resolve_tuning_cache_dir(JaxConfig(s))


# -- space --------------------------------------------------------------------

def _restricted(dims) -> list:
    return [(n, [v for v in vals if v not in PORT_DROPS]) for n, vals in dims if n in PORT_KNOBS]


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_space_is_the_reference_restricted_to_the_port_knobs(name, tmp_path):
    jcfg, tcfg = _bundles(tmp_path, **WORKLOADS[name])
    jext, text = _extended(jcfg, tcfg)
    assert torch_space.candidate_space(text) == _restricted(jax_space.candidate_space(jext))
    assert torch_search.search_space_for(tcfg, text) == _restricted(jax_search.search_space_for(jcfg, jext))
    want = jax_space.default_point(jext)
    assert torch_space.default_point(text) == {k: v for k, v in want.items() if k in PORT_KNOBS}
    for dim in ("gae_unroll", "precision"):
        for inc in ({"gae_impl": "assoc"}, {"vtrace_impl": "assoc"}, {}):
            assert torch_space.skip_dimension(dim, inc, text) == jax_space.skip_dimension(dim, inc, jext)


# -- the synthetic learn batch ------------------------------------------------

@pytest.mark.parametrize("env", ["gym:CartPole-v1", "jax:pendulum", "jax:pong16"])
def test_synthetic_learn_batch_equals_the_reference(env, tmp_path):
    jcfg, tcfg = _bundles(tmp_path, env=env)
    want = jax_search._synthetic_learn_batch(jax_make_env(jcfg.env_config).specs, 5, 3, seed=4)
    got = torch_search._synthetic_learn_batch(make_env(tcfg.env_config, "cpu").specs, 5, 3, seed=4)
    assert got.keys() == want.keys()
    for k in want:
        pairs = [(got[k][kk], want[k][kk]) for kk in want[k]] if isinstance(want[k], dict) else [(got[k], want[k])]
        for g, w in pairs:
            assert g.dtype == w.dtype and g.shape == w.shape, k
            np.testing.assert_array_equal(g, w, err_msg=k)


# -- the search, on one timing table -----------------------------------------

def _table_ms(config, point, *args, **kwargs) -> float:
    """One timing table for both packages: a function of the port's knobs
    only ('pallas' is 'xla'), so the reference's other trials time equal
    to their incumbent."""
    ms = 100.0
    ms += {"f32": 5.0, "bf16": -10.0}.get(point.get("precision"), 0.0)
    ms += {"assoc": -5.0}.get(point.get("gae_impl"), 0.0)
    ms += {"assoc": -4.0}.get(point.get("vtrace_impl"), 0.0)
    ms += {"row": 1.0}.get(point.get("shuffle"), 0.0)
    return ms


def _port_trials(ref: dict) -> list:
    """The reference's trials that set only port knobs away from the
    default, projected onto the port's knobs."""
    default = ref["default"]
    out = []
    for t in ref["trials"]:
        cfg = t["config"]
        if any(cfg[k] != default[k] for k in cfg if k not in PORT_KNOBS) or set(cfg.values()) & set(PORT_DROPS):
            continue
        out.append({"config": {k: v for k, v in cfg.items() if k in PORT_KNOBS}, "iter_ms": t["iter_ms"]})
    return out


@pytest.mark.parametrize("name", ["ppo-pendulum", "impala-gym-cartpole", "ddpg-lift"])
def test_search_makes_the_reference_trials_and_winner(name, tmp_path, monkeypatch):
    monkeypatch.setattr(jax_search, "measure_point", _table_ms)
    monkeypatch.setattr(torch_search, "measure_point", _table_ms)
    jcfg, _ = _bundles(tmp_path / "jax", **WORKLOADS[name])
    _, tcfg = _bundles(tmp_path / "torch", **WORKLOADS[name])
    want = jax_search.tune_workload(jcfg)
    got = torch_search.tune_workload(tcfg, device="cpu")
    assert not got["cache_hit"] and got["measured"] == len(got["trials"])
    assert got["trials"] == _port_trials(want)
    assert got["config"] == {k: v for k, v in want["config"].items() if k in PORT_KNOBS}
    assert got["default"] == {k: v for k, v in want["default"].items() if k in PORT_KNOBS}
    assert (got["default_ms"], got["chosen_ms"]) == (want["default_ms"], want["chosen_ms"])
    assert got["platform"] == got["device_kind"] == "cpu" and "torch" in got and "jax" not in got
    assert got["measure"]["surface"] == want["measure"]["surface"]
    again = torch_search.tune_workload(tcfg, device="cpu")
    assert again["cache_hit"] and again["measured"] == 0 and again["config"] == got["config"]


def test_host_ddpg_has_nothing_to_search(tmp_path):
    _, tcfg = _bundles(tmp_path, **WORKLOADS["ddpg-gym-pendulum"])
    with pytest.raises(ValueError, match="no searchable"):
        torch_search.tune_workload(tcfg, device="cpu")


# -- resolve_autotune -----------------------------------------------------------

def _decide(jcfg, tcfg):
    jext, text = _extended(jcfg, tcfg)
    want = jax_resolve_autotune(jcfg, jext)
    got = resolve_autotune(tcfg, text, "cpu")
    return want, got


def _same(want, got):
    assert (got.mode, got.hit, got.applied, got.source, got.note) == (
        want.mode, want.hit, {k: v for k, v in want.applied.items() if k in PORT_KNOBS}, want.source, want.note)


@pytest.mark.parametrize("mode", ["off", "cache-hit", "cache-miss", "search", "search-host-ddpg"])
def test_resolve_autotune_decides_as_the_reference(mode, tmp_path, monkeypatch):
    monkeypatch.setattr(jax_search, "measure_point", _table_ms)
    monkeypatch.setattr(torch_search, "measure_point", _table_ms)
    work = dict(WORKLOADS["ddpg-gym-pendulum" if mode == "search-host-ddpg" else "ppo-pendulum"])
    work["autotune"] = mode.split("-")[0]
    jcfg, _ = _bundles(tmp_path / "jax", **work)
    _, tcfg = _bundles(tmp_path / "torch", **work)
    if mode == "cache-hit":
        tuned = {"precision": "f32", "gae_impl": "assoc", "shuffle": "row"}
        jext, text = _extended(jcfg, tcfg)
        jkey, _ = jax_search.workload_fingerprint(jext, jcfg.env_config)
        tkey, _ = workload_fingerprint(text, tcfg.env_config, device="cpu")
        JaxTuningCache(jax_resolve_tuning_cache_dir(jcfg.session_config)).store(jkey, {"config": tuned})
        TuningCache(resolve_tuning_cache_dir(tcfg.session_config)).store(tkey, {"config": tuned})
    want, got = _decide(jcfg, tcfg)
    _same(want, got)
    assert got.telemetry()["hit"] == bool(want.hit)
    if mode in ("cache-hit", "search"):
        assert tcfg.learner_config.algo.gae_impl == "assoc"  # applied to the raw tree, for the rebuild


def test_search_refuses_a_process_group_of_more_than_one(tmp_path, monkeypatch):
    """Ranks would time with their own noise and pick divergent programs:
    'search' refuses a process group, as the reference refuses
    ``jax.process_count() > 1``; 'cache' is deterministic across ranks."""
    import surreal_tpu_torch.tune as torch_tune

    monkeypatch.setattr(torch_tune, "_multi_process", lambda: True)
    monkeypatch.setattr(torch_search, "measure_point", _table_ms)
    jcfg, tcfg = _bundles(tmp_path, horizon=8, autotune="search")
    _, text = _extended(jcfg, tcfg)
    with pytest.raises(ValueError, match="single-process only"):
        resolve_autotune(tcfg, text, "cpu")
    jcached, cached = _bundles(tmp_path, horizon=8, autotune="cache")
    assert resolve_autotune(cached, _extended(jcached, cached)[1], "cpu").source == "default"


def test_unknown_autotune_mode_raises_the_reference_message(tmp_path):
    jcfg, tcfg = _bundles(tmp_path, horizon=8, autotune="always")
    with pytest.raises(ValueError) as want:
        _decide(jcfg, tcfg)
    with pytest.raises(ValueError) as got:
        Trainer(tcfg, device="cpu")
    assert str(got.value) == str(want.value) and "autotune" in str(got.value)


# -- real searches, then the trainers in 'cache' mode -------------------------

def _tune_events(folder) -> list[dict]:
    return [e for e in _iter_jsonl(os.path.join(str(folder), "telemetry", "events.jsonl")) if e["type"] == "tune"]


def _small(folder, **kw):
    return _bundles(folder, **kw)[1]


@pytest.mark.parametrize("path", ["ppo-lift", "ddpg-lift", "seed-impala-cartpole"])
def test_real_search_then_the_trainer_builds_with_the_winner(path, tmp_path):
    """A real search at 2 envs x 8 steps (one measured iteration a
    trial), then the trainer in 'cache' mode: a pure hit, built with the
    winner, one ``tune`` event in its session's telemetry."""
    if path == "ppo-lift":
        kw = dict(algo="ppo", env="jax:lift", num_envs=2, horizon=8, epochs=1, num_minibatches=1)
        dims = [("gae_impl", ["xla", "assoc"])]
    elif path == "ddpg-lift":
        kw = dict(algo="ddpg", env="jax:lift", num_envs=2, horizon=8, updates_per_iter=2,
                  exploration={"warmup_steps": 0})
        dims = [("precision", ["mixed", "f32"])]
    else:
        kw = dict(algo="impala", env="gym:CartPole-v1", num_envs=4, horizon=8,
                  session={"topology": {"num_env_workers": 1}, "total_env_steps": 64})
        dims = [("vtrace_impl", ["xla", "assoc"])]
    out = torch_search.tune_workload(_small(tmp_path, **kw), dims=dims, warmup=1, throwaway=0, iters=1, device="cpu")
    assert not out["cache_hit"] and out["measured"] == 2 and set(out["config"]) == {dims[0][0]}
    assert out["measure"]["surface"] == ("learn" if path.startswith("seed") else "fused")
    assert all(t["iter_ms"] > 0 for t in out["trials"])
    cfg = _small(tmp_path, autotune="cache", **kw)
    try:
        if path == "ppo-lift":
            trainer = Trainer(cfg, device="cpu")
            trainer.run(max_env_steps=16)
        elif path == "ddpg-lift":
            trainer = OffPolicyTrainer(cfg, device="cpu")
            trainer.run(max_env_steps=16)
        else:
            trainer = SEEDTrainer(cfg, device="cpu")
            trainer.run()
    finally:
        faults.configure(None)
    d = trainer.tune_decision
    assert d.hit and d.source == "cache" and d.applied == out["config"]
    name, value = dims[0][0], out["config"][dims[0][0]]
    assert trainer.learner.config.algo[name] == value
    (event,) = _tune_events(tmp_path)
    assert event["hit"] and event["config"] == out["config"] and event["mode"] == "cache"


def test_trainer_search_mode_measures_applies_and_persists(tmp_path, monkeypatch):
    """'search' at build time on a miss: the winner applied to this
    trainer and persisted, so the next build is a pure hit."""
    monkeypatch.setattr(torch_search, "candidate_space", lambda ext: [("shuffle", ["block", "row"])])
    kw = dict(algo="ppo", env="jax:lift", num_envs=2, horizon=8, epochs=1, num_minibatches=1, autotune="search")
    t = Trainer(_small(tmp_path, **kw), device="cpu")
    assert t.tune_decision.source == "search" and t.tune_decision.hit is False
    assert t.learner.config.algo.shuffle == t.tune_decision.applied["shuffle"]
    t2 = Trainer(_small(tmp_path, **kw), device="cpu")
    assert t2.tune_decision.hit is True and t2.tune_decision.applied == t.tune_decision.applied


def test_cache_mode_miss_keeps_defaults_and_off_writes_no_event(tmp_path):
    kw = dict(algo="ppo", env="jax:lift", num_envs=2, horizon=8, epochs=1, num_minibatches=1)
    t = Trainer(_small(tmp_path / "miss", autotune="cache", **kw), device="cpu")
    assert t.tune_decision.hit is False and t.tune_decision.applied == {}
    assert t.learner.config.algo.gae_impl == "xla"
    off = Trainer(_small(tmp_path / "off", **kw), device="cpu")
    assert off.tune_decision.mode == "off" and "rollout_unroll" not in off.config.learner_config.algo
    try:
        off.run(max_env_steps=16)
    finally:
        faults.configure(None)
    assert _tune_events(tmp_path / "off") == []


# -- CLI -----------------------------------------------------------------------

TUNE_ARGV = ["tune", "ppo", "jax:lift", "--folder", "F", "--num-envs", "2", "--set",
             "learner_config.algo.horizon=8", "--iters", "1", "--warmup", "1", "--dims",
             "gae_impl=xla,assoc;precision=f32,mixed", "--force", "--out", "O"]
CHAOS_ARGV = ["chaos", "impala", "gym:CartPole-v1", "--seeds", "4", "--dir", "D", "--out", "O",
              "--max-shrink-runs", "3"]


@pytest.mark.parametrize("argv", [TUNE_ARGV, CHAOS_ARGV, ["chaos", "all"]], ids=["tune", "chaos", "chaos-defaults"])
def test_tune_and_chaos_parse_as_the_reference(argv, monkeypatch):
    got = {}
    for pkg, mod in (("jax", jax_launch), ("torch", torch_launch)):
        fn = "run_" + argv[0]
        monkeypatch.setattr(mod, fn, lambda args, pkg=pkg: got.__setitem__(pkg, vars(args)) or 0)
        assert mod.main(list(argv)) == 0
    keys = set(got["jax"]) - {"fn", "raw_argv"}
    assert {k: got["torch"][k] for k in keys} == {k: got["jax"][k] for k in keys}
    assert set(got["torch"]) - {"fn"} == keys
    dims = TUNE_ARGV[TUNE_ARGV.index("--dims") + 1]
    assert jax_launch._parse_dims(dims) == torch_launch._parse_dims(dims)


def test_chaos_cli_rejects_a_bogus_algo():
    with pytest.raises(SystemExit):
        torch_launch.main(["chaos", "nonesuch", "--seeds", "1"])


def test_tune_cli_writes_cache_artifact_and_telemetry(tmp_path, capsys):
    folder = str(tmp_path / "sess")
    out = str(tmp_path / "tune.json")
    argv = ["tune", "ppo", "jax:lift", "--folder", folder, "--num-envs", "2", "--set",
            "session_config.backend=cpu", "learner_config.algo.horizon=8", "learner_config.algo.epochs=1",
            "learner_config.algo.num_minibatches=1", "--iters", "1", "--warmup", "1",
            "--dims", "gae_impl=xla,assoc", "--out", out]
    assert torch_launch.main(argv) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["cache_hit"] is False and row["measured"] == 2 and row["default_ms"] > 0
    assert row["geometry"] == "2 envs x 8 horizon"
    with open(out) as f:
        artifact = json.load(f)
    assert artifact["platform"] == artifact["device"] == "cpu"
    assert [w["key"] for w in artifact["workloads"]] == [row["key"]]
    assert torch_launch.main(argv) == 0
    row2 = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row2["cache_hit"] is True and row2["measured"] == 0
    with open(out) as f:
        assert len(json.load(f)["workloads"]) == 1  # keyed by fingerprint
    s = diag_summary(folder)
    assert s["tune"]["hit"] is True and (s["tune_hits"], s["tune_misses"]) == (1, 1)
    assert "Autotuner" in diag_report(folder)
