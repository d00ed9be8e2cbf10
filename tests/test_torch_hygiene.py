"""Hygiene of the PyTorch port: it imports nothing of JAX, of the JAX
package, of zmq or of msgpack (its SEED, parameter and experience wires
are the standard library's sockets, the parameter service's bytes are
decoded without pickle, and the experience plane imports pickle in its
wire codec only), its
entry points never fall back to the CPU on their own, and every gauge
literal it emits is documented in its ``GAUGE_REGISTRY`` with a unit (the
reference's lint, ``tests/test_import_hygiene.py``)."""

import ast
import pathlib
import re

import pytest
import torch

import surreal_tpu_torch
from surreal_tpu_torch.launch.trainer import Trainer
from surreal_tpu_torch.session.config import Config
from surreal_tpu_torch.session.default_configs import base_config

_PKG = pathlib.Path(surreal_tpu_torch.__file__).parent
_REPO = _PKG.parent
_BANNED = ("jax", "jaxlib", "flax", "optax", "chex", "orbax", "surreal_tpu", "zmq", "msgpack", "ml_dtypes")


def _imported_roots(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.lineno, node.module.split(".")[0]


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    scripts = ("chip_smoke.py", "ab_replay_rows.py", "ab_scan_kernels.py")
    files = sorted(_PKG.rglob("*.py")) + [_REPO / name for name in scripts]
    assert len(files) > 20, "the scan did not find the port"
    scanned = {str(path.relative_to(_PKG)) for path in files if _PKG in path.parents}
    session_runtime = {
        "__main__.py", "main/launch.py", "engine/core.py", "engine/stages.py", "launch/hooks.py",
        "launch/recovery.py", "launch/evaluator.py", "session/checkpoint.py", "session/telemetry.py",
        "session/metrics.py", "session/tracker.py", "session/interrupt.py", "utils/faults.py", "utils/tree.py",
    }
    trajectory = {
        "envs/device/pendulum.py", "envs/device/cartpole.py", "ops/ring_attention.py", "models/attention.py",
        "learners/seq_policy.py",
    }
    host = {
        "envs/gym_adapter.py", "envs/dm_control_adapter.py", "envs/robosuite_adapter.py", "envs/wrappers.py",
        "learners/prefetch.py", "envs/device/nut_assembly.py", "envs/device/pixels.py",
    }
    seed = {
        "distributed/__init__.py", "distributed/sockets.py", "distributed/shm_transport.py",
        "distributed/inference_server.py", "distributed/env_worker.py", "launch/seed_trainer.py",
        "utils/respawn.py",
    }
    perf = {"session/costs.py", "session/profile.py"}
    serving = {"distributed/fleet.py", "distributed/param_fanout.py", "utils/net.py"}
    experience = {
        "experience/__init__.py", "experience/wire.py", "experience/link.py", "experience/shard.py",
        "experience/sender.py", "experience/sampler.py", "experience/plane.py", "replay/tiers.py",
        "replay/fifo.py", "experience/spill.py",
    }
    gateway = {
        "gateway/__init__.py", "gateway/protocol.py", "gateway/table.py", "gateway/admission.py",
        "gateway/server.py", "gateway/loadgen.py",
    }
    publish = {
        "agents/__init__.py", "agents/base.py", "agents/ppo_agent.py", "agents/ddpg_agent.py",
        "distributed/param_service.py", "distributed/module_dict.py", "envs/video.py",
    }
    wanted = session_runtime | trajectory | host | seed | perf | publish | serving | experience | gateway
    assert wanted <= scanned, f"not scanned: {sorted(wanted - scanned)}"
    bad = [
        f"{path.relative_to(_REPO)}:{line}: import {root}"
        for path in files
        for line, root in _imported_roots(path)
        if root in _BANNED
    ]
    assert not bad, "the port must not import JAX, the JAX package, zmq, msgpack or ml_dtypes:\n" + "\n".join(bad)
    # nothing on the parameter wire unpickles: bytes from a socket are decoded by their header
    wire = ("distributed/sockets.py", "distributed/module_dict.py", "distributed/param_service.py",
            "distributed/param_fanout.py")
    unpickling = [f"{name}: import {root}" for name in wire for _, root in _imported_roots(_PKG / name)
                  if root in ("pickle", "cloudpickle", "dill", "marshal")]
    assert not unpickling, unpickling
    # the experience plane's pickle fallback lives in its wire codec only
    pickling = sorted(str(path.relative_to(_PKG)) for path in _PKG.rglob("*.py")
                      if path.parent.name in ("experience", "replay")
                      and any(root == "pickle" for _, root in _imported_roots(path)))
    assert pickling == ["experience/wire.py"], pickling
    # the gateway unpickles only in its codec, behind the server's session
    # and transport gate
    pickling = sorted(str(path.relative_to(_PKG)) for path in (_PKG / "gateway").rglob("*.py")
                      if any(root in ("pickle", "cloudpickle", "dill", "marshal") for _, root in _imported_roots(path)))
    assert pickling == ["gateway/protocol.py"], pickling


def _tiny_config():
    return Config(
        learner_config=Config(algo=Config(name="ppo", horizon=4)),
        env_config=Config(name="jax:lift", num_envs=2),
        session_config=Config(folder="unused"),
    ).extend(base_config())


def test_trainer_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        Trainer(_tiny_config())
    # asking for the CPU explicitly is the only way onto it
    assert Trainer(_tiny_config(), device="cpu").device.type == "cpu"


_GAUGE = re.compile(
    r"[\"']((?:perf|replay|experience|fleet|param|gateway|ops|slo|lineage|trace|remediation|loadgen|lgroup|tier"
    r"|engine|chaos)/[a-z0-9_]+)[\"']"
)


def test_every_gauge_literal_is_registered_with_a_unit():
    """Every whole ``<family>/<name>`` literal in the port's source is a
    ``GAUGE_REGISTRY`` entry whose unit is in ``GAUGE_UNITS``. A literal
    that ends in ``_`` is a prefix (``launch/hooks.py``'s unported
    subsystems), not a gauge."""
    from surreal_tpu_torch.session.costs import GAUGE_REGISTRY, GAUGE_UNITS

    bad = []
    for path in sorted(_PKG.rglob("*.py")):
        if path.name == "costs.py":
            continue  # the registry itself defines the names
        src = path.read_text()
        for m in _GAUGE.finditer(src):
            name = m.group(1)
            if name.endswith("_"):
                continue
            if name not in GAUGE_REGISTRY:
                bad.append(f"{path.relative_to(_REPO)}:{src.count(chr(10), 0, m.start()) + 1}: {name}")
    assert not bad, "gauges emitted but not in session/costs.py::GAUGE_REGISTRY:\n" + "\n".join(bad)
    assert any(k.startswith("perf/") for k in GAUGE_REGISTRY)
    for name, rec in GAUGE_REGISTRY.items():
        assert isinstance(rec, dict) and rec.get("unit") in GAUGE_UNITS and rec.get("desc"), name
