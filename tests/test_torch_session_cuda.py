"""Card-only checks of the port's session runtime (marker ``cuda``; they
skip without a card). This file imports nothing of the JAX package, so it
collects on a machine that has the port and a card only:

    python -m pytest tests/test_torch_session_cuda.py -m cuda

- a state saved from the card restores onto the card bit-equal;
- an iteration off every cadence, through the engine and the hooks,
  makes no host sync (``torch.cuda.set_sync_debug_mode("error")``);
- a 'bf16' PPO learn (dynamic loss scaling: the scale read, the skip
  decided and the state chosen on the device) makes no host sync;
- an agent acts on the card from a view fetched over the parameter
  service, the view bit-equal to the published one;
- an iteration that publishes its acting view makes one host sync, in
  the publish (the view's copy to the host), and none elsewhere."""

import pytest
import torch

from surreal_tpu_torch.launch.trainer import Trainer
from surreal_tpu_torch.session import checkpoint as torch_checkpoint
from surreal_tpu_torch.session.config import Config
from surreal_tpu_torch.session.default_configs import base_config
from surreal_tpu_torch.utils.tree import tree_flatten


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {"w": torch.randn(3, 4, generator=g), "b": torch.randn(4, generator=g).to(torch.bfloat16)},
        "count": torch.tensor(seed, dtype=torch.int32),
        "ring": (torch.randint(0, 255, (5, 2), generator=g).to(torch.uint8), 7, None),
    }


def _equal(a, b):
    fa, fb = tree_flatten(a), tree_flatten(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        if isinstance(fa[k], torch.Tensor):
            assert fa[k].dtype == fb[k].dtype and torch.equal(fa[k], fb[k]), k
        else:
            assert fa[k] == fb[k], k
    return True


def _tiny(tmp_path, **session):
    sess = {"folder": str(tmp_path), "metrics": {"every_n_iters": 1, "tensorboard": False, "console": False},
            "checkpoint": {"every_n_iters": 2}, "eval": {"every_n_iters": 0}}
    for k, v in session.items():
        sess[k] = {**sess.get(k, {}), **v}
    return Config(
        learner_config={"algo": {"name": "ppo", "horizon": 8, "epochs": 1, "num_minibatches": 1, "precision": "f32"}},
        env_config={"name": "jax:lift", "num_envs": 8, "time_limit": 5}, session_config=sess,
    ).extend(base_config())


@pytest.mark.cuda
def test_checkpoint_restores_onto_cuda_bit_equal(tmp_path):
    """A state saved from the card restores onto the card bit-equal, in
    its dtypes, on the template's device."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    def on_card(state):
        return {**state, "params": {k: v.cuda() for k, v in state["params"].items()}, "count": state["count"].cuda()}

    saved = on_card(_state(3))
    mgr = torch_checkpoint.CheckpointManager(str(tmp_path))
    mgr.save(1, saved)
    state, _ = mgr.restore(on_card(_state()))
    assert state["params"]["w"].is_cuda and state["count"].is_cuda
    assert _equal(state, saved)


@pytest.mark.cuda
def test_off_cadence_iteration_makes_no_host_sync(tmp_path):
    """On the card, one iteration through the engine and the hooks whose
    boundary fires no cadence (metrics every 2, checkpoint and eval off)
    runs under ``set_sync_debug_mode("error")``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = _tiny(tmp_path, metrics={"every_n_iters": 2}, checkpoint={"every_n_iters": 0})
    tr = Trainer(cfg)
    inner = tr._device_train_iter
    calls = []

    def wrapped(*a, **kw):
        calls.append(1)
        # from iteration 3's step through its boundary (off the metrics
        # cadence) to the start of iteration 4's step
        torch.cuda.set_sync_debug_mode("error" if len(calls) == 3 else 0)
        return inner(*a, **kw)

    tr._device_train_iter = wrapped
    seen = []
    try:
        tr.run(max_env_steps=4 * 64, on_metrics=lambda i, m: seen.append(i))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert seen == [2, 4]


@pytest.mark.cuda
def test_bf16_learn_makes_no_host_sync():
    """One 'bf16' PPO learn (4 epochs x 4 minibatches, each a loss-scaled
    step) on the card under set_sync_debug_mode('error'), after a first
    learn that builds the kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import numpy as np

    from surreal_tpu_torch.envs.base import ArraySpec, EnvSpecs
    from surreal_tpu_torch.learners import build_learner

    T, B, obs_dim, act_dim = 8, 16, 17, 4
    f32 = np.dtype(np.float32)
    specs = EnvSpecs(obs=ArraySpec((obs_dim,), f32), action=ArraySpec((act_dim,), f32))
    learner = build_learner(Config(algo=Config(name="ppo", precision="bf16")), specs, device="cuda")
    g = torch.Generator().manual_seed(1)
    batch = {
        "obs": torch.randn(T, B, obs_dim, generator=g), "next_obs": torch.randn(T, B, obs_dim, generator=g),
        "action": torch.randn(T, B, act_dim, generator=g), "reward": torch.randn(T, B, generator=g),
        "done": torch.zeros(T, B, dtype=torch.bool), "terminated": torch.zeros(T, B, dtype=torch.bool),
        "behavior_logp": torch.randn(T, B, generator=g) - 3.0,
        "behavior": {"mean": torch.zeros(T, B, act_dim), "log_std": torch.full((T, B, act_dim), -0.5)},
    }
    batch = {k: ({a: b.cuda() for a, b in v.items()} if isinstance(v, dict) else v.cuda()) for k, v in batch.items()}
    from surreal_tpu_torch.learners.ppo import _block_layout

    domain = 4 * _block_layout(T * B, 4, obs_dim * 2)
    perms = torch.stack([torch.randperm(domain, generator=g) for _ in range(4)]).cuda()
    state = learner.init(torch.Generator().manual_seed(0))
    learner.learn(state, batch, perms=perms)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        new, metrics = learner.learn(state, batch, perms=perms)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert float(metrics["precision/loss_scale"]) == 2.0**15 and float(metrics["health/nonfinite"]) == 0.0
    assert int(new.opt_state.good_steps) == 16


@pytest.mark.cuda
def test_agent_acts_on_the_card_from_a_fetched_view():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import time

    import numpy as np

    from surreal_tpu_torch.agents import make_agent
    from surreal_tpu_torch.distributed import ParameterPublisher, ParameterServer
    from surreal_tpu_torch.envs.base import ArraySpec, EnvSpecs
    from surreal_tpu_torch.learners import build_learner

    f32 = np.dtype(np.float32)
    specs = EnvSpecs(obs=ArraySpec((17,), f32), action=ArraySpec((4,), f32))
    learner = build_learner(Config(algo=Config(name="ppo"), model=Config(dtype="bfloat16")), specs, device="cuda")
    published = learner.init(torch.Generator().manual_seed(1))
    pub = ParameterPublisher()
    server = ParameterServer(pub.address)
    agent = make_agent(learner)
    try:
        agent.connect(server.address, learner.init(torch.Generator().manual_seed(2)))
        pub.publish(agent.acting_view(published))
        deadline = time.monotonic() + 10
        while not agent.fetch_params():
            assert time.monotonic() < deadline, "nothing fetched"
            time.sleep(0.02)
        want, got = tree_flatten(agent.acting_view(published)), tree_flatten(agent.acting_view(agent.state))
        assert any(v.dtype == torch.bfloat16 for v in got.values())
        for k, v in want.items():
            assert got[k].is_cuda and got[k].dtype == v.dtype and torch.equal(got[k], v), k
        action, info = agent.remote_act(torch.randn(8, 17, device="cuda"))
        assert action.is_cuda and info["param_version"].is_cuda and info["param_version"].tolist() == [1] * 8
    finally:
        agent.close()
        server.close()
        pub.close()


@pytest.mark.cuda
def test_publishing_iteration_syncs_once_in_the_publish(tmp_path, monkeypatch):
    """Publish every 3 iterations, metrics every 4: iteration 3 (it
    publishes) and iteration 5 (no cadence) run under
    set_sync_debug_mode('error') from their step through their boundary,
    except inside the publish, which makes exactly one sync (counted under
    'warn'), as does the publish at iteration 6."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import warnings

    from surreal_tpu_torch.distributed.param_service import ParameterPublisher

    cfg = _tiny(tmp_path, metrics={"every_n_iters": 4}, checkpoint={"every_n_iters": 0},
                publish={"enabled": True, "every_n_iters": 3})
    tr = Trainer(cfg)
    inner = tr._device_train_iter
    calls = []

    def wrapped(*a, **kw):
        calls.append(1)
        torch.cuda.set_sync_debug_mode("error" if len(calls) in (3, 5) else 0)
        return inner(*a, **kw)

    publish_syncs = []
    publish = ParameterPublisher.publish

    def counted(self, params):
        mode = torch.cuda.get_sync_debug_mode()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                return publish(self, params)
            finally:
                torch.cuda.set_sync_debug_mode(mode)
                publish_syncs.append(sum("synchroniz" in str(w.message) and "prototype" not in str(w.message)
                                         for w in caught))

    monkeypatch.setattr(ParameterPublisher, "publish", counted)
    tr._device_train_iter = wrapped
    try:
        tr.run(max_env_steps=8 * 64)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert len(calls) == 8 and publish_syncs == [1, 1]
