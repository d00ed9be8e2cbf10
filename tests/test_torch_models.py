"""Parity of the PyTorch port's NatureCNN, CategoricalPPOModel and the
shared-stem PPOModel with the JAX package's flax modules: the parameter
tree of flax's own init (its names and shapes, from ``jax.eval_shape``)
filled with numpy draws, carried over by ``utils/convert.py``, and the same
numpy inputs through both."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from surreal_tpu.models.encoders import cnn_from_config as jax_cnn_from_config
from surreal_tpu.models.ppo_net import CategoricalPPOModel as JaxCategoricalPPOModel
from surreal_tpu.models.ppo_net import PPOModel as JaxPPOModel
from surreal_tpu_torch.models.ppo_net import CategoricalPPOModel, PPOModel
from surreal_tpu_torch.ops.precision import torch_dtype
from surreal_tpu_torch.utils.convert import categorical_params_from_jax, params_from_jax

# f32: the same f32 convolutions and matmuls, summed in another order.
# 'mixed': both compute every layer in bf16 with f32 accumulation, but
# round the bias add and the activations at other places (bf16 keeps 8
# mantissa bits, ~4e-3 relative per rounding, over four or five layers).
TOL = {"f32": dict(rtol=1e-5, atol=1e-5), "mixed": dict(rtol=2e-2, atol=2e-2)}
OBS = (42, 42, 2)
# strides (4, 2, 1) leave a 1x1 last conv output at 42x42, which cannot
# catch a flatten-order fault; (2, 2, 1) leaves 6x6
GEOMETRIES = {"default": (4, 2, 1), "6x6": (2, 2, 1)}


def _model_cfg(precision: str, cnn: bool, strides=(4, 2, 1)) -> dict:
    compute = "float32" if precision == "f32" else "bfloat16"
    return {
        "actor_hidden": (32, 16),
        "critic_hidden": (24, 16),
        "activation": "tanh",
        "cnn": {"enabled": cnn, "channels": (8, 16, 16), "kernels": (8, 4, 3), "strides": strides, "dense": 32},
        "dtype": "float32",
        "compute_dtype": compute,
    }


def _pixels(seed: int, lead=(3, 5)) -> np.ndarray:
    """Sparse bright pixels, as Pong draws them, plus some grey levels."""
    rng = np.random.default_rng(seed)
    px = np.where(rng.random((*lead, *OBS)) < 0.1, 255, 0)
    grey = rng.random((*lead, *OBS)) < 0.05
    return np.where(grey, rng.integers(0, 256, (*lead, *OBS)), px).astype(np.uint8)


def _flax_params(model, obs: np.ndarray, seed: int):
    """The tree ``model.init`` builds, filled with N(0, 1/fan_in) draws
    (biases too, so that every term of every layer counts)."""
    shapes = jax.eval_shape(model.init, jax.random.key(0), jnp.asarray(obs))
    rng = np.random.default_rng(seed)

    def draw(leaf):
        fan_in = int(np.prod(leaf.shape[:-1])) if len(leaf.shape) > 1 else 4
        return (rng.normal(size=leaf.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree.map(draw, shapes)


def _close(got: torch.Tensor, want, tol) -> None:
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("precision", ["f32", "mixed"])
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_cnn_categorical_model_matches_flax(precision, geometry):
    cfg = _model_cfg(precision, cnn=True, strides=GEOMETRIES[geometry])
    obs = _pixels(seed=len(geometry))
    j_model = JaxCategoricalPPOModel(model_cfg=cfg, n_actions=3)
    j_params = _flax_params(j_model, obs[0, :1], seed=1)
    params = categorical_params_from_jax(j_params)
    t_model = CategoricalPPOModel(cfg, OBS, 3)
    assert set(params) == set(dict(t_model.named_parameters()))
    j_out = jax.jit(j_model.apply)(j_params, jnp.asarray(obs))
    t_out = functional_call(t_model, params, (torch.from_numpy(obs),))
    for got, want in zip(t_out, j_out):
        assert got.shape == want.shape
        _close(got, want, TOL[precision])

    # the stem alone, on float input (the model took uint8)
    j_cnn = jax_cnn_from_config(cfg["cnn"], jnp.dtype(cfg["compute_dtype"]), jnp.float32)
    j_stem = {"params": j_params["params"]["NatureCNN_0"]}
    stem = {k.removeprefix("stem."): v for k, v in params.items() if k.startswith("stem.")}
    assert t_model.stem.compute_dtype == torch_dtype(cfg["compute_dtype"])
    x = obs[0].astype(np.float32) / 255.0
    want = jax.jit(j_cnn.apply)(j_stem, jnp.asarray(x))
    got = functional_call(t_model.stem, stem, (torch.from_numpy(x),)).to(torch.float32)
    _close(got, want, TOL[precision])


@pytest.mark.parametrize("precision", ["f32", "mixed"])
def test_mlp_categorical_model_matches_flax(precision):
    cfg = _model_cfg(precision, cnn=False)
    obs = np.random.default_rng(3).normal(size=(4, 6, 11)).astype(np.float32)
    j_model = JaxCategoricalPPOModel(model_cfg=cfg, n_actions=5)
    j_params = _flax_params(j_model, obs[0], seed=2)
    params = categorical_params_from_jax(j_params)
    t_model = CategoricalPPOModel(cfg, (11,), 5)
    assert set(params) == set(dict(t_model.named_parameters()))
    j_out = jax.jit(j_model.apply)(j_params, jnp.asarray(obs))
    t_out = functional_call(t_model, params, (torch.from_numpy(obs),))
    for got, want in zip(t_out, j_out):
        _close(got, want, TOL[precision])


def test_cnn_gaussian_model_shares_one_stem_and_matches_flax():
    """PPOModel with the CNN enabled builds one stem for both heads, as the
    reference does (not two trunks)."""
    cfg = _model_cfg("f32", cnn=True, strides=GEOMETRIES["6x6"])
    obs = _pixels(seed=5, lead=(7,))
    j_model = JaxPPOModel(model_cfg=cfg, act_dim=2)
    j_params = _flax_params(j_model, obs[:1], seed=3)
    params = params_from_jax(j_params)
    t_model = PPOModel(cfg, OBS, 2)
    names = set(dict(t_model.named_parameters()))
    assert set(params) == names and not any(n.startswith(("actor.", "critic.")) for n in names)
    j_out = jax.jit(j_model.apply)(j_params, jnp.asarray(obs))
    t_out = functional_call(t_model, params, (torch.from_numpy(obs),))
    for got, want in zip(t_out, j_out):
        _close(got, want, TOL["f32"])


def test_converter_rejects_a_foreign_tree():
    with pytest.raises(ValueError, match="unexpected flax model tree"):
        categorical_params_from_jax({"params": {"MLP_0": {}, "Dense_0": {}}})
