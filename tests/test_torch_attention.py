"""Parity of the PyTorch port's attention ops (``ops/ring_attention.py``)
and trajectory transformer (``models/attention.py``) with the JAX
package, on converted weights (``utils/convert.py``).

Tolerances: at float32 rtol 1e-5 / atol 1e-5 (the same sums in another
order); under bf16 compute ('mixed') 2e-2, the repo's bar for bf16 models
(tests/test_torch_ppo.py): each Dense rounds its output to bf16's 8
mantissa bits (about 4e-3 relative) and XLA and torch round the bias add,
the gelu and the residual adds at other places."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from surreal_tpu.models.attention import CausalSelfAttention as JaxAttention
from surreal_tpu.models.attention import TrajectoryCategoricalPPOModel as JaxCategorical
from surreal_tpu.models.attention import TrajectoryEncoder as JaxEncoder
from surreal_tpu.models.attention import TrajectoryPPOModel as JaxModel
from surreal_tpu.ops.ring_attention import decode_attention as jax_decode_attention
from surreal_tpu.ops.ring_attention import full_attention as jax_full_attention
from surreal_tpu_torch.models.attention import (
    CausalSelfAttention,
    TrajectoryCategoricalPPOModel,
    TrajectoryEncoder,
    TrajectoryPPOModel,
)
from surreal_tpu_torch.ops.ring_attention import decode_attention, full_attention
from surreal_tpu_torch.utils.convert import trajectory_categorical_params_from_jax, trajectory_params_from_jax

F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
DTYPES = {"f32": (jnp.float32, torch.float32, F32_TOL), "bf16": (jnp.bfloat16, torch.bfloat16, BF16_TOL)}
ENC = dict(features=32, num_layers=2, num_heads=2, head_dim=8, max_len=16)
PIXEL_CNN = dict(enabled=True, channels=(8, 16), kernels=(4, 3), strides=(2, 1), dense=32)


def _to_np(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if isinstance(x, jax.Array) else x.detach().float().numpy()


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(_to_np(got), _to_np(want), err_msg=what, **tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("causal", [True, False])
def test_full_attention_matches_jax(dtype, causal):
    jd, td, tol = DTYPES[dtype]
    rng = np.random.default_rng(0)
    q, k, v = (rng.normal(size=(3, 9, 2, 8)).astype(np.float32) for _ in range(3))
    want = jax_full_attention(*(jnp.asarray(x, jd) for x in (q, k, v)), causal=causal)
    got = full_attention(*(torch.from_numpy(x).to(td) for x in (q, k, v)), causal=causal)
    assert got.dtype == td and got.shape == (3, 9, 2, 8)
    _close(got, want, tol)  # observed (both ops): at most 4.1e-7 (f32), bit-equal (bf16)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_decode_attention_matches_jax(dtype):
    """Every position of a cache whose later rows hold stale values (a
    wrapped segment's), and equal to full attention's row at that position."""
    jd, td, tol = DTYPES[dtype]
    rng = np.random.default_rng(1)
    B, T, H, D = 3, 7, 2, 8
    q, k, v = (rng.normal(size=(B, T, H, D)).astype(np.float32) for _ in range(3))
    full = full_attention(*(torch.from_numpy(x).to(td) for x in (q, k, v)), causal=True)
    for pos in range(T):
        kc, vc = k.copy(), v.copy()
        kc[:, pos + 1:] = 100.0 * rng.normal(size=kc[:, pos + 1:].shape)  # stale rows, masked
        want = jax_decode_attention(jnp.asarray(q[:, pos], jd), jnp.asarray(kc, jd), jnp.asarray(vc, jd), pos)
        got = decode_attention(torch.from_numpy(q[:, pos]).to(td), torch.from_numpy(kc).to(td),
                               torch.from_numpy(vc).to(td), pos)
        assert got.dtype == td
        _close(got, want, tol, f"pos {pos}")
        _close(got, full[:, pos], tol, f"pos {pos} against the full pass")


def _params(shapes, seed):
    """flax's tree (names and shapes) filled with N(0, 1/fan_in) draws and
    LayerNorm scales around 1, so that no layer is near its trivial value."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        if name.endswith("['scale']"):
            return (1.0 + 0.2 * rng.normal(size=leaf.shape)).astype(np.float32)
        fan_in = int(np.prod(leaf.shape[:-1])) if len(leaf.shape) > 1 else 8
        if "kernel" in name and len(leaf.shape) == 3:  # DenseGeneral [E, H, D]
            fan_in = leaf.shape[0]
        return (rng.normal(size=leaf.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _obs(pixels: bool, B: int, T: int, seed: int):
    rng = np.random.default_rng(seed)
    if pixels:
        return np.where(rng.random((B, T, 16, 16, 2)) < 0.2, 255, 0).astype(np.uint8)
    return rng.normal(size=(B, T, 5)).astype(np.float32)


def _models(cls: str, pixels: bool, jd, td):
    """(JAX module, its params, the port's module, converted params) for
    one class; the encoder and the attention layer are held through the
    trunk of a full model, so one converter covers all four classes."""
    cnn = dict(PIXEL_CNN) if pixels else None
    obs_shape = (16, 16, 2) if pixels else (5,)
    if cls == "categorical":
        jm = JaxCategorical(encoder_cfg=ENC, n_actions=3, cnn_cfg=cnn, compute_dtype=jd)
        tm = TrajectoryCategoricalPPOModel(ENC, obs_shape, 3, cnn_cfg=cnn, compute_dtype=td)
        convert = trajectory_categorical_params_from_jax
    else:
        jm = JaxModel(encoder_cfg=ENC, act_dim=2, cnn_cfg=cnn, compute_dtype=jd)
        tm = TrajectoryPPOModel(ENC, obs_shape, 2, cnn_cfg=cnn, compute_dtype=td)
        convert = trajectory_params_from_jax
    dummy = jnp.zeros((1, 1, *obs_shape), jnp.uint8 if pixels else jnp.float32)
    params = _params(jax.eval_shape(jm.init, jax.random.key(0), dummy), seed=3)
    t_params = convert(params)
    assert set(t_params) == {k for k, _ in tm.named_parameters()}
    if cls in ("ppo", "categorical"):
        return jm, params, tm, t_params
    trunk = params["params"]["trunk"]
    t_trunk = {k[len("trunk."):]: v for k, v in t_params.items() if k.startswith("trunk.")}
    enc_kw = dict(features=ENC["features"], num_layers=ENC["num_layers"], num_heads=ENC["num_heads"],
                  head_dim=ENC["head_dim"], max_len=ENC["max_len"])
    if cls == "encoder":
        return (JaxEncoder(**enc_kw, cnn_cfg=cnn, compute_dtype=jd), {"params": trunk},
                tm.trunk, t_trunk)
    attn = {k[len("attn0."):]: v for k, v in t_trunk.items() if k.startswith("attn0.")}
    return (JaxAttention(num_heads=ENC["num_heads"], head_dim=ENC["head_dim"], compute_dtype=jd),
            {"params": trunk["attn0"]}, tm.trunk.attn0, attn)


CASES = [
    pytest.param("attention", False, id="attention"),
    pytest.param("encoder", False, id="encoder"),
    pytest.param("encoder", True, id="encoder-cnn"),
    pytest.param("ppo", False, id="ppo"),
    pytest.param("categorical", False, id="categorical"),
    pytest.param("categorical", True, id="categorical-cnn"),
]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("cls,pixels", CASES)
def test_trajectory_modules_match_jax(cls, pixels, dtype):
    """Each class's full pass over [B, T, ...] and its decode chain (one
    position at a time against K/V caches in the compute dtype, as acting
    runs it) against the JAX module's, on the same converted weights; the
    port's decode chain also against its own full pass. Observed: at
    most 1.3e-6 at f32; under bf16 2.15e-2 absolute, inside
    atol + rtol * |want|."""
    jd, td, tol = DTYPES[dtype]
    B, T = 3, 6
    jm, params, tm, t_params = _models(cls, pixels, jd, td)
    if cls == "attention":
        x = np.random.default_rng(4).normal(size=(B, T, ENC["features"])).astype(np.float32)
        j_in, t_in = jnp.asarray(x, jd), torch.from_numpy(x).to(td)
    else:
        x = _obs(pixels, B, T, seed=4)
        j_in, t_in = jnp.asarray(x), torch.from_numpy(x)
    want_full = jm.apply(params, j_in)
    got_full = functional_call(tm, t_params, (t_in,))
    want_full = want_full if isinstance(want_full, tuple) else (want_full,)
    got_full = got_full if isinstance(got_full, tuple) else (got_full,)
    for g, w in zip(got_full, want_full):
        _close(g, w, tol, "full pass")

    H, D = ENC["num_heads"], ENC["head_dim"]
    n_caches = ENC["num_layers"]

    def j_cache():
        mk = lambda: jnp.zeros((B, T, H, D), jd)  # noqa: E731
        return {"k": mk(), "v": mk()} if cls == "attention" else [{"k": mk(), "v": mk()} for _ in range(n_caches)]

    def t_cache():
        mk = lambda: torch.zeros((B, T, H, D), dtype=td)  # noqa: E731
        return {"k": mk(), "v": mk()} if cls == "attention" else [{"k": mk(), "v": mk()} for _ in range(n_caches)]

    jc, tc = j_cache(), t_cache()
    for pos in range(T):
        w, jc = jm.apply(params, j_in[:, pos], cache=jc, pos=pos)
        with torch.no_grad():
            g, tc = functional_call(tm, t_params, (t_in[:, pos],), {"cache": tc, "pos": pos})
        w = w if isinstance(w, tuple) else (w,)
        g = g if isinstance(g, tuple) else (g,)
        for gi, wi, fi in zip(g, w, got_full):
            _close(gi, wi, tol, f"decode pos {pos}")
            _close(gi, fi[:, pos], tol, f"decode pos {pos} against the port's full pass")
    # the caches hold the compute dtype
    first = tc if cls == "attention" else tc[0]
    assert first["k"].dtype == td


def test_trajectory_model_rejects_a_mesh():
    with pytest.raises(NotImplementedError, match="ring attention"):
        TrajectoryPPOModel(ENC, (5,), 2, mesh=object())
    with pytest.raises(NotImplementedError, match="ring attention"):
        CausalSelfAttention(32, mesh=object())
    enc = TrajectoryEncoder((5,), **{k: ENC[k] for k in ("features", "num_layers", "num_heads", "head_dim")})
    assert enc.pos_embed.shape == (4096, 32)
