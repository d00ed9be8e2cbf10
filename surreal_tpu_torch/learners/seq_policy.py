"""Policy-head sampling and trajectory-policy acting, the port of
``surreal_tpu/learners/seq_policy.py`` (``PolicyHeadMixin``,
``SequenceActingMixin``, ``build_seq_model``), mixed into PPO and IMPALA.

``PolicyHeadMixin`` is the one place actions are sampled from head
outputs (diagonal-Gaussian or categorical). ``SequenceActingMixin`` owns
the trajectory policy's acting carry: the context is segment-aligned (a
fresh carry for each rollout), so what a position saw while acting is
exactly what the sequence learn recomputes over the whole segment (the
importance-ratio contract). ``model.encoder.act_impl`` picks one of two
interchangeable forms:

- ``'kv'`` (default): incremental decode against per-layer K/V caches in
  the compute dtype, O(T) attention per env step;
- ``'padded'``: write the obs into a zero-padded [B, T, ...] segment buffer
  and re-encode it, reading one position, O(T^2) per step; the simple form
  the kv path is held against.

Both wrap at ``pos >= T`` (a long eval episode re-segments). ``pos`` is a
host int in the carry, where the reference traces it: a device scalar
used as an index would be a host sync on every env step.

Host classes provide ``model`` (applied through ``apply``), ``config``
(algo.horizon, model.encoder), ``specs``, ``policy``, ``discrete``,
``seq_policy`` and ``_norm_obs``.
"""

from __future__ import annotations

import numpy as np
import torch

from surreal_tpu_torch.learners.base import EVAL_DETERMINISTIC, TRAINING
from surreal_tpu_torch.ops import distributions as D
from surreal_tpu_torch.ops.precision import torch_dtype


class PolicyHeadMixin:
    def _head_act(
        self,
        out,
        mode: str,
        generator: torch.Generator | None = None,
        noise: torch.Tensor | None = None,
    ):
        """Sample (or take the mode of) the policy head and return the
        behaviour info attached to experience. ``noise`` replaces the draw:
        standard-normal [B, act_dim] for the Gaussian head, standard Gumbel
        [B, n_actions] for the categorical head."""
        if self.discrete:
            if mode == EVAL_DETERMINISTIC:
                action = torch.argmax(out.logits, dim=-1).to(torch.int32)
            else:
                action = D.categorical_sample(out.logits, generator, gumbel=noise).to(torch.int32)
            logp = D.categorical_logp(out.logits, action)
            info = {"logp": logp, "logits": out.logits, "value": out.value}
        else:
            if mode == EVAL_DETERMINISTIC:
                action = out.mean
            else:
                action = D.diag_gauss_sample(out.mean, out.log_std, generator, noise=noise)
            logp = D.diag_gauss_logp(out.mean, out.log_std, action)
            info = {
                "logp": logp,
                "mean": out.mean,
                "log_std": out.log_std,
                "value": out.value,
            }
        return action, info


class SequenceActingMixin(PolicyHeadMixin):
    def rebind_mesh(self, mesh, sp_axis: str = "sp", batch_axis=None) -> None:
        """The reference routes the trajectory encoder's attention through
        ring attention over ``mesh[sp_axis]`` here; the port has no mesh
        yet. A no-op for memoryless policies, as in the reference."""
        if self.seq_policy:
            raise NotImplementedError(
                "rebind_mesh: ring attention over a sequence-parallel mesh is not ported to PyTorch yet"
            )

    def act_init(self, num_envs: int):
        """A fresh acting carry for a rollout segment (None for memoryless
        policies); its form follows ``encoder.act_impl``."""
        if not self.seq_policy:
            return None
        enc = self.config.model.encoder
        T = int(self.config.algo.horizon)
        if enc.get("act_impl", "kv") == "padded":
            # pixels buffer as uint8 (the trajectory models keep uint8 raw
            # into the CNN stem); vector obs buffer in f32
            dtype = torch.uint8 if self.specs.obs.dtype == np.uint8 else torch.float32
            buf = torch.zeros((num_envs, T, *self.specs.obs.shape), dtype=dtype, device=self.device)
            return {"buf": buf, "pos": 0}
        # the caches live in the compute dtype, the attention's own
        # precision, so decode and the whole-segment pass round alike
        kv_dtype = torch_dtype(self.policy.compute_dtype)
        shape = (num_envs, T, int(enc.num_heads), int(enc.head_dim))
        mk = lambda: torch.zeros(shape, dtype=kv_dtype, device=self.device)  # noqa: E731
        return {"cache": [{"k": mk(), "v": mk()} for _ in range(int(enc.num_layers))], "pos": 0}

    @torch.no_grad()
    def act_step(
        self,
        state,
        act_carry,
        obs: torch.Tensor,
        mode: str = TRAINING,
        generator: torch.Generator | None = None,
        noise: torch.Tensor | None = None,
    ):
        """History-conditioned acting -> (action, act_info, new_carry).
        The carry's tensors are updated in place (they belong to this
        rollout alone)."""
        if not self.seq_policy:
            return super().act_step(state, act_carry, obs, mode, generator, noise)
        pos = act_carry["pos"]
        if "cache" in act_carry:
            cache = act_carry["cache"]
            # positions after pos are masked, so a wrap only resets the
            # index; stale K/V rows are overwritten as the segment advances
            if pos >= cache[0]["k"].shape[1]:
                pos = 0
            out_t, cache = self.apply(
                state.params, self._norm_obs(state.obs_stats, obs), cache=cache, pos=pos
            )
            action, info = self._head_act(out_t, mode, generator, noise)
            return action, info, {"cache": cache, "pos": pos + 1}
        buf = act_carry["buf"]
        if pos >= buf.shape[1]:
            # a long eval episode outruns one segment: fresh context
            buf.zero_()
            pos = 0
        buf[:, pos] = obs.to(buf.dtype)
        # causal attention: position pos reads only the 0..pos prefix, so
        # the zero padding after it is never seen
        out = self.apply(state.params, self._norm_obs(state.obs_stats, buf))
        out_t = type(out)(*(x[:, pos] for x in out))
        action, info = self._head_act(out_t, mode, generator, noise)
        return action, info, {"buf": buf, "pos": pos + 1}


def build_seq_model(
    model_config,
    specs,
    init_log_std: float,
    horizon: int | None = None,
    policy=None,
    generator: torch.Generator | None = None,
):
    """The trajectory actor-critic from ``learner_config.model``, shared by
    every learner that supports ``encoder.kind='trajectory'``. ``horizon``
    (algo.horizon) is checked against ``encoder.max_len``: the learn pass
    runs T+1 positions. ``policy`` (the learner's precision policy) gives
    the compute dtype; None keeps bf16, the reference's default."""
    from surreal_tpu_torch.models.attention import TrajectoryCategoricalPPOModel, TrajectoryPPOModel

    max_len = int(model_config.encoder.get("max_len", 4096))
    if horizon is not None and int(horizon) + 1 > max_len:
        raise ValueError(
            f"algo.horizon={int(horizon)} needs model.encoder.max_len >= "
            f"{int(horizon) + 1} (the sequence learn pass extends the "
            f"segment by one bootstrap position); got max_len={max_len}"
        )
    cnn_cfg = None
    if model_config.cnn.enabled:
        if len(specs.obs.shape) != 3:
            raise ValueError(
                "model.encoder.kind='trajectory' with model.cnn.enabled "
                f"needs [H, W, C] pixel obs; got shape {specs.obs.shape}"
            )
        cnn_cfg = model_config.cnn.to_dict()
    elif len(specs.obs.shape) != 1:
        raise ValueError(
            "model.encoder.kind='trajectory' needs flat vector obs (or "
            "model.cnn.enabled for [H, W, C] pixels); got obs shape "
            f"{specs.obs.shape}"
        )
    enc_cfg = model_config.encoder.to_dict()
    compute_dtype = torch_dtype(policy.compute_dtype) if policy is not None else torch.bfloat16
    kw = dict(cnn_cfg=cnn_cfg, compute_dtype=compute_dtype, generator=generator)
    if specs.discrete:
        return TrajectoryCategoricalPPOModel(enc_cfg, specs.obs.shape, specs.action.n, **kw)
    return TrajectoryPPOModel(enc_cfg, specs.obs.shape, int(specs.action.shape[0]), init_log_std, **kw)
