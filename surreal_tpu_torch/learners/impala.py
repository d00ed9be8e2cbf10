"""IMPALA/V-trace learner, the port of
``surreal_tpu/learners/impala.py::IMPALALearner``, memoryless path: one
Adam step per batch (no epochs or minibatches), V-trace with exact
truncation handling, a categorical head for discrete actions (the pixel
Pong path, with the NatureCNN stem) and a diagonal-Gaussian head
otherwise. It shares the PPO batch contract, so the same Trainer and
device collector drive it.

V-trace goes to ``ops/vtrace.py``: ``vtrace_impl`` 'xla' (the default)
and 'pallas' both reach the fused V-trace kernel, 'assoc' the reference's
'assoc' form, whose recurrence is the reverse scan's kernel; each wrapper
launches its CUDA kernel for CUDA tensors and runs its plain version for
CPU tensors. With ``model.encoder.kind='trajectory'`` the model is the
trajectory transformer: acting goes through ``act_init``/``act_step``
(``learners/seq_policy.py``) and the learn takes one extended [B, T+1]
pass, whose shifted values are V-trace's bootstrap. Under dynamic loss
scaling ('bf16', 'bf16_fp8') the differentiated loss is multiplied by
the scale carried in the optimizer state, as in the reference; IMPALA
stages nothing in bf16 (its learn reads the batch once).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.func import functional_call

from surreal_tpu_torch.envs.base import EnvSpecs
from surreal_tpu_torch.learners.base import (
    TRAINING,
    Learner,
    OptState,
    Params,
    apply_updates,
    chain_step,
    check_scan_unroll,
    optimizer_from_config,
    param_dtypes_of,
    training_health,
)
from surreal_tpu_torch.learners.seq_policy import SequenceActingMixin, build_seq_model
from surreal_tpu_torch.models.ppo_net import CategoricalPPOModel, PPOModel
from surreal_tpu_torch.ops import distributions as D
from surreal_tpu_torch.ops.precision import current_loss_scale, loss_scale_metrics, scale_loss
from surreal_tpu_torch.ops.running_stats import RunningStats, init_stats, normalize, update_stats
from surreal_tpu_torch.ops.vtrace import VTraceOutput, vtrace_nextobs, vtrace_nextobs_assoc
from surreal_tpu_torch.session.config import Config
from surreal_tpu_torch.utils.asserts import check_learn_batch

IMPALA_LEARNER_CONFIG = Config(
    algo=Config(
        name="impala",
        horizon=64,           # unroll length per learner batch
        clip_rho=1.0,
        clip_c=1.0,
        clip_pg_rho=1.0,
        value_coeff=0.5,
        entropy_coeff=0.01,
        init_log_std=-0.5,    # continuous-action variant
        # 'xla' and 'pallas' both mean the fused V-trace of ops/vtrace.py:
        # the CUDA kernel on the card, its plain version on the CPU.
        # 'assoc' means ops/vtrace.py::vtrace_nextobs_assoc, whose
        # recurrence is the reverse scan's CUDA kernel on the card.
        vtrace_impl="xla",
    ),
    optimizer=Config(lr=6e-4),
    replay=Config(kind="fifo"),
)


class IMPALAState(NamedTuple):
    params: Params
    opt_state: OptState
    obs_stats: RunningStats
    iteration: torch.Tensor   # int32 scalar


class IMPALALearner(SequenceActingMixin, Learner):
    supports_trajectory_encoder = True  # one update over whole sequences

    def __init__(self, learner_config, env_specs: EnvSpecs, device: str | torch.device = "cuda"):
        super().__init__(learner_config, env_specs, device)
        self.discrete = env_specs.discrete
        enc = learner_config.model.get("encoder", None)
        self.seq_policy = bool(enc is not None and enc.get("kind") == "trajectory")
        self.requires_act_carry = self.seq_policy
        impl = learner_config.algo.get("vtrace_impl", "xla")
        if impl not in ("xla", "assoc", "pallas"):
            raise ValueError(f"vtrace_impl {impl!r} not in xla|assoc|pallas")
        check_scan_unroll(learner_config.algo, "gae_unroll")
        self.model_cfg = self.policy.model_config(learner_config.model)
        # the module defines the computation (applied with functional_call);
        # the parameters it is applied with live in the learner state
        self.model = self._build_model(torch.Generator().manual_seed(0))
        self.tx = optimizer_from_config(learner_config.optimizer, self.policy)

    def _build_model(self, generator: torch.Generator | None):
        obs_shape = self.specs.obs.shape
        if self.seq_policy:
            return build_seq_model(
                self.config.model, self.specs, self.config.algo.init_log_std,
                horizon=self.config.algo.horizon, policy=self.policy, generator=generator,
            )
        if self.discrete:
            return CategoricalPPOModel(self.model_cfg, obs_shape, self.specs.action.n, generator=generator)
        return PPOModel(
            self.model_cfg, obs_shape, int(self.specs.action.shape[0]),
            init_log_std=self.config.algo.init_log_std, generator=generator,
        )

    # -- state ---------------------------------------------------------------
    def init(self, generator: torch.Generator | None = None) -> IMPALAState:
        """Fresh state. Parameters are drawn on the CPU from ``generator``
        (a CPU generator, or None for a fixed seed of 0) and then moved to
        the device, so one seed gives the same weights on every device."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        with torch.no_grad():
            model = self._build_model(generator)
        return self.state_from_params(dict(model.named_parameters()))

    def state_from_params(self, params: Params) -> IMPALAState:
        """A fresh state (new optimizer state and obs filter) around
        ``params``; how converted reference weights enter the port."""
        params = param_dtypes_of(self.model, params, self.device)
        obs_shape = self.specs.obs.shape if self._use_obs_filter else (1,)
        return IMPALAState(
            params=params,
            opt_state=self.tx.init(params),
            obs_stats=init_stats(obs_shape, self.device),
            iteration=torch.zeros((), dtype=torch.int32, device=self.device),
        )

    @property
    def _use_obs_filter(self) -> bool:
        # pixel obs are normalized by /255 in the CNN stem, not by ZFilter
        return bool(self.config.algo.use_obs_filter) and self.specs.obs.dtype != np.uint8

    def _norm_obs(self, stats: RunningStats, obs: torch.Tensor) -> torch.Tensor:
        if not self._use_obs_filter:
            return obs
        return normalize(stats, obs.to(torch.float32))

    def apply(self, params: Params, obs: torch.Tensor, **kw):
        """The model applied with ``params``; ``kw`` (cache, pos) reach a
        trajectory model's decode form."""
        return functional_call(self.model, params, (obs,), kw)

    # -- acting (same behaviour-info contract as PPO) --------------------------
    @torch.no_grad()
    def act(
        self,
        state: IMPALAState,
        obs: torch.Tensor,
        mode: str = TRAINING,
        generator: torch.Generator | None = None,
        noise: torch.Tensor | None = None,
    ):
        if self.seq_policy:
            raise RuntimeError(
                "trajectory policies condition on history: act through "
                "act_init/act_step (the device collector and the evaluator "
                "do); the stateless act() has no context to condition on"
            )
        out = self.apply(state.params, self._norm_obs(state.obs_stats, obs))
        return self._head_act(out, mode, generator, noise)

    # -- learning ------------------------------------------------------------
    def learn(self, state: IMPALAState, batch: dict, generator: torch.Generator | None = None):
        """One Adam step on the whole [T, B] batch. Draws nothing, so
        ``generator`` is unused (the reference's learn key is unused too)."""
        del generator
        check_learn_batch(batch, self.specs, name="impala.learn")
        algo = self.config.algo
        with torch.no_grad():
            if self._use_obs_filter:
                obs_stats = update_stats(state.obs_stats, batch["obs"])
            else:
                obs_stats = state.obs_stats
            obs = self._norm_obs(obs_stats, batch["obs"])
            next_obs = self._norm_obs(obs_stats, batch["next_obs"])
            if not self.seq_policy:
                # V(s'_t) only feeds V-trace, which is gradient-stopped
                values_next = self.apply(state.params, next_obs).value

        leaves = {k: v.detach().requires_grad_(True) for k, v in state.params.items()}
        if self.seq_policy:
            # one extended [B, T+1] pass: each position conditioned on its
            # segment prefix (as act_step was), V-trace's bootstrap read
            # from the shifted positions (the truncation caveat of PPO's
            # _learn_seq holds here too)
            T = batch["reward"].shape[0]
            ext = torch.cat([obs.transpose(0, 1), next_obs[-1][:, None]], dim=1)
            out_ext = self.apply(leaves, ext)
            out = type(out_ext)(*(x[:, :T].transpose(0, 1) for x in out_ext))  # [T, B, ...]
            # the one copy: the detached [B, T+1] values to [T+1, B], so
            # V-trace gets contiguous [T, B] values and values_next
            v_tb = out_ext.value.detach().t().contiguous()
            values_d, values_next = v_tb[:T], v_tb[1:]
        else:
            out = self.apply(leaves, obs)
            values_d = out.value.detach()
        values = out.value
        if self.discrete:
            logp = D.categorical_logp(out.logits, batch["action"])
            entropy = D.categorical_entropy(out.logits).mean()
        else:
            logp = D.diag_gauss_logp(out.mean, out.log_std, batch["action"])
            entropy = D.diag_gauss_entropy(out.log_std).mean()
        vt = self._vtrace(batch, logp.detach(), values_d, values_next)
        pg_loss = -(vt.pg_advantages * logp).mean()
        v_loss = 0.5 * ((values - vt.vs) ** 2).mean()
        total = pg_loss + algo.value_coeff * v_loss - algo.entropy_coeff * entropy
        # the dynamic loss scale from the carried optimizer state (1.0
        # without loss scaling); the chain unscales and skips overflows
        scale = current_loss_scale(state.opt_state)
        grads = dict(zip(leaves, torch.autograd.grad(scale_loss(total, scale), list(leaves.values()))))

        with torch.no_grad():
            updates, opt_state, grad_norm = chain_step(self.tx, grads, state.opt_state, scale)
            params = apply_updates(state.params, updates)
            new_state = IMPALAState(
                params=params,
                opt_state=opt_state,
                obs_stats=obs_stats,
                iteration=state.iteration + 1,
            )
            metrics = {
                "loss/pg": pg_loss.detach(),
                "loss/value": v_loss.detach(),
                "policy/entropy": entropy.detach(),
                "policy/rho_mean": torch.exp(logp.detach() - batch["behavior_logp"]).mean(),
                # the true gradient's norm: inf and nan survive the division
                **training_health(state.params, params, grad_norm),
                **loss_scale_metrics(opt_state),
            }
        return new_state, metrics

    def _vtrace(self, batch, target_logp, values, values_next) -> VTraceOutput:
        """Truncation-exact V-trace over [T, B]; 'xla' and 'pallas' both go
        to ops/vtrace.py::vtrace_nextobs (the fused kernel), 'assoc' to
        ops/vtrace.py::vtrace_nextobs_assoc (the reverse scan's kernel).
        Each launches its CUDA kernel for CUDA tensors and runs its plain
        version for CPU tensors."""
        algo = self.config.algo
        form = vtrace_nextobs_assoc if algo.get("vtrace_impl", "xla") == "assoc" else vtrace_nextobs
        return form(
            batch["behavior_logp"], target_logp, batch["reward"], values, values_next,
            batch["done"], batch["terminated"], algo.gamma,
            clip_rho=algo.clip_rho, clip_c=algo.clip_c, clip_pg_rho=algo.clip_pg_rho,
        )
