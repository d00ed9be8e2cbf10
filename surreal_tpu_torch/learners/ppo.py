"""PPO learner, the port of ``surreal_tpu/learners/ppo.py::PPOLearner``:
GAE, clipped-surrogate and adaptive-KL-penalty modes, KL early stop and
beta adaptation, value clipping, grad-norm clip, and the ZFilter
obs-normalizer update; a diagonal-Gaussian head for continuous actions
and a categorical one for discrete actions; the memoryless MLP/CNN models
and the trajectory transformer (``model.encoder.kind='trajectory'``,
learned by :meth:`PPOLearner._learn_seq`).

The reference's nested ``lax.scan`` over epochs x minibatches becomes two
Python loops; the KL early stop is a carried bool tensor that zeroes the
policy-loss coefficient, so the loop never reads a value back to the
host. Randomness is explicit: epoch permutations come from a
``torch.Generator``, or are given (``perms``) so tests can inject the ones
JAX drew.

Batch layout (from launch/rollout.py):
  obs [T,B,...], next_obs [T,B,...] (pre-reset terminal obs at dones),
  action [T,B,...], reward [T,B], done [T,B] (episode boundary),
  terminated [T,B] (true env termination, excludes truncation),
  behavior_logp [T,B], behavior: {mean, log_std} | {logits}.

Truncation is handled exactly: bootstrap discount gamma*(1-terminated)
pairs with V(next_obs), while the GAE decay uses gamma*lam*(1-done).
``value_bootstrap='shared'`` instead takes one value forward over
[obs; next_obs[-1:]] and bootstraps off the shifted values (truncations
then bootstrap off the post-reset obs).
"""

from __future__ import annotations

import math
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
from surreal_tpu_torch.ops.gae import gae_advantages_masked
from surreal_tpu_torch.ops.precision import current_loss_scale, loss_scale_metrics, scale_loss
from surreal_tpu_torch.ops.returns import reverse_linear_scan_assoc
from surreal_tpu_torch.ops.running_stats import RunningStats, init_stats, normalize, update_stats
from surreal_tpu_torch.session.config import Config
from surreal_tpu_torch.utils.asserts import check_learn_batch

PPO_LEARNER_CONFIG = Config(
    algo=Config(
        name="ppo",
        ppo_mode="clip",      # 'clip' | 'adapt'
        lam=0.97,             # GAE lambda
        clip_ratio=0.2,
        kl_target=0.01,
        kl_early_stop=4.0,    # stop policy updates when kl > factor*target
        beta_init=1.0,        # adaptive-KL penalty coefficient
        beta_range=(1e-3, 35.0),
        beta_adjust=1.5,
        horizon=128,          # rollout length per SGD iteration
        epochs=4,
        num_minibatches=4,
        value_coeff=0.5,
        entropy_coeff=0.01,
        clip_value=True,      # PPO-style value clipping
        norm_adv=True,
        init_log_std=-0.5,
        # 'xla' and 'pallas' both mean the fused GAE of ops/gae.py: the CUDA
        # kernel on the card, its plain version on the CPU. 'assoc' means the
        # reference's deltas then ops/returns.py::reverse_linear_scan_assoc:
        # the reverse scan's CUDA kernel on the card, its plain loop on the CPU.
        gae_impl="xla",
        # the minibatch scan's unroll in the JAX package; any value it
        # accepts is accepted, and changes nothing in the port's Python loop
        sgd_unroll=1,
        shuffle="block",      # 'block' permutes contiguous blocks | 'row'
        # value forward for GAE: 'exact' runs a second forward over next_obs
        # (truncations bootstrap off the true terminal obs); 'shared' one
        # forward over [obs; next_obs[-1:]] (shifted values)
        value_bootstrap="exact",
    ),
    replay=Config(kind="fifo"),
)


def _block_layout(domain: int, num_mb: int, row_bytes: int) -> int:
    """Blocks per minibatch for block-shuffled SGD, or 0 to use row mode.

    The reference's rules verbatim: block mode needs ``domain`` exactly
    divisible by ``num_mb`` (else a fixed tail would be excluded from every
    epoch), at least 4 blocks per minibatch (else the shuffle only permutes
    minibatch order), and rows of at most 4096 bytes."""
    if domain % num_mb != 0 or row_bytes > 4096:
        return 0
    mb_size = domain // num_mb
    blocks_per_mb = 1
    while blocks_per_mb < 64 and mb_size % (blocks_per_mb * 2) == 0:
        blocks_per_mb *= 2
    return blocks_per_mb if blocks_per_mb >= 4 else 0


class PPOState(NamedTuple):
    params: Params
    opt_state: OptState
    obs_stats: RunningStats
    kl_beta: torch.Tensor     # scalar, adaptive-KL mode
    iteration: torch.Tensor   # int32 scalar


class PPOLearner(SequenceActingMixin, Learner):
    supports_trajectory_encoder = True

    def __init__(self, learner_config, env_specs: EnvSpecs, device: str | torch.device = "cuda"):
        super().__init__(learner_config, env_specs, device)
        algo = learner_config.algo
        self.discrete = env_specs.discrete
        enc = learner_config.model.get("encoder", None)
        self.seq_policy = bool(enc is not None and enc.get("kind") == "trajectory")
        self.requires_act_carry = self.seq_policy
        if algo.get("gae_impl", "xla") not in ("xla", "assoc", "pallas"):
            raise ValueError(f"gae_impl {algo.gae_impl!r} not in xla|assoc|pallas")
        if algo.get("shuffle", "block") not in ("block", "row"):
            raise ValueError(f"algo.shuffle {algo.shuffle!r} not in block|row")
        check_scan_unroll(algo, "gae_unroll")
        check_scan_unroll(algo, "sgd_unroll")
        self.model_cfg = self.policy.model_config(learner_config.model)
        # the module defines the computation (applied with functional_call);
        # the parameters it is applied with live in the learner state
        self.model = self._build_model(torch.Generator().manual_seed(0))
        self.tx = optimizer_from_config(learner_config.optimizer, self.policy)

    def _build_model(self, generator: torch.Generator | None):
        algo = self.config.algo
        if self.seq_policy:
            return build_seq_model(
                self.config.model, self.specs, algo.init_log_std,
                horizon=algo.horizon, policy=self.policy, generator=generator,
            )
        if self.discrete:
            return CategoricalPPOModel(self.model_cfg, self.specs.obs.shape, self.specs.action.n, generator=generator)
        return PPOModel(
            self.model_cfg, self.specs.obs.shape, int(self.specs.action.shape[0]),
            init_log_std=algo.init_log_std, generator=generator,
        )

    # -- state ---------------------------------------------------------------
    def init(self, generator: torch.Generator | None = None) -> PPOState:
        """Fresh state. Parameters are drawn on the CPU from ``generator``
        (a CPU generator, or None for a fixed seed of 0) and then moved to
        the device, so one seed gives the same weights on every device."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        with torch.no_grad():
            model = self._build_model(generator)
        params = {k: v.detach().to(self.device) for k, v in model.named_parameters()}
        return self.state_from_params(params)

    def state_from_params(self, params: Params) -> PPOState:
        """A fresh state (new optimizer state and obs filter) around
        ``params``; how converted reference weights enter the port."""
        params = param_dtypes_of(self.model, params, self.device)
        obs_shape = self.specs.obs.shape if self._use_obs_filter else (1,)
        return PPOState(
            params=params,
            opt_state=self.tx.init(params),
            obs_stats=init_stats(obs_shape, self.device),
            kl_beta=torch.tensor(self.config.algo.beta_init, dtype=torch.float32, device=self.device),
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

    # -- acting --------------------------------------------------------------
    @torch.no_grad()
    def act(
        self,
        state: PPOState,
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
    def learn(
        self,
        state: PPOState,
        batch: dict,
        generator: torch.Generator | None = None,
        perms: torch.Tensor | None = None,
    ):
        """One SGD iteration. ``perms`` [epochs, perm_domain] replaces the
        per-epoch permutations (of blocks in block mode, of rows in row
        mode) that are otherwise drawn from ``generator``."""
        check_learn_batch(batch, self.specs, name="ppo.learn")
        if self.seq_policy:
            return self._learn_seq(state, batch, generator, perms)
        algo = self.config.algo
        T, B = batch["reward"].shape

        with torch.no_grad():
            # 1) obs-normalizer update (reference: ZFilter update then broadcast)
            if self._use_obs_filter:
                obs_stats = update_stats(state.obs_stats, batch["obs"])
            else:
                obs_stats = state.obs_stats
            obs = self._norm_obs(obs_stats, batch["obs"])
            next_obs = self._norm_obs(obs_stats, batch["next_obs"])
            # 2) value forward for GAE, then GAE and advantage normalization
            if algo.get("value_bootstrap", "exact") == "shared":
                # one forward over [obs; last next_obs], shifted
                v_all = self.apply(state.params, torch.cat([obs, next_obs[-1:]], dim=0)).value
                values, v_next = v_all[:-1], v_all[1:]
            else:
                # a second forward over next_obs, so truncated episodes
                # bootstrap off the true pre-reset terminal obs
                values = self.apply(state.params, obs).value
                v_next = self.apply(state.params, next_obs).value
            advantages, value_targets = self._gae(batch, values, v_next)
            advantages = self._norm_advantages(advantages)

        # 3) flatten time x batch -> sample axis
        N = T * B
        flat = {
            "obs": obs.reshape(N, *obs.shape[2:]),
            "action": batch["action"].reshape(N, *batch["action"].shape[2:]),
            "behavior_logp": batch["behavior_logp"].reshape(N),
            "adv": advantages.reshape(N),
            "target": value_targets.reshape(N),
            "value_old": values.reshape(N),
            **self._behavior(batch, lambda x: x.reshape(N, -1)),
        }
        # the obs minibatch array in the policy's staging dtype (bf16 under
        # 'bf16' and 'bf16_fp8'): the minibatch gathers move half the bytes,
        # rounded where the model's compute-dtype cast would round them
        flat = self.policy.cast_stage(flat, keys=("obs",))
        sgd_out = self._sgd_epochs(state, flat, N, algo.num_minibatches, generator, perms)
        return self._finalize(state, obs_stats, sgd_out, values, value_targets, advantages)

    def _behavior(self, batch, layout) -> dict:
        """The behaviour policy's head parameters for the loss's KL, each
        passed through ``layout``."""
        if self.discrete:
            return {"b_logits": layout(batch["behavior"]["logits"])}
        return {
            "b_mean": layout(batch["behavior"]["mean"]),
            "b_log_std": layout(batch["behavior"]["log_std"]),
        }

    def _gae(self, batch, values, v_next):
        """Truncation-exact GAE over [T, B]. 'xla' and 'pallas' both go to
        ops/gae.py; 'assoc' builds the reference's TD deltas and solves the
        recurrence with ops/returns.py::reverse_linear_scan_assoc. Each
        launches its CUDA kernel for CUDA tensors and runs its plain version
        for CPU tensors."""
        algo = self.config.algo
        # a fill on the device: torch.tensor(x, device='cuda') copies from
        # the host and synchronizes
        gamma = torch.full((), algo.gamma, dtype=torch.float32, device=values.device)
        boot_disc = gamma * (1.0 - batch["terminated"].to(torch.float32))
        decay = gamma * algo.lam * (1.0 - batch["done"].to(torch.float32))
        if algo.get("gae_impl", "xla") == "assoc":
            deltas = batch["reward"] + boot_disc * v_next - values
            advantages = reverse_linear_scan_assoc(decay, deltas)
            return advantages, advantages + values
        return gae_advantages_masked(batch["reward"], boot_disc, decay, values, v_next)

    def _norm_advantages(self, advantages):
        if not self.config.algo.norm_adv:
            return advantages
        # population variance, as jnp.var
        adv_var, adv_mean = torch.var_mean(advantages, correction=0)
        return (advantages - adv_mean) / (torch.sqrt(adv_var) + 1e-8)

    def _loss_fn(self, params, mb, kl_beta, policy_coeff):
        """Clipped / adaptive-KL PPO loss. Every reduction is a full mean,
        so flat [N] minibatches (memoryless) and [envs, T] segment
        minibatches (sequence) share it."""
        algo = self.config.algo
        out = self.apply(params, mb["obs"])
        if self.discrete:
            logp = D.categorical_logp(out.logits, mb["action"])
            kl = D.categorical_kl(mb["b_logits"], out.logits).mean()
            entropy = D.categorical_entropy(out.logits).mean()
        else:
            logp = D.diag_gauss_logp(out.mean, out.log_std, mb["action"])
            kl = D.diag_gauss_kl(mb["b_mean"], mb["b_log_std"], out.mean, out.log_std).mean()
            entropy = D.diag_gauss_entropy(out.log_std).mean()

        ratio = torch.exp(logp - mb["behavior_logp"])
        if algo.ppo_mode == "clip":
            clipped = torch.clamp(ratio, 1.0 - algo.clip_ratio, 1.0 + algo.clip_ratio)
            pg_loss = -torch.minimum(ratio * mb["adv"], clipped * mb["adv"]).mean()
        else:  # adaptive KL penalty
            pg_loss = -(ratio * mb["adv"]).mean() + kl_beta * kl

        v = out.value
        if algo.clip_value:
            v_clip = mb["value_old"] + torch.clamp(
                v - mb["value_old"], -algo.clip_ratio, algo.clip_ratio
            )
            v_loss = 0.5 * torch.maximum(
                (v - mb["target"]) ** 2, (v_clip - mb["target"]) ** 2
            ).mean()
        else:
            v_loss = 0.5 * ((v - mb["target"]) ** 2).mean()

        total = policy_coeff * (pg_loss - algo.entropy_coeff * entropy) + algo.value_coeff * v_loss
        return total, {"pg_loss": pg_loss, "v_loss": v_loss, "entropy": entropy, "kl": kl}

    def _sgd_epochs(self, state, data, domain, num_mb, generator, perms):
        """epochs x minibatches of Adam steps with the KL early stop over
        ``data``, indexed on its leading axis of size ``domain``: flat
        (t, b) samples in the memoryless path, whole envs in the sequence
        path.

        ``algo.shuffle`` selects how minibatches are drawn, with the
        reference's layout: 'block' permutes contiguous blocks (up to 64
        per minibatch, see :func:`_block_layout`), 'row' permutes rows
        (also the fallback when fewer than 4 blocks fit a minibatch)."""
        algo = self.config.algo
        mb_size = domain // num_mb
        row_bytes = max(math.prod(x.shape[1:]) * x.element_size() for x in data.values())
        blocks_per_mb = (
            _block_layout(domain, num_mb, row_bytes) if algo.get("shuffle", "block") == "block" else 0
        )
        if blocks_per_mb:
            nblocks = num_mb * blocks_per_mb
            block_len = mb_size // blocks_per_mb
            data = {k: x.reshape(nblocks, block_len, *x.shape[1:]) for k, x in data.items()}
            unblock = lambda x: x.reshape(blocks_per_mb * block_len, *x.shape[2:])  # noqa: E731
            perm_domain, idx_shape = nblocks, (num_mb, blocks_per_mb)
        else:
            unblock = lambda x: x  # noqa: E731
            perm_domain, idx_shape = domain, (num_mb, mb_size)

        if perms is None:
            perms = torch.stack([
                torch.randperm(perm_domain, generator=generator, device=self.device)
                for _ in range(algo.epochs)
            ])
        elif tuple(perms.shape) != (algo.epochs, perm_domain):
            raise ValueError(
                f"perms must be [epochs={algo.epochs}, {perm_domain}]; got {tuple(perms.shape)}"
            )
        # row mode on a domain not divisible by num_mb drops the tail
        idx = perms.to(self.device, torch.long)[:, : idx_shape[0] * idx_shape[1]]
        idx = idx.reshape(algo.epochs, *idx_shape)

        params, opt_state = state.params, state.opt_state
        stopped = torch.zeros((), dtype=torch.bool, device=self.device)
        auxs = []
        for epoch in range(algo.epochs):
            for m in range(num_mb):
                mb = {k: unblock(x.index_select(0, idx[epoch, m])) for k, x in data.items()}
                policy_coeff = torch.where(stopped, 0.0, 1.0)
                leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
                total, aux = self._loss_fn(leaves, mb, state.kl_beta, policy_coeff)
                # the dynamic loss scale, read from the carried optimizer
                # state (a power of two; 1.0 without loss scaling): only the
                # differentiated total is scaled, the chain unscales
                scale = current_loss_scale(opt_state)
                grads = dict(zip(leaves, torch.autograd.grad(scale_loss(total, scale), list(leaves.values()))))
                with torch.no_grad():
                    aux = {k: v.detach() for k, v in aux.items()}
                    # the true gradient's norm; inf and nan survive the division
                    updates, opt_state, aux["grad_norm"] = chain_step(self.tx, grads, opt_state, scale)
                    params = apply_updates(params, updates)
                    stopped = stopped | (aux["kl"] > algo.kl_early_stop * algo.kl_target)
                auxs.append(aux)
        stacked = {
            k: torch.stack([a[k] for a in auxs]).reshape(algo.epochs, num_mb) for k in auxs[0]
        }
        return (params, opt_state, stopped), stacked

    @torch.no_grad()
    def _finalize(self, state, obs_stats, sgd_out, values, value_targets, advantages):
        """Beta adaptation + new state + the metrics dict."""
        algo = self.config.algo
        (params, opt_state, stopped), auxs = sgd_out
        final_kl = auxs["kl"][-1, -1]

        beta = state.kl_beta
        if algo.ppo_mode == "adapt":
            lo, hi = algo.beta_range
            beta = torch.where(
                final_kl > 2.0 * algo.kl_target,
                torch.clamp_max(beta * algo.beta_adjust, hi),
                torch.where(
                    final_kl < algo.kl_target / 2.0,
                    torch.clamp_min(beta / algo.beta_adjust, lo),
                    beta,
                ),
            )

        new_state = PPOState(
            params=params,
            opt_state=opt_state,
            obs_stats=obs_stats,
            kl_beta=beta,
            iteration=state.iteration + 1,
        )
        ev_denom = torch.var(value_targets, correction=0) + 1e-8
        metrics = {
            "loss/pg": auxs["pg_loss"].mean(),
            "loss/value": auxs["v_loss"].mean(),
            "policy/entropy": auxs["entropy"].mean(),
            "policy/kl": final_kl,
            "policy/kl_beta": beta,
            "policy/early_stopped": stopped.to(torch.float32),
            "value/explained_variance": 1.0 - torch.var(value_targets - values, correction=0) / ev_denom,
            "adv/mean_abs": torch.abs(advantages).mean(),
        }
        metrics.update(training_health(state.params, params, auxs["grad_norm"].mean()))
        # the loss-scale telemetry (device scalars; none without loss scaling)
        metrics.update(loss_scale_metrics(opt_state))
        return new_state, metrics

    # -- sequence learning ---------------------------------------------------
    def _learn_seq(self, state: PPOState, batch: dict, generator=None, perms=None):
        """One SGD iteration for the trajectory policy. What history
        conditioning changes, as in the reference:

        - the model runs over whole segments [B, T, ...]: each position
          conditions on its causal prefix, as ``act_step`` did;
        - minibatches are whole envs, never flat (t, b) samples (a shuffled
          sample has no prefix to condition on), through the same block
          layout with the segment's row bytes;
        - values and the bootstrap come from one extended [B, T+1] pass
          (the last next_obs appended). A mid-segment truncation then
          bootstraps off the post-reset obs, the reference's documented
          bias; terminations are exact (their discount is 0).
        """
        algo = self.config.algo
        T, B = batch["reward"].shape
        if B // algo.num_minibatches == 0:
            raise ValueError(
                f"num_minibatches={algo.num_minibatches} exceeds the env "
                f"batch width {B}: sequence minibatches are whole envs"
            )
        with torch.no_grad():
            if self._use_obs_filter:
                obs_stats = update_stats(state.obs_stats, batch["obs"])
            else:
                obs_stats = state.obs_stats
            obs_bt = self._norm_obs(obs_stats, batch["obs"]).transpose(0, 1)  # [B, T, ...]
            last_next = self._norm_obs(obs_stats, batch["next_obs"][-1])
            ext = torch.cat([obs_bt, last_next[:, None]], dim=1)  # [B, T+1, ...]
            out_ext = self.apply(state.params, ext)
            # the one copy: [B, T+1] values to [T+1, B], so values and v_next
            # are contiguous [T, B] rows, as the GAE kernel takes them
            v_tb = out_ext.value.t().contiguous()
            values, v_next = v_tb[:T], v_tb[1:]
            advantages, value_targets = self._gae(batch, values, v_next)
            advantages = self._norm_advantages(advantages)

        # env-major training arrays [B, T, ...]; a minibatch gathers whole
        # envs, so _loss_fn recomputes whole-segment conditioning
        bt = lambda x: x.transpose(0, 1)  # noqa: E731
        data = {
            "obs": ext[:, :T],
            "action": bt(batch["action"]),
            "behavior_logp": bt(batch["behavior_logp"]),
            "adv": bt(advantages),
            "target": bt(value_targets),
            "value_old": bt(values),
            **self._behavior(batch, bt),
        }
        # the staging cast of the memoryless path (uint8 pixels pass through)
        data = self.policy.cast_stage(data, keys=("obs",))
        sgd_out = self._sgd_epochs(state, data, B, algo.num_minibatches, generator, perms)
        return self._finalize(state, obs_stats, sgd_out, values, value_targets, advantages)
