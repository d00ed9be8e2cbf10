"""DDPG learner, the port of ``surreal_tpu/learners/ddpg.py``
(``DDPG_LEARNER_CONFIG``, ``DDPGState``, ``DDPGLearner``,
``ou_noise_step``): critic TD loss on flat n-step transitions with
optional IS weights, actor DPG loss through the live critic, target
networks updated softly (tau every step) or hard (copied every N), and
the per-sample |TD| returned for the priority refresh.

Functional as in the reference: one :class:`DDPGState` carries live and
target params and both optimizers' states; ``learn`` returns a new state.
Randomness is explicit: ``act`` and :func:`ou_noise_step` take their
standard normals from a ``torch.Generator`` or as given (``noise``,
``normals``), so tests can inject the ones JAX drew. Under dynamic loss
scaling each chain carries its own scale: each loss is multiplied by its
chain's, and the telemetry reports the actor's scale and both chains'
overflows, as the reference does.
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
    global_norm,
    incremental_update,
    make_optimizer_chain,
    param_dtypes_of,
    training_health,
)
from surreal_tpu_torch.models.ddpg_net import DDPGActor, DDPGCritic
from surreal_tpu_torch.ops.precision import current_loss_scale, loss_scale_metrics, scale_loss
from surreal_tpu_torch.ops.running_stats import RunningStats, init_stats, normalize, update_stats
from surreal_tpu_torch.session.config import Config
from surreal_tpu_torch.utils.asserts import check_learn_batch

DDPG_LEARNER_CONFIG = Config(
    algo=Config(
        name="ddpg",
        n_step=1,             # >1 enables the aggregator's n-step folding
        actor_lr=1e-3,
        critic_lr=1e-3,
        target=Config(
            mode="soft",       # 'soft' (tau each step) | 'hard' (copy every N)
            tau=0.005,
            hard_every=500,
        ),
        exploration=Config(
            noise="ou",        # 'ou' | 'gaussian' (OU state lives in the rollout carry)
            sigma=0.2,
            ou_theta=0.15,
            ou_dt=1.0,
            warmup_steps=2000,  # uniform-random actions before policy acting
        ),
        updates_per_iter=64,   # SGD updates per collect chunk (off-policy ratio)
        # the update scan's unroll in the JAX package; any value it accepts
        # is accepted, and changes nothing in the port's eager update loop
        update_unroll=1,
        # uniform replay only: gather all updates_per_iter index sets in one
        # launch before the update loop (launch/offpolicy_trainer.py)
        batched_uniform_sampling=True,
        # 'xla' and 'pallas' both mean the gather kernel of
        # ops/replay_rows.py on the card, its plain version on the CPU
        replay_gather="xla",
        horizon=16,            # collect chunk length per iteration
        use_layer_norm=True,
    ),
    replay=Config(kind="uniform"),
)

# the scalar metrics of one learn call (priority/td_abs rides beside them)
LEARN_METRIC_KEYS = (
    "loss/critic", "loss/actor", "q/mean_target", "q/mean_abs_td",
    "health/grad_norm", "health/param_norm", "health/update_ratio", "health/nonfinite",
)


class DDPGState(NamedTuple):
    actor_params: Params
    critic_params: Params
    target_actor_params: Params
    target_critic_params: Params
    actor_opt: OptState
    critic_opt: OptState
    obs_stats: RunningStats
    iteration: torch.Tensor  # int32 learn-call counter (drives hard updates)


def _both(actor: Params, critic: Params) -> Params:
    """One flat tree over both networks, for the shared health metrics."""
    return {**{f"actor/{k}": v for k, v in actor.items()}, **{f"critic/{k}": v for k, v in critic.items()}}


def _unscaled(grads: Params, scale) -> Params:
    return grads if not isinstance(scale, torch.Tensor) else {k: g / scale for k, g in grads.items()}


class DDPGLearner(Learner):
    def __init__(self, learner_config, env_specs: EnvSpecs, device: str | torch.device = "cuda"):
        super().__init__(learner_config, env_specs, device)
        if env_specs.discrete:
            raise ValueError("DDPG requires a continuous action space")
        algo = learner_config.algo
        if algo.target.mode not in ("soft", "hard"):
            raise ValueError(f"algo.target.mode {algo.target.mode!r} not in soft|hard")
        self.act_dim = int(env_specs.action.shape[0])
        self.model_cfg = self.policy.model_config(learner_config.model)
        # the modules define the computation (applied with functional_call);
        # the parameters they are applied with live in the learner state
        self.actor, self.critic = self._build_models(torch.Generator().manual_seed(0))
        max_norm = learner_config.optimizer.max_grad_norm
        self.actor_tx = make_optimizer_chain(algo.actor_lr, max_norm, self.policy)
        self.critic_tx = make_optimizer_chain(algo.critic_lr, max_norm, self.policy)

    def _build_models(self, generator: torch.Generator | None) -> tuple[DDPGActor, DDPGCritic]:
        obs_shape = self.specs.obs.shape
        actor = DDPGActor(self.model_cfg, obs_shape, self.act_dim, generator=generator)
        critic = DDPGCritic(
            self.model_cfg, obs_shape, self.act_dim,
            use_layer_norm=self.config.algo.use_layer_norm, generator=generator,
        )
        return actor, critic

    # -- state ---------------------------------------------------------------
    def init(self, generator: torch.Generator | None = None) -> DDPGState:
        """Fresh state. Parameters are drawn on the CPU from ``generator``
        (a CPU generator, or None for a fixed seed of 0), actor first, then
        moved to the device, so one seed gives the same weights on every
        device."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        with torch.no_grad():
            actor, critic = self._build_models(generator)
        return self.state_from_params(
            {k: v.detach() for k, v in actor.named_parameters()},
            {k: v.detach() for k, v in critic.named_parameters()},
        )

    def state_from_params(self, actor_params: Params, critic_params: Params) -> DDPGState:
        """A fresh state around ``actor_params`` and ``critic_params``
        (targets equal to them, new optimizer states and obs filter); how
        converted reference weights enter the port."""
        actor_params = param_dtypes_of(self.actor, actor_params, self.device)
        critic_params = param_dtypes_of(self.critic, critic_params, self.device)
        obs_shape = self.specs.obs.shape if self._use_obs_filter else (1,)
        return DDPGState(
            actor_params=actor_params,
            critic_params=critic_params,
            target_actor_params={k: v.clone() for k, v in actor_params.items()},
            target_critic_params={k: v.clone() for k, v in critic_params.items()},
            actor_opt=self.actor_tx.init(actor_params),
            critic_opt=self.critic_tx.init(critic_params),
            obs_stats=init_stats(obs_shape, self.device),
            iteration=torch.zeros((), dtype=torch.int32, device=self.device),
        )

    @property
    def _use_obs_filter(self) -> bool:
        return bool(self.config.algo.use_obs_filter) and self.specs.obs.dtype != np.uint8

    def _norm_obs(self, stats: RunningStats, obs: torch.Tensor) -> torch.Tensor:
        if not self._use_obs_filter:
            return obs
        return normalize(stats, obs.to(torch.float32))

    def actor_apply(self, params: Params, obs: torch.Tensor) -> torch.Tensor:
        return functional_call(self.actor, params, (obs,))

    def critic_apply(self, params: Params, obs: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
        return functional_call(self.critic, params, (obs, action))

    # -- acting --------------------------------------------------------------
    @torch.no_grad()
    def act(
        self,
        state: DDPGState,
        obs: torch.Tensor,
        mode: str = TRAINING,
        generator: torch.Generator | None = None,
        noise: torch.Tensor | None = None,
    ):
        """Deterministic actor; training mode with ``exploration.noise ==
        'gaussian'`` adds ``sigma * noise`` (standard normals [B, act_dim],
        drawn from ``generator`` unless given). OU noise is stateful: the
        off-policy collector carries it with :func:`ou_noise_step`."""
        a = self.actor_apply(state.actor_params, self._norm_obs(state.obs_stats, obs))
        explo = self.config.algo.exploration
        if mode == TRAINING and explo.noise == "gaussian":
            if noise is None:
                noise = torch.randn(a.shape, generator=generator, dtype=a.dtype, device=a.device)
            a = a + explo.sigma * noise.to(a.dtype)
        return torch.clamp(a, -1.0, 1.0), {}

    @torch.no_grad()
    def update_obs_stats(self, state: DDPGState, fresh_obs: torch.Tensor) -> DDPGState:
        """Fold FRESH trajectory obs into the normalizer, once per collect
        chunk; never in ``learn``, whose replayed (and, under prioritized
        replay, high-|TD|-biased) minibatches would skew the stats."""
        if not self._use_obs_filter:
            return state
        return state._replace(obs_stats=update_stats(state.obs_stats, fresh_obs))

    # -- learning ------------------------------------------------------------
    def learn(self, state: DDPGState, batch: dict, generator: torch.Generator | None = None):
        """One SGD update of both networks on flat n-step transitions.

        batch: obs [B,...], action [B,A], reward [B] (n-step sum), next_obs
        [B,...] (s_{t+n}), discount [B] (gamma^k * not-terminated, 0 past
        episode end), optional is_weights [B]. Obs-normalizer stats are
        read-only here (see :meth:`update_obs_stats`). ``generator`` is
        unused, as the reference's key is. Returns (new_state, metrics):
        the scalar metrics of :data:`LEARN_METRIC_KEYS` plus
        ``priority/td_abs`` [B]."""
        del generator
        check_learn_batch(batch, self.specs, name="ddpg.learn")
        algo = self.config.algo
        obs = self._norm_obs(state.obs_stats, batch["obs"])
        next_obs = self._norm_obs(state.obs_stats, batch["next_obs"])
        is_w = batch.get("is_weights")
        if is_w is None:
            is_w = torch.ones_like(batch["reward"])

        # critic: TD target from the target networks
        with torch.no_grad():
            next_a = self.actor_apply(state.target_actor_params, next_obs)
            q_next = self.critic_apply(state.target_critic_params, next_obs, next_a)
            target = batch["reward"] + batch["discount"] * q_next

        # each chain's own dynamic loss scale (1.0 without loss scaling)
        c_scale = current_loss_scale(state.critic_opt)
        a_scale = current_loss_scale(state.actor_opt)
        c_leaves = {k: v.detach().requires_grad_(True) for k, v in state.critic_params.items()}
        td = self.critic_apply(c_leaves, obs, batch["action"]) - target
        c_loss = (is_w * td**2).mean()
        c_grads = dict(zip(c_leaves, torch.autograd.grad(scale_loss(c_loss, c_scale), list(c_leaves.values()))))

        # actor: deterministic policy gradient through the live critic
        a_leaves = {k: v.detach().requires_grad_(True) for k, v in state.actor_params.items()}
        a = self.actor_apply(a_leaves, obs)
        a_loss = -(is_w * self.critic_apply(state.critic_params, obs, a)).mean()
        a_grads = dict(zip(a_leaves, torch.autograd.grad(scale_loss(a_loss, a_scale), list(a_leaves.values()))))

        with torch.no_grad():
            td = td.detach()
            c_updates, critic_opt = self.critic_tx.update(c_grads, state.critic_opt)
            critic_params = apply_updates(state.critic_params, c_updates)
            a_updates, actor_opt = self.actor_tx.update(a_grads, state.actor_opt)
            actor_params = apply_updates(state.actor_params, a_updates)

            # target update: soft every step, or a hard copy every N
            iteration = state.iteration + 1
            if algo.target.mode == "soft":
                tau = algo.target.tau
                target_actor = incremental_update(actor_params, state.target_actor_params, tau)
                target_critic = incremental_update(critic_params, state.target_critic_params, tau)
            else:
                do_copy = (iteration % algo.target.hard_every) == 0
                target_actor = {
                    k: torch.where(do_copy, v, state.target_actor_params[k]) for k, v in actor_params.items()
                }
                target_critic = {
                    k: torch.where(do_copy, v, state.target_critic_params[k]) for k, v in critic_params.items()
                }

            new_state = DDPGState(
                actor_params=actor_params,
                critic_params=critic_params,
                target_actor_params=target_actor,
                target_critic_params=target_critic,
                actor_opt=actor_opt,
                critic_opt=critic_opt,
                obs_stats=state.obs_stats,
                iteration=iteration,
            )
            metrics = {
                "loss/critic": c_loss.detach(),
                "loss/actor": a_loss.detach(),
                "q/mean_target": target.mean(),
                "q/mean_abs_td": torch.abs(td).mean(),
                # one health set over BOTH networks, each tree's gradients
                # unscaled by its own scale (inf and nan survive)
                **training_health(
                    _both(state.actor_params, state.critic_params),
                    _both(actor_params, critic_params),
                    global_norm(_both(_unscaled(a_grads, a_scale), _unscaled(c_grads, c_scale))),
                ),
                **loss_scale_metrics({"actor": actor_opt, "critic": critic_opt}),
            }
            # per-sample |TD| for the prioritized-replay refresh; the
            # off-policy trainer pops it before treating metrics as scalars
            metrics["priority/td_abs"] = torch.abs(td)
        return new_state, metrics


def ou_noise_step(
    noise: torch.Tensor,
    theta: float,
    sigma: float,
    dt: float = 1.0,
    generator: torch.Generator | None = None,
    normals: torch.Tensor | None = None,
) -> torch.Tensor:
    """One Ornstein-Uhlenbeck step of the collector's noise [B, act_dim]:
    ``noise + (-theta * noise * dt) + sigma * sqrt(dt) * normals``, with
    standard normals drawn from ``generator`` unless given. ``sigma *
    sqrt(dt)`` is formed in float32, as the reference forms it."""
    if normals is None:
        normals = torch.randn(noise.shape, generator=generator, dtype=noise.dtype, device=noise.device)
    drift = -theta * noise * dt
    diffusion = float(np.float32(sigma) * np.sqrt(np.float32(dt))) * normals.to(noise.dtype)
    return noise + drift + diffusion
