"""Learner base, the port of ``surreal_tpu/learners/base.py``
(``training_health``, ``recovery_scale``, ``make_optimizer_chain``,
``set_recovery_lr_scale``, ``Learner``), plus optax's
``incremental_update``.

A learner is a set of functions over an explicit state (a NamedTuple of
tensors and dicts of tensors), as in the reference:

    state           = learner.init(generator)
    state, metrics  = learner.learn(state, batch, generator)
    action, info    = learner.act(state, obs, mode, generator)
    action, info, carry = learner.act_step(state, carry, obs, mode, generator)

The optimizer is functional too: optax's ``clip_by_global_norm -> adam ->
recovery_scale`` written out over dicts of tensors, so that its state
(Adam moments, step count, the recovery LR scale) rides the learner state
like the reference's optax state does.
"""

from __future__ import annotations

import abc
import copy
from typing import Any, Callable, Mapping, NamedTuple

import torch

from surreal_tpu_torch.envs.base import EnvSpecs
from surreal_tpu_torch.ops.precision import resolve_policy
from surreal_tpu_torch.utils.device import resolve_device

# Agent modes (parity: the reference's agent modes)
TRAINING = "training"
EVAL_DETERMINISTIC = "eval_deterministic"
EVAL_STOCHASTIC = "eval_stochastic"

Params = dict[str, torch.Tensor]

_INT32_MAX = 2**31 - 1


def check_scan_unroll(algo, name: str) -> None:
    """Reads an ``algo.*_unroll`` knob (``rollout_unroll``, ``gae_unroll``,
    ``sgd_unroll``, ``update_unroll``) as the JAX package does, with
    ``int(x)``. There it unrolls a ``lax.scan`` (the autotuner searches
    it); eager PyTorch runs the same loop step by step, so every value the
    reference accepts is accepted and changes nothing, and a value the
    reference refuses raises here too."""
    int(algo.get(name, 1))


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """``optax.global_norm``: sqrt of the sum of squares of every leaf."""
    return torch.sqrt(sum(torch.sum(x * x) for x in tree.values()))


def training_health(old_params: Params, new_params: Params, grad_norm: torch.Tensor) -> dict:
    """Training-health diagnostics shared by every learner: grad norm,
    param norm, update ratio, and a NaN/inf guard. All outputs stay device
    scalars; they reach the host only at the metrics cadence."""
    old_norm = global_norm(old_params)
    new_norm = global_norm(new_params)
    update_norm = global_norm({k: new_params[k] - old_params[k] for k in new_params})
    finite = torch.isfinite(grad_norm) & torch.isfinite(new_norm)
    return {
        "health/grad_norm": grad_norm,
        "health/param_norm": new_norm,
        "health/update_ratio": update_norm / (old_norm + 1e-12),
        "health/nonfinite": 1.0 - finite.to(torch.float32),
    }


class OptState(NamedTuple):
    """State of :class:`OptimizerChain`: optax's ``ScaleByAdamState``
    (count, mu, nu) plus the ``recovery_scale`` leaf (1.0 until a
    divergence rollback backs the learning rate off)."""

    count: torch.Tensor           # int32 scalar, Adam steps taken
    mu: Params
    nu: Params
    recovery_scale: torch.Tensor  # float32 scalar


def linear_schedule(init: float, end: float, transition_steps: int) -> Callable[[torch.Tensor], torch.Tensor]:
    """``optax.linear_schedule(init, end, transition_steps)``."""

    def schedule(count: torch.Tensor) -> torch.Tensor:
        frac = 1.0 - torch.clamp(count, 0, transition_steps).to(torch.float32) / transition_steps
        return (init - end) * frac + end

    return schedule


class OptimizerChain:
    """``optax.chain(clip_by_global_norm(max_norm), adam(lr), recovery_scale())``
    with optax's exact rules:

    - the clip rescales by ``max_norm / ||g||`` only when ``||g|| >= max_norm``
      (no ``+1e-6``, unlike ``torch.nn.utils.clip_grad_norm_``);
    - Adam uses b1 0.9, b2 0.999, eps 1e-8, eps inside the root 0, and
      bias correction by ``1 - b**count``;
    - the update is finally multiplied by the state's ``recovery_scale``.
    """

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, lr: float | Callable[[torch.Tensor], torch.Tensor], max_grad_norm: float):
        self.lr = lr
        self.max_grad_norm = max_grad_norm

    def init(self, params: Params) -> OptState:
        some = next(iter(params.values()))
        return OptState(
            count=torch.zeros((), dtype=torch.int32, device=some.device),
            mu={k: torch.zeros_like(v) for k, v in params.items()},
            nu={k: torch.zeros_like(v) for k, v in params.items()},
            recovery_scale=torch.ones((), dtype=torch.float32, device=some.device),
        )

    def update(self, grads: Params, state: OptState) -> tuple[Params, OptState]:
        g_norm = global_norm(grads)
        keep = g_norm < self.max_grad_norm
        grads = {
            k: torch.where(keep, g, (g / g_norm) * self.max_grad_norm) for k, g in grads.items()
        }
        b1, b2 = self.b1, self.b2
        mu = {k: (1 - b1) * g + b1 * state.mu[k] for k, g in grads.items()}
        nu = {k: (1 - b2) * (g * g) + b2 * state.nu[k] for k, g in grads.items()}
        count = torch.clamp_max(state.count + 1, _INT32_MAX)  # optax safe_increment
        bc1 = 1 - torch.pow(b1, count.to(torch.float32))
        bc2 = 1 - torch.pow(b2, count.to(torch.float32))
        step = -(self.lr(state.count) if callable(self.lr) else self.lr)
        updates = {
            k: (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + self.eps) * step * state.recovery_scale
            for k in grads
        }
        return updates, OptState(count=count, mu=mu, nu=nu, recovery_scale=state.recovery_scale)


def set_recovery_lr_scale(tree: Any, scale: float) -> Any:
    """``tree`` (a learner state) with ``scale`` written into the
    ``recovery_scale`` leaf of every :class:`OptState` in it (DDPG has
    two). Each leaf gets its own scalar tensor, on its old leaf's device.
    Between iterations only: the divergence guard's LR backoff
    (``launch/recovery.py``)."""
    if isinstance(tree, OptState):
        old = tree.recovery_scale
        return tree._replace(recovery_scale=torch.full((), scale, dtype=torch.float32, device=old.device))
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(set_recovery_lr_scale(x, scale) for x in tree))
    if isinstance(tree, dict):
        return {k: set_recovery_lr_scale(v, scale) for k, v in tree.items()}
    return tree


def apply_updates(params: Params, updates: Params) -> Params:
    return {k: (p + updates[k]).to(p.dtype) for k, p in params.items()}


def incremental_update(new: Params, old: Params, tau: float) -> Params:
    """``optax.incremental_update``: Polyak averaging with optax's grouping,
    ``tau * new + (1 - tau) * old``."""
    return {k: tau * new[k] + (1.0 - tau) * old[k] for k in new}


def make_optimizer_chain(lr, max_grad_norm: float, policy) -> OptimizerChain:
    """The optimizer-chain constructor every learner uses: clip -> adam ->
    recovery_scale. Loss scaling is not ported (its policies raise at
    ``resolve_policy``)."""
    if policy.loss_scaling:
        raise NotImplementedError("dynamic loss scaling is not ported yet")
    return OptimizerChain(lr, max_grad_norm)


def optimizer_from_config(opt_cfg, policy) -> OptimizerChain:
    """The chain from a ``learner_config.optimizer`` subtree: a constant lr,
    or one annealed linearly to 0 over ``anneal_steps`` Adam steps."""
    if opt_cfg.lr_schedule == "linear":
        lr = linear_schedule(opt_cfg.lr, 0.0, opt_cfg.get("anneal_steps", 10_000))
    else:
        lr = opt_cfg.lr
    return make_optimizer_chain(lr, opt_cfg.max_grad_norm, policy)


class Learner(abc.ABC):
    """Algorithm = init + learn + act. Subclasses hold only static
    configuration and the device; all mutable values live in the state."""

    def __init__(self, learner_config, env_specs: EnvSpecs, device: str | torch.device = "cuda"):
        self.config = learner_config
        self.specs = env_specs
        self.device = resolve_device(device)
        self.policy = resolve_policy(learner_config)
        # the trajectory encoder is an on-policy seam (PPO and IMPALA set
        # supports_trajectory_encoder); any other algorithm ignoring the
        # knob would train another model than the one configured
        enc = learner_config.get("model", None)
        enc = enc.get("encoder", None) if enc is not None else None
        if (
            enc is not None
            and enc.get("kind", "auto") == "trajectory"
            and not self.supports_trajectory_encoder
        ):
            raise ValueError(
                "model.encoder.kind='trajectory' is an on-policy seam "
                f"(ppo, impala; got algo {learner_config.algo.name!r}); "
                "ddpg uses its own actor/critic model build"
            )

    def acting_copy(self) -> "Learner":
        """This learner with deep copies of its modules, for a thread that
        acts while the main thread learns (the host loops' collector and
        staging thread, the evaluator under pipelined side-bands).
        ``functional_call`` swaps the parameters into the module object
        while it runs, so two threads applying one module would each see
        the other's parameters. Call it on the main thread before the
        other thread starts, while nothing else applies the modules."""
        twin = copy.copy(self)
        for name, value in vars(self).items():
            if isinstance(value, torch.nn.Module):
                setattr(twin, name, copy.deepcopy(value))
        return twin

    @abc.abstractmethod
    def init(self, generator: torch.Generator | None = None) -> Any:
        """Build the initial state (params, optimizer, aux)."""

    @abc.abstractmethod
    def learn(self, state: Any, batch: Mapping[str, torch.Tensor], generator: torch.Generator | None = None):
        """One SGD iteration -> (new_state, metrics dict of device scalars)."""

    @abc.abstractmethod
    def act(self, state: Any, obs: torch.Tensor, mode: str = TRAINING, generator: torch.Generator | None = None):
        """Batched action selection -> (action, act_info)."""

    # -- the acting seam of history-conditioned policies ---------------------
    # Trajectory policies thread a per-env acting carry through a rollout;
    # for memoryless ones act_init is None and act_step is act.
    requires_act_carry: bool = False
    supports_trajectory_encoder: bool = False  # PPO and IMPALA implement it

    def act_init(self, num_envs: int) -> Any:
        """A fresh acting carry for a rollout segment (None: memoryless)."""
        return None

    def act_step(
        self,
        state: Any,
        act_carry: Any,
        obs: torch.Tensor,
        mode: str = TRAINING,
        generator: torch.Generator | None = None,
        noise: torch.Tensor | None = None,
    ):
        """History-conditioned acting -> (action, act_info, new_carry).
        ``noise`` replaces the action draw, as ``act`` takes it."""
        action, info = self.act(state, obs, mode, generator, noise=noise)
        return action, info, act_carry
