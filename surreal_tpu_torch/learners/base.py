"""Learner base, the port of ``surreal_tpu/learners/base.py``
(``training_health``, ``recovery_scale``, ``make_optimizer_chain``,
``set_recovery_lr_scale``, ``get_recovery_lr_scale``, ``Learner``), plus
optax's ``incremental_update``.

A learner is a set of functions over an explicit state (a NamedTuple of
tensors and dicts of tensors), as in the reference:

    state           = learner.init(generator)
    state, metrics  = learner.learn(state, batch, generator)
    action, info    = learner.act(state, obs, mode, generator)
    action, info, carry = learner.act_step(state, carry, obs, mode, generator)

The optimizer is functional too: optax's ``clip_by_global_norm -> adam ->
recovery_scale`` written out over dicts of tensors, so that its state
(Adam moments, step count, the recovery LR scale) rides the learner state
like the reference's optax state does. Under loss scaling the chain is
wrapped in ``ops/precision.py::DynamicLossScaling``, whose
``LossScaleState`` holds the chain's state as ``inner``.
"""

from __future__ import annotations

import abc
import copy
import functools
from typing import Any, Callable, Mapping, NamedTuple

import torch

from surreal_tpu_torch.envs.base import EnvSpecs
from surreal_tpu_torch.ops.precision import dynamic_loss_scaling, find_instances, global_norm, resolve_policy
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


@functools.lru_cache(maxsize=None)
def _round_scalar(x: float, dtype: torch.dtype) -> float:
    return torch.tensor(x, dtype=dtype).item()


def _weak(x: float, dtype: torch.dtype) -> float:
    """A Python scalar as JAX applies it to an array of ``dtype``: weakly
    typed, so rounded to the array's dtype first (0.999 is 1.0 in
    bfloat16). torch keeps such a scalar in float32 for bfloat16
    arithmetic, so it is rounded here; float32 needs nothing."""
    return x if dtype == torch.float32 else _round_scalar(float(x), dtype)


class OptimizerChain:
    """``optax.chain(clip_by_global_norm(max_norm), adam(lr), recovery_scale())``
    with optax's exact rules:

    - the clip rescales by ``max_norm / ||g||`` only when ``||g|| >= max_norm``
      (no ``+1e-6``, unlike ``torch.nn.utils.clip_grad_norm_``);
    - Adam uses b1 0.9, b2 0.999, eps 1e-8, eps inside the root 0, and
      bias correction by ``1 - b**count``;
    - the update is finally multiplied by the state's ``recovery_scale``.

    A leaf of another dtype than float32 (``model.dtype='bfloat16'``)
    follows JAX's promotion as optax meets it: moments in the leaf's
    dtype, every Python constant and the bias corrections rounded to it,
    and the float32 recovery scale promoting the update to float32 (the
    parameter is rounded back when the update is applied).
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

    def update(self, grads: Params, state: OptState, g_norm: torch.Tensor | None = None) -> tuple[Params, OptState]:
        """One step; ``g_norm`` is ``global_norm(grads)`` where the caller
        has already computed it (the clip reads it)."""
        if g_norm is None:
            g_norm = global_norm(grads)
        keep = g_norm < self.max_grad_norm
        b1, b2 = self.b1, self.b2
        count = torch.clamp_max(state.count + 1, _INT32_MAX)  # optax safe_increment
        bc1 = 1 - torch.pow(b1, count.to(torch.float32))
        bc2 = 1 - torch.pow(b2, count.to(torch.float32))
        step = -(self.lr(state.count) if callable(self.lr) else self.lr)
        rs = state.recovery_scale
        consts = {torch.float32: (g_norm, self.max_grad_norm, 1 - b1, b1, 1 - b2, b2, bc1, bc2, self.eps, step)}
        mu, nu, updates = {}, {}, {}
        for k, g in grads.items():
            dt = g.dtype
            if dt not in consts:  # the constants as JAX applies them to a leaf of this dtype
                consts[dt] = (
                    g_norm.to(dt), *(_weak(x, dt) for x in (self.max_grad_norm, 1 - b1, b1, 1 - b2, b2)),
                    bc1.to(dt), bc2.to(dt), _weak(self.eps, dt),
                    step.to(dt) if isinstance(step, torch.Tensor) else _weak(step, dt),
                )
            norm, max_norm, c1, d1, c2, d2, bc1_k, bc2_k, eps, step_k = consts[dt]
            g = torch.where(keep, g, (g / norm) * max_norm)
            mu[k] = c1 * g + d1 * state.mu[k]
            nu[k] = c2 * (g * g) + d2 * state.nu[k]
            u = (mu[k] / bc1_k) / (torch.sqrt(nu[k] / bc2_k) + eps) * step_k
            updates[k] = (u if dt == rs.dtype else u.to(rs.dtype)) * rs
        return updates, OptState(count=count, mu=mu, nu=nu, recovery_scale=rs)


def set_recovery_lr_scale(tree: Any, scale: float) -> Any:
    """``tree`` (a learner state) with ``scale`` written into the
    ``recovery_scale`` leaf of every :class:`OptState` in it (DDPG has
    two; under loss scaling each sits in its ``LossScaleState.inner``).
    Each leaf gets its own scalar tensor, on its old leaf's device.
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


def get_recovery_lr_scale(tree: Any) -> float | None:
    """The recovery LR scale of the first :class:`OptState` in ``tree``
    (in ``jax.tree`` order), or None when it has none. One device-to-host
    read; for telemetry and tests, not the hot loop."""
    found = find_instances(tree, OptState)
    return float(found[0].recovery_scale) if found else None


def param_dtypes_of(module: torch.nn.Module, params: Mapping[str, torch.Tensor], device) -> Params:
    """``params`` detached onto ``device``, each leaf in the dtype of the
    module's parameter of its name: float32, or ``model.dtype`` for the
    trunks (``models/encoders.py::make_trunk``). How converted reference
    weights, which arrive as float32, enter a learner state."""
    dtypes = {k: v.dtype for k, v in module.named_parameters()}
    return {k: v.detach().to(device, dtypes[k]) for k, v in params.items()}


def apply_updates(params: Params, updates: Params) -> Params:
    return {k: (p + updates[k]).to(p.dtype) for k, p in params.items()}


def incremental_update(new: Params, old: Params, tau: float) -> Params:
    """``optax.incremental_update``: Polyak averaging with optax's grouping,
    ``tau * new + (1 - tau) * old``, the constants weakly typed."""
    return {k: _weak(tau, x.dtype) * x + _weak(1.0 - tau, x.dtype) * old[k] for k, x in new.items()}


def chain_step(tx, grads: Params, opt_state, scale) -> tuple[Params, Any, torch.Tensor]:
    """``tx.update`` on the gradients of the loss times ``scale`` (from
    ``current_loss_scale``), plus the true gradient norm for the health
    metrics, the reference's ``global_norm(grads) / scale``. Without loss
    scaling that norm is the chain's clip norm too, so it is computed once."""
    norm = global_norm(grads)
    if isinstance(scale, torch.Tensor):
        updates, opt_state = tx.update(grads, opt_state)
        return updates, opt_state, norm / scale
    updates, opt_state = tx.update(grads, opt_state, g_norm=norm)
    return updates, opt_state, norm


def make_optimizer_chain(lr, max_grad_norm: float, policy):
    """The optimizer-chain constructor every learner uses (PPO, IMPALA and
    both DDPG chains): clip -> adam -> recovery_scale, wrapped in dynamic
    loss scaling when the policy asks for it (``ops/precision.py``)."""
    inner = OptimizerChain(lr, max_grad_norm)
    if policy.loss_scaling:
        return dynamic_loss_scaling(inner, policy)
    return inner


def optimizer_from_config(opt_cfg, policy):
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
