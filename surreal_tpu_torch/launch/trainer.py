"""Training driver, the port of ``surreal_tpu/launch/trainer.py::Trainer``
in device mode on one device: per iteration, collect a horizon on the
batched device env, then one ``learn`` of the on-policy learner (PPO or
IMPALA).

``run`` is the reference's: ``SessionHooks`` (metrics, eval,
checkpoints, auto-resume, the interrupt sentinel, the divergence guard)
around a ``LoopEngine`` whose step is ``_device_train_iter``. Metrics
reach the host only every ``session_config.metrics.every_n_iters``
iterations; between those reads an iteration makes no host sync. On a
rollback the generator is re-seeded from (seed, rollback count) and the
env carry is re-initialised, where the reference folds the count into its
keys.

The reference's guards hold: a trajectory policy (it threads an acting
carry through the rollout) needs a device env, and a sequence-parallel
mesh (``topology.mesh.sp > 1``) needs a trajectory policy. Not ported
yet: host-env mode, the dp/sp meshes (an sp mesh over a trajectory
policy raises at ``rebind_mesh``) and the autotuner.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from surreal_tpu_torch.engine import EngineConfig, LoopEngine, LoopState, Outcome, StageSpec, sideband_stages
from surreal_tpu_torch.envs import make_env
from surreal_tpu_torch.launch.hooks import SessionHooks, training_env_config
from surreal_tpu_torch.launch.rollout import RolloutCarry, device_rollout, init_device_carry
from surreal_tpu_torch.learners import build_learner
from surreal_tpu_torch.learners.base import check_scan_unroll
from surreal_tpu_torch.utils import faults
from surreal_tpu_torch.utils.device import resolve_device

_LEARN_KEYS = (
    "obs", "next_obs", "action", "reward", "done", "terminated", "behavior_logp", "behavior",
)


def derive_seed(seed: int, *parts: int) -> int:
    """A 63-bit seed for ``torch.Generator.manual_seed`` mixed from
    ``seed`` and ``parts`` (the rollback count, an iteration); the port's
    counterpart of ``jax.random.fold_in``."""
    return int(np.random.SeedSequence([int(seed), *map(int, parts)]).generate_state(1, np.uint64)[0] >> 1)


class Trainer:
    """On-policy (PPO, IMPALA) trainer on one device; ``device`` defaults
    to the card and raises without it."""

    def __init__(self, config, device: str | torch.device = "cuda"):
        self.config = config
        self.device = resolve_device(device)
        model = config.learner_config.get("model", None)
        encoder = model.get("encoder", None) if model is not None else None
        if (
            encoder is not None and encoder.get("kind") == "trajectory"
            and not str(config.env_config.name).startswith("jax:")
        ):
            raise ValueError(
                "model.encoder.kind='trajectory' needs a device env "
                "(jax:*): host loops act per-step without the "
                "sequence context carry"
            )
        self.env = make_env(training_env_config(config.env_config), self.device)
        self.learner = build_learner(config.learner_config, self.env.specs, self.device)
        topo = config.session_config.get("topology", None)
        mesh = topo.get("mesh", None) if topo is not None else None
        if mesh is not None and int(mesh.get("sp", 1)) > 1:
            if not self.learner.requires_act_carry:
                raise ValueError(
                    "topology.mesh sp>1 shards trajectory attention; "
                    "it requires model.encoder.kind='trajectory' "
                    "(memoryless policies have no sequence axis to "
                    "shard — use the dp axis instead)"
                )
            self.learner.rebind_mesh(mesh, "sp")  # raises: not ported yet
        self.horizon = self.learner.config.algo.horizon
        # the rollout scan's unroll in the JAX package: accepted, nothing to
        # unroll in the port's rollout loop (learners/base.py)
        check_scan_unroll(self.learner.config.algo, "rollout_unroll")
        self.num_envs = config.env_config.num_envs
        self.seed = config.session_config.seed
        self.steps_per_iter = self.horizon * self.num_envs

    def _device_train_iter(
        self,
        state,
        carry: RolloutCarry,
        generator: torch.Generator | None = None,
        action_noise: torch.Tensor | None = None,
        reset_draws: torch.Tensor | None = None,
        step_draws: torch.Tensor | None = None,
        perms: torch.Tensor | None = None,
    ):
        """One iteration: rollout then learn. The optional tensors replace
        the draws from ``generator`` (see launch/rollout.py); ``perms`` is
        PPO's (``PPOLearner.learn``) and is passed on only when given."""
        carry, batch = device_rollout(
            self.env, self.learner, state, carry, self.horizon, generator,
            action_noise=action_noise, reset_draws=reset_draws, step_draws=step_draws,
        )
        learn_batch = {k: batch[k] for k in _LEARN_KEYS}
        learn_draws = {} if perms is None else {"perms": perms}
        state, metrics = self.learner.learn(state, learn_batch, generator, **learn_draws)
        n_done = batch["ep_done"].sum()
        ep_return_sum = batch["ep_return"].sum()
        metrics["episode/return"] = torch.where(
            n_done > 0, ep_return_sum / torch.clamp_min(n_done, 1), torch.nan
        )
        metrics["episode/count"] = n_done.to(torch.float32)
        return state, carry, metrics

    def init_loop_state(
        self, generator: torch.Generator | None = None, reset_draws: torch.Tensor | None = None
    ) -> RolloutCarry:
        return init_device_carry(self.env, self.num_envs, generator, reset_draws)

    def run(
        self,
        max_env_steps: int | None = None,
        on_metrics: Callable[[int, dict], object] | None = None,
    ):
        """Train until ``max_env_steps`` (default: session total_env_steps).

        Returns (final_state, last_metrics). ``on_metrics(iteration, dict)``
        fires every ``metrics.every_n_iters`` iterations with host floats;
        returning truthy from it stops training.
        """
        cfg = self.config.session_config
        total = max_env_steps or cfg.total_env_steps
        state = self.learner.init(torch.Generator().manual_seed(self.seed))
        faults.configure_from(cfg)  # install (or reset) the run's fault plan
        hooks = SessionHooks(self.config, self.learner)
        try:
            state, iteration, env_steps = hooks.restore(state)
            hooks.begin_run(iteration, env_steps)
            generator = torch.Generator(device=self.device).manual_seed(self.seed)
            carry = self.init_loop_state(generator)
            # the env carry is updated in place, so a deferred boundary
            # reads a clone of the state (engine/core.py)
            stages = (StageSpec("collect", donate=True), StageSpec("learn", donate=True)) + sideband_stages()

            def step(ls):
                # unfenced span: the time to issue the iteration
                with hooks.tracer.span("train_iter"):
                    ls.state, ls.extras["carry"], metrics = self._device_train_iter(
                        ls.state, ls.extras["carry"], ls.key
                    )
                return Outcome(
                    metrics=metrics, steps=self.steps_per_iter,
                    hook_key=derive_seed(self.seed, ls.extras["nonce"], ls.iteration + 1),
                )

            def apply_fault(ls, f):
                ls.state = faults.apply_trainer_fault(f, ls.state)

            def on_rollback(ls):
                rb = hooks.recovery.rollback(ls.state, fresh=self._fresh_init)
                ls.state, ls.iteration, ls.env_steps = rb.state, rb.iteration, rb.env_steps
                # re-seed the offending batch: a deterministic workload
                # must not replay into the same divergence
                ls.extras["nonce"] = rb.nonce
                ls.key = torch.Generator(device=self.device).manual_seed(derive_seed(self.seed, rb.nonce))
                ls.extras["carry"] = self.init_loop_state(ls.key)

            engine = LoopEngine(
                hooks, total, step, stages, EngineConfig.from_session(cfg),
                on_metrics=on_metrics, apply_fault=apply_fault, on_rollback=on_rollback,
            )
            ls = engine.run(LoopState(
                state=state, key=generator, iteration=iteration, env_steps=env_steps,
                extras={"carry": carry, "nonce": 0},
            ))
            hooks.final_checkpoint(ls.iteration, ls.env_steps, ls.state)
            return ls.state, hooks.last_metrics
        finally:
            hooks.close()

    def _fresh_init(self, nonce: int):
        """The divergence guard's fallback when no finite checkpoint exists:
        an init keyed by the rollback count."""
        return self.learner.init(torch.Generator().manual_seed(derive_seed(self.seed, nonce)))
