"""Training driver, the port of ``surreal_tpu/launch/trainer.py::Trainer``
in device mode on one device: collect a horizon on the batched device
env, then one ``learn`` of the on-policy learner (PPO or IMPALA), per
iteration.

Not ported yet: host-env mode, the dp/sp meshes, ``SessionHooks``
(checkpointing, telemetry, recovery), the ``LoopEngine`` and the
autotuner. ``run`` is a plain loop that reads metrics back to the host
only every ``session_config.metrics.every_n_iters`` iterations; between
those reads the iteration makes no host sync.
"""

from __future__ import annotations

from typing import Callable

import torch

from surreal_tpu_torch.envs import make_env
from surreal_tpu_torch.launch.rollout import RolloutCarry, device_rollout, init_device_carry
from surreal_tpu_torch.learners import build_learner
from surreal_tpu_torch.learners.base import check_scan_unroll
from surreal_tpu_torch.session.config import Config
from surreal_tpu_torch.utils.device import resolve_device

_LEARN_KEYS = (
    "obs", "next_obs", "action", "reward", "done", "terminated", "behavior_logp", "behavior",
)


def training_env_config(env_config) -> Config:
    """The training env never records video (that is eval's job)."""
    return Config(video=Config(enabled=False)).extend(env_config)


class Trainer:
    """On-policy (PPO, IMPALA) trainer on one device; ``device`` defaults
    to the card and raises without it."""

    def __init__(self, config, device: str | torch.device = "cuda"):
        self.config = config
        self.device = resolve_device(device)
        self.env = make_env(training_env_config(config.env_config), self.device)
        self.learner = build_learner(config.learner_config, self.env.specs, self.device)
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
        fires every ``metrics.every_n_iters`` iterations, and after the
        last, with host floats; returning truthy from it stops training.
        """
        cfg = self.config.session_config
        total = max_env_steps or cfg.total_env_steps
        every = max(1, int(cfg.metrics.every_n_iters))
        state = self.learner.init(torch.Generator().manual_seed(self.seed))
        generator = torch.Generator(device=self.device).manual_seed(self.seed)
        carry = self.init_loop_state(generator)
        iteration, env_steps, last = 0, 0, {}
        while env_steps < total:
            state, carry, metrics = self._device_train_iter(state, carry, generator)
            iteration += 1
            env_steps += self.steps_per_iter
            if iteration % every == 0 or env_steps >= total:
                # the one device -> host read of the cadence
                values = torch.stack([v.to(torch.float32) for v in metrics.values()]).tolist()
                last = dict(zip(metrics, values))
                if on_metrics is not None and on_metrics(iteration, last):
                    break
        return state, last
