"""Periodic policy evaluation, the port of
``surreal_tpu/launch/evaluator.py`` (``Evaluator``) for the port's device
envs (``jax:lift``, ``jax:pong``, ``jax:pong16``, ``jax:pendulum``,
``jax:cartpole``).

An evaluation runs ``eval.episodes`` fresh episodes side by side on the
evaluator's own batched env, acting through the learner's ``act_step``
(with a fresh ``act_init`` carry) in
'eval_deterministic' or 'eval_stochastic' mode, for the env's time limit
(or ``eval.max_steps``) with each episode latched at its first done, as
the reference's scan does. It returns ``eval/return``, ``eval/length``
and ``eval/success`` (0 for envs that report no success), read back to
the host in one copy.

Not ported yet: host envs (gym, dm_control, robosuite) and video
recording; both raise.
"""

from __future__ import annotations

import torch

from surreal_tpu_torch.envs import make_env
from surreal_tpu_torch.learners.base import EVAL_DETERMINISTIC, EVAL_STOCHASTIC


class Evaluator:
    """Scores learner state over N fresh episodes; returns ``eval/*`` metrics."""

    def __init__(self, env_config, eval_config, learner):
        self.episodes = int(eval_config.episodes)
        self.mode = EVAL_DETERMINISTIC if eval_config.mode == "deterministic" else EVAL_STOCHASTIC
        self.learner = learner
        cap = eval_config.get("max_steps", None)
        if cap is not None and int(cap) < 1:
            raise ValueError(f"eval max_steps must be >= 1, got {cap}")
        video = env_config.get("video", None)
        if video is not None and video.get("enabled", False) and video.get("dir", None):
            raise NotImplementedError(
                "env_config.video with eval: recording eval episodes is not ported to PyTorch yet"
            )
        if not str(env_config.name).startswith("jax:"):
            raise NotImplementedError(
                f"eval on host env {env_config.name!r}: the PyTorch port evaluates on device envs (jax:*) only"
            )
        self.env = make_env(env_config, learner.device)
        self._time_limit = int(cap) if cap is not None else (self.env.time_limit or 1000)

    @torch.no_grad()
    def _device_eval(self, state, generator: torch.Generator) -> dict[str, torch.Tensor]:
        B, dev = self.episodes, self.learner.device
        env_state, obs = self.env.reset(B, generator=generator)
        ret = torch.zeros(B, dtype=torch.float32, device=dev)
        length = torch.zeros(B, dtype=torch.int32, device=dev)
        alive = torch.ones(B, dtype=torch.float32, device=dev)
        success = torch.zeros(B, dtype=torch.bool, device=dev)
        # act_step is act for memoryless policies; a trajectory policy
        # threads its context carry, re-segmenting past its horizon
        act_carry = self.learner.act_init(B)
        for _ in range(self._time_limit):
            action, _, act_carry = self.learner.act_step(state, act_carry, obs, self.mode, generator)
            env_state, obs, reward, done, info = self.env.step(env_state, action, generator)
            ret = ret + reward * alive
            length = length + (alive > 0).to(torch.int32)
            if "success" in info:
                success = success | (info["success"] & (alive > 0))
            alive = alive * (1.0 - done.to(torch.float32))
        return {
            "eval/return": ret.mean(),
            "eval/length": length.to(torch.float32).mean(),
            "eval/success": success.to(torch.float32).mean(),
        }

    def evaluate(self, state, key: int) -> dict[str, float]:
        """One evaluation with draws seeded by ``key`` (an int)."""
        generator = torch.Generator(device=self.learner.device).manual_seed(int(key))
        out = self._device_eval(state, generator)
        return dict(zip(out, torch.stack(list(out.values())).tolist()))
