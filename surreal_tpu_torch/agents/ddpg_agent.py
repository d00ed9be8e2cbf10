"""The DDPG agent, the port of ``surreal_tpu/agents/ddpg_agent.py``: the
deterministic actor with exploration noise in training mode.

It owns what is agent state and not learner state, as in the reference:

- **OU exploration noise** is a stateful process: in training mode with
  ``exploration.noise='ou'``, :meth:`DDPGAgent.act` steps the agent's
  noise [B, act_dim] with ``ou_noise_step`` and adds it to the clipped
  actor output (clipping again); :meth:`DDPGAgent.mask_noise_on_reset`
  zeroes the rows of episodes that ended. ``noise`` is then the step's
  standard normals (the reference's ``k_noise`` draw); with Gaussian
  noise, or in an eval mode, it is what ``DDPGLearner.act`` takes;
- **the actor-only wire view**: a remote DDPG actor fetches the actor
  parameters and the obs normalizer, not the critic, target or optimizer
  state of the full ``DDPGState``.
"""

from __future__ import annotations

import torch

from surreal_tpu_torch.agents.base import Agent
from surreal_tpu_torch.learners.base import TRAINING
from surreal_tpu_torch.learners.ddpg import DDPGLearner, ou_noise_step


class DDPGAgent(Agent):
    def __init__(self, learner: DDPGLearner, mode: str = TRAINING):
        super().__init__(learner, mode)
        self._noise: torch.Tensor | None = None

    def acting_view(self, state) -> dict:
        return {"actor_params": state.actor_params, "obs_stats": state.obs_stats}

    def reset_noise(self, num_envs: int) -> None:
        self._noise = torch.zeros((num_envs, self.learner.act_dim), dtype=torch.float32, device=self.device)

    def mask_noise_on_reset(self, done) -> None:
        """Zero the noise rows whose episode just ended (OU state must not
        leak across resets)."""
        if self._noise is not None:
            done = torch.as_tensor(done).to(self.device, non_blocking=True)
            self._noise = self._noise * (1.0 - done.to(torch.float32))[:, None]

    def act(self, state, obs, generator: torch.Generator | None = None, noise: torch.Tensor | None = None):
        """Training mode with OU exploration steps the agent's noise; every
        other mode is the learner's ``act``."""
        expl = self.learner.config.algo.exploration
        if self.mode == TRAINING and expl.noise == "ou":
            obs = self._obs(obs)
            if self._noise is None or self._noise.shape[0] != obs.shape[0]:
                self.reset_noise(int(obs.shape[0]))
            action, info = self.learner.act(state, obs, self.mode, generator)
            self._noise = ou_noise_step(
                self._noise, expl.ou_theta, expl.sigma, expl.ou_dt, generator=generator,
                normals=None if noise is None else noise.to(self.device),
            )
            return torch.clamp(action + self._noise, -1.0, 1.0), info
        return super().act(state, obs, generator, noise)
