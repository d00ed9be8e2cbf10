"""The PPO agent, the port of ``surreal_tpu/agents/ppo_agent.py``.

Policy math lives in ``PPOLearner.act``. This class owns the on-policy
remote-actor contract: every transition a PPO actor outside the session
emits carries the behaviour statistics and the version of the parameters
that chose the action, ``param_version`` (int32 a row, on the learner's
device), which the learner's staleness guard reads.
"""

from __future__ import annotations

import torch

from surreal_tpu_torch.agents.base import Agent


class PPOAgent(Agent):
    def remote_act(self, obs, generator: torch.Generator | None = None, noise: torch.Tensor | None = None):
        """:meth:`Agent.remote_act`, with ``param_version`` stamped into
        the behaviour info."""
        action, info = super().remote_act(obs, generator, noise)
        stamp = torch.full((int(action.shape[0]),), self.param_version, dtype=torch.int32, device=action.device)
        return action, {**info, "param_version": stamp}
