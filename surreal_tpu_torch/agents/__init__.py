"""The agent layer of the PyTorch port, the port of
``surreal_tpu/agents/__init__.py``."""

from surreal_tpu_torch.agents.base import AGENT_MODES, Agent
from surreal_tpu_torch.agents.ddpg_agent import DDPGAgent
from surreal_tpu_torch.agents.ppo_agent import PPOAgent
from surreal_tpu_torch.learners.base import TRAINING, Learner


def make_agent(learner: Learner, mode: str = TRAINING) -> Agent:
    """The agent class of the learner's algorithm (read from its extended
    config): ppo and impala -> :class:`PPOAgent` (the version-stamping
    remote act), ddpg -> :class:`DDPGAgent` (the actor-only wire view)."""
    name = learner.config.algo.name
    cls = {"ppo": PPOAgent, "ddpg": DDPGAgent, "impala": PPOAgent}.get(name, Agent)
    return cls(learner, mode)


__all__ = ["AGENT_MODES", "Agent", "PPOAgent", "DDPGAgent", "make_agent"]
