"""Algorithm layer of the PyTorch port (PPO, IMPALA and DDPG), the port of
``surreal_tpu/learners/__init__.py``."""

from __future__ import annotations

import torch

from surreal_tpu_torch.envs.base import EnvSpecs
from surreal_tpu_torch.learners.base import (
    EVAL_DETERMINISTIC,
    EVAL_STOCHASTIC,
    TRAINING,
    Learner,
)


def build_learner(learner_config, env_specs: EnvSpecs, device: str | torch.device = "cuda") -> Learner:
    """Dispatch on ``algo.name`` with the per-algorithm defaults extended
    onto the user tree, as the reference does. 'ppo', 'impala' and 'ddpg'
    are ported."""
    from surreal_tpu_torch.session.default_configs import BASE_LEARNER_CONFIG

    name = learner_config.algo.name
    if name == "ppo":
        from surreal_tpu_torch.learners.ppo import PPO_LEARNER_CONFIG, PPOLearner

        cfg = learner_config.extend(PPO_LEARNER_CONFIG.extend(BASE_LEARNER_CONFIG))
        return PPOLearner(cfg, env_specs, device)
    if name == "impala":
        from surreal_tpu_torch.learners.impala import IMPALA_LEARNER_CONFIG, IMPALALearner

        cfg = learner_config.extend(IMPALA_LEARNER_CONFIG.extend(BASE_LEARNER_CONFIG))
        return IMPALALearner(cfg, env_specs, device)
    if name == "ddpg":
        from surreal_tpu_torch.learners.ddpg import DDPG_LEARNER_CONFIG, DDPGLearner

        cfg = learner_config.extend(DDPG_LEARNER_CONFIG.extend(BASE_LEARNER_CONFIG))
        return DDPGLearner(cfg, env_specs, device)
    raise ValueError(f"unknown algorithm {name!r}; have ppo | ddpg | impala")


__all__ = ["EVAL_DETERMINISTIC", "EVAL_STOCHASTIC", "TRAINING", "Learner", "build_learner"]
