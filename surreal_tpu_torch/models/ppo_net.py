"""PPO actor-critic, the port of ``surreal_tpu/models/ppo_net.py::PPOModel``:
separate actor and critic MLP trunks, a diagonal-Gaussian mean head
(orthogonal(0.01)) and a value head (orthogonal(1.0)), both computed in
the trunk's dtype and cast to float32, and a state-independent ``log_std``
parameter. ``CategoricalPPOModel`` is not ported yet.

The learner applies the model functionally (``torch.func.functional_call``
with a params dict), so parameters live in the learner state rather than
in the module; ``utils/convert.py`` maps the flax tree onto these names.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from surreal_tpu_torch.models.encoders import dense, make_trunk, orthogonal_init


class PolicyOutput(NamedTuple):
    mean: torch.Tensor      # [..., act_dim] float32
    log_std: torch.Tensor   # [..., act_dim] float32 (state-independent)
    value: torch.Tensor     # [...] float32


class PPOModel(nn.Module):
    """Continuous-control actor-critic with a diagonal-Gaussian head."""

    def __init__(
        self,
        model_cfg: dict,
        obs_dim: int,
        act_dim: int,
        init_log_std: float = -0.5,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        self.actor = make_trunk(model_cfg, obs_dim, model_cfg["actor_hidden"], generator)
        self.critic = make_trunk(model_cfg, obs_dim, model_cfg["critic_hidden"], generator)
        self.mean_head = orthogonal_init(
            nn.Linear(self.actor.out_dim, act_dim), 0.01, generator
        )
        self.value_head = orthogonal_init(
            nn.Linear(self.critic.out_dim, 1), 1.0, generator
        )
        self.log_std = nn.Parameter(torch.full((act_dim,), float(init_log_std)))

    def forward(self, obs: torch.Tensor) -> PolicyOutput:
        actor_h = self.actor(obs)
        critic_h = self.critic(obs)
        mean = dense(actor_h, self.mean_head, actor_h.dtype).to(torch.float32)
        log_std = self.log_std.expand(mean.shape)
        value = dense(critic_h, self.value_head, critic_h.dtype).to(torch.float32)
        return PolicyOutput(mean=mean, log_std=log_std, value=value[..., 0])
