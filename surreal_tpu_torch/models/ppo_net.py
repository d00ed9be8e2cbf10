"""Actor-critic models, the port of ``surreal_tpu/models/ppo_net.py``
(``PPOModel``, ``CategoricalPPOModel``).

Both models take the obs trunk from ``models/encoders.py::make_trunk``:
separate actor and critic MLPs for state obs, or one NatureCNN stem shared
by both heads for pixel obs (``model.cnn.enabled``), as the reference does.
The heads are computed in the trunk's dtype and cast to float32: a
diagonal-Gaussian mean head (orthogonal(0.01)) with a state-independent
``log_std`` parameter, or a logits head (orthogonal(0.01)); and a value
head (orthogonal(1.0)).

The learners apply a model functionally (``torch.func.functional_call``
with a params dict), so parameters live in the learner state rather than
in the module; ``utils/convert.py`` maps the flax trees onto these names.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
from torch import nn

from surreal_tpu_torch.models.encoders import dense, make_trunk, orthogonal_init


class PolicyOutput(NamedTuple):
    mean: torch.Tensor      # [..., act_dim] float32
    log_std: torch.Tensor   # [..., act_dim] float32 (state-independent)
    value: torch.Tensor     # [...] float32


class CategoricalOutput(NamedTuple):
    logits: torch.Tensor    # [..., n_actions] float32
    value: torch.Tensor     # [...] float32


class _ActorCritic(nn.Module):
    """The trunks shared by both models: ``stem`` for pixel obs, else
    ``actor`` and ``critic``; ``_trunks(obs)`` gives (actor_h, critic_h)."""

    def __init__(self, model_cfg: dict, obs_shape: Sequence[int], generator: torch.Generator | None):
        super().__init__()
        if model_cfg["cnn"]["enabled"]:
            self.stem = make_trunk(model_cfg, obs_shape, model_cfg["actor_hidden"], generator)
            self.head_in = self.stem.out_dim, self.stem.out_dim
        else:
            self.actor = make_trunk(model_cfg, obs_shape, model_cfg["actor_hidden"], generator)
            self.critic = make_trunk(model_cfg, obs_shape, model_cfg["critic_hidden"], generator)
            self.head_in = self.actor.out_dim, self.critic.out_dim

    def _trunks(self, obs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        if hasattr(self, "stem"):
            h = self.stem(obs)
            return h, h
        return self.actor(obs), self.critic(obs)


class PPOModel(_ActorCritic):
    """Continuous-control actor-critic with a diagonal-Gaussian head."""

    def __init__(
        self,
        model_cfg: dict,
        obs_shape: Sequence[int],
        act_dim: int,
        init_log_std: float = -0.5,
        generator: torch.Generator | None = None,
    ):
        super().__init__(model_cfg, obs_shape, generator)
        self.mean_head = orthogonal_init(nn.Linear(self.head_in[0], act_dim), 0.01, generator)
        self.value_head = orthogonal_init(nn.Linear(self.head_in[1], 1), 1.0, generator)
        self.log_std = nn.Parameter(torch.full((act_dim,), float(init_log_std)))

    def forward(self, obs: torch.Tensor) -> PolicyOutput:
        actor_h, critic_h = self._trunks(obs)
        mean = dense(actor_h, self.mean_head, actor_h.dtype).to(torch.float32)
        log_std = self.log_std.expand(mean.shape)
        value = dense(critic_h, self.value_head, critic_h.dtype).to(torch.float32)
        return PolicyOutput(mean=mean, log_std=log_std, value=value[..., 0])


class CategoricalPPOModel(_ActorCritic):
    """Discrete-action actor-critic (the IMPALA pixel path)."""

    def __init__(
        self,
        model_cfg: dict,
        obs_shape: Sequence[int],
        n_actions: int,
        generator: torch.Generator | None = None,
    ):
        super().__init__(model_cfg, obs_shape, generator)
        self.logits_head = orthogonal_init(nn.Linear(self.head_in[0], n_actions), 0.01, generator)
        self.value_head = orthogonal_init(nn.Linear(self.head_in[1], 1), 1.0, generator)

    def forward(self, obs: torch.Tensor) -> CategoricalOutput:
        actor_h, critic_h = self._trunks(obs)
        logits = dense(actor_h, self.logits_head, actor_h.dtype).to(torch.float32)
        value = dense(critic_h, self.value_head, critic_h.dtype).to(torch.float32)
        return CategoricalOutput(logits=logits, value=value[..., 0])
