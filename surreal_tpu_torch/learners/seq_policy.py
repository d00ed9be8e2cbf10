"""Policy-head sampling, the port of
``surreal_tpu/learners/seq_policy.py::PolicyHeadMixin``. The trajectory
policies' acting carry (``SequenceActingMixin``) is not ported yet.

Host classes provide ``discrete``.
"""

from __future__ import annotations

import torch

from surreal_tpu_torch.learners.base import EVAL_DETERMINISTIC
from surreal_tpu_torch.ops import distributions as D


class PolicyHeadMixin:
    def _head_act(
        self,
        out,
        mode: str,
        generator: torch.Generator | None = None,
        noise: torch.Tensor | None = None,
    ):
        """Sample (or take the mode of) the policy head and return the
        behaviour info attached to experience. ``noise`` replaces the draw:
        standard-normal [B, act_dim] for the Gaussian head, standard Gumbel
        [B, n_actions] for the categorical head."""
        if self.discrete:
            if mode == EVAL_DETERMINISTIC:
                action = torch.argmax(out.logits, dim=-1).to(torch.int32)
            else:
                action = D.categorical_sample(out.logits, generator, gumbel=noise).to(torch.int32)
            logp = D.categorical_logp(out.logits, action)
            info = {"logp": logp, "logits": out.logits, "value": out.value}
        else:
            if mode == EVAL_DETERMINISTIC:
                action = out.mean
            else:
                action = D.diag_gauss_sample(out.mean, out.log_std, generator, noise=noise)
            logp = D.diag_gauss_logp(out.mean, out.log_std, action)
            info = {
                "logp": logp,
                "mean": out.mean,
                "log_std": out.log_std,
                "value": out.value,
            }
        return action, info
