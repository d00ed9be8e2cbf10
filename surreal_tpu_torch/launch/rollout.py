"""Trajectory collection, the port of ``surreal_tpu/launch/rollout.py``
(``successor_and_termination``, ``device_rollout``, ``init_device_carry``,
``host_rollout``).

Two collectors, one batch contract (see learners/ppo.py):

- :func:`device_rollout`: the envs are batched torch envs on the card.
  The reference's ``lax.scan`` over the horizon is a Python loop here;
  each step acts on the whole [B, ...] env batch through the learner's
  ``act_step``, with a fresh ``act_init`` carry for each call: a
  trajectory policy's context is segment-aligned (the learn recomputes
  exactly this conditioning), and a memoryless learner's carry is None.
  Episode returns are tracked in band: ``ep_return`` is nonzero only at
  done steps (the finished episode's sum), so metrics need no side
  channel.
- :func:`host_rollout`: a batched numpy host env (gym, dm_control,
  robosuite), the SEED-RL pattern: each step copies the obs batch to the
  card, acts once for all envs, and reads the actions back (the step's one
  device->host read); the host leaves are stacked in numpy and go to the
  card once per rollout, one copy per leaf.

Randomness is explicit: action noise (standard normal [T, B, act_dim] for
a Gaussian head, standard Gumbel [T, B, n_actions] for a categorical one),
env reset draws [T, B, reset_draw_dim] and, for envs that draw while they
step, env step draws [T, B, step_draw_dim] may be given (the parity tests
pass the numbers JAX drew); otherwise they come from ``generator``.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from surreal_tpu_torch.envs.base import HostEnv
from surreal_tpu_torch.envs.device.base import AutoReset
from surreal_tpu_torch.learners.aggregator import multistep_batch
from surreal_tpu_torch.learners.base import TRAINING, Learner

# the act-info keys that describe the behaviour policy (the head's own)
_BEHAVIOR_KEYS = ("mean", "log_std", "logits")


class RolloutCarry(NamedTuple):
    env_state: Any
    obs: torch.Tensor
    ep_return: torch.Tensor  # [B] running episode return
    ep_length: torch.Tensor  # [B] running episode length (int32)


def successor_and_termination(obs2, done, step_info):
    """The two auto-reset invariants every collector shares: the true
    successor obs at a done step is the PRE-reset terminal obs, and
    ``terminated`` is done minus truncation (what zeroes bootstrap
    targets)."""
    terminal_obs = step_info["terminal_obs"]
    truncated = step_info["truncated"]
    done_b = done.reshape(done.shape + (1,) * (obs2.dim() - done.dim()))
    next_obs = torch.where(done_b, terminal_obs, obs2)
    terminated = done & ~truncated
    return next_obs, terminated


@torch.no_grad()
def device_rollout(
    env: AutoReset,
    learner: Learner,
    state,
    carry: RolloutCarry,
    horizon: int,
    generator: torch.Generator | None = None,
    action_noise: torch.Tensor | None = None,
    reset_draws: torch.Tensor | None = None,
    step_draws: torch.Tensor | None = None,
):
    """Collect ``horizon`` steps across the B batched device envs.

    Returns (new_carry, batch): batch has the learner batch contract plus
    ``ep_return``/``ep_done`` for metrics, every leaf [T, B, ...].
    """
    c = carry
    act_carry = learner.act_init(c.obs.shape[0])
    steps = []
    for t in range(horizon):
        action, info, act_carry = learner.act_step(
            state, act_carry, c.obs, TRAINING, generator,
            noise=None if action_noise is None else action_noise[t],
        )
        env_state, obs2, reward, done, step_info = env.step(
            c.env_state, action, generator,
            reset_draws=None if reset_draws is None else reset_draws[t],
            step_draws=None if step_draws is None else step_draws[t],
        )
        next_obs, terminated = successor_and_termination(obs2, done, step_info)
        ep_return = c.ep_return + reward
        ep_length = c.ep_length + 1
        steps.append({
            "obs": c.obs,
            "next_obs": next_obs,
            "action": action,
            "reward": reward,
            "done": done,
            "terminated": terminated,
            "behavior_logp": info["logp"],
            "behavior": {k: v for k, v in info.items() if k in _BEHAVIOR_KEYS},
            "ep_return": torch.where(done, ep_return, 0.0),
            "ep_done": done,
        })
        c = RolloutCarry(
            env_state=env_state,
            obs=obs2,
            ep_return=torch.where(done, 0.0, ep_return),
            ep_length=torch.where(done, torch.zeros_like(ep_length), ep_length),
        )
    batch = {k: torch.stack([s[k] for s in steps]) for k in steps[0] if k != "behavior"}
    batch["behavior"] = {k: torch.stack([s["behavior"][k] for s in steps]) for k in steps[0]["behavior"]}
    return c, batch


def init_device_carry(
    env: AutoReset,
    num_envs: int,
    generator: torch.Generator | None = None,
    reset_draws: torch.Tensor | None = None,
) -> RolloutCarry:
    env_state, obs = env.reset(num_envs, generator=generator, draws=reset_draws)
    return RolloutCarry(
        env_state=env_state,
        obs=obs,
        ep_return=torch.zeros(num_envs, dtype=torch.float32, device=env.device),
        ep_length=torch.zeros(num_envs, dtype=torch.int32, device=env.device),
    )


@torch.no_grad()
def host_rollout(
    env: HostEnv,
    learner: Learner,
    state,
    obs: np.ndarray,
    horizon: int,
    generator: torch.Generator | None = None,
    action_noise: torch.Tensor | None = None,
    act=None,
):
    """Collect ``horizon`` steps from a batched host env through
    ``learner.act`` on the learner's device (one inference per step for
    ALL envs). ``action_noise`` [T, B, ...] replaces the action draws;
    ``act``, where given, is called in place of ``learner.act`` (the
    session's cost counting wraps it).

    Returns (last_obs, batch on the learner's device, episode stats): the
    batch has the learner batch contract, every leaf [T, B, ...]; the
    stats hold the returns and lengths of the episodes that finished.
    """
    device = learner.device
    act = act or learner.act
    steps = []
    ep_returns: list[float] = []
    ep_lengths: list[int] = []
    for t in range(horizon):
        obs_t = torch.from_numpy(np.ascontiguousarray(obs)).to(device, non_blocking=True)
        action, info = act(
            state, obs_t, TRAINING, generator, noise=None if action_noise is None else action_noise[t]
        )
        action_np = action.cpu().numpy()  # the step's one device->host read
        out = env.step(action_np)
        terminal_obs = out.info.get("terminal_obs")
        truncated = np.asarray(out.info.get("truncated", np.zeros(len(out.done), bool)))
        if terminal_obs is not None and out.done.any():
            done_b = out.done.reshape(out.done.shape + (1,) * (out.obs.ndim - 1))
            next_obs = np.where(done_b, terminal_obs, out.obs)
        else:
            next_obs = out.obs
        steps.append({
            "obs": obs_t,
            "next_obs": next_obs,
            "action": action,
            "reward": out.reward,
            "done": out.done,
            "terminated": out.done & ~truncated,
            "behavior_logp": info["logp"],
            "behavior": {k: v for k, v in info.items() if k in _BEHAVIOR_KEYS},
        })
        if "episode_returns" in out.info:
            ep_returns.extend(np.asarray(out.info["episode_returns"]).tolist())
            ep_lengths.extend(np.asarray(out.info["episode_lengths"]).tolist())
        obs = out.obs
    batch = multistep_batch(steps, device)
    return obs, batch, {"returns": ep_returns, "lengths": ep_lengths}
