"""Experience aggregation, the port of ``surreal_tpu/learners/aggregator.py``.

Aggregation is the host-to-device seam: host rollouts produce per-step
dicts (numpy arrays from the env, tensors already on the card from the
learner's ``act``); :func:`stack_steps` stacks them time-major, and
:func:`multistep_batch` moves each host leaf to the card in ONE copy.
Device rollouts never touch this path; ``nstep_transitions`` folds their
(and the host DDPG path's) trajectories on the device.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def _stack(leaves: list):
    if isinstance(leaves[0], torch.Tensor):
        return torch.stack(leaves)
    return np.stack([np.asarray(x) for x in leaves])


def stack_steps(steps: Sequence[dict]) -> dict:
    """Stack a list of per-step dicts (possibly nested one level) into
    time-major leaves: list of {k: [B,...]} -> {k: [T,B,...]}. numpy
    leaves stack in numpy, tensor leaves with ``torch.stack`` on their
    device."""
    out: dict = {}
    for k, v in steps[0].items():
        if isinstance(v, dict):
            out[k] = {kk: _stack([s[k][kk] for s in steps]) for kk in v}
        else:
            out[k] = _stack([s[k] for s in steps])
    return out


def to_device(tree, device: torch.device):
    """Every numpy leaf of a (one-level nested) dict as a tensor on
    ``device``, one non-blocking copy each; tensor leaves move only if they
    live elsewhere."""

    def move(x):
        if isinstance(x, torch.Tensor):
            return x.to(device, non_blocking=True)
        return torch.from_numpy(np.ascontiguousarray(x)).to(device, non_blocking=True)

    return {k: ({kk: move(vv) for kk, vv in v.items()} if isinstance(v, dict) else move(v)) for k, v in tree.items()}


def multistep_batch(steps: Sequence[dict], device: torch.device | str | None = None) -> dict:
    """PPO-style sub-trajectory batch (parity: MultistepAggregatorWithInfo):
    time-major [T, B, ...] leaves with the behaviour policy's ``action_info``
    carried alongside. With ``device``, each host leaf goes there in one
    copy (the reference's single ``device_put``).

    Each step dict must have: obs, next_obs, action, reward, done,
    terminated, behavior_logp, behavior (dict of dist params).
    """
    batch = stack_steps(steps)
    return batch if device is None else to_device(batch, torch.device(device))


def ssar_transitions(steps: Sequence[dict]) -> dict:
    """DDPG-style flat (s, a, r, s', done) transitions (parity:
    SSARAggregator): stacks steps then flattens [T, B] -> [T*B] for replay
    insertion."""
    batch = stack_steps(steps)
    flat = {}
    for k, v in batch.items():
        if isinstance(v, dict):
            flat[k] = {kk: vv.reshape(-1, *vv.shape[2:]) for kk, vv in v.items()}
        else:
            flat[k] = v.reshape(-1, *v.shape[2:])
    return flat


def nstep_transitions(traj: dict, gamma: float, n_step: int) -> dict:
    """Fold a time-major trajectory batch into flat n-step transitions.

    traj: obs/next_obs [T,B,...], action [T,B,A], reward/done/terminated
    [T,B]. Episode boundaries are handled exactly: accumulation stops at
    ``done``; the bootstrap pair is (next_obs, gamma^{k+1}) of the LAST
    accumulated step, zeroed if that step truly terminated.

    Returns {obs, action, reward, next_obs, discount} flattened to
    [(T-n+1)*B, ...], with the reference's operations in its order.
    """
    T = traj["reward"].shape[0]
    if n_step > T:
        raise ValueError(f"n_step={n_step} exceeds trajectory length {T}")
    S = T - n_step + 1  # valid window starts

    def win(x, k):  # rows t+k for all window starts: [S, B, ...]
        return x[k : k + S]

    done = traj["done"].to(torch.float32)
    term = traj["terminated"].to(torch.float32)
    reward = traj["reward"]

    # alive[k] = windows still inside the episode entering offset k
    alive = torch.ones_like(win(done, 0))
    g = torch.zeros_like(win(reward, 0))
    next_obs = torch.zeros_like(win(traj["next_obs"], 0))
    discount = torch.zeros_like(win(reward, 0))
    for k in range(n_step):
        alive_next = alive * (1.0 - win(done, k))
        g = g + alive * (gamma**k) * win(reward, k)
        # `last` marks the final accumulated offset for each window: the
        # step where the episode ended, or the window end if it survived
        last = alive - alive_next if k < n_step - 1 else alive
        lb = last.reshape(last.shape + (1,) * (next_obs.dim() - last.dim()))
        next_obs = next_obs + lb * win(traj["next_obs"], k)
        discount = discount + last * (gamma ** (k + 1)) * (1.0 - win(term, k))
        alive = alive_next

    out = {
        "obs": win(traj["obs"], 0),
        "action": win(traj["action"], 0),
        "reward": g,
        "next_obs": next_obs,
        "discount": discount,
    }
    return {k: v.reshape(-1, *v.shape[2:]) for k, v in out.items()}
