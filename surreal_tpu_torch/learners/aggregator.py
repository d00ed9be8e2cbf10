"""Experience aggregation, the port of
``surreal_tpu/learners/aggregator.py::nstep_transitions`` (the device
path's n-step folding). The host-side stacking helpers (``stack_steps``,
``multistep_batch``, ``ssar_transitions``) wait for the host-env path.
"""

from __future__ import annotations

import torch


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
