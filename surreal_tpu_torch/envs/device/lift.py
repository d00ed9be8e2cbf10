"""On-device BlockLifting task, the port of ``surreal_tpu/envs/jax/lift.py``
(``BlockLift``, factory name ``jax:lift``), written as batched torch ops
over a leading env dimension.

Physics and reward are the reference's, operation for operation: a
position-actuated parallel-jaw hand on a 3-DoF gantry with a 1-DoF finger
opening; a cube under gravity with inelastic table contact and sliding
friction decay; a squeeze force from finger penetration whose Coulomb
support decides between the rigid-grasp limit (block velocity-matched to
the hand) and a partial grasp that slips; two physics substeps per
control step; a dense reward (reach + squeeze + lift, max 6.0/step); and
``done`` always False (episodes end by the 200-step time limit in
:class:`AutoReset`). The JAX module documents the model in full.

Obs is 17-dim: grip_pos(3), grip_vel(3), grip_width(1), block_pos(3),
block_vel(3), block_pos - grip_pos(3), block height above rest(1).
Action is 4-dim in [-1, 1]: commanded xyz velocity and close rate.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from surreal_tpu_torch.envs.base import ArraySpec, EnvSpecs
from surreal_tpu_torch.envs.device.base import DeviceEnv

# -- geometry / physics constants (SI units; table top is z = 0) ------------
_DT = 0.01                 # physics substep [s]
_N_SUB = 2                 # substeps per control step (control dt = 0.02 s)
_BLOCK_HALF = 0.02         # 4 cm cube
_BLOCK_MASS = 0.1          # kg
_G = 9.81
_GRIP_V_MAX = 0.35         # gantry speed limit [m/s]
_GRIP_W_MAX = 0.10         # max finger opening [m]
_GRIP_W_SPEED = 0.25       # finger open/close rate [m/s]
_PAD = 0.004               # finger-pad compliance margin [m]
_PAD_HALF_H = 0.025        # finger-pad half-height (z grasp-overlap gate) [m]
_K_SQUEEZE = 300.0         # squeeze stiffness [N/m]
_PEN_MAX = 0.012           # squeeze penetration cap [m]
_MU = 1.0                  # finger-block friction coefficient
_SLIP_DRAG = 6.0           # horizontal drag toward hand motion in partial grasp
_TABLE_FRICTION = 8.0      # exponential sliding-decay rate on the table [1/s]
_WS_XY = 0.25              # gripper workspace half-extent in x, y
_WS_Z_MAX = 0.35           # gripper workspace ceiling
_TABLE_XY = 0.30           # block stays on the table within +-this
_LIFT_TARGET = 0.10        # lift height defining full reward / success [m]
_BLOCK_SPAWN = 0.10        # block spawn half-range in x, y
_GRIP_SPAWN = 0.02         # hand spawn half-range in x, y
_GRIP_Z0 = 0.20            # hand spawn height

# reset draws per env: block x, y; hand x, y; finger opening
RESET_LOW = (-_BLOCK_SPAWN, -_BLOCK_SPAWN, -_GRIP_SPAWN, -_GRIP_SPAWN, 2.0 * _BLOCK_HALF - 0.005)
RESET_HIGH = (_BLOCK_SPAWN, _BLOCK_SPAWN, _GRIP_SPAWN, _GRIP_SPAWN, _GRIP_W_MAX)


class LiftState(NamedTuple):
    grip_pos: torch.Tensor    # [B, 3] gripper (hand) center
    grip_vel: torch.Tensor    # [B, 3] realized hand velocity (for obs)
    grip_width: torch.Tensor  # [B] finger opening
    block_pos: torch.Tensor   # [B, 3] block center
    block_vel: torch.Tensor   # [B, 3]


class BlockLift(DeviceEnv):
    """Block lifting with state observations (17-dim) and 4-dim continuous
    actions; factory name ``jax:lift``."""

    max_episode_steps = 200
    reset_draw_dim = 5

    specs = EnvSpecs(
        obs=ArraySpec(shape=(17,), dtype=np.dtype(np.float32), name="state"),
        action=ArraySpec(shape=(4,), dtype=np.dtype(np.float32), name="hand"),
    )

    def __init__(self, device: torch.device | str):
        super().__init__(device)
        f32 = dict(dtype=torch.float32, device=self.device)
        self._ws_lo = torch.tensor([-_WS_XY, -_WS_XY, 0.0], **f32)
        self._ws_hi = torch.tensor([_WS_XY, _WS_XY, _WS_Z_MAX], **f32)
        self._align = torch.tensor([_BLOCK_HALF, _BLOCK_HALF, _PAD_HALF_H], **f32)
        self._gravity = torch.tensor([0.0, 0.0, -_G], **f32)
        self._reset_low = torch.tensor(RESET_LOW, **f32)
        self._reset_span = torch.tensor(RESET_HIGH, **f32) - self._reset_low
        self._table_decay = math.exp(-_TABLE_FRICTION * _DT)

    def reset(
        self,
        num_envs: int,
        generator: torch.Generator | None = None,
        draws: torch.Tensor | None = None,
    ):
        """``draws`` [B, 5] = (block x, block y, hand x, hand y, opening),
        each already in its range; uniform from ``generator`` if absent."""
        if draws is None:
            u = torch.rand(
                (num_envs, self.reset_draw_dim), generator=generator,
                dtype=torch.float32, device=self.device,
            )
            draws = self._reset_low + u * self._reset_span
        elif draws.shape != (num_envs, self.reset_draw_dim):
            raise ValueError(f"reset draws must be [{num_envs}, {self.reset_draw_dim}]; got {tuple(draws.shape)}")
        draws = draws.to(device=self.device, dtype=torch.float32)
        zeros3 = torch.zeros((num_envs, 3), dtype=torch.float32, device=self.device)
        z = torch.ones((num_envs, 1), dtype=torch.float32, device=self.device)
        state = LiftState(
            grip_pos=torch.cat([draws[:, 2:4], z * _GRIP_Z0], dim=1),
            grip_vel=zeros3,
            grip_width=draws[:, 4].clone(),
            block_pos=torch.cat([draws[:, 0:2], z * _BLOCK_HALF], dim=1),
            block_vel=zeros3.clone(),
        )
        return state, self._obs(state)

    def _grasp_force(self, grip_pos, grip_width, block_pos):
        """Squeeze normal force [B] and the contact gate [B]: a squeeze
        exists when the hand straddles the block (centers aligned within
        the block half-extent in x, y and the pad half-height in z) and
        the opening is tighter than block width + pad compliance."""
        d = torch.abs(grip_pos - block_pos)
        aligned = torch.all(d < self._align, dim=-1)
        pen = torch.clamp(2.0 * _BLOCK_HALF + 2.0 * _PAD - grip_width, 0.0, _PEN_MAX)
        f_n = torch.where(aligned, _K_SQUEEZE * pen, torch.zeros_like(pen))
        return f_n, aligned & (pen > 0.0)

    def _substep(self, s: LiftState, v_cmd: torch.Tensor, w_rate: torch.Tensor) -> LiftState:
        # hand: kinematic position actuation inside the workspace box
        new_gpos = torch.clamp(s.grip_pos + v_cmd * _DT, self._ws_lo, self._ws_hi)
        gvel = (new_gpos - s.grip_pos) / _DT
        new_w = torch.clamp(s.grip_width + w_rate * _DT, 0.0, _GRIP_W_MAX)

        f_n, contact = self._grasp_force(new_gpos, new_w, s.block_pos)
        support = _MU * f_n / (_BLOCK_MASS * _G)  # >= 1 holds the weight
        held = contact & (support >= 1.0)
        sup1 = torch.clamp_max(support, 1.0)[:, None]

        # partial grasp: slips under reduced gravity, dragged along
        slip_acc = self._gravity * (1.0 - sup1) + (gvel - s.block_vel) * _SLIP_DRAG * sup1
        acc = torch.where(contact[:, None], slip_acc, self._gravity)
        # rigid-grasp limit: block velocity-matched to the hand
        bvel = torch.where(held[:, None], gvel, s.block_vel + acc * _DT)
        bpos = s.block_pos + bvel * _DT

        # table: inelastic normal contact + sliding-friction decay
        on_table = bpos[:, 2] <= _BLOCK_HALF
        bz = torch.clamp_min(bpos[:, 2], _BLOCK_HALF)
        vz = torch.where(on_table, torch.clamp_min(bvel[:, 2], 0.0), bvel[:, 2])
        slide = torch.where(on_table & ~held, self._table_decay, 1.0)
        vxy = bvel[:, :2] * slide[:, None]
        pxy = torch.clamp(bpos[:, :2], -_TABLE_XY, _TABLE_XY)
        return LiftState(
            grip_pos=new_gpos,
            grip_vel=gvel,
            grip_width=new_w,
            block_pos=torch.cat([pxy, bz[:, None]], dim=1),
            block_vel=torch.cat([vxy, vz[:, None]], dim=1),
        )

    def step(self, state: LiftState, action: torch.Tensor):
        a = torch.clamp(action.to(torch.float32), -1.0, 1.0)
        v_cmd = a[:, :3] * _GRIP_V_MAX
        w_rate = -a[:, 3] * _GRIP_W_SPEED  # action[3] > 0 closes the fingers
        for _ in range(_N_SUB):
            state = self._substep(state, v_cmd, w_rate)

        f_n, _ = self._grasp_force(state.grip_pos, state.grip_width, state.block_pos)
        support = _MU * f_n / (_BLOCK_MASS * _G)
        grasped = support >= 1.0
        dist = torch.linalg.vector_norm(state.grip_pos - state.block_pos, dim=-1)
        height = torch.clamp((state.block_pos[:, 2] - _BLOCK_HALF) / _LIFT_TARGET, 0.0, 1.0)
        reward = (
            (1.0 - torch.tanh(10.0 * dist))
            + 0.5 * torch.clamp_max(support, 1.0)  # continuous squeeze shaping
            + 4.5 * height
        )
        done = torch.zeros_like(grasped)  # time-limit truncation only (AutoReset)
        info = {
            "success": height >= 0.95,
            "grasped": grasped,
            "block_height": state.block_pos[:, 2] - _BLOCK_HALF,
        }
        return state, self._obs(state), reward, done, info

    @staticmethod
    def _obs(state: LiftState) -> torch.Tensor:
        return torch.cat(
            [
                state.grip_pos,
                state.grip_vel,
                state.grip_width[:, None],
                state.block_pos,
                state.block_vel,
                state.block_pos - state.grip_pos,
                (state.block_pos[:, 2] - _BLOCK_HALF)[:, None],
            ],
            dim=1,
        )
