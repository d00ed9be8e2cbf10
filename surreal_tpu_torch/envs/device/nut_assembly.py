"""On-device NutAssembly task, the port of
``surreal_tpu/envs/jax/nut_assembly.py`` (``NutAssembly``, factory name
``jax:nut``), written as batched torch ops over a leading env dimension.

The task extends :class:`BlockLift` (same hand, same grasp model, the
same two physics substeps a control step, here a Python loop where the
reference scans) with a fixed peg on the right of the table: a nut
released (or slipping) with its center inside the peg's capture radius,
airborne and below the peg top, threads: it slides down the post (xy
clamped to the peg axis) and rests at its base. A firm regrasp pulls it
back off. Reward (max about 6 a step): reach toward the nut, continuous
squeeze shaping, a carry term toward the hover point above the peg, and a
threaded bonus; ``info['success']`` marks threaded-at-rest steps, and
episodes end by the 200-step time limit only.

Obs is 20-dim: grip_pos(3), grip_vel(3), grip_width(1), nut_pos(3),
nut_vel(3), nut_pos - grip_pos(3), peg_top - nut_pos(3), threaded(1).
Reset draws per env (explicit, or uniform from a generator): nut x, nut y,
hand x, hand y, finger opening, each in its range.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from surreal_tpu_torch.envs.base import ArraySpec, EnvSpecs
from surreal_tpu_torch.envs.device.base import DeviceEnv
from surreal_tpu_torch.envs.device.lift import (
    _BLOCK_HALF,
    _BLOCK_MASS,
    _DT,
    _G,
    _GRIP_V_MAX,
    _GRIP_W_MAX,
    _GRIP_W_SPEED,
    _GRIP_Z0,
    _MU,
    _N_SUB,
    _SLIP_DRAG,
    _TABLE_FRICTION,
    _TABLE_XY,
    _WS_XY,
    _WS_Z_MAX,
    BlockLift,
    LiftState,
)

# peg geometry (table top is z = 0)
PEG_XY = np.array([0.15, 0.15], dtype=np.float32)  # post axis position
PEG_HEIGHT = 0.10          # post top [m]
PEG_CAPTURE_R = 0.018      # nut-center capture radius for threading [m]
_NUT_SPAWN_X = (-0.20, 0.0)  # nut spawns left of the peg
_NUT_SPAWN_Y = 0.15
_HOVER = 0.03              # carry target height above the peg top

# reset draws per env: nut x, y; hand x, y; finger opening
RESET_LOW = (_NUT_SPAWN_X[0], -_NUT_SPAWN_Y, -0.02, -0.02, 2.0 * _BLOCK_HALF - 0.005)
RESET_HIGH = (_NUT_SPAWN_X[1], _NUT_SPAWN_Y, 0.02, 0.02, _GRIP_W_MAX)


class NutState(NamedTuple):
    hand: LiftState         # gripper + nut as the "block" of the grasp model
    threaded: torch.Tensor  # [B] bool, the nut is on the peg


class NutAssembly(DeviceEnv):
    """Nut threading with state observations (20-dim) and the 4-dim
    continuous gripper action; factory name ``jax:nut``."""

    max_episode_steps = 200
    reset_draw_dim = 5

    specs = EnvSpecs(
        obs=ArraySpec(shape=(20,), dtype=np.dtype(np.float32), name="state"),
        action=ArraySpec(shape=(4,), dtype=np.dtype(np.float32), name="hand"),
    )

    def __init__(self, device: torch.device | str):
        super().__init__(device)
        f32 = dict(dtype=torch.float32, device=self.device)
        self._lift = BlockLift(self.device)  # the shared grasp model
        self._ws_lo = torch.tensor([-_WS_XY, -_WS_XY, 0.0], **f32)
        self._ws_hi = torch.tensor([_WS_XY, _WS_XY, _WS_Z_MAX], **f32)
        self._gravity = torch.tensor([0.0, 0.0, -_G], **f32)
        self._peg_xy = torch.from_numpy(PEG_XY).to(self.device)
        self._peg_top = torch.tensor([PEG_XY[0], PEG_XY[1], PEG_HEIGHT], **f32)
        self._hover = torch.tensor([PEG_XY[0], PEG_XY[1], PEG_HEIGHT + _BLOCK_HALF + _HOVER], **f32)
        self._reset_low = torch.tensor(RESET_LOW, **f32)
        self._reset_span = torch.tensor(RESET_HIGH, **f32) - self._reset_low
        self._table_decay = math.exp(-_TABLE_FRICTION * _DT)

    def reset(
        self,
        num_envs: int,
        generator: torch.Generator | None = None,
        draws: torch.Tensor | None = None,
    ):
        """``draws`` [B, 5] = (nut x, nut y, hand x, hand y, opening), each
        already in its range; uniform from ``generator`` if absent."""
        if draws is None:
            draws = self._reset_low + self._uniform(num_envs, self.reset_draw_dim, generator) * self._reset_span
        else:
            draws = self._checked_draws(draws, num_envs, self.reset_draw_dim, "reset")
        zeros3 = torch.zeros((num_envs, 3), dtype=torch.float32, device=self.device)
        z = torch.ones((num_envs, 1), dtype=torch.float32, device=self.device)
        hand = LiftState(
            grip_pos=torch.cat([draws[:, 2:4], z * _GRIP_Z0], dim=1),
            grip_vel=zeros3,
            grip_width=draws[:, 4].clone(),
            block_pos=torch.cat([draws[:, 0:2], z * _BLOCK_HALF], dim=1),
            block_vel=zeros3.clone(),
        )
        state = NutState(hand=hand, threaded=torch.zeros(num_envs, dtype=torch.bool, device=self.device))
        return state, self._obs(state)

    def _substep(self, s: LiftState, threaded: torch.Tensor, v_cmd: torch.Tensor, w_rate: torch.Tensor):
        new_gpos = torch.clamp(s.grip_pos + v_cmd * _DT, self._ws_lo, self._ws_hi)
        gvel = (new_gpos - s.grip_pos) / _DT
        new_w = torch.clamp(s.grip_width + w_rate * _DT, 0.0, _GRIP_W_MAX)

        f_n, contact = self._lift._grasp_force(new_gpos, new_w, s.block_pos)
        support = _MU * f_n / (_BLOCK_MASS * _G)
        held = contact & (support >= 1.0)
        # a firm regrasp pulls the nut back OFF the peg
        threaded = threaded & ~held
        sup1 = torch.clamp_max(support, 1.0)[:, None]

        slip_acc = self._gravity * (1.0 - sup1) + (gvel - s.block_vel) * _SLIP_DRAG * sup1
        acc = torch.where(contact[:, None], slip_acc, self._gravity)
        bvel = torch.where(held[:, None], gvel, s.block_vel + acc * _DT)
        bpos = s.block_pos + bvel * _DT

        # threading: released inside the capture radius, airborne and below
        # the peg top -> the nut is on the post and slides down it
        over_peg = (
            (torch.linalg.vector_norm(bpos[:, :2] - self._peg_xy, dim=-1) < PEG_CAPTURE_R)
            & (bpos[:, 2] < PEG_HEIGHT + _BLOCK_HALF)
            & (bpos[:, 2] > _BLOCK_HALF + 1e-3)
        )
        threaded = threaded | (over_peg & ~held)
        on_post = threaded[:, None]
        pxy = torch.where(on_post, self._peg_xy, bpos[:, :2])
        vxy = torch.where(on_post, 0.0, bvel[:, :2])

        # table: inelastic normal contact + sliding-friction decay
        on_table = bpos[:, 2] <= _BLOCK_HALF
        bz = torch.clamp_min(bpos[:, 2], _BLOCK_HALF)
        vz = torch.where(on_table, torch.clamp_min(bvel[:, 2], 0.0), bvel[:, 2])
        slide = torch.where(on_table & ~held, self._table_decay, 1.0)
        vxy = vxy * slide[:, None]
        pxy = torch.clamp(pxy, -_TABLE_XY, _TABLE_XY)
        hand = LiftState(
            grip_pos=new_gpos,
            grip_vel=gvel,
            grip_width=new_w,
            block_pos=torch.cat([pxy, bz[:, None]], dim=1),
            block_vel=torch.cat([vxy, vz[:, None]], dim=1),
        )
        return hand, threaded

    def step(self, state: NutState, action: torch.Tensor):
        a = torch.clamp(action.to(torch.float32), -1.0, 1.0)
        v_cmd = a[:, :3] * _GRIP_V_MAX
        w_rate = -a[:, 3] * _GRIP_W_SPEED  # action[3] > 0 closes the fingers
        hand, threaded = state.hand, state.threaded
        for _ in range(_N_SUB):
            hand, threaded = self._substep(hand, threaded, v_cmd, w_rate)
        state = NutState(hand=hand, threaded=threaded)

        f_n, _ = self._lift._grasp_force(hand.grip_pos, hand.grip_width, hand.block_pos)
        support = _MU * f_n / (_BLOCK_MASS * _G)
        grasped = support >= 1.0
        dist_reach = torch.linalg.vector_norm(hand.grip_pos - hand.block_pos, dim=-1)
        dist_carry = torch.linalg.vector_norm(hand.block_pos - self._hover, dim=-1)
        at_rest = hand.block_pos[:, 2] <= _BLOCK_HALF + 1e-4
        reward = (
            (1.0 - torch.tanh(10.0 * dist_reach))
            + 0.5 * torch.clamp_max(support, 1.0)
            + 2.0 * (1.0 - torch.tanh(5.0 * dist_carry))
            + 2.5 * threaded.to(torch.float32)
        )
        done = torch.zeros_like(grasped)  # time-limit truncation only (AutoReset)
        info = {
            "success": threaded & at_rest,
            "grasped": grasped,
            "threaded": threaded,
            "nut_height": hand.block_pos[:, 2] - _BLOCK_HALF,
        }
        return state, self._obs(state), reward, done, info

    def _obs(self, state: NutState) -> torch.Tensor:
        hand = state.hand
        return torch.cat(
            [
                hand.grip_pos,
                hand.grip_vel,
                hand.grip_width[:, None],
                hand.block_pos,
                hand.block_vel,
                hand.block_pos - hand.grip_pos,
                self._peg_top - hand.block_pos,
                state.threaded.to(torch.float32)[:, None],
            ],
            dim=1,
        )
