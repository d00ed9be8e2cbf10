"""On-device pixel Pong, the port of ``surreal_tpu/envs/jax/pong.py``
(``Pong``, factory name ``jax:pong``; ``PongSmall``, ``jax:pong16``),
written as batched torch ops over a leading env dimension.

The game is the reference's, operation for operation: the agent's paddle
on the left edge of the unit court, a tracking opponent on the right,
Discrete(3) actions (stay / up / down), wall bounces, paddle hits that
deflect the ball by the hit offset and speed it up toward a cap, +1 when
the opponent misses and -1 when the agent misses, a re-serve toward the
side that was scored against, and ``done`` when either side reaches 21.
``info['score']`` is agent minus opponent points. The JAX module documents
the model in full.

Observation: [R, R, 2] uint8 (NHWC), R = 42 (16 for ``PongSmall``):
channel 0 the current frame, channel 1 the previous one. Pixels are
thresholds on the ball and paddle positions, so the grid and the physics
round exactly as the reference does under ``jit`` (where it always runs),
with its float32 constants: a last-bit difference in a position can flip
a pixel. XLA rewrites a division by a constant into a multiply by the
constant's float32 reciprocal, and folds ``(x / c1) * c2`` into
``x * (c2 / c1)``; the port writes those two products out.

Randomness is explicit (the reference keeps a PRNG key in the state):

- reset draws [B, 2]: the serve's vertical speed in [-0.02, 0.02), and
  1.0 where the serve goes toward the agent (else 0.0);
- step draws [B, 1]: the vertical speed of the serve that follows a point.
  The reference splits its key for this on every step, point or not; the
  draw is used only where a point was scored.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from surreal_tpu_torch.envs.base import ArraySpec, DiscreteSpec, EnvSpecs
from surreal_tpu_torch.envs.device.base import DeviceEnv

_RES = 42                 # render resolution (square)
_PADDLE_HALF = 0.08       # paddle half-height (court units)
_PADDLE_SPEED = 0.04      # agent paddle speed per step
_OPP_SPEED = 0.03         # opponent tracking speed
_BALL_SPEED0 = 0.03       # serve speed
_BALL_SPEED_MAX = 0.06
_SPEEDUP = 1.05           # per paddle hit
_AGENT_X = 0.04           # paddle plane x positions
_OPP_X = 0.96
_DEFLECT = 0.04           # max |vy| added by hit offset
_WIN_SCORE = 21
_SERVE_VY = 0.02          # serve vertical speed range is [-this, this)


class PongState(NamedTuple):
    ball: torch.Tensor         # [B, 2] position (x, y)
    vel: torch.Tensor          # [B, 2] velocity
    agent_y: torch.Tensor      # [B] agent paddle center
    opp_y: torch.Tensor        # [B] opponent paddle center
    agent_score: torch.Tensor  # [B] int32 points won by the agent
    opp_score: torch.Tensor    # [B] int32 points won by the opponent
    prev_frame: torch.Tensor   # [B, R, R] uint8


def _specs(res: int) -> EnvSpecs:
    return EnvSpecs(
        obs=ArraySpec(shape=(res, res, 2), dtype=np.dtype(np.uint8), name="pixels"),
        action=DiscreteSpec(shape=(), dtype=np.dtype(np.int32), name="action", n=3),
    )


class Pong(DeviceEnv):
    """Paddle-vs-paddle Pong with [42, 42, 2] uint8 pixel observations;
    factory name ``jax:pong``."""

    max_episode_steps = 2048
    reset_draw_dim = 2
    step_draw_dim = 1
    res = _RES
    specs = _specs(_RES)

    def __init__(self, device: torch.device | str):
        super().__init__(device)
        f32 = dict(dtype=torch.float32, device=self.device)
        res = self.res
        # (arange + 0.5) / res, as XLA computes it
        grid = (torch.arange(res, **f32) + 0.5) * torch.tensor(1.0 / res, **f32)
        self._ys = grid[:, None]                                # [R, 1]
        self._xs = grid[None, :]                                # [1, R]
        self._cell = torch.tensor(1.0 / res, **f32)
        # the paddles' columns never move
        self._agent_col = torch.abs(self._xs - _AGENT_X) <= self._cell
        self._opp_col = torch.abs(self._xs - _OPP_X) <= self._cell
        self._moves = torch.tensor([0.0, -_PADDLE_SPEED, _PADDLE_SPEED], **f32)
        self._center = torch.tensor([0.5, 0.5], **f32)

    # -- pieces --------------------------------------------------------------
    def _render(self, ball: torch.Tensor, agent_y: torch.Tensor, opp_y: torch.Tensor) -> torch.Tensor:
        """[B, R, R] uint8 frames: rows are y (top = 0), columns x."""
        ys, xs, cell = self._ys, self._xs, self._cell
        ball_px = (torch.abs(ys - ball[:, 1, None, None]) <= cell) & (
            torch.abs(xs - ball[:, 0, None, None]) <= cell
        )
        agent_px = (torch.abs(ys - agent_y[:, None, None]) <= _PADDLE_HALF) & self._agent_col
        opp_px = (torch.abs(ys - opp_y[:, None, None]) <= _PADDLE_HALF) & self._opp_col
        return (ball_px | agent_px | opp_px).to(torch.uint8) * 255

    def _serve(self, vy: torch.Tensor, toward_agent: torch.Tensor):
        """Ball from the center toward the scored-against side."""
        vx = torch.where(toward_agent, -_BALL_SPEED0, _BALL_SPEED0).to(torch.float32)
        return self._center.expand(vy.shape[0], 2), torch.stack([vx, vy], dim=1)

    def _uniform_vy(self, u: torch.Tensor) -> torch.Tensor:
        return -_SERVE_VY + u * (2.0 * _SERVE_VY)

    # -- API -----------------------------------------------------------------
    def reset(
        self,
        num_envs: int,
        generator: torch.Generator | None = None,
        draws: torch.Tensor | None = None,
    ):
        """``draws`` [B, 2] = (serve vy, 1.0 if toward the agent), each
        already in its range; drawn from ``generator`` if absent."""
        if draws is None:
            u = self._uniform(num_envs, 2, generator)
            draws = torch.stack([self._uniform_vy(u[:, 0]), (u[:, 1] < 0.5).to(torch.float32)], dim=1)
        draws = self._checked_draws(draws, num_envs, 2, "reset")
        ball, vel = self._serve(draws[:, 0], draws[:, 1] != 0.0)
        half = torch.full((num_envs,), 0.5, dtype=torch.float32, device=self.device)
        zeros = torch.zeros(num_envs, dtype=torch.int32, device=self.device)
        state = PongState(
            ball=ball.clone(),
            vel=vel,
            agent_y=half,
            opp_y=half.clone(),
            agent_score=zeros,
            opp_score=zeros.clone(),
            prev_frame=self._render(ball, half, half),
        )
        return state, self._obs(state)

    def _paddle_bounce(self, ball, vel, paddle_y, plane_x: float, left: bool):
        toward = vel[:, 0] < 0 if left else vel[:, 0] > 0
        plane = ball[:, 0] <= plane_x if left else ball[:, 0] >= plane_x
        crossed = plane & toward
        hit = crossed & (torch.abs(ball[:, 1] - paddle_y) <= _PADDLE_HALF)
        speed = torch.clamp_max(torch.abs(vel[:, 0]) * _SPEEDUP, _BALL_SPEED_MAX)
        new_vx = speed if left else -speed
        # vy + offset * DEFLECT with offset = (ball_y - paddle_y) / PADDLE_HALF
        # in [-1, 1], as XLA folds it (DEFLECT / PADDLE_HALF is exactly 0.5)
        new_vy = torch.clamp(
            vel[:, 1] + (ball[:, 1] - paddle_y) * (_DEFLECT / _PADDLE_HALF),
            -_BALL_SPEED_MAX, _BALL_SPEED_MAX,
        )
        vel = torch.where(hit[:, None], torch.stack([new_vx, new_vy], dim=1), vel)
        ball_x = torch.where(hit, torch.full_like(ball[:, 0], plane_x), ball[:, 0])
        ball = torch.stack([ball_x, ball[:, 1]], dim=1)
        return ball, vel, hit, crossed

    def step(
        self,
        state: PongState,
        action: torch.Tensor,
        generator: torch.Generator | None = None,
        draws: torch.Tensor | None = None,
    ):
        """``draws`` [B, 1] = the vy of a serve after a point; drawn from
        ``generator`` if absent."""
        num_envs = action.shape[0]
        if draws is None:
            draws = self._uniform_vy(self._uniform(num_envs, 1, generator))
        serve_vy = self._checked_draws(draws, num_envs, 1, "step")[:, 0]
        # paddles
        move = self._moves[action.long()]
        agent_y = torch.clamp(state.agent_y + move, _PADDLE_HALF, 1.0 - _PADDLE_HALF)
        opp_y = torch.clamp(
            state.opp_y + torch.clamp(state.ball[:, 1] - state.opp_y, -_OPP_SPEED, _OPP_SPEED),
            _PADDLE_HALF,
            1.0 - _PADDLE_HALF,
        )

        # ball flight + wall bounce
        ball = state.ball + state.vel
        out = (ball[:, 1] < 0.0) | (ball[:, 1] > 1.0)
        vy = torch.where(out, -state.vel[:, 1], state.vel[:, 1])
        ball = torch.stack([ball[:, 0], torch.clamp(ball[:, 1], 0.0, 1.0)], dim=1)
        vel = torch.stack([state.vel[:, 0], vy], dim=1)

        ball, vel, hit_a, crossed_a = self._paddle_bounce(ball, vel, agent_y, _AGENT_X, True)
        ball, vel, hit_o, crossed_o = self._paddle_bounce(ball, vel, opp_y, _OPP_X, False)
        agent_missed = crossed_a & ~hit_a
        opp_missed = crossed_o & ~hit_o
        reward = torch.where(
            opp_missed, 1.0, torch.where(agent_missed, -1.0, 0.0)
        ).to(torch.float32)
        agent_score = state.agent_score + opp_missed.to(torch.int32)
        opp_score = state.opp_score + agent_missed.to(torch.int32)

        # re-serve after a point, toward whoever was scored against
        serve_ball, serve_vel = self._serve(serve_vy, agent_missed)
        point = agent_missed | opp_missed
        ball = torch.where(point[:, None], serve_ball, ball)
        vel = torch.where(point[:, None], serve_vel, vel)

        frame = self._render(ball, agent_y, opp_y)
        new_state = PongState(
            ball=ball,
            vel=vel,
            agent_y=agent_y,
            opp_y=opp_y,
            agent_score=agent_score,
            opp_score=opp_score,
            prev_frame=frame,
        )
        done = (agent_score >= _WIN_SCORE) | (opp_score >= _WIN_SCORE)
        info = {"score": agent_score - opp_score, "point": point}
        obs = torch.stack([frame, state.prev_frame], dim=-1)
        return new_state, obs, reward, done, info

    @staticmethod
    def _obs(state: PongState) -> torch.Tensor:
        return torch.stack([state.prev_frame, state.prev_frame], dim=-1)


class PongSmall(Pong):
    """16x16 Pong (``jax:pong16``): the same court, physics and opponent;
    resolution is render-only."""

    res = 16
    specs = _specs(16)
