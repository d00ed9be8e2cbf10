"""Device-rendered pixel variants of the manipulation envs, the port of
``surreal_tpu/envs/jax/pixels.py`` (``BlockLiftPixels``, factory name
``jax:lift_pixels``; ``NutAssemblyPixels``, ``jax:nut_pixels``, BASELINE
config ④'s shape).

The scene is rasterized from env state on the device with elementwise
masks over the whole [B, RES, RES] batch, as the reference does per env
under vmap. Two orthographic views, each ``RES x RES``: channel 0 the
SIDE view (x right, z up), channel 1 the TOP view (x right, y down).
Objects draw at distinct intensities (fingers 255, object 170, peg 110,
table line 60); overlaps resolve by max intensity. The previous two-view
frame is carried in the env state and concatenated, giving obs
``[RES, RES, 4] uint8`` (current, then previous).

``frame_renderer`` gives the evaluator's video recording a frame of a
device env's state (``_views_to_rgb``: the two views side by side, RGB).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from surreal_tpu_torch.envs.base import ArraySpec, EnvSpecs
from surreal_tpu_torch.envs.device.base import DeviceEnv
from surreal_tpu_torch.envs.device.lift import _BLOCK_HALF, _PAD_HALF_H, _WS_XY, _WS_Z_MAX, BlockLift
from surreal_tpu_torch.envs.device.nut_assembly import PEG_HEIGHT, PEG_XY, NutAssembly

RES = 64
_FINGER_HALF_X = 0.006   # finger pad half-thickness along the travel axis
_FINGER_HALF_Y = 0.010
_PEG_HALF_R = 0.012

# world extents mapped onto the image square
_X_LO, _X_HI = -_WS_XY - 0.02, _WS_XY + 0.02
_Y_LO, _Y_HI = -_WS_XY - 0.02, _WS_XY + 0.02
_Z_LO, _Z_HI = -0.02, _WS_Z_MAX + 0.02


def _axis(lo: float, hi: float, device) -> torch.Tensor:
    """Pixel-center world coordinates along one image axis, [RES] float32:
    ``lo + (i + 0.5) * ((hi - lo) / RES)``, each operation rounded to
    float32 as the reference computes it."""
    i = torch.arange(RES, dtype=torch.float32, device=device) + 0.5
    return lo + i * ((hi - lo) / RES)


def _boxes_view(u: torch.Tensor, v: torch.Tensor, boxes) -> torch.Tensor:
    """Rasterize axis-aligned boxes onto a [B, RES, RES] uint8 view.

    ``u``/``v``: world coordinates [RES] of pixel columns/rows. ``boxes``:
    (cu, cv, hu, hv, intensity) with each geometric entry a [B] tensor or
    a Python float (the same for every env). Overlaps resolve by max."""

    def col(x):  # [B] -> [B, 1, 1]; floats broadcast as they are
        return x[:, None, None] if isinstance(x, torch.Tensor) else x

    img = None
    for cu, cv, hu, hv, val in boxes:
        mask = (torch.abs(u[None, None, :] - col(cu)) <= col(hu)) & (torch.abs(v[None, :, None] - col(cv)) <= col(hv))
        layer = mask.to(torch.uint8) * val
        img = layer if img is None else torch.maximum(img, layer)
    return img


def _render_hand_scene(hand, extra_side=(), extra_top=()) -> torch.Tensor:
    """[B, RES, RES, 2] uint8: side + top orthographic views of the gripper
    and its object, plus per-view extra boxes (e.g. the peg)."""
    dev = hand.grip_pos.device
    xs = _axis(_X_LO, _X_HI, dev)
    ys = _axis(_Y_LO, _Y_HI, dev)
    zs = _axis(_Z_HI, _Z_LO, dev)  # rows top-down: high z at row 0
    gx, gy, gz = hand.grip_pos.unbind(-1)
    half_w = hand.grip_width * 0.5
    bx, by, bz = hand.block_pos.unbind(-1)
    side = _boxes_view(xs, zs, [
        # two finger pads straddling the travel axis
        (gx - half_w, gz, _FINGER_HALF_X, _PAD_HALF_H, 255),
        (gx + half_w, gz, _FINGER_HALF_X, _PAD_HALF_H, 255),
        # palm bar joining the fingers
        (gx, gz + _PAD_HALF_H, half_w, _FINGER_HALF_X, 255),
        (bx, bz, _BLOCK_HALF, _BLOCK_HALF, 170),
        # table surface line at z = 0
        (0.0, 0.0, _X_HI, 0.004, 60),
        *extra_side,
    ])
    top = _boxes_view(xs, ys, [
        (gx - half_w, gy, _FINGER_HALF_X, _FINGER_HALF_Y, 255),
        (gx + half_w, gy, _FINGER_HALF_X, _FINGER_HALF_Y, 255),
        (bx, by, _BLOCK_HALF, _BLOCK_HALF, 170),
        *extra_top,
    ])
    return torch.stack([side, top], dim=-1)


def render_lift(state) -> torch.Tensor:
    return _render_hand_scene(state)


def render_nut(state) -> torch.Tensor:
    peg_x, peg_y = float(PEG_XY[0]), float(PEG_XY[1])
    return _render_hand_scene(
        state.hand,
        extra_side=[(peg_x, PEG_HEIGHT / 2.0, _PEG_HALF_R, PEG_HEIGHT / 2.0, 110)],
        extra_top=[(peg_x, peg_y, _PEG_HALF_R, _PEG_HALF_R, 110)],
    )


class PixelState(NamedTuple):
    inner: object
    prev: torch.Tensor  # [B, RES, RES, 2] previous two-view frame


class _DevicePixels(DeviceEnv):
    """Pixel wrapper over a state-obs device env: same dynamics and reward,
    observations become current + previous two-view frames."""

    inner_cls: type[DeviceEnv]  # set by subclasses
    render = None               # staticmethod(state) -> [B, RES, RES, 2] uint8

    def __init__(self, device: torch.device | str):
        super().__init__(device)
        self.inner = self.inner_cls(self.device)

    def reset(self, num_envs: int, generator: torch.Generator | None = None, draws: torch.Tensor | None = None):
        s, _ = self.inner.reset(num_envs, generator=generator, draws=draws)
        frame = type(self).render(s)
        return PixelState(s, frame), torch.cat([frame, frame], dim=-1)

    def step(self, state: PixelState, action: torch.Tensor):
        s, _, reward, done, info = self.inner.step(state.inner, action)
        frame = type(self).render(s)
        obs = torch.cat([frame, state.prev], dim=-1)
        return PixelState(s, frame), obs, reward, done, info


def _pixel_specs(inner) -> EnvSpecs:
    return EnvSpecs(
        obs=ArraySpec(shape=(RES, RES, 4), dtype=np.dtype(np.uint8), name="pixels"),
        action=inner.specs.action,
    )


class BlockLiftPixels(_DevicePixels):
    """Factory name ``jax:lift_pixels``."""

    inner_cls = BlockLift
    render = staticmethod(render_lift)
    max_episode_steps = BlockLift.max_episode_steps
    reset_draw_dim = BlockLift.reset_draw_dim
    specs = _pixel_specs(BlockLift)


class NutAssemblyPixels(_DevicePixels):
    """Factory name ``jax:nut_pixels``, BASELINE config ④'s shape."""

    inner_cls = NutAssembly
    render = staticmethod(render_nut)
    max_episode_steps = NutAssembly.max_episode_steps
    reset_draw_dim = NutAssembly.reset_draw_dim
    specs = _pixel_specs(NutAssembly)


# -- eval-video frame rendering ---------------------------------------------

def _views_to_rgb(views, upscale: int = 3) -> np.ndarray:
    """[R, R, 2] two-view uint8 -> side-by-side RGB [R*u, 2*R*u + u, 3]
    (host numpy, once a recorded frame)."""
    v = np.asarray(views)
    sep = np.full((v.shape[0], 1), 40, np.uint8)  # thin divider column
    panel = np.concatenate([v[..., 0], sep, v[..., 1]], axis=1)
    panel = panel.repeat(upscale, axis=0).repeat(upscale, axis=1)
    return np.stack([panel] * 3, axis=-1)


def frame_renderer(env):
    """The eval-video renderer of a device env: ``state -> [H, W, 3]
    uint8`` (numpy) of env 0 of a batched state, or None when the env has
    no visual form (``jax:lift``, ``jax:nut``, their pixel variants and
    ``jax:pong``/``jax:pong16`` have one)."""
    from surreal_tpu_torch.envs.device.pong import Pong

    def first(views: torch.Tensor) -> np.ndarray:
        return _views_to_rgb(views[0].cpu().numpy())

    if isinstance(env, _DevicePixels):
        render = type(env).render
        return lambda s: first(render(s.inner))
    if isinstance(env, BlockLift):
        return lambda s: first(render_lift(s))
    if isinstance(env, NutAssembly):
        return lambda s: first(render_nut(s))
    if isinstance(env, Pong):
        def pong_frame(s):
            f = s.prev_frame[0].cpu().numpy().repeat(4, axis=0).repeat(4, axis=1)
            return np.stack([f] * 3, axis=-1)

        return pong_frame
    return None
