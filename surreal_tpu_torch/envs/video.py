"""Eval-episode video recording, the port of ``surreal_tpu/envs/video.py``
(``VideoWrapper``, ``save_episode_frames``), copied: it is numpy only.

Records env 0's frames every N episodes. An episode is written as mp4
when imageio (with an ffmpeg backend) imports and encodes, else as a
``.npz`` of the frame stack: the reference's rule for the file format.
"""

from __future__ import annotations

import os

import numpy as np

from surreal_tpu_torch.envs.base import HostEnv, HostWrapper, StepOutput


class VideoWrapper(HostWrapper):
    def __init__(self, env: HostEnv, out_dir: str, every_n_episodes: int = 50):
        super().__init__(env)
        self.out_dir = out_dir
        self.every_n = max(1, every_n_episodes)
        self._episode = 0
        self._frames: list[np.ndarray] = []
        os.makedirs(out_dir, exist_ok=True)

    def _render(self) -> np.ndarray | None:
        render = getattr(self.env, "render", None)
        if render is None and hasattr(self.env, "envs"):
            env0 = self.env.envs[0]
            render = getattr(env0, "render", None)
            if render is None and hasattr(env0, "physics"):  # dm_control
                return self.env.envs[0].physics.render(height=240, width=320)
        if render is None:
            return None
        frame = render()
        return None if frame is None else np.asarray(frame)

    @property
    def _recording(self) -> bool:
        return self._episode % self.every_n == 0

    def reset(self, seed: int | None = None) -> np.ndarray:
        obs = self.env.reset(seed)
        self._frames = []
        if self._recording:
            frame = self._render()
            if frame is not None:
                self._frames.append(frame)
        return obs

    def step(self, actions: np.ndarray) -> StepOutput:
        out = self.env.step(actions)
        if self._recording:
            frame = self._render()
            if frame is not None:
                self._frames.append(frame)
        if out.done[0]:
            if self._recording and self._frames:
                self._save()
            self._episode += 1
            self._frames = []
        return out

    def _save(self) -> None:
        save_episode_frames(self._frames, self.out_dir, self._episode)


def save_episode_frames(frames, out_dir: str, episode_idx: int) -> str:
    """Write one episode's frame stack (mp4 when an encoder exists, else
    .npz). Shared by the host VideoWrapper and the device-env eval
    recorder. Returns the file stem."""
    os.makedirs(out_dir, exist_ok=True)
    stem = os.path.join(out_dir, f"episode_{episode_idx:06d}")
    arr = np.stack([np.asarray(f) for f in frames])
    try:
        import imageio.v2 as imageio

        imageio.mimwrite(stem + ".mp4", arr, fps=30)
    except Exception:
        np.savez_compressed(stem + ".npz", frames=arr)
    return stem
