"""Host-side observation wrappers, a copy of ``surreal_tpu/envs/wrappers.py`` (parity: reference
``surreal/env/wrapper.py`` — FrameStackWrapper, GrayscaleWrapper,
TransposeWrapper, FilterWrapper/obs-concat, max-step; SURVEY.md §2.1).

These run on the CPU host on numpy batches *before* the host-to-device copy so the
device-bound payload is final (e.g. grayscale before shipping cuts DCN
bytes 3x). Channel convention is channels-last [..., H, W, C] to match TPU
conv layouts; TransposeWrapper exists for sources that produce [C, H, W].
"""

from __future__ import annotations

import dataclasses

import numpy as np

from surreal_tpu_torch.envs.base import ArraySpec, HostEnv, HostWrapper, StepOutput


class FrameStackWrapper(HostWrapper):
    """Stack the last k obs along the channel (last) axis."""

    def __init__(self, env: HostEnv, k: int):
        super().__init__(env)
        self.k = k
        inner = env.specs.obs
        shape = (*inner.shape[:-1], inner.shape[-1] * k)
        self.specs = dataclasses.replace(
            env.specs, obs=dataclasses.replace(inner, shape=shape)
        )
        self._frames: np.ndarray | None = None  # [B, ..., C*k]

    def reset(self, seed: int | None = None) -> np.ndarray:
        obs = self.env.reset(seed)
        self._frames = np.concatenate([obs] * self.k, axis=-1)
        return self._frames.copy()

    def step(self, actions: np.ndarray) -> StepOutput:
        out = self.env.step(actions)
        c = out.obs.shape[-1]
        info = dict(out.info)
        if "terminal_obs" in info:
            # terminal_obs must match THIS wrapper's obs spec: the episode's
            # final stack = previous frames shifted + the terminal frame.
            info["terminal_obs"] = np.concatenate(
                [self._frames[..., c:], info["terminal_obs"]], axis=-1
            )
        self._frames = np.concatenate([self._frames[..., c:], out.obs], axis=-1)
        # reset stacks for finished envs: repeat the fresh reset obs
        if out.done.any():
            idx = np.nonzero(out.done)[0]
            self._frames[idx] = np.concatenate([out.obs[idx]] * self.k, axis=-1)
        return StepOutput(
            obs=self._frames.copy(), reward=out.reward, done=out.done, info=info
        )


class GrayscaleWrapper(HostWrapper):
    """RGB [..., H, W, 3] -> grayscale [..., H, W, 1] (ITU-R 601 luma)."""

    _LUMA = np.asarray([0.299, 0.587, 0.114], np.float32)

    def __init__(self, env: HostEnv):
        super().__init__(env)
        inner = env.specs.obs
        self.specs = dataclasses.replace(
            env.specs, obs=dataclasses.replace(inner, shape=(*inner.shape[:-1], 1))
        )

    def _convert(self, obs: np.ndarray) -> np.ndarray:
        gray = obs.astype(np.float32) @ self._LUMA
        return gray[..., None].astype(self.specs.obs.dtype)

    def reset(self, seed: int | None = None) -> np.ndarray:
        return self._convert(self.env.reset(seed))

    def step(self, actions: np.ndarray) -> StepOutput:
        out = self.env.step(actions)
        info = dict(out.info)
        if "terminal_obs" in info:
            info["terminal_obs"] = self._convert(info["terminal_obs"])
        return StepOutput(
            obs=self._convert(out.obs), reward=out.reward, done=out.done, info=info
        )


class TransposeWrapper(HostWrapper):
    """Permute obs axes (after the batch axis), e.g. CHW -> HWC."""

    def __init__(self, env: HostEnv, perm: tuple[int, ...]):
        super().__init__(env)
        self.perm = perm
        inner = env.specs.obs
        shape = tuple(inner.shape[p] for p in perm)
        self.specs = dataclasses.replace(
            env.specs, obs=dataclasses.replace(inner, shape=shape)
        )
        self._batch_perm = (0, *(p + 1 for p in perm))

    def reset(self, seed: int | None = None) -> np.ndarray:
        return np.transpose(self.env.reset(seed), self._batch_perm)

    def step(self, actions: np.ndarray) -> StepOutput:
        out = self.env.step(actions)
        info = dict(out.info)
        if "terminal_obs" in info:
            info["terminal_obs"] = np.transpose(info["terminal_obs"], self._batch_perm)
        return StepOutput(
            obs=np.transpose(out.obs, self._batch_perm),
            reward=out.reward,
            done=out.done,
            info=info,
        )


class ActionRepeatWrapper(HostWrapper):
    """Repeat each action k times, summing rewards (dm_control-style).

    Batched caveat: the inner env auto-resets, so an env that finishes on an
    inner step keeps stepping its *new* episode for the remaining repeats
    (per-env pausing isn't possible through a batched host adapter). Rewards
    after the boundary are excluded and the FIRST done's terminal_obs /
    truncated are the ones reported, so bootstrapping stays correct; the
    returned obs for such envs is up to k-1 steps into the new episode.
    """

    def __init__(self, env: HostEnv, k: int):
        super().__init__(env)
        self.k = k

    def step(self, actions: np.ndarray) -> StepOutput:
        total = np.zeros(self.num_envs, np.float32)
        done = np.zeros(self.num_envs, bool)
        terminal_obs = None
        truncated = np.zeros(self.num_envs, bool)
        out = None
        for _ in range(self.k):
            out = self.env.step(actions)
            total += out.reward * ~done  # stop accumulating past the boundary
            inner_term = out.info.get("terminal_obs")
            if inner_term is not None:
                if terminal_obs is None:
                    terminal_obs = np.zeros_like(inner_term)
                first_done = out.done & ~done  # envs finishing on THIS inner step
                terminal_obs[first_done] = inner_term[first_done]
                truncated |= np.asarray(out.info.get("truncated", False)) & first_done
            done |= out.done
        info = dict(out.info)
        if terminal_obs is not None:
            info["terminal_obs"] = terminal_obs
            info["truncated"] = truncated
        return StepOutput(obs=out.obs, reward=total, done=done, info=info)


class PixelObsWrapper(HostWrapper):
    """Replace state obs with rendered RGB frames (the pixel-obs path for
    backends whose native obs is a state vector; parity with the reference's
    camera-pixel Robosuite configs, SURVEY.md §2.1 env-adapter row).

    Uses nearest-neighbor resize (pure numpy — no cv2 in this image) to
    ``image_size``. uint8 output keeps host->device bytes small.
    """

    def __init__(self, env: HostEnv, image_size: tuple[int, int] = (84, 84)):
        super().__init__(env)
        self.image_size = tuple(image_size)
        h, w = self.image_size
        self.specs = dataclasses.replace(
            env.specs,
            obs=ArraySpec(shape=(h, w, 3), dtype=np.dtype(np.uint8), name="pixels"),
        )
        # capture the TRUE terminal frame while the episode's last state is
        # still live: the adapter fires this right before its auto-reset
        # (time-limit-truncated pixel episodes bootstrap off this frame; a
        # post-reset render would be the NEXT episode's first frame).
        # Install on the innermost adapter — an instance attribute on an
        # intermediate wrapper would shadow nothing (the adapter checks its
        # OWN attribute) and the hook would silently never fire.
        self._terminal_frames: dict[int, np.ndarray] = {}
        adapter = env
        while isinstance(adapter, HostWrapper):
            adapter = adapter.env
        adapter.pre_reset_hook = self._capture_terminal

    def _render_one(self, env) -> np.ndarray:
        frame = np.asarray(env.render())
        return _nn_resize(frame, self.image_size).astype(np.uint8)

    def _capture_terminal(self, i: int, env) -> None:
        self._terminal_frames[i] = self._render_one(env)

    def _grab(self) -> np.ndarray:
        return np.stack([self._render_one(env) for env in self.env.envs])

    def reset(self, seed: int | None = None) -> np.ndarray:
        self.env.reset(seed)
        self._terminal_frames.clear()
        return self._grab()

    def step(self, actions: np.ndarray) -> StepOutput:
        self._terminal_frames.clear()
        out = self.env.step(actions)
        pixels = self._grab()
        info = dict(out.info)
        terminal = pixels
        if self._terminal_frames:
            terminal = pixels.copy()
            for i, frame in self._terminal_frames.items():
                terminal[i] = frame
        info["terminal_obs"] = terminal
        return StepOutput(obs=pixels, reward=out.reward, done=out.done, info=info)


def _nn_resize(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    h, w = size
    ys = (np.arange(h) * img.shape[0] / h).astype(np.intp)
    xs = (np.arange(w) * img.shape[1] / w).astype(np.intp)
    return img[ys][:, xs]


class EpisodeStatsWrapper(HostWrapper):
    """Track per-env episode return/length; finished episodes surface in
    ``info['episode_returns']``/``info['episode_lengths']`` (parity: the
    stats the reference's agents pushed to tensorplex, SURVEY.md §5.5).
    """

    def __init__(self, env: HostEnv):
        super().__init__(env)
        self._ret = np.zeros(env.num_envs, np.float64)
        self._len = np.zeros(env.num_envs, np.int64)

    def reset(self, seed: int | None = None) -> np.ndarray:
        self._ret[:] = 0.0
        self._len[:] = 0
        return self.env.reset(seed)

    def step(self, actions: np.ndarray) -> StepOutput:
        out = self.env.step(actions)
        self._ret += out.reward
        self._len += 1
        info = dict(out.info)
        if out.done.any():
            idx = np.nonzero(out.done)[0]
            info["episode_returns"] = self._ret[idx].copy()
            info["episode_lengths"] = self._len[idx].copy()
            self._ret[idx] = 0.0
            self._len[idx] = 0
        return StepOutput(obs=out.obs, reward=out.reward, done=out.done, info=info)
