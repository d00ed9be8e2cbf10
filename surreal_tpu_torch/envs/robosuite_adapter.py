"""Robosuite host adapter, a copy of ``surreal_tpu/envs/robosuite_adapter.py`` (parity: reference robosuite wrapper in
``surreal/env/``, SURVEY.md §2.1 env-adapter row — state obs via
robot-state + object-state concat, shaped rewards, horizon truncation).

robosuite is NOT installed in this image (SURVEY.md §7), so this adapter
import-gates at construction: with robosuite present it is one more
``make_env`` backend (``robosuite:Lift`` etc.); without it the factory's
error points at the on-device BlockLifting-class task ``jax:lift``, which
is the path the north-star benchmarks use. The adapter is exercised in
tests against a faked robosuite module implementing the same surface
(``make``, dict obs, 4-tuple step, ``action_spec``, ``horizon``).
"""

from __future__ import annotations

from typing import Any

import numpy as np

from surreal_tpu_torch.envs.base import (
    ArraySpec,
    EnvSpecs,
    HostEnv,
    StepOutput,
    rescale_canonical_action,
)

# the reference's FilterWrapper kept these obs-dict keys, concatenated
_STATE_KEYS = ("robot-state", "object-state")


def _flatten_state(obs_dict: dict) -> np.ndarray:
    parts = [
        np.asarray(obs_dict[k], np.float32).ravel()
        for k in _STATE_KEYS
        if k in obs_dict
    ]
    if not parts:  # newer robosuite: per-robot prefixed keys
        parts = [
            np.asarray(v, np.float32).ravel()
            for k, v in sorted(obs_dict.items())
            if k.endswith(("-state", "_state"))
        ]
    if not parts:
        raise ValueError(
            f"no state keys found in robosuite obs dict: {sorted(obs_dict)}"
        )
    return np.concatenate(parts)


class _RenderableEnv:
    """Gym-style ``.render()`` facade over a robosuite env: PixelObsWrapper
    and VideoWrapper call ``env.render()`` on each inner env, while
    robosuite renders offscreen through ``env.sim.render`` (and returns the
    frame bottom-up, as MuJoCo offscreen buffers do)."""

    def __init__(self, env, camera: str = "agentview", height: int = 256, width: int = 256):
        self._env = env
        self._camera = camera
        self._height = height
        self._width = width

    def __getattr__(self, name: str) -> Any:
        return getattr(self._env, name)

    def render(self) -> np.ndarray:
        frame = self._env.sim.render(
            camera_name=self._camera, height=self._height, width=self._width
        )
        return np.asarray(frame)[::-1]


class RobosuiteAdapter(HostEnv):
    """B independent robosuite envs behind the batched HostEnv API
    (state observations; pixel obs ride PixelObsWrapper like any host env —
    pass ``renderable=True`` so the offscreen renderer is enabled and each
    env exposes a gym-style ``render()``).
    """

    def __init__(
        self,
        env_id: str,
        num_envs: int = 1,
        seed: int = 0,
        robots: str = "Sawyer",
        renderable: bool = False,
        camera: str = "agentview",
        **make_kwargs: Any,
    ):
        import robosuite

        kwargs = dict(
            robots=robots,
            has_renderer=False,
            has_offscreen_renderer=renderable,
            use_camera_obs=False,
            use_object_obs=True,
            reward_shaping=True,  # the reference trained on shaped rewards
        )
        kwargs.update(make_kwargs)
        self.envs = [robosuite.make(env_id, **kwargs) for _ in range(num_envs)]
        if renderable:
            self.envs = [_RenderableEnv(e, camera=camera) for e in self.envs]
        self.num_envs = num_envs
        self._seed = seed
        # robosuite draws reset randomness from the GLOBAL numpy RNG; keep
        # a per-instance stream and swap it in around robosuite calls so
        # two adapters (e.g. training + eval envs) can't clobber each
        # other's determinism through the shared global state
        self._np_state = np.random.RandomState(seed).get_state()

        proto = self.envs[0]
        obs0 = self._isolated_reset(proto)
        obs_dim = _flatten_state(obs0).shape[0]
        low, high = proto.action_spec
        self._act_low = np.asarray(low, np.float32)
        self._act_high = np.asarray(high, np.float32)
        self.horizon = int(getattr(proto, "horizon", 1000))
        self._t = np.zeros(num_envs, np.int64)
        self.specs = EnvSpecs(
            obs=ArraySpec(shape=(obs_dim,), dtype=np.dtype(np.float32), name="state"),
            action=ArraySpec(
                shape=self._act_low.shape, dtype=np.dtype(np.float32), name="action"
            ),
        )

    def _isolated_reset(self, env) -> dict:
        """Run ``env.reset()`` under this adapter's private numpy stream."""
        outer = np.random.get_state()
        np.random.set_state(self._np_state)
        try:
            return env.reset()
        finally:
            self._np_state = np.random.get_state()
            np.random.set_state(outer)

    def reset(self, seed: int | None = None) -> np.ndarray:
        if seed is not None:
            self._np_state = np.random.RandomState(seed).get_state()
        self._t[:] = 0
        return np.stack(
            [_flatten_state(self._isolated_reset(env)) for env in self.envs]
        )

    def step(self, actions: np.ndarray) -> StepOutput:
        native = rescale_canonical_action(actions, self._act_low, self._act_high)
        obs_b, rew_b, done_b = [], [], []
        terminal_obs = np.zeros((self.num_envs, *self.specs.obs.shape), np.float32)
        truncated_b = np.zeros(self.num_envs, bool)
        for i, env in enumerate(self.envs):
            obs_dict, reward, done, _ = env.step(native[i])
            obs = _flatten_state(obs_dict)
            self._t[i] += 1
            truncated = self._t[i] >= self.horizon
            done = bool(done) or truncated
            if done:
                terminal_obs[i] = obs
                # robosuite ends episodes at the horizon; task "success"
                # does not terminate the MDP, so a done here is truncation
                # unless the env says otherwise before the horizon
                truncated_b[i] = truncated
                if self.pre_reset_hook is not None:
                    self.pre_reset_hook(i, env)
                obs = _flatten_state(self._isolated_reset(env))
                self._t[i] = 0
            obs_b.append(obs)
            rew_b.append(float(reward))
            done_b.append(done)
        return StepOutput(
            obs=np.stack(obs_b),
            reward=np.asarray(rew_b, np.float32),
            done=np.asarray(done_b, bool),
            info={"terminal_obs": terminal_obs, "truncated": truncated_b},
        )

    def close(self) -> None:
        for env in self.envs:
            env.close()
