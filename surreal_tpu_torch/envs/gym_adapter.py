"""Gymnasium host adapter, a copy of ``surreal_tpu/envs/gym_adapter.py`` (parity: reference gym adapter in
``surreal/env/``, SURVEY.md §2.1 env-adapter row).

Differences from the reference, by design: the adapter is *batched* — one
adapter steps B envs and returns contiguous arrays ready for a single
host-to-device copy — because the rebuild replaces the 1-process-per-env actor
pool with SEED-style central inference (SURVEY.md §3.2).
"""

from __future__ import annotations

from typing import Any

import numpy as np

from surreal_tpu_torch.envs.base import (
    ArraySpec,
    DiscreteSpec,
    EnvSpecs,
    HostEnv,
    StepOutput,
    rescale_canonical_action,
)


class GymAdapter(HostEnv):
    """B independent gymnasium envs behind the batched HostEnv API."""

    def __init__(self, env_id: str, num_envs: int = 1, seed: int = 0, **make_kwargs: Any):
        import gymnasium

        self.envs = [gymnasium.make(env_id, **make_kwargs) for _ in range(num_envs)]
        self.num_envs = num_envs
        self._seed = seed
        self._seeded = False

        proto = self.envs[0]
        obs_space = proto.observation_space
        act_space = proto.action_space
        obs_spec = ArraySpec(
            shape=tuple(obs_space.shape), dtype=np.dtype(obs_space.dtype), name="obs"
        )
        if hasattr(act_space, "n"):  # Discrete
            act_spec = DiscreteSpec(
                shape=(), dtype=np.dtype(np.int32), name="action", n=int(act_space.n)
            )
            self._act_low = self._act_high = None
        else:  # Box -> canonical [-1, 1]
            act_spec = ArraySpec(
                shape=tuple(act_space.shape), dtype=np.dtype(np.float32), name="action"
            )
            self._act_low = np.asarray(act_space.low, np.float32)
            self._act_high = np.asarray(act_space.high, np.float32)
        self.specs = EnvSpecs(obs=obs_spec, action=act_spec)

    def reset(self, seed: int | None = None) -> np.ndarray:
        # Seed each env's RNG stream only on the first reset (or when the
        # caller passes an explicit seed); plain reset() afterwards keeps the
        # streams advancing so repeated resets don't replay identical episodes.
        if seed is None and self._seeded:
            obs = [env.reset()[0] for env in self.envs]
        else:
            base = self._seed if seed is None else seed
            obs = [env.reset(seed=base + i)[0] for i, env in enumerate(self.envs)]
            self._seeded = True
        return np.stack(obs).astype(self.specs.obs.dtype)

    def step(self, actions: np.ndarray) -> StepOutput:
        if self._act_low is not None:
            actions = rescale_canonical_action(actions, self._act_low, self._act_high)
        obs_b, rew_b, done_b = [], [], []
        terminal_obs = np.zeros((self.num_envs, *self.specs.obs.shape), self.specs.obs.dtype)
        truncated_b = np.zeros(self.num_envs, bool)
        for i, env in enumerate(self.envs):
            act = actions[i]
            if isinstance(self.specs.action, DiscreteSpec):
                act = int(act)
            obs, reward, terminated, truncated, _ = env.step(act)
            done = terminated or truncated
            if done:
                terminal_obs[i] = obs
                truncated_b[i] = truncated and not terminated
                if self.pre_reset_hook is not None:
                    self.pre_reset_hook(i, env)
                obs, _ = env.reset()
            obs_b.append(obs)
            rew_b.append(reward)
            done_b.append(done)
        return StepOutput(
            obs=np.stack(obs_b).astype(self.specs.obs.dtype),
            reward=np.asarray(rew_b, np.float32),
            done=np.asarray(done_b, bool),
            info={"terminal_obs": terminal_obs, "truncated": truncated_b},
        )

    def close(self) -> None:
        for env in self.envs:
            env.close()
