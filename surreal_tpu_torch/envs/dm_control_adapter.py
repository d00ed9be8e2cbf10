"""dm_control host adapter, a copy of ``surreal_tpu/envs/dm_control_adapter.py`` (parity: reference dm_control adapter in
``surreal/env/``, SURVEY.md §2.1): flattens the suite's ordered obs dict
into one float vector, canonicalizes actions to [-1, 1], batched like the
gym adapter. BASELINE config ② (cheetah-run) runs through this.
"""

from __future__ import annotations

import numpy as np

from surreal_tpu_torch.envs.base import (
    ArraySpec,
    EnvSpecs,
    HostEnv,
    StepOutput,
    rescale_canonical_action,
)


def _flatten_obs(obs_dict) -> np.ndarray:
    return np.concatenate(
        [np.asarray(v, np.float32).ravel() for v in obs_dict.values()]
    )


class DmControlAdapter(HostEnv):
    def __init__(self, domain: str, task: str, num_envs: int = 1, seed: int = 0):
        from dm_control import suite

        self.envs = [
            suite.load(domain, task, task_kwargs={"random": seed + i})
            for i in range(num_envs)
        ]
        self.num_envs = num_envs

        proto = self.envs[0]
        ts = proto.reset()
        obs_dim = _flatten_obs(ts.observation).shape[0]
        act_spec = proto.action_spec()
        self._act_low = np.asarray(act_spec.minimum, np.float32)
        self._act_high = np.asarray(act_spec.maximum, np.float32)
        self.specs = EnvSpecs(
            obs=ArraySpec(shape=(obs_dim,), dtype=np.dtype(np.float32), name="obs"),
            action=ArraySpec(
                shape=tuple(act_spec.shape), dtype=np.dtype(np.float32), name="action"
            ),
        )

    def reset(self, seed: int | None = None) -> np.ndarray:
        del seed  # dm_control seeding is fixed at construction
        return np.stack(
            [_flatten_obs(env.reset().observation) for env in self.envs]
        )

    def step(self, actions: np.ndarray) -> StepOutput:
        native = rescale_canonical_action(actions, self._act_low, self._act_high)
        obs_b, rew_b, done_b = [], [], []
        terminal_obs = np.zeros((self.num_envs, *self.specs.obs.shape), np.float32)
        truncated_b = np.zeros(self.num_envs, bool)
        for i, env in enumerate(self.envs):
            ts = env.step(native[i])
            done = ts.last()
            obs = _flatten_obs(ts.observation)
            if done:
                terminal_obs[i] = obs
                # dm_control suite episodes end by time limit (discount==1.0
                # at the boundary means truncation, not termination)
                truncated_b[i] = ts.discount is None or ts.discount > 0.0
                if self.pre_reset_hook is not None:
                    self.pre_reset_hook(i, env)
                obs = _flatten_obs(env.reset().observation)
            obs_b.append(obs)
            rew_b.append(0.0 if ts.reward is None else ts.reward)
            done_b.append(done)
        return StepOutput(
            obs=np.stack(obs_b),
            reward=np.asarray(rew_b, np.float32),
            done=np.asarray(done_b, bool),
            info={"terminal_obs": terminal_obs, "truncated": truncated_b},
        )
