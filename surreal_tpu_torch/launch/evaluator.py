"""Periodic policy evaluation, the port of
``surreal_tpu/launch/evaluator.py`` (``Evaluator``).

- **device envs** (``jax:*``): an evaluation runs ``eval.episodes`` fresh
  episodes side by side on the evaluator's own batched env, acting
  through the learner's ``act_step`` (with a fresh ``act_init`` carry),
  for the env's time limit (or ``eval.max_steps``) with each episode
  latched at its first done, as the reference's scan does; the result is
  read back to the host in one copy.
- **host envs** (gym, dm_control, robosuite): the evaluator owns a
  separate env instance of ``eval.episodes`` parallel envs (so eval never
  perturbs the training env), steps it until every episode has finished
  or for at most 10,000 steps (or ``eval.max_steps``), acting through the
  learner's ``act`` on its device, one action read back per step.

Either way the mode is 'eval_deterministic' or 'eval_stochastic', and the
metrics are ``eval/return``, ``eval/length`` and ``eval/success`` (0 for
envs that report no success).

Video (``env_config.video`` with ``enabled`` and ``dir``), where the
reference records it: a host env records through the ``VideoWrapper``
that ``make_env`` puts at the end of its chain; on a device env, every
``video.every_n_episodes``-th evaluation also rolls one episode of the
unwrapped env (no auto-reset, so the outcome frame is kept) with the
policy and renders each state (``envs/device/pixels.py::frame_renderer``),
reset frame and terminal frame included, to ``episode_NNNNNN`` in the
video dir. A device env without a renderer raises, as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from surreal_tpu_torch.envs import is_jax_env, make_env
from surreal_tpu_torch.learners.base import EVAL_DETERMINISTIC, EVAL_STOCHASTIC
from surreal_tpu_torch.session.config import Config


class Evaluator:
    """Scores learner state over N fresh episodes; returns ``eval/*`` metrics."""

    def __init__(self, env_config, eval_config, learner):
        self.episodes = int(eval_config.episodes)
        self.mode = EVAL_DETERMINISTIC if eval_config.mode == "deterministic" else EVAL_STOCHASTIC
        # its own module copies: under pipelined side-bands an evaluation
        # runs on the engine's staging thread while the main thread learns
        self.learner = learner.acting_copy()
        cap = eval_config.get("max_steps", None)
        if cap is not None and int(cap) < 1:
            raise ValueError(f"eval max_steps must be >= 1, got {cap}")
        video = env_config.get("video", None)
        self._video = video if video is not None and video.get("enabled", False) and video.get("dir", None) else None
        # a host env is built with eval.episodes parallel envs; a device env
        # takes its batch at reset
        self.env = make_env(Config(num_envs=self.episodes).extend(env_config), learner.device)
        self.host = not is_jax_env(self.env)
        if self.host:
            if learner.requires_act_carry:
                self.env.close()
                raise ValueError(
                    "trajectory policies evaluate on device envs (jax:*): "
                    "the host eval loop acts statelessly per step"
                )
            self._time_limit = int(cap) if cap is not None else 10_000
        else:
            self._time_limit = int(cap) if cap is not None else (self.env.time_limit or 1000)
            if self._video is not None:
                from surreal_tpu_torch.envs.device.pixels import frame_renderer

                self._render_frame = frame_renderer(self.env.env)
                if self._render_frame is None:
                    raise ValueError(
                        "env_config.video.enabled is set but device env "
                        f"{type(self.env.env).__name__} has no frame renderer "
                        "(envs/device/pixels.py frame_renderer): disable video or add a renderer for this env"
                    )
                self._video_episode = 0

    @torch.no_grad()
    def _device_eval(self, state, generator: torch.Generator) -> dict[str, torch.Tensor]:
        B, dev = self.episodes, self.learner.device
        env_state, obs = self.env.reset(B, generator=generator)
        ret = torch.zeros(B, dtype=torch.float32, device=dev)
        length = torch.zeros(B, dtype=torch.int32, device=dev)
        alive = torch.ones(B, dtype=torch.float32, device=dev)
        success = torch.zeros(B, dtype=torch.bool, device=dev)
        # act_step is act for memoryless policies; a trajectory policy
        # threads its context carry, re-segmenting past its horizon
        act_carry = self.learner.act_init(B)
        for _ in range(self._time_limit):
            action, _, act_carry = self.learner.act_step(state, act_carry, obs, self.mode, generator)
            env_state, obs, reward, done, info = self.env.step(env_state, action, generator)
            ret = ret + reward * alive
            length = length + (alive > 0).to(torch.int32)
            if "success" in info:
                success = success | (info["success"] & (alive > 0))
            alive = alive * (1.0 - done.to(torch.float32))
        return {
            "eval/return": ret.mean(),
            "eval/length": length.to(torch.float32).mean(),
            "eval/success": success.to(torch.float32).mean(),
        }

    @torch.no_grad()
    def _host_eval(self, state, generator: torch.Generator):
        env, dev = self.env, self.learner.device
        obs = env.reset()
        B = env.num_envs
        ret = np.zeros(B, np.float32)
        length = np.zeros(B, np.int32)
        alive = np.ones(B, bool)
        success = np.zeros(B, bool)
        for _ in range(self._time_limit):
            obs_t = torch.from_numpy(np.ascontiguousarray(obs)).to(dev, non_blocking=True)
            action, _ = self.learner.act(state, obs_t, self.mode, generator)
            out = env.step(action.cpu().numpy())
            ret += out.reward * alive
            length += alive.astype(np.int32)
            info_success = out.info.get("success")
            if info_success is not None:
                success |= np.asarray(info_success, bool) & alive
            alive &= ~out.done
            obs = out.obs
            if not alive.any():
                break
        return {
            "eval/return": float(ret.mean()),
            "eval/length": float(length.mean()),
            "eval/success": float(success.astype(np.float32).mean()),
        }

    @torch.no_grad()
    def _record_device_episode(self, state, generator: torch.Generator) -> None:
        """One episode of the unwrapped env (batch 1) with the policy, each
        state rendered to a frame, the terminal one included; every
        ``video.every_n_episodes``-th call records, the others return."""
        from surreal_tpu_torch.envs.video import save_episode_frames

        episode = self._video_episode
        self._video_episode += 1
        if episode % max(1, self._video.every_n_episodes):
            return
        env = self.env.env
        env_state, obs = env.reset(1, generator=generator)
        frames = [self._render_frame(env_state)]
        act_carry = self.learner.act_init(1)
        for _ in range(self._time_limit):
            action, _, act_carry = self.learner.act_step(state, act_carry, obs, self.mode, generator)
            if env.step_draw_dim:
                env_state, obs, _, done, _ = env.step(env_state, action, generator=generator)
            else:
                env_state, obs, _, done, _ = env.step(env_state, action)
            frames.append(self._render_frame(env_state))
            if bool(done[0]):
                break
        save_episode_frames(frames, self._video.dir, episode)

    def evaluate(self, state, key: int) -> dict[str, float]:
        """One evaluation with draws seeded by ``key`` (an int); a recorded
        episode draws from its own generator, seeded by ``key + 7``."""
        generator = torch.Generator(device=self.learner.device).manual_seed(int(key))
        if self.host:
            return self._host_eval(state, generator)
        out = self._device_eval(state, generator)
        metrics = dict(zip(out, torch.stack(list(out.values())).tolist()))
        if self._video is not None:
            video_gen = torch.Generator(device=self.learner.device).manual_seed(int(key) + 7)
            self._record_device_episode(state, video_gen)
        return metrics

    def close(self) -> None:
        if self.host:
            self.env.close()
