"""Training driver, the port of ``surreal_tpu/launch/trainer.py::Trainer``
on one device, for the on-policy learners (PPO, IMPALA). Two drive modes,
chosen by the env family:

- **device mode** (``jax:*`` envs): per iteration, collect a horizon on
  the batched device env, then one ``learn`` (``_device_train_iter``).
  Metrics reach the host only every ``session_config.metrics.every_n_iters``
  iterations; between those reads an iteration makes no host sync.
- **host mode** (gym, dm_control, robosuite): SEED-style batched stepping
  on the host feeding ``learn`` on the card (``_host_train_iter``), in one
  of two loops. ``_host_loop_alternate`` (``topology.overlap_rollouts`` or
  ``engine.overlap_collect`` false) collects, then learns. ``_host_loop_overlap``
  (the default) steps the env for iteration k+1 on a collector thread,
  with its own ``torch.Generator``, while the main thread learns on k; the
  collector acts from the newest published state, at most one update
  behind. Both threads issue work to the same CUDA stream, so the overlap
  hides the host's env stepping, not device work. At the stop boundary
  the in-flight rollout is discarded uncounted; a collector exception is
  raised on the main thread; after a rollback, the rollouts the poisoned
  policy collected (the queued one and the one in flight) are dropped.

``run`` is the reference's: ``SessionHooks`` (metrics, eval, checkpoints,
auto-resume, the interrupt sentinel, the divergence guard) around a
``LoopEngine``. On a rollback the generator is re-seeded from (seed,
rollback count), where the reference folds the count into its keys; the
device env carry is re-initialised, a host env (alternate loop) reset on
a seed moved by the count.

The reference's guards hold: a trajectory policy (it threads an acting
carry through the rollout) needs a device env, and a sequence-parallel
mesh (``topology.mesh.sp > 1``) needs a trajectory policy. Not ported
yet: the dp/sp meshes (an sp mesh over a trajectory policy raises at
``rebind_mesh``).

``algo.autotune`` ('cache' | 'search') is consulted right after the
learner is built (``tune.resolve_autotune``); a decision that applies
tuned knobs rebuilds the learner, and ``run`` records it as a ``tune``
event.
"""

from __future__ import annotations

import functools
import queue as queue_mod
import threading
from collections import deque
from typing import Callable

import numpy as np
import torch

from surreal_tpu_torch.engine import (
    EngineConfig, LoopEngine, LoopState, Outcome, StageSpec, overlap_collect, sideband_stages,
)
from surreal_tpu_torch.envs import is_jax_env, make_env
from surreal_tpu_torch.launch.hooks import HOST_METRICS_WINDOW, SessionHooks, host_metrics, training_env_config
from surreal_tpu_torch.launch.rollout import RolloutCarry, device_rollout, host_rollout, init_device_carry
from surreal_tpu_torch.learners import build_learner
from surreal_tpu_torch.learners.base import check_scan_unroll
from surreal_tpu_torch.session.telemetry import Tracer
from surreal_tpu_torch.tune import resolve_autotune
from surreal_tpu_torch.utils import faults
from surreal_tpu_torch.utils.device import resolve_device

_LEARN_KEYS = (
    "obs", "next_obs", "action", "reward", "done", "terminated", "behavior_logp", "behavior",
)


def derive_seed(seed: int, *parts: int) -> int:
    """A 63-bit seed for ``torch.Generator.manual_seed`` mixed from
    ``seed`` and ``parts`` (the rollback count, an iteration); the port's
    counterpart of ``jax.random.fold_in``."""
    return int(np.random.SeedSequence([int(seed), *map(int, parts)]).generate_state(1, np.uint64)[0] >> 1)


class Trainer:
    """On-policy (PPO, IMPALA) trainer on one device; ``device`` defaults
    to the card and raises without it."""

    def __init__(self, config, device: str | torch.device = "cuda"):
        self.config = config
        self.device = resolve_device(device)
        model = config.learner_config.get("model", None)
        encoder = model.get("encoder", None) if model is not None else None
        if (
            encoder is not None and encoder.get("kind") == "trajectory"
            and not str(config.env_config.name).startswith("jax:")
        ):
            raise ValueError(
                "model.encoder.kind='trajectory' needs a device env "
                "(jax:*): host loops act per-step without the "
                "sequence context carry"
            )
        self.env = make_env(training_env_config(config.env_config), self.device)
        self.device_mode = is_jax_env(self.env)
        self.learner = build_learner(config.learner_config, self.env.specs, self.device)
        # the program autotuner (tune/): consult the per-workload tuning
        # cache (or search, algo.autotune='search'); a non-empty decision
        # rewrites the learner overrides, so rebuild the learner from them
        self.tune_decision = resolve_autotune(config, self.learner.config, self.device)
        if self.tune_decision.applied:
            self.learner = build_learner(config.learner_config, self.env.specs, self.device)
        topo = config.session_config.get("topology", None)
        mesh = topo.get("mesh", None) if topo is not None else None
        if mesh is not None and int(mesh.get("sp", 1)) > 1:
            if not self.learner.requires_act_carry:
                raise ValueError(
                    "topology.mesh sp>1 shards trajectory attention; "
                    "it requires model.encoder.kind='trajectory' "
                    "(memoryless policies have no sequence axis to "
                    "shard — use the dp axis instead)"
                )
            self.learner.rebind_mesh(mesh, "sp")  # raises: not ported yet
        self.horizon = self.learner.config.algo.horizon
        # the rollout scan's unroll in the JAX package: accepted, nothing to
        # unroll in the port's rollout loop (learners/base.py)
        check_scan_unroll(self.learner.config.algo, "rollout_unroll")
        self.num_envs = config.env_config.num_envs
        self.seed = config.session_config.seed
        self.steps_per_iter = self.horizon * self.num_envs

    def _device_train_iter(
        self,
        state,
        carry: RolloutCarry,
        generator: torch.Generator | None = None,
        action_noise: torch.Tensor | None = None,
        reset_draws: torch.Tensor | None = None,
        step_draws: torch.Tensor | None = None,
        perms: torch.Tensor | None = None,
    ):
        """One iteration: rollout then learn. The optional tensors replace
        the draws from ``generator`` (see launch/rollout.py); ``perms`` is
        PPO's (``PPOLearner.learn``) and is passed on only when given."""
        carry, batch = device_rollout(
            self.env, self.learner, state, carry, self.horizon, generator,
            action_noise=action_noise, reset_draws=reset_draws, step_draws=step_draws,
        )
        learn_batch = {k: batch[k] for k in _LEARN_KEYS}
        learn_draws = {} if perms is None else {"perms": perms}
        state, metrics = self.learner.learn(state, learn_batch, generator, **learn_draws)
        n_done = batch["ep_done"].sum()
        ep_return_sum = batch["ep_return"].sum()
        metrics["episode/return"] = torch.where(
            n_done > 0, ep_return_sum / torch.clamp_min(n_done, 1), torch.nan
        )
        metrics["episode/count"] = n_done.to(torch.float32)
        return state, carry, metrics

    def init_loop_state(
        self, generator: torch.Generator | None = None, reset_draws: torch.Tensor | None = None
    ) -> RolloutCarry:
        return init_device_carry(self.env, self.num_envs, generator, reset_draws)

    def run(
        self,
        max_env_steps: int | None = None,
        on_metrics: Callable[[int, dict], object] | None = None,
    ):
        """Train until ``max_env_steps`` (default: session total_env_steps).

        Returns (final_state, last_metrics). ``on_metrics(iteration, dict)``
        fires every ``metrics.every_n_iters`` iterations with host floats;
        returning truthy from it stops training.
        """
        cfg = self.config.session_config
        total = max_env_steps or cfg.total_env_steps
        state = self.learner.init(torch.Generator().manual_seed(self.seed))
        faults.configure_from(cfg)  # install (or reset) the run's fault plan
        hooks = SessionHooks(self.config, self.learner)
        try:
            state, iteration, env_steps = hooks.restore(state)
            hooks.begin_run(iteration, env_steps)
            if self.tune_decision.mode != "off":
                hooks.tune_event(**self.tune_decision.telemetry())
            loop = self._device_loop
            if not self.device_mode:
                loop = self._host_loop_overlap if overlap_collect(cfg) else self._host_loop_alternate
            ls = loop(state, iteration, env_steps, total, hooks, on_metrics)
            hooks.final_checkpoint(ls.iteration, ls.env_steps, ls.state)
            return ls.state, hooks.last_metrics
        finally:
            hooks.close()

    # -- device (fused) loop -------------------------------------------------
    def _device_loop(self, state, iteration, env_steps, total, hooks, on_metrics) -> LoopState:
        generator = torch.Generator(device=self.device).manual_seed(self.seed)
        carry = self.init_loop_state(generator)
        # the env carry is updated in place, so a deferred boundary
        # reads a clone of the state (engine/core.py)
        stages = (StageSpec("collect", donate=True), StageSpec("learn", donate=True)) + sideband_stages()

        def step(ls):
            # unfenced span: the time to issue the iteration
            with hooks.tracer.span("train_iter"):
                ls.state, ls.extras["carry"], metrics = hooks.count_program(
                    "train_iter", self._device_train_iter, ls.state, ls.extras["carry"], ls.key,
                    phase="train_iter",
                )
            return Outcome(metrics=metrics, steps=self.steps_per_iter, hook_key=self._hook_key(ls))

        def on_rollback(ls):
            self._rollback(ls, hooks)
            ls.extras["carry"] = self.init_loop_state(ls.key)

        engine = LoopEngine(
            hooks, total, step, stages, EngineConfig.from_session(self.config.session_config),
            on_metrics=on_metrics, apply_fault=self._apply_fault, on_rollback=on_rollback,
        )
        return engine.run(LoopState(
            state=state, key=generator, iteration=iteration, env_steps=env_steps,
            extras={"carry": carry, "nonce": 0},
        ))

    def _apply_fault(self, ls, f):
        ls.state = faults.apply_trainer_fault(f, ls.state)

    def _rollback(self, ls, hooks):
        """Restore the last finite checkpoint and re-seed the offending
        batch: a deterministic workload must not replay into the same
        divergence."""
        rb = hooks.recovery.rollback(ls.state, fresh=self._fresh_init)
        ls.state, ls.iteration, ls.env_steps = rb.state, rb.iteration, rb.env_steps
        ls.extras["nonce"] = rb.nonce
        ls.key = torch.Generator(device=self.device).manual_seed(derive_seed(self.seed, rb.nonce))
        return rb

    def _hook_key(self, ls) -> int:
        """The boundary's own seed (eval draws) for the iteration ``ls`` is
        about to count."""
        return derive_seed(self.seed, ls.extras["nonce"], ls.iteration + 1)

    # -- host-env loops ------------------------------------------------------
    def _host_train_iter(
        self,
        state,
        obs: np.ndarray,
        generator: torch.Generator | None = None,
        action_noise: torch.Tensor | None = None,
        perms: torch.Tensor | None = None,
        tracer=None,
        hooks=None,
    ):
        """One host iteration: ``host_rollout`` then ``learn`` on the
        learner's device, each in its ``tracer`` span when one is given.
        The optional tensors replace the draws from ``generator``; ``perms``
        is PPO's. With ``hooks``, the act and the learn go through its
        cost counting. Returns (state, last obs, metrics, episode stats)."""
        span = (tracer or Tracer(None)).span  # a disabled tracer is a no-op
        with span("rollout"):
            obs, batch, ep_stats = host_rollout(
                self.env, self.learner, state, obs, self.horizon, generator, action_noise,
                act=self._counted_act(hooks, self.learner),
            )
        learn_draws = {} if perms is None else {"perms": perms}
        learn = self.learner.learn
        if hooks is not None:
            learn = functools.partial(hooks.count_program, "learn", learn, phase="learn")
        with span("learn"):
            state, metrics = learn(state, batch, generator, **learn_draws)
        return state, obs, metrics, ep_stats

    def _counted_act(self, hooks, actor):
        """``actor.act`` through ``hooks``' cost counting (the 'act'
        program, ``horizon`` calls a 'rollout' span), or None without
        hooks."""
        if hooks is None:
            return None
        return functools.partial(
            hooks.count_program, "act", actor.act, phase="rollout", calls_per_phase=self.horizon
        )

    def _host_stages(self, overlap: bool):
        # nothing is updated in place on the host path (the collector acts
        # from the published state), so a deferred boundary reads the
        # state as it is
        return (
            StageSpec("collect", donate=False, overlap=overlap),
            StageSpec("learn", donate=False),
        ) + sideband_stages()

    def _host_loop_alternate(self, state, iteration, env_steps, total, hooks, on_metrics) -> LoopState:
        """Strict rollout -> learn alternation: the card idles during every
        env step, but the policy lag is exactly zero."""
        obs_holder = [self.env.reset(seed=self.config.env_config.seed)]
        recent_returns: deque = deque(maxlen=HOST_METRICS_WINDOW)

        def step(ls):
            ls.state, obs_holder[0], metrics, ep_stats = self._host_train_iter(
                ls.state, obs_holder[0], ls.key, tracer=hooks.tracer, hooks=hooks
            )
            recent_returns.extend(ep_stats["returns"])
            return Outcome(
                metrics=host_metrics(metrics, recent_returns), steps=self.steps_per_iter,
                hook_key=self._hook_key(ls),
            )

        def on_rollback(ls):
            rb = self._rollback(ls, hooks)
            # a NaN policy steps the env into garbage: reset it on a
            # rollback-distinct seed
            obs_holder[0] = self.env.reset(seed=self.config.env_config.seed + rb.nonce)

        engine = LoopEngine(
            hooks, total, step, self._host_stages(False), EngineConfig.from_session(self.config.session_config),
            on_metrics=on_metrics, apply_fault=self._apply_fault, on_rollback=on_rollback,
        )
        return engine.run(LoopState(
            state=state, key=torch.Generator(device=self.device).manual_seed(self.seed),
            iteration=iteration, env_steps=env_steps, extras={"nonce": 0},
        ))

    def _host_loop_overlap(self, state, iteration, env_steps, total, hooks, on_metrics) -> LoopState:
        """Double-buffered host loop: a collector thread steps the env for
        iteration k+1 while the main thread learns on k. The collector
        reads the acting state once per rollout (one behaviour policy per
        batch, recorded in behavior_logp), at most one update behind. At
        the stop boundary one in-flight rollout may be discarded; its env
        steps are not counted. Each rollout carries the rollback generation
        of the state it acted with, and the learner drops those from before
        the last rollback (the queued one and the one in flight)."""
        # the collector reads the newest (state, generation); the main thread writes
        act_holder = [(state, 0)]
        generation = [0]
        out: queue_mod.Queue = queue_mod.Queue(maxsize=1)
        stop_evt = threading.Event()
        tracer = hooks.tracer  # thread-safe; the collector spans "rollout"
        collect_gen = torch.Generator(device=self.device).manual_seed(derive_seed(self.seed, 1))
        actor = self.learner.acting_copy()  # the collector's own modules, made before it starts
        act = self._counted_act(hooks, actor)

        def collect():
            obs = self.env.reset(seed=self.config.env_config.seed)
            try:
                while not stop_evt.is_set():
                    a_state, gen = act_holder[0]
                    with tracer.span("rollout"):
                        obs, batch, ep_stats = host_rollout(
                            self.env, actor, a_state, obs, self.horizon, collect_gen, act=act
                        )
                    while not stop_evt.is_set():
                        try:
                            out.put((gen, batch, ep_stats), timeout=0.2)
                            break
                        except queue_mod.Full:
                            continue
            except BaseException as e:  # surface env and act crashes to the main thread
                out.put(e)

        collector = threading.Thread(target=collect, daemon=True, name="host-collector")
        collector.start()
        recent_returns: deque = deque(maxlen=HOST_METRICS_WINDOW)

        def step(ls):
            with tracer.span("chunk-wait"):
                while True:
                    got = out.get()
                    if isinstance(got, BaseException):
                        raise got
                    gen, batch, ep_stats = got
                    if gen == generation[0]:
                        break
            with tracer.span("learn"):
                ls.state, metrics = hooks.count_program(
                    "learn", self.learner.learn, ls.state, batch, ls.key, phase="learn"
                )
            act_holder[0] = (ls.state, generation[0])
            recent_returns.extend(ep_stats["returns"])
            return Outcome(
                metrics=host_metrics(metrics, recent_returns), steps=self.steps_per_iter,
                hook_key=self._hook_key(ls),
            )

        def apply_fault(ls, f):
            self._apply_fault(ls, f)
            act_holder[0] = (ls.state, generation[0])

        def on_rollback(ls):
            self._rollback(ls, hooks)
            # the collector acts healthy again; what the poisoned policy
            # collected is dropped as it arrives. Its own env obs cannot be
            # reset from here, so a run whose env state went nonfinite
            # re-trips and exhausts the bounded budget
            generation[0] += 1
            act_holder[0] = (ls.state, generation[0])

        try:
            engine = LoopEngine(
                hooks, total, step, self._host_stages(True), EngineConfig.from_session(self.config.session_config),
                on_metrics=on_metrics, apply_fault=apply_fault, on_rollback=on_rollback,
            )
            return engine.run(LoopState(
                state=state, key=torch.Generator(device=self.device).manual_seed(self.seed),
                iteration=iteration, env_steps=env_steps, extras={"nonce": 0},
            ))
        finally:
            stop_evt.set()
            while True:  # unblock a collector waiting on the full queue
                try:
                    out.get_nowait()
                except queue_mod.Empty:
                    break
            collector.join(timeout=30)

    def _fresh_init(self, nonce: int):
        """The divergence guard's fallback when no finite checkpoint exists:
        an init keyed by the rollback count."""
        return self.learner.init(torch.Generator().manual_seed(derive_seed(self.seed, nonce)))
