"""Base config trees, copied key for key from the JAX package's
``surreal_tpu/session/default_configs.py`` so that one config tree drives
both packages (the port imports no module of the JAX package). The JAX
file documents each key; the port reads only the keys of the PPO device
path and accepts, and ignores, the rest.
"""

from __future__ import annotations

from surreal_tpu_torch.session.config import REQUIRED, Config

BASE_LEARNER_CONFIG = Config(
    algo=Config(
        name=REQUIRED,
        gamma=0.99,
        n_step=1,
        use_obs_filter=True,
        max_staleness=None,
        autotune="off",
        # lax.scan unrolls of the JAX package (its autotuner searches
        # them): the rollout scan, and the time recurrences of GAE and
        # V-trace. Accepted with any value the reference accepts; eager
        # PyTorch has no scan to unroll, so they change nothing here
        # (learners/base.py::check_scan_unroll).
        rollout_unroll=1,
        gae_unroll=1,
        precision="mixed",
    ),
    model=Config(
        actor_hidden=(64, 64),
        critic_hidden=(64, 64),
        activation="tanh",
        encoder=Config(
            kind="auto",
            features=64,
            num_layers=2,
            num_heads=4,
            head_dim=16,
            act_impl="kv",
            max_len=4096,
        ),
        cnn=Config(
            enabled=False,
            channels=(32, 64, 64),
            kernels=(8, 4, 3),
            strides=(4, 2, 1),
            dense=512,
        ),
        dtype="auto",
        compute_dtype="auto",
    ),
    optimizer=Config(
        name="adam",
        lr=3e-4,
        max_grad_norm=0.5,
        lr_schedule="constant",
        loss_scaling=Config(
            enabled="auto",
            init=2.0**15,
            growth_interval=2000,
            growth_factor=2.0,
            backoff_factor=0.5,
            min=1.0,
            max=2.0**24,
        ),
    ),
    replay=Config(
        kind="fifo",
        remote_kind="uniform",
        capacity=100_000,
        start_sample_size=1_000,
        batch_size=256,
        priority_alpha=0.6,
        priority_beta0=0.4,
        priority_eps=1e-6,
    ),
)

BASE_ENV_CONFIG = Config(
    name=REQUIRED,
    num_envs=1,
    action_repeat=1,
    frame_stack=1,
    grayscale=False,
    image_size=None,
    pixel_obs=False,
    flatten_obs=True,
    time_limit=None,
    video=Config(enabled=False, dir=None, every_n_episodes=50),
    seed=0,
)

BASE_SESSION_CONFIG = Config(
    folder=REQUIRED,
    backend="tpu",
    topology=Config(
        mesh=Config(dp=-1, tp=1),
        num_env_workers=0,
        worker_mode="thread",
        transport="auto",
        pipeline_workers=True,
        worker_silence_s=120.0,
        respawn_backoff_s=0.5,
        respawn_backoff_cap_s=30.0,
        sanitize_obs=True,
        experience_plane=Config(
            enabled=False,
            num_shards=2,
            shard_mode="thread",
            transport="auto",
            insert_slots=4,
            watermark_timeout_s=5.0,
            ack_timeout_s=5.0,
            sample_timeout_s=10.0,
            fifo_depth=64,
            respawn_backoff_s=0.5,
            respawn_backoff_cap_s=30.0,
        ),
        inference_fleet=Config(
            replicas=1,
            min_replicas=1,
            max_replicas=4,
            autoscale=False,
            scale_up_serve_ms=40.0,
            scale_down_serve_ms=5.0,
            scale_cooldown_s=30.0,
            respawn_backoff_s=0.5,
            respawn_backoff_cap_s=30.0,
            act_history=8,
        ),
        gateway=Config(
            enabled=False,
            bind=None,
            max_sessions=256,
            lease_s=30.0,
            act_cache=256,
            pin_versions=True,
            tenant_quotas=Config(
                default=Config(
                    max_sessions=64,
                    rate=200.0,
                    burst=400.0,
                    queue_depth=64,
                ),
            ),
            respawn_backoff_s=0.5,
            respawn_backoff_cap_s=30.0,
        ),
        overlap_rollouts=True,
        multihost=Config(
            coordinator=None,
            num_processes=None,
            process_id=None,
        ),
    ),
    total_env_steps=1_000_000,
    compile_cache_dir=None,
    tuning_cache_dir=None,
    checkpoint=Config(
        every_n_iters=500,
        keep_last=3,
        keep_best=True,
        restore_from=None,
        auto_resume=True,
        include_replay=False,
    ),
    recovery=Config(
        interrupt=True,
        on_divergence="rollback",
        max_rollbacks=3,
        lr_backoff=0.5,
        min_lr_scale=0.05,
        grad_norm_limit=None,
        heal_after_windows=20,
    ),
    faults=Config(plan=None),
    metrics=Config(
        every_n_iters=10,
        tensorboard=True,
        console=True,
    ),
    telemetry=Config(
        enabled=True,
        heartbeat_every_s=10.0,
        max_log_mb=256,
    ),
    ops=Config(
        enabled=True,
        ring=64,
        min_dump_interval_s=5.0,
    ),
    slo=Config(
        enabled=True,
        budget_windows=20,
        budget=0.2,
        act_rtt_p99_ms=None,
        attach_p99_ms=None,
        throttle_rate=None,
        staleness_updates=None,
    ),
    watchdog=Config(
        enabled=True,
        warmup=8,
        window=32,
        mad_k=6.0,
        min_rel=0.25,
        sustain=2,
        queue_depth_max=512.0,
        respawn_burst=2,
        growth_windows=2,
        staleness_growth_windows=4,
        staleness_floor=64.0,
        regression_frac=0.5,
        regression_sustain=3,
        baseline_dir=None,
        close_windows=5,
        evidence_window_s=120.0,
        update_every=5,
        max_captures=4,
        capture_cooldown_s=60.0,
    ),
    remediate=Config(
        enabled=True,
        max_actions=8,
        cooldown_s=30.0,
        verify_windows=4,
        regress_margin=0.1,
        throttle_factor=0.5,
        min_rate=1.0,
        shed_rate=50.0,
    ),
    eval=Config(
        every_n_iters=100,
        episodes=5,
        mode="deterministic",
        max_steps=None,
    ),
    perf=Config(
        enabled=True,
        peak_flops=None,
        peak_membw=None,
        memory_analysis="auto",
    ),
    profile=Config(
        trigger_file=True,
        num_iters=5,
        slow_iter_factor=None,
        max_auto_captures=2,
    ),
    profiler=Config(
        enabled=False,
        start_iter=20,
        num_iters=5,
    ),
    publish=Config(
        enabled=False,
        every_n_iters=1,
        bind="tcp://127.0.0.1:*",
        fanout=Config(
            enabled=False,
            wire="f32",
            delta=True,
            ack_ttl_s=60.0,
        ),
    ),
    seed=0,
)

def base_config() -> Config:
    """The three-tree default bundle.
    ``learner_config`` is deliberately EMPTY here: the learner tree layers
    as user-overrides -> per-algorithm defaults -> BASE_LEARNER_CONFIG
    inside ``learners.build_learner``. Materializing BASE defaults into the
    user tree at bundle time would turn them into explicit "user" values
    that silently stomp per-algorithm defaults (e.g. IMPALA's lr)."""
    return Config(
        learner_config=Config(),
        env_config=BASE_ENV_CONFIG,
        session_config=BASE_SESSION_CONFIG,
    )
