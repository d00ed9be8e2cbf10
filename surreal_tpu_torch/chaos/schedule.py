"""Seeded multi-site fault-schedule generator, the port of
``surreal_tpu/chaos/schedule.py``: the same constants, profiles and draws,
validated against the port's ``utils/faults.py`` registry.

A *schedule* is a campaign-ready fault plan for ``utils/faults.py``: a
list of ``{"site", "kind", "at", "times"[, "ms"]}`` specs drawn over the
site registry's per-site kind vocabulary (``faults.SITE_KINDS``), under
co-fire constraints that keep a short training run survivable-by-design
(the oracles then check that it actually WAS survived correctly):

- no ``sigterm`` (run-ending by contract — the SIGKILL cold-restart
  drill covers process death separately);
- at most ``1 + (intensity > 0)`` kill-kind faults, at most one per
  site (supervisors respawn one corpse at a time deterministically;
  simultaneous multi-kill of the same tier is a soak-mode scenario);
- at most one ``nan_state`` (a rollback is a global restore; two in one
  short run can chain past ``max_rollbacks``), and never together with
  ``kill_stage`` (a boundary crash during a rollback restore makes
  oracle attribution ambiguous — the EXCLUSIVE_GROUPS rule);
- a total injected-delay budget (``sum(ms * times)`` per schedule) so
  delay faults probe timeouts without stalling the run past the test
  budget.

Determinism: the only entropy source is ``random.Random(f"{profile}:
{seed}")`` — string seeding hashes the bytes, not ``PYTHONHASHSEED``,
so a (profile, seed) pair generates the identical schedule in any
process forever. The injector schedules by CALL COUNT, so replaying a
schedule replays the same faults at the same logical points.

Intensity ramps with ``seed % 3``: higher tiers draw more faults, more
repeats, and longer delays — a campaign over consecutive seeds sweeps
gentle -> hostile automatically.

A *profile* names the run topology a schedule is drawn for — the scope
metadata: which sites are actually wired live in that topology (a fault
at a site the run never calls would silently never fire and rot the
campaign's coverage claim).
"""

from __future__ import annotations

import random

from surreal_tpu_torch.utils import faults

# kinds that crash a supervised component (respawned by its supervisor)
KILL_KINDS = frozenset({
    "kill_worker", "kill_shard", "kill_replica", "kill_member",
    "kill_stage",
})

# kinds honoring an "ms" argument
DELAY_KINDS = frozenset({
    "delay", "delay_frame", "delay_stage", "delay_sample", "delay_reply",
    "delay_publish", "delay_fsync",
})

# per-schedule budget on sum(ms * times) across delay faults
DELAY_BUDGET_MS = 1200.0

# (site, kind) pairs that must not co-fire in one schedule
EXCLUSIVE_GROUPS: tuple[frozenset[tuple[str, str]], ...] = (
    frozenset({("trainer.iteration", "nan_state"),
               ("engine.stage", "kill_stage")}),
)

# Per-site scope metadata: the campaign-safe kind subset (excluded:
# sigterm ends the run; gateway.session kill_replica needs an acting
# external session; lgroup.* / param_service.reply need topologies no
# campaign profile builds — their coverage rides the dedicated tests,
# enforced by the import-hygiene fault-site lint) and the call-index
# window 'at' is drawn from, tuned to the profiles' ~600-step runs so a
# drawn fault actually fires (the fault_surfacing oracle then checks
# every in-window entry surfaced as a fault event).
SITE_META: dict[str, dict] = {
    "trainer.iteration": {"kinds": ("delay", "nan_state"), "at": (1, 6)},
    "engine.stage": {"kinds": ("delay_stage", "kill_stage"), "at": (1, 5)},
    "env_worker.step": {"kinds": ("kill_worker", "delay"), "at": (5, 50)},
    "transport.send": {
        "kinds": ("drop_frame", "delay_frame", "corrupt_slab"),
        "at": (5, 80),
    },
    "server.serve": {"kinds": ("delay",), "at": (5, 80)},
    "fleet.replica": {"kinds": ("kill_replica", "delay"), "at": (30, 80)},
    "gateway.session": {"kinds": ("drop_frame", "delay"), "at": (10, 50)},
    "ops.push": {"kinds": ("drop_frame", "delay"), "at": (2, 20)},
    "trace.emit": {"kinds": ("drop_span", "delay"), "at": (1, 10)},
    "watchdog.eval": {"kinds": ("drop_eval", "delay"), "at": (1, 4)},
    "param.publish": {
        "kinds": ("delay_publish", "drop_frame"), "at": (1, 5),
    },
    "experience.shard": {"kinds": ("kill_shard", "delay"), "at": (20, 80)},
    "experience.sample": {"kinds": ("delay_sample",), "at": (1, 8)},
    "experience.send": {
        "kinds": ("corrupt_wire_frame", "drop_frame", "delay_frame"),
        "at": (2, 15),
    },
    "experience.spill": {
        "kinds": ("truncate_segment", "enospc", "delay_fsync"),
        "at": (1, 8),
    },
}

# Campaign profiles: topology scope -> eligible sites. Union spans 15 of
# the reference's 17 registry sites (see SITE_META on the two excluded
# ones; the port's registry has both but ``lgroup.member``).
PROFILES: dict[str, dict] = {
    # SEED serving stack: workers + 2-replica fleet + gateway + versioned
    # fanout publishing, checkpoints on (nan_state needs a rollback target)
    "seed_gateway": {
        "algo": "impala",
        "env": "gym:CartPole-v1",
        "sites": (
            "trainer.iteration", "engine.stage", "env_worker.step",
            "transport.send", "server.serve", "fleet.replica",
            "gateway.session", "ops.push", "trace.emit", "watchdog.eval",
            "param.publish",
        ),
        "nan_ok": True,
    },
    # SEED chunk relay through the sharded experience plane
    "seed_experience": {
        "algo": "impala",
        "env": "gym:CartPole-v1",
        "sites": (
            "trainer.iteration", "engine.stage", "env_worker.step",
            "transport.send", "server.serve", "experience.shard",
            "experience.sample", "experience.send", "ops.push",
            "trace.emit", "watchdog.eval",
        ),
        "nan_ok": False,
    },
    # host off-policy over the remote replay plane with the spill WAL on
    "ddpg_spill": {
        "algo": "ddpg",
        "env": "gym:Pendulum-v1",
        "sites": (
            "trainer.iteration", "engine.stage", "experience.shard",
            "experience.sample", "experience.send", "experience.spill",
            "ops.push", "trace.emit", "watchdog.eval",
        ),
        "nan_ok": False,
    },
}


def _violates_exclusive(chosen: list[dict], site: str, kind: str) -> bool:
    have = {(e["site"], e["kind"]) for e in chosen}
    for group in EXCLUSIVE_GROUPS:
        if (site, kind) in group and have & (group - {(site, kind)}):
            return True
    return False


def generate_schedule(seed: int, profile: str = "seed_gateway") -> dict:
    """Draw one deterministic multi-site schedule for ``(seed, profile)``.

    Returns ``{"seed", "profile", "intensity", "plan"}`` where ``plan``
    validates against :class:`faults.FaultInjector` (site AND kind
    checked) — generation failing validation is a bug, so it is asserted
    here, not left to the run."""
    meta = PROFILES[profile]
    rng = random.Random(f"{profile}:{int(seed)}")
    intensity = int(seed) % 3
    n_faults = 2 + intensity + rng.randrange(2)
    max_kills = 1 + (1 if intensity > 0 else 0)

    sites = list(meta["sites"])
    plan: list[dict] = []
    kills = 0
    nans = 0
    delay_ms_left = DELAY_BUDGET_MS
    # draw sites without replacement first (multi-site by construction),
    # then with replacement if the draw count exceeds the pool
    order = rng.sample(sites, k=min(n_faults, len(sites)))
    while len(order) < n_faults:
        order.append(rng.choice(sites))
    for site in order:
        kinds = [
            k for k in SITE_META[site]["kinds"]
            if not (k in KILL_KINDS and (
                kills >= max_kills
                or any(e["site"] == site and e["kind"] in KILL_KINDS
                       for e in plan)
            ))
            and not (k == "nan_state" and (nans >= 1 or not meta["nan_ok"]))
            and not _violates_exclusive(plan, site, k)
        ]
        if not kinds:
            continue
        kind = rng.choice(kinds)
        lo, hi = SITE_META[site]["at"]
        entry: dict = {
            "site": site, "kind": kind, "at": rng.randint(lo, hi),
            "times": 1,
        }
        if kind in KILL_KINDS:
            kills += 1
        elif kind == "nan_state":
            nans += 1
        else:
            entry["times"] = 1 + rng.randrange(1 + intensity)
        if kind in DELAY_KINDS:
            ms = float(rng.choice((5, 10, 20)) * (1 + intensity))
            if ms * entry["times"] > delay_ms_left:
                entry["times"] = max(1, int(delay_ms_left // ms))
                if ms * entry["times"] > delay_ms_left:
                    continue  # budget exhausted: drop the fault
            delay_ms_left -= ms * entry["times"]
            entry["ms"] = ms
        plan.append(entry)

    # stable order: the schedule is an artifact, not a draw transcript
    plan.sort(key=lambda e: (e["site"], e["kind"], e["at"]))
    faults.FaultInjector(plan)  # raises on any generator/registry drift
    return {
        "seed": int(seed),
        "profile": profile,
        "intensity": intensity,
        "plan": plan,
    }
