"""Checkpoint and resume, the port of ``surreal_tpu/session/checkpoint.py``
(``PrecisionMismatchError``, ``check_precision_metadata``,
``CheckpointManager``, ``make_checkpoint_manager``), on ``torch.save`` in
place of orbax.

What is saved is the learner state (params, optimizer state, obs
normalizer, adaptive scalars) and the run position (iteration, env
steps); env carries are not, as in the reference: a resumed run resets
its envs. The off-policy trainer may add its replay as a step-aligned
extra tree (``checkpoint.include_replay``).

Layout under ``<session folder>/checkpoints/`` (the reference's):

    <step>/state.pt        one per saved step, pruned to ``keep_last``
    best/state.pt          the state with the best ``best_key`` so far
    best_metric.json       that value and its step
    run_meta.json          the precision policy of the run that saves here
    extra/<step>/state.pt  the extra tree of a step, pruned alike

A ``state.pt`` holds a flat ``{tree path: CPU tensor}`` dict, the
non-tensor leaves (the replay ring's host cursor and size) and the meta
dict; no NamedTuple is pickled, and it loads with
``torch.load(weights_only=True)``. Restore rebuilds it into the
structure, dtypes and devices of a template state (the port's
counterpart of orbax's template restore): a leaf whose shape or dtype
differs from the template's raises, nothing is cast.

Every write goes to a temporary directory (or file) first and is then
renamed into place, so a kill mid-save leaves the previous steps as they
were and no half-written step. ``restore`` walks the steps from the
newest and falls back past a step that fails to load.
"""

from __future__ import annotations

import json
import os
import shutil
import uuid
from typing import Any

import torch

from surreal_tpu_torch.utils.tree import tree_flatten, tree_unflatten

STATE_FILE = "state.pt"
_TMP_PREFIX = ".tmp-"


class PrecisionMismatchError(ValueError):
    """A checkpoint was saved under another precision policy than the one
    restoring it; the message names both and the fix."""


def check_precision_metadata(recorded: dict | None, active: dict | None) -> None:
    """Raise :class:`PrecisionMismatchError` when a checkpoint's recorded
    precision metadata disagrees with the active policy. Missing metadata
    on either side passes."""
    if not recorded or not active:
        return
    mismatched = {
        k: (recorded.get(k), active.get(k))
        for k in ("policy", "param_dtype", "loss_scaling", "compute_dtype", "data_dtype", "fp8")
        if k in recorded and recorded.get(k) != active.get(k)
    }
    if mismatched:
        detail = ", ".join(f"{k}: checkpoint={a!r} vs active={b!r}" for k, (a, b) in sorted(mismatched.items()))
        raise PrecisionMismatchError(
            "checkpoint was saved under a different precision policy "
            f"({detail}). Set algo.precision (and optimizer.loss_scaling) "
            "to match the checkpoint to resume it, or point "
            "session.folder at a fresh directory to train under the new "
            "policy from scratch."
        )


def _payload(tree: Any, meta: dict | None) -> dict:
    """The saved form of ``tree``: tensors copied to the host now (the
    caller's state may be updated in place right after), other leaves as
    they are."""
    tensors, leaves = {}, {}
    for path, x in tree_flatten(tree).items():
        if isinstance(x, torch.Tensor):
            tensors[path] = x.detach().to("cpu", copy=True)
        elif x is None or isinstance(x, (bool, int, float, str)):
            leaves[path] = x
        else:
            raise TypeError(f"checkpoint leaf {path!r} of type {type(x).__name__} is not savable")
    return {"tensors": tensors, "leaves": leaves, "meta": meta}


def _restore_into(template: Any, payload: dict) -> Any:
    """``payload``'s leaves in ``template``'s structure, on each template
    tensor's device; shapes, dtypes and leaf kinds must match."""
    tensors, leaves = payload["tensors"], payload["leaves"]
    flat = tree_flatten(template)
    saved = set(tensors) | set(leaves)
    if saved != set(flat):
        missing, extra = sorted(set(flat) - saved), sorted(saved - set(flat))
        raise ValueError(f"checkpoint structure differs from the template: missing {missing[:5]}, extra {extra[:5]}")
    out = {}
    for path, want in flat.items():
        if isinstance(want, torch.Tensor):
            got = tensors.get(path)
            if got is None:
                raise ValueError(f"checkpoint leaf {path!r} is not a tensor; the template's is")
            if got.shape != want.shape or got.dtype != want.dtype:
                raise ValueError(
                    f"checkpoint leaf {path!r} is {got.dtype}{list(got.shape)}; "
                    f"the template's is {want.dtype}{list(want.shape)}"
                )
            out[path] = got.to(want.device)
        else:
            if path not in leaves:
                raise ValueError(f"checkpoint leaf {path!r} is a tensor; the template's is not")
            out[path] = leaves[path]
    return tree_unflatten(template, out)


def _write_file(path: str, payload: dict) -> None:
    with open(path, "wb") as f:
        torch.save(payload, f)
        f.flush()
        os.fsync(f.fileno())


def _load(path: str) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True)


def _write_json(path: str, obj) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


class _StepDirs:
    """Numbered step directories under one root, each written atomically
    (a temporary directory renamed into place) and pruned to the newest
    ``keep_last``. As with orbax's manager, a save at a step not above the
    newest saved one is skipped."""

    def __init__(self, root: str, keep_last: int):
        self.root = root
        self.keep_last = keep_last
        os.makedirs(root, exist_ok=True)
        for name in os.listdir(root):  # left by a kill mid-save
            if name.startswith(_TMP_PREFIX):
                shutil.rmtree(os.path.join(root, name), ignore_errors=True)

    def steps(self) -> list[int]:
        return sorted(
            int(n) for n in os.listdir(self.root) if n.isdigit() and os.path.isdir(os.path.join(self.root, n))
        )

    def latest(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def path(self, step: int) -> str:
        return os.path.join(self.root, str(step), STATE_FILE)

    def save(self, step: int, payload: dict) -> bool:
        latest = self.latest()
        if latest is not None and step <= latest:
            return False
        tmp = os.path.join(self.root, f"{_TMP_PREFIX}{step}-{uuid.uuid4().hex[:8]}")
        os.makedirs(tmp)
        _write_file(os.path.join(tmp, STATE_FILE), payload)
        os.replace(tmp, os.path.join(self.root, str(step)))
        if self.keep_last and self.keep_last > 0:
            for old in self.steps()[: -self.keep_last]:
                shutil.rmtree(os.path.join(self.root, str(old)), ignore_errors=True)
        return True


class CheckpointManager:
    """Save and restore learner state with keep-last-N and keep-best
    retention. ``on_event(type, **fields)`` is an optional telemetry sink
    (the session tracer's ``event``) for restore-fallback decisions."""

    def __init__(self, folder: str, keep_last: int = 3, keep_best: bool = True,
                 best_key: str = "episode/return", on_event=None):
        self._on_event = on_event
        self.directory = os.path.join(os.path.abspath(folder), "checkpoints")
        self.keep_best = keep_best
        self.best_key = best_key
        self._keep_last = keep_last
        self._steps = _StepDirs(self.directory, keep_last)
        self._extra_steps: _StepDirs | None = None
        self._best_dir = os.path.join(self.directory, "best")
        self._best_meta_path = os.path.join(self.directory, "best_metric.json")
        self._run_meta_path = os.path.join(self.directory, "run_meta.json")

    def _extra(self) -> _StepDirs:
        """Step-aligned auxiliary state (the replay) in its own tree under
        ``extra/``, so the main payload keeps one shape across configs."""
        if self._extra_steps is None:
            self._extra_steps = _StepDirs(os.path.join(self.directory, "extra"), self._keep_last)
        return self._extra_steps

    # -- save ----------------------------------------------------------------
    def save(self, step: int, state: Any, *, env_steps: int = 0, metrics: dict[str, float] | None = None) -> None:
        """Persist ``state`` at ``step``; update best/ when the tracked
        metric improves."""
        payload = _payload(state, {"iteration": int(step), "env_steps": int(env_steps)})
        self._steps.save(step, payload)
        if not (self.keep_best and metrics):
            return
        value = metrics.get(self.best_key)
        if value is None or value != value:  # absent or NaN
            return
        best = self.best_metric()
        if best is not None and value <= best["value"]:
            return
        os.makedirs(self._best_dir, exist_ok=True)
        best_path = os.path.join(self._best_dir, STATE_FILE)
        _write_file(best_path + ".tmp", payload)
        os.replace(best_path + ".tmp", best_path)
        _write_json(self._best_meta_path, {"value": float(value), "step": int(step)})

    def save_extra(self, step: int, tree: Any) -> None:
        """Persist auxiliary state aligned to ``step``."""
        self._extra().save(step, _payload(tree, None))

    def restore_extra(self, template: Any, step: int):
        """The auxiliary tree saved at exactly ``step``, or None when there
        is none (the caller keeps a fresh buffer)."""
        if step not in self._extra().steps():
            return None
        return _restore_into(template, _load(self._extra().path(step)))

    # -- run metadata (the precision policy) ---------------------------------
    def save_run_metadata(self, meta: dict) -> None:
        _write_json(self._run_meta_path, meta)

    def run_metadata(self) -> dict | None:
        """The recorded run metadata; None when absent or torn."""
        if not os.path.exists(self._run_meta_path):
            return None
        try:
            with open(self._run_meta_path) as f:
                return json.load(f)
        except (OSError, json.JSONDecodeError):
            return None

    def check_precision(self, active_meta: dict | None) -> None:
        check_precision_metadata(self.run_metadata(), active_meta)

    # -- restore -------------------------------------------------------------
    def latest_step(self) -> int | None:
        return self._steps.latest()

    def steps(self) -> list[int]:
        """All retained step numbers, ascending (damaged ones included:
        ``restore`` is where damage is found)."""
        return self._steps.steps()

    def best_metric(self) -> dict | None:
        if not os.path.exists(self._best_meta_path):
            return None
        with open(self._best_meta_path) as f:
            try:
                return json.load(f)
            except json.JSONDecodeError:
                return None

    def _restore_step(self, template_state: Any, step: int):
        payload = _load(self._steps.path(step))
        return _restore_into(template_state, payload), payload["meta"]

    def restore(self, template_state: Any, step: int | None = None, validate=None):
        """(state, meta) at ``step`` (default: the newest that restores),
        or None when there is no checkpoint.

        Without ``step``, the walk goes from the newest step to the
        oldest. A step that fails to load (truncated, or not of the
        template's structure) is skipped with a ``recovery`` event of kind
        ``checkpoint_fallback``; a step that ``validate(state)`` rejects is
        skipped with kind ``skipped_nonfinite_checkpoint``. If steps exist
        and none loads, the newest step's error is raised: a failure of
        every step is systemic, and a silent fresh start would overwrite
        the progress the caller asked to resume. If every loadable step
        was rejected, None. An explicit ``step`` raises its own error.
        """
        if step is not None:
            return self._restore_step(template_state, step)
        candidates = sorted(self.steps(), reverse=True)
        first_exc: Exception | None = None
        for i, s in enumerate(candidates):
            try:
                state, meta = self._restore_step(template_state, s)
            except Exception as e:  # torch.load and the rebuild raise per kind of damage
                if first_exc is None:
                    first_exc = e
                if self._on_event is not None and i < len(candidates) - 1:
                    self._on_event(
                        "recovery", kind="checkpoint_fallback", bad_step=int(s),
                        next_step=int(candidates[i + 1]), error=f"{type(e).__name__}: {e}"[:200],
                    )
                continue
            if validate is not None and not validate(state):
                if self._on_event is not None:
                    self._on_event("recovery", kind="skipped_nonfinite_checkpoint", step=int(s))
                continue
            return state, meta
        if first_exc is not None:
            raise first_exc
        return None

    def restore_best(self, template_state: Any):
        """The keep-best snapshot as (state, meta); None when absent."""
        if self.best_metric() is None:
            return None
        payload = _load(os.path.join(self._best_dir, STATE_FILE))
        return _restore_into(template_state, payload), payload["meta"]


def make_checkpoint_manager(session_config, on_event=None) -> CheckpointManager | None:
    """From ``session_config.checkpoint``; None when disabled
    (``every_n_iters`` <= 0)."""
    ck = session_config.checkpoint
    if not ck.every_n_iters or ck.every_n_iters <= 0:
        return None
    return CheckpointManager(
        session_config.folder, keep_last=ck.keep_last, keep_best=ck.keep_best, on_event=on_event,
    )
