"""Nested-state helpers for the port's explicit states: NamedTuples (the
learner, optimizer and replay states), dicts with string keys (params,
replay storage) and lists or tuples, down to leaves (tensors, Python
scalars, None). The port's counterpart of the ``jax.tree`` functions the
reference's session layer uses.

A leaf's path is its keys joined with ``/`` (``opt_state/mu/actor.layers.0.weight``),
so a dict key may not hold a ``/``.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator

import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(node) -> Iterator[tuple[str, Any]] | None:
    if _is_namedtuple(node):
        return ((f, getattr(node, f)) for f in node._fields)
    if isinstance(node, dict):
        for k in node:
            if not isinstance(k, str) or "/" in k:
                raise ValueError(f"state dict key {k!r} is not a string without '/'")
        return iter(node.items())
    if isinstance(node, (list, tuple)):
        return ((str(i), x) for i, x in enumerate(node))
    return None


def _rebuild(node, values: list):
    if _is_namedtuple(node):
        return type(node)(*values)
    if isinstance(node, dict):
        return dict(zip(node.keys(), values))
    return type(node)(values)


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """``tree`` with ``fn`` applied to every leaf, structure kept."""
    kids = _children(tree)
    if kids is None:
        return fn(tree)
    return _rebuild(tree, [tree_map(fn, x) for _, x in kids])


def tree_flatten(tree: Any, prefix: str = "") -> dict[str, Any]:
    """``{path: leaf}`` in tree order."""
    kids = _children(tree)
    if kids is None:
        return {prefix: tree}
    out: dict[str, Any] = {}
    for k, x in kids:
        out.update(tree_flatten(x, f"{prefix}/{k}" if prefix else k))
    return out


def tree_unflatten(template: Any, flat: dict[str, Any], prefix: str = "") -> Any:
    """The structure of ``template`` with leaves looked up in ``flat``
    by path (``tree_flatten``'s inverse)."""
    kids = _children(template)
    if kids is None:
        return flat[prefix]
    return _rebuild(
        template, [tree_unflatten(x, flat, f"{prefix}/{k}" if prefix else k) for k, x in kids]
    )


def tensor_leaves(tree: Any) -> list[torch.Tensor]:
    return [x for x in tree_flatten(tree).values() if isinstance(x, torch.Tensor)]
