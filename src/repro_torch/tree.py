"""Nested dicts of tensors (the port's params, optimizer state and
gradients), walked in a fixed order: the reference's pytree helpers for
the one tree shape the port uses."""
from __future__ import annotations

from typing import Any, Callable, Dict, List


def tree_map(fn: Callable, tree: Dict[str, Any], *rest: Dict[str, Any]):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest``; a new nested dict of the results."""
    return {k: tree_map(fn, v, *(r[k] for r in rest)) if isinstance(v, dict)
            else fn(v, *(r[k] for r in rest)) for k, v in tree.items()}


def leaves(tree: Dict[str, Any]) -> List[Any]:
    """The leaves in insertion order (the order ``unflatten`` takes)."""
    out: List[Any] = []
    for v in tree.values():
        out.extend(leaves(v) if isinstance(v, dict) else (v,))
    return out


def unflatten(like: Dict[str, Any], values) -> Dict[str, Any]:
    """A tree shaped like ``like`` holding ``values`` in leaf order."""
    it = iter(values)
    return tree_map(lambda _: next(it), like)
