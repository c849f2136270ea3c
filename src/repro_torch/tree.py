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


def zip_leaves(tree: Dict[str, Any], *rest: Dict[str, Any]
               ) -> List[List[Any]]:
    """The leaves of ``tree`` and the matching leaves of each of ``rest``
    (matched by key, as ``tree_map`` matches them), one list a tree, in
    ``tree``'s leaf order: one walk, no tree built on the way."""
    outs: List[List[Any]] = [[] for _ in range(1 + len(rest))]

    def walk(node, others):
        for k, v in node.items():
            sub = [o[k] for o in others]
            if isinstance(v, dict):
                walk(v, sub)
            else:
                outs[0].append(v)
                for out, x in zip(outs[1:], sub):
                    out.append(x)

    walk(tree, rest)
    return outs


def split_tree(tree: Dict[str, Any], parts_of: Callable, n: int
               ) -> List[Dict[str, Any]]:
    """``n`` trees out of ``tree``: ``parts_of(path, leaf)`` (path the
    tuple of keys) gives each tree's leaf at that path, None where the
    tree has none; a node left empty is dropped."""
    outs: List[Dict[str, Any]] = [{} for _ in range(n)]

    def walk(node, path, dests):
        for k, v in node.items():
            if isinstance(v, dict):
                subs = [{} for _ in range(n)]
                walk(v, path + (k,), subs)
                for d, sub in zip(dests, subs):
                    if sub:
                        d[k] = sub
            else:
                for d, part in zip(dests, parts_of(path + (k,), v)):
                    if part is not None:
                        d[k] = part

    walk(tree, (), outs)
    return outs


def unflatten(like: Dict[str, Any], values) -> Dict[str, Any]:
    """A tree shaped like ``like`` holding ``values`` in leaf order."""
    it = iter(values)
    return tree_map(lambda _: next(it), like)
