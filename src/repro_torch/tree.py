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
    _zip_walk(tree, rest, outs)
    return outs


def _zip_walk(node, others, outs) -> None:
    # a module function, not a closure that calls itself: such a closure
    # is a reference cycle, which would keep ``outs`` (an optimizer
    # step's gradients) alive until the garbage collector next runs
    for k, v in node.items():
        sub = [o[k] for o in others]
        if isinstance(v, dict):
            _zip_walk(v, sub, outs)
        else:
            outs[0].append(v)
            for out, x in zip(outs[1:], sub):
                out.append(x)


def split_tree(tree: Dict[str, Any], parts_of: Callable, n: int
               ) -> List[Dict[str, Any]]:
    """``n`` trees out of ``tree``: ``parts_of(path, leaf)`` (path the
    tuple of keys) gives each tree's leaf at that path, None where the
    tree has none; a node left empty is dropped."""
    outs: List[Dict[str, Any]] = [{} for _ in range(n)]
    _split_walk(tree, (), outs, parts_of, n)
    return outs


def _split_walk(node, path, dests, parts_of, n) -> None:
    for k, v in node.items():
        if isinstance(v, dict):
            subs = [{} for _ in range(n)]
            _split_walk(v, path + (k,), subs, parts_of, n)
            for d, sub in zip(dests, subs):
                if sub:
                    d[k] = sub
        else:
            for d, part in zip(dests, parts_of(path + (k,), v)):
                if part is not None:
                    d[k] = part


def items(tree: Dict[str, Any], path: tuple = ()):
    """(path, leaf) of every leaf in leaf order, path the tuple of keys
    (a module generator: recursion through a closure would be a
    reference cycle that keeps what it collects alive until the garbage
    collector runs)."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from items(v, path + (k,))
        else:
            yield path + (k,), v


def unflatten(like: Dict[str, Any], values) -> Dict[str, Any]:
    """A tree shaped like ``like`` holding ``values`` in leaf order."""
    it = iter(values)
    return tree_map(lambda _: next(it), like)
