"""Parameter trees of the port: nested dicts, lists and tuples of tensors
(``None`` leaves are kept as they are).  The reference uses JAX pytrees;
these two helpers are what the optimizer, the trainer and the checkpoint
store need of them.  Dicts are walked in insertion order, so two trees
built the same way flatten alike."""

from __future__ import annotations

from typing import Any, Callable


def leaves(tree) -> list:
    """The non-container leaves of ``tree`` (``None`` skipped), in order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [] if tree is None else [tree]


def tree_map(fn: Callable[..., Any], tree, *rest):
    """``fn`` over the leaves of ``tree`` and the congruent ``rest``; the
    result has ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return None if tree is None else fn(tree, *rest)


def unflatten(tree, flat: list):
    """A tree of ``tree``'s structure holding ``flat`` (one per leaf, in
    ``leaves`` order)."""
    it = iter(flat)
    out = tree_map(lambda _: next(it), tree)
    if next(it, None) is not None:
        raise ValueError("more values than leaves")
    return out
