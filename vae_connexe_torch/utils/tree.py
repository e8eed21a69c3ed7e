"""Maps over nested parameter dataclasses and tuples of them (the port's
pytrees).  None is an empty tree, as in JAX: an absent prior has no
leaves and maps to None."""

from __future__ import annotations

import dataclasses
import functools


@functools.cache
def _fields(cls) -> tuple[str, ...] | None:
    """The field names of a dataclass type, None for a leaf's type; looked
    up once per type (the step wrappers walk a tree on every call)."""
    if not dataclasses.is_dataclass(cls):
        return None
    return tuple(f.name for f in dataclasses.fields(cls))


def tree_leaves(tree) -> list:
    """The tensors of a nested dataclass, in field order (a tuple's in
    its order)."""
    if tree is None:
        return []
    if type(tree) is tuple:
        return [leaf for t in tree for leaf in tree_leaves(t)]
    names = _fields(type(tree))
    if names is None:
        return [tree]
    return [leaf for n in names for leaf in tree_leaves(getattr(tree, n))]


def tree_map(fn, tree, *rest):
    """``fn`` applied leaf by leaf to ``tree`` and the same-shaped ``rest``;
    returns a tree of the same classes."""
    if tree is None:
        return None
    if type(tree) is tuple:
        return tuple(tree_map(fn, t, *(r[i] for r in rest))
                     for i, t in enumerate(tree))
    names = _fields(type(tree))
    if names is None:
        return fn(tree, *rest)
    return type(tree)(**{
        n: tree_map(fn, getattr(tree, n), *(getattr(r, n) for r in rest))
        for n in names})


def stack_trees(trees):
    """Trees of one shape -> one tree whose leaves carry a leading axis
    (a seed axis)."""
    import torch

    return tree_map(lambda *leaves: torch.stack(leaves), *trees)


def unstack_tree(tree, i: int):
    """Entry ``i`` of a tree whose leaves carry a leading axis."""
    return tree_map(lambda t: t[i], tree)


def tree_unflatten(tree, leaves):
    """A tree shaped like ``tree`` holding ``leaves`` (in field order)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)
