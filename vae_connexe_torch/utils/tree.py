"""Maps over nested parameter dataclasses (the port's pytrees)."""

from __future__ import annotations

import dataclasses


def tree_leaves(tree) -> list:
    """The tensors of a nested dataclass, in field order."""
    if dataclasses.is_dataclass(tree):
        return [leaf for f in dataclasses.fields(tree)
                for leaf in tree_leaves(getattr(tree, f.name))]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` applied leaf by leaf to ``tree`` and the same-shaped ``rest``;
    returns a tree of the same classes."""
    if dataclasses.is_dataclass(tree):
        return type(tree)(**{
            f.name: tree_map(fn, getattr(tree, f.name),
                             *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree)})
    return fn(tree, *rest)


def tree_unflatten(tree, leaves):
    """A tree shaped like ``tree`` holding ``leaves`` (in field order)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)
