"""Nested-dict parameter trees: the reference's pytrees of arrays become
dicts of tensors with the same keys.  Leaves are visited in sorted key
order, as ``jax.tree.leaves`` visits a dict, so flat layouts (the wire's
payload vector, its error-feedback residual) line up with the reference's."""

from __future__ import annotations

from typing import Callable, List

import torch


def leaves(tree) -> List:
    """The leaves of ``tree`` in sorted key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [tree]


def map_(fn: Callable, tree, *rest):
    """``fn`` applied leaf by leaf over trees of one structure."""
    if isinstance(tree, dict):
        return {k: map_(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def unflatten(like, values):
    """A tree shaped like ``like`` whose leaves are ``values``, taken in
    sorted key order (the inverse of ``leaves``)."""
    it = iter(values)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)

    return build(like)


def pick(tree, i: int):
    """Element ``i`` of every tuple leaf: splits a tree of tuples (what
    ``map_`` gives for a function with several results) into trees."""
    return {k: pick(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def ravel(tree) -> torch.Tensor:
    """The leaves laid end to end as one f32 vector, in sorted key order
    (the wire's payload layout)."""
    return torch.cat([l.reshape(-1).float() for l in leaves(tree)])


def unravel(like, flat: torch.Tensor):
    """The inverse of ``ravel``: a tree shaped like ``like`` from the first
    elements of ``flat``, each leaf cast to ``like``'s dtype."""
    ls = leaves(like)
    sizes = [l.numel() for l in ls]
    parts = torch.split(flat[:sum(sizes)], sizes)
    return unflatten(like, [p.reshape(l.shape).to(l.dtype)
                            for p, l in zip(parts, ls)])
