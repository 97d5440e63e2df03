"""Parameter trees: the reference's pytrees of arrays become dicts (and
lists or tuples, as FSLSTM's stack of layers) of tensors with the same
keys.  Leaves are visited as ``jax.tree.leaves`` visits them: a dict's in
sorted key order, a list's or tuple's in index order, so flat layouts (the
wire's payload vector, its error-feedback residual) line up with the
reference's."""

from __future__ import annotations

from typing import Callable, List

import torch

_SEQ = (list, tuple)


def leaves(tree) -> List:
    """The leaves of ``tree`` in the reference's order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, _SEQ):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def map_(fn: Callable, tree, *rest):
    """``fn`` applied leaf by leaf over trees of one structure."""
    if isinstance(tree, dict):
        return {k: map_(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, _SEQ):
        return type(tree)(map_(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def _build(node, it):
    if isinstance(node, dict):
        built = {k: _build(node[k], it) for k in sorted(node)}
        return {k: built[k] for k in node}
    if isinstance(node, _SEQ):
        return type(node)(_build(v, it) for v in node)
    return next(it)


def unflatten(like, values):
    """A tree shaped like ``like`` whose leaves are ``values``, taken in the
    order of ``leaves`` (its inverse).  A module-level recursion, not a
    nested one: a nested function that calls itself is a reference cycle,
    which would keep ``values`` (and every tensor in it) alive until the
    garbage collector's next cycle pass."""
    return _build(like, iter(values))


def ravel(tree) -> torch.Tensor:
    """The leaves laid end to end as one f32 vector, in the order of
    ``leaves`` (the wire's payload layout)."""
    return torch.cat([l.reshape(-1).float() for l in leaves(tree)])


def unravel(like, flat: torch.Tensor):
    """The inverse of ``ravel``: a tree shaped like ``like`` from the first
    elements of ``flat``, each leaf cast to ``like``'s dtype."""
    ls = leaves(like)
    sizes = [l.numel() for l in ls]
    parts = torch.split(flat[:sum(sizes)], sizes)
    return unflatten(like, [p.reshape(l.shape).to(l.dtype)
                            for p, l in zip(parts, ls)])
