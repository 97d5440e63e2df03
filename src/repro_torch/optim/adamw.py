"""AdamW and SGD on parameter trees (the reference's ``adamw_update``,
its ZeRO-1 scatter form ``adamw_update_zero1``, and ``sgd_update``).

  state = adamw_init(params)
  params, state = adamw_update(params, grads, state, step, lr=..., ...)

Functional: new tensors out, nothing updated in place.  ``mask`` (a tree
of bools) freezes the leaves where it is ``False``: parameter and both
moments are kept as they are, which is how a client trains its LoRA
leaves only while the quantized base stays frozen (paper C2).

ZeRO-1 (``adamw_update_zero1``): on a mesh whose data axes are live,
``repro_torch.dist.sharding.opt_state_specs`` widens each leaf's spec over
``data`` (+``pod``) on one dim, and each rank keeps only its block of the
f32 moments on that dim (``zero1_shard`` / ``zero1_init``).  The
gradients are replicated, so a rank slices its block of the parameter and
gradient for free, updates it with ``adamw_step_``'s arithmetic, and
all-gathers only the updated parameter block: the one collective of the
update.  The same f32 arithmetic on the same values, so it equals
``adamw_update`` bit for bit.  ``REPRO_ZERO1_SCATTER=0``, or a mesh with
no live data axis, runs ``adamw_update`` instead.
"""

from __future__ import annotations

import os

import torch

from repro_torch import tree as tree_util


def adamw_init(params):
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
    return {"mu": tree_util.map_(zeros, params),
            "nu": tree_util.map_(zeros, params)}


@torch.no_grad()
def adamw_step_(flat_p, flat_g, flat_mu, flat_nu, train, step, *, lr=1e-3,
                b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0) -> None:
    """One AdamW step over lists of leaves, replacing each trained entry of
    ``flat_p``, ``flat_mu`` and ``flat_nu`` by its new tensor and dropping
    its gradient from ``flat_g`` as it goes, so that a caller who owns the
    lists holds one leaf's old and new tensors at a time.  ``train[i]``
    false keeps leaf ``i`` as it is.  step: 1-based; the bias corrections
    are taken in f32, as the reference takes them."""
    step = torch.tensor(float(step), dtype=torch.float32)
    c1 = float(1.0 - torch.tensor(b1, dtype=torch.float32) ** step)
    c2 = float(1.0 - torch.tensor(b2, dtype=torch.float32) ** step)
    for i, on in enumerate(train):
        if not on:
            continue
        p, g32 = flat_p[i], flat_g[i].float()
        flat_g[i] = None
        mu2 = b1 * flat_mu[i] + (1 - b1) * g32
        nu2 = b2 * flat_nu[i] + (1 - b2) * torch.square(g32)
        del g32
        flat_mu[i], flat_nu[i] = mu2, nu2
        delta = (mu2 / c1) / (torch.sqrt(nu2 / c2) + eps)
        if weight_decay > 0:
            delta = delta + weight_decay * p.float()
        flat_p[i] = (p.float() - lr * delta).to(p.dtype)


def adamw_update(params, grads, state, step, *, lr=1e-3, b1=0.9, b2=0.999,
                 eps=1e-8, weight_decay=0.0, mask=None):
    """step: 1-based int.  A leaf whose ``mask`` entry is ``False`` keeps
    its parameter and moments (the same tensors)."""
    flat_p = tree_util.leaves(params)
    train = ([m is not False for m in tree_util.leaves(mask)]
             if mask is not None else [True] * len(flat_p))
    flat_mu = tree_util.leaves(state["mu"])
    flat_nu = tree_util.leaves(state["nu"])
    adamw_step_(flat_p, tree_util.leaves(grads), flat_mu, flat_nu, train,
                step, lr=lr, b1=b1, b2=b2, eps=eps,
                weight_decay=weight_decay)
    return (tree_util.unflatten(params, flat_p),
            {"mu": tree_util.unflatten(params, flat_mu),
             "nu": tree_util.unflatten(params, flat_nu)})


def zero1_scatter_enabled() -> bool:
    """The scatter update is the default on a mesh;
    ``REPRO_ZERO1_SCATTER=0`` falls back to ``adamw_update``."""
    return os.environ.get("REPRO_ZERO1_SCATTER", "1") != "0"


def _spec_leaves(tree) -> list:
    """The leaves of a spec tree (dicts of spec tuples) in the order of
    ``tree_util.leaves`` over the parameter tree."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _spec_leaves(tree[k])]
    return [tree]


def _widen_info(pspec, ospec):
    """Per leaf, in the parameter tree's leaf order: ``(dim, axis entry)``
    where ``opt_state_specs`` widened the param spec over the data axes,
    or None (moments replicated: nothing to scatter)."""
    def info(ps, os_):
        pe = list(ps)
        for d, e in enumerate(os_):
            if e is not None and (d >= len(pe) or pe[d] is None):
                return (d, e)
        return None
    return [info(ps, os_) for ps, os_ in zip(_spec_leaves(pspec),
                                             _spec_leaves(ospec))]


def _zero1_plan(params, mesh) -> list:
    """Per leaf: None, or ``(dim, axes)`` of its scatter."""
    from repro_torch.dist.sharding import opt_state_specs, param_specs
    plan = _widen_info(param_specs(params, mesh),
                       opt_state_specs(params, mesh))
    return [None if wi is None else
            (wi[0], (wi[1],) if isinstance(wi[1], str) else tuple(wi[1]))
            for wi in plan]


def _block(x, wi, mesh):
    """This rank's block of ``x`` on the scattered dim (a view)."""
    from repro_torch.dist.collectives import axis_size, block_index
    if wi is None:
        return x
    d, axes = wi
    ways = 1
    for ax in axes:
        ways *= axis_size(mesh, ax)
    size = x.shape[d] // ways
    return x.narrow(d, block_index(mesh, axes) * size, size)


def zero1_shard(state, params, mesh):
    """This rank's ZeRO-1 blocks of a full moment state (``adamw_init``'s
    or ``adamw_update``'s), each a contiguous copy."""
    plan = _zero1_plan(params, mesh)
    return {name: tree_util.unflatten(params, [
        _block(x, wi, mesh).clone(memory_format=torch.contiguous_format)
        for x, wi in zip(tree_util.leaves(state[name]), plan)])
        for name in ("mu", "nu")}


def zero1_init(params, mesh):
    """Zero moments, this rank's ZeRO-1 blocks only."""
    plan = _zero1_plan(params, mesh)
    return {name: tree_util.unflatten(params, [
        torch.zeros(_block(p, wi, mesh).shape, dtype=torch.float32,
                    device=p.device)
        for p, wi in zip(tree_util.leaves(params), plan)])
        for name in ("mu", "nu")}


def zero1_gather(state, params, mesh):
    """The full moments from every rank's blocks (an all-gather a
    scattered leaf)."""
    from repro_torch.dist.collectives import all_gather
    plan = _zero1_plan(params, mesh)
    return {name: tree_util.unflatten(params, [
        x if wi is None else all_gather(x, mesh, wi[1], dim=wi[0])
        for x, wi in zip(tree_util.leaves(state[name]), plan)])
        for name in ("mu", "nu")}


def adamw_update_zero1(params, grads, state, step, *, mesh, lr=1e-3, b1=0.9,
                       b2=0.999, eps=1e-8, weight_decay=0.0, mask=None):
    """AdamW with the ZeRO-1 scatter schedule (module docstring), in every
    rank of ``mesh``.  ``params`` and ``grads`` are whole on every rank;
    ``state`` holds this rank's moment blocks (``zero1_shard``) and so does
    the state returned.  Falls back to ``adamw_update`` (full moments) when
    ``mesh`` is None, has no live data axis, or ``REPRO_ZERO1_SCATTER=0``.
    Equals ``adamw_update`` bit for bit."""
    from repro_torch.dist.collectives import all_gather
    from repro_torch.dist.sharding import _axis_candidates, _mesh_shape
    if (mesh is None or not zero1_scatter_enabled()
            or not _axis_candidates(_mesh_shape(mesh))):
        return adamw_update(params, grads, state, step, lr=lr, b1=b1, b2=b2,
                            eps=eps, weight_decay=weight_decay, mask=mask)
    plan = _zero1_plan(params, mesh)
    flat_p = tree_util.leaves(params)
    train = ([m is not False for m in tree_util.leaves(mask)]
             if mask is not None else [True] * len(flat_p))
    # replicated params and grads: this rank's block is a free local slice
    blocks = [_block(p, wi, mesh) if on else p
              for p, wi, on in zip(flat_p, plan, train)]
    grad_blocks = [_block(g, wi, mesh) if on else g
                   for g, wi, on in zip(tree_util.leaves(grads), plan,
                                        train)]
    flat_mu = tree_util.leaves(state["mu"])
    flat_nu = tree_util.leaves(state["nu"])
    adamw_step_(blocks, grad_blocks, flat_mu, flat_nu, train, step, lr=lr,
                b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)
    # the ONLY collective of the update: gather each updated param block
    out_p = [all_gather(p2, mesh, wi[1], dim=wi[0])
             if on and wi is not None else p2
             for p2, wi, on in zip(blocks, plan, train)]
    return (tree_util.unflatten(params, out_p),
            {"mu": tree_util.unflatten(params, flat_mu),
             "nu": tree_util.unflatten(params, flat_nu)})


@torch.no_grad()
def sgd_update(params, grads, *, lr=1e-2):
    return tree_util.map_(
        lambda p, g: (p.float() - lr * g.float()).to(p.dtype), params, grads)
