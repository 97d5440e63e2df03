"""AdamW and SGD on parameter trees (the reference's plain ``adamw_update``
and ``sgd_update``; its ZeRO-1 scatter form is not ported yet).

  state = adamw_init(params)
  params, state = adamw_update(params, grads, state, step, lr=..., ...)

Functional: new tensors out, nothing updated in place.  ``mask`` (a tree
of bools) freezes the leaves where it is ``False``: parameter and both
moments are kept as they are, which is how a client trains its LoRA
leaves only while the quantized base stays frozen (paper C2).
"""

from __future__ import annotations

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


@torch.no_grad()
def sgd_update(params, grads, *, lr=1e-2):
    return tree_util.map_(
        lambda p, g: (p.float() - lr * g.float()).to(p.dtype), params, grads)
