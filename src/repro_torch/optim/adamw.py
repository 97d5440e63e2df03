"""AdamW on parameter trees (the reference's plain ``adamw_update``; its
ZeRO-1 scatter form is not ported yet).

  state = adamw_init(params)
  params, state = adamw_update(params, grads, state, step, lr=..., ...)

Functional: new tensors out, nothing updated in place.
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
def adamw_update(params, grads, state, step, *, lr=1e-3, b1=0.9, b2=0.999,
                 eps=1e-8, weight_decay=0.0):
    """step: 1-based int.  The bias corrections are taken in f32, as the
    reference takes them."""
    step = torch.tensor(float(step), dtype=torch.float32)
    c1 = float(1.0 - torch.tensor(b1, dtype=torch.float32) ** step)
    c2 = float(1.0 - torch.tensor(b2, dtype=torch.float32) ** step)
    def leaf(p, g, mu, nu):
        g32 = g.float()
        mu2 = b1 * mu + (1 - b1) * g32
        nu2 = b2 * nu + (1 - b2) * torch.square(g32)
        delta = (mu2 / c1) / (torch.sqrt(nu2 / c2) + eps)
        if weight_decay > 0:
            delta = delta + weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), mu2, nu2

    out = tree_util.map_(leaf, params, grads, state["mu"], state["nu"])
    return (tree_util.pick(out, 0),
            {"mu": tree_util.pick(out, 1), "nu": tree_util.pick(out, 2)})
