"""FedAdam — adaptive server-side federated optimization (Reddi et al.,
ICLR 2021), as the paper uses it to update the QLoRA parameters.

The server treats the (weighted) average client delta as a pseudo-gradient
and applies Adam to the global model:

    Δ_t   = Σ_s w_s (θ_s - θ_global) / Σ_s w_s
    m_t   = β1 m_{t-1} + (1-β1) Δ_t
    v_t   = β2 v_{t-1} + (1-β2) Δ_t²
    θ_t+1 = θ_t + η m_t / (√v_t + τ)
"""

from __future__ import annotations

import torch

from repro_torch import tree as tree_util


def fedadam_init(global_tree):
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
    return {"m": tree_util.map_(zeros, global_tree),
            "v": tree_util.map_(zeros, global_tree)}


@torch.no_grad()
def fedadam_update(global_tree, avg_delta, state, *, lr=1e-2, b1=0.9,
                   b2=0.99, tau=1e-3):
    m = tree_util.map_(lambda m_, d: b1 * m_ + (1 - b1) * d.float(),
                       state["m"], avg_delta)
    v = tree_util.map_(lambda v_, d: b2 * v_ + (1 - b2) * torch.square(
        d.float()), state["v"], avg_delta)
    new = tree_util.map_(
        lambda p, m_, v_: (p.float() + lr * m_ / (torch.sqrt(v_) + tau)
                           ).to(p.dtype), global_tree, m, v)
    return new, {"m": m, "v": v}


@torch.no_grad()
def fedavg(client_trees, weights):
    """Plain weighted averaging (McMahan et al.).  weights: (S,)."""
    w = torch.as_tensor(weights, dtype=torch.float32)
    w = w / w.sum()

    def avg(*leaves):
        stacked = torch.stack([l.float() for l in leaves])
        out = torch.tensordot(w.to(stacked.device), stacked, dims=1)
        return out.to(leaves[0].dtype)

    return tree_util.map_(avg, *client_trees)
