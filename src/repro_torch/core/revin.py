"""RevIN — Reversible Instance Normalization (Kim et al., ICLR 2022).

Used in the paper's forecasting fine-tuning phase; plain instance norm
(non-learnable) is used in the supervised fine-tuning phase (§3.2
Normalization).
"""

from __future__ import annotations

import torch


def init_revin(num_channels: int, *, device=None):
    return {"gamma": torch.ones((num_channels,), dtype=torch.float32,
                                device=device),
            "beta": torch.zeros((num_channels,), dtype=torch.float32,
                                device=device)}


def revin_norm(params, x, eps: float = 1e-5):
    """x: (B, L, M) -> (normalized x, stats).  Affine if params given."""
    if params is not None and x.shape[-1] != params["gamma"].shape[0]:
        raise ValueError(f"revin: {x.shape[-1]} channels, params for "
                         f"{params['gamma'].shape[0]}")
    mu = x.mean(dim=1, keepdim=True)
    sd = torch.sqrt(x.var(dim=1, keepdim=True, unbiased=False) + eps)
    xn = (x - mu) / sd
    if params is not None:
        xn = xn * params["gamma"][None, None, :] + params["beta"][None, None, :]
    return xn, {"mu": mu, "sd": sd}


def revin_denorm(params, y, stats, eps: float = 1e-5):
    """y: (B, T, M) model output -> de-normalized forecast."""
    if params is not None:
        g = params["gamma"][None, None, :]
        g_safe = torch.where(g.abs() < 1e-12, torch.full_like(g, 1e-12), g)
        y = (y - params["beta"][None, None, :]) / g_safe
    return y * stats["sd"] + stats["mu"]


def instance_norm(x, eps: float = 1e-5):
    """Phase-1 normalization: zero-mean unit-std per instance
    (non-learnable)."""
    return revin_norm(None, x, eps)
