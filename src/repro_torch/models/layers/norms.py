"""RMSNorm and LayerNorm (f32 inside, cast back)."""

from __future__ import annotations

import torch


def init_rmsnorm(dim: int, *, layers: int = 0, device=None):
    """Scale of ones, f32 whatever the model's dtype (as the reference);
    ``layers`` > 0 stacks a leading layer axis."""
    shape = (layers, dim) if layers else (dim,)
    return {"scale": torch.ones(shape, dtype=torch.float32, device=device)}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6, *,
            gemma_style: bool = False) -> torch.Tensor:
    """RMSNorm in f32, cast back. ``gemma_style`` uses (1 + scale)."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * (var + eps) ** -0.5
    scale = params["scale"].float()
    y = y * (1.0 + scale) if gemma_style else y * scale
    return y.to(x.dtype)


def init_layernorm(dim: int, *, dtype=torch.float32, device=None):
    return {"scale": torch.ones((dim,), dtype=dtype, device=device),
            "bias": torch.zeros((dim,), dtype=dtype, device=device)}


def layernorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * (var + eps) ** -0.5
    y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype)
