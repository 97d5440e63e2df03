"""Feed-forward block: SwiGLU (the dense family's activation)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers.linear import dense, init_dense


def init_mlp(generator: torch.Generator, d_model: int, d_ff: int, *,
             layers: int = 0, dtype=torch.float32, device=None):
    kw = dict(layers=layers, dtype=dtype, device=device)
    return {
        "gate": init_dense(generator, d_model, d_ff, **kw),
        "up": init_dense(generator, d_model, d_ff, **kw),
        "down": init_dense(generator, d_ff, d_model, **kw),
    }


def mlp(params, x: torch.Tensor, activation: str) -> torch.Tensor:
    if activation != "swiglu":
        raise NotImplementedError(f"activation {activation!r} is not ported "
                                  f"yet (swiglu only)")
    h = F.silu(dense(params["gate"], x)) * dense(params["up"], x)
    return dense(params["down"], h)
