"""Feed-forward blocks: SwiGLU / GeGLU / plain GELU.  GELU is the tanh
approximation, as the reference's ``jax.nn.gelu(approximate=True)``."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers.linear import dense, init_dense

ACTIVATIONS = ("swiglu", "geglu", "gelu")


def init_mlp(generator: torch.Generator, d_model: int, d_ff: int,
             activation: str = "swiglu", *, layers: int = 0,
             dtype=torch.float32, device=None, out_dim: int | None = None):
    """Gated activations have ``gate``, ``up`` and ``down``; ``"gelu"`` has
    ``up`` and ``down``.  ``down`` maps to ``out_dim`` (default
    ``d_model``)."""
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}")
    kw = dict(layers=layers, dtype=dtype, device=device)
    out_dim = out_dim or d_model
    p = {}
    if activation != "gelu":
        p["gate"] = init_dense(generator, d_model, d_ff, **kw)
    p["up"] = init_dense(generator, d_model, d_ff, **kw)
    p["down"] = init_dense(generator, d_ff, out_dim, **kw)
    return p


def mlp(params, x: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "swiglu":
        h = F.silu(dense(params["gate"], x)) * dense(params["up"], x)
    elif activation == "geglu":
        h = F.gelu(dense(params["gate"], x), approximate="tanh") * \
            dense(params["up"], x)
    elif activation == "gelu":
        h = F.gelu(dense(params["up"], x), approximate="tanh")
    else:
        raise ValueError(f"unknown activation {activation!r}")
    return dense(params["down"], h)
