"""Rotary position embeddings + token/vocab embedding helpers."""

from __future__ import annotations

import torch

from repro_torch.models.layers.linear import draw_normal


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies for RoPE, shape (head_dim // 2,) float32."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotate the two halves of the last dim (half-split, not interleaved).

    x: (..., S, H, Dh); positions: broadcastable to (..., S) absolute
    positions.
    """
    inv = rope_freqs(x.shape[-1], theta, x.device)          # (dh/2,)
    ang = positions[..., None].float() * inv                 # (..., S, dh/2)
    ang = ang[..., None, :]                                  # (..., S, 1, dh/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    rot = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return rot.to(x.dtype)


def init_embedding(generator: torch.Generator, vocab: int, dim: int, *,
                   dtype=torch.float32, device=None):
    return {"table": draw_normal(generator, (vocab, dim), 0.02, dtype=dtype,
                                 device=device)}


def embed(params, tokens: torch.Tensor) -> torch.Tensor:
    return params["table"][tokens]


def unembed(params, x: torch.Tensor) -> torch.Tensor:
    """Tied LM head: (..., d) @ (vocab, d)^T -> (..., vocab)."""
    return x @ params["table"].T
