"""Channel independence + patching + patch/position embeddings (paper §3.2,
adopted from PatchTST)."""

from __future__ import annotations

import torch


def num_patches(lookback: int, patch_len: int, stride: int) -> int:
    if (lookback - patch_len) % stride:
        raise ValueError(f"lookback={lookback} patch_len={patch_len} "
                         f"stride={stride}: patches do not tile the window")
    return (lookback - patch_len) // stride + 1


def channel_split(x: torch.Tensor) -> torch.Tensor:
    """Channel independence: (B, L, M) -> (B*M, L) — each univariate series
    goes through the shared backbone on its own (paper Fig. 1b)."""
    B, L, M = x.shape
    return x.permute(0, 2, 1).reshape(B * M, L)


def channel_merge(y: torch.Tensor, batch: int, channels: int) -> torch.Tensor:
    """(B*M, T) -> (B, T, M)."""
    T = y.shape[-1]
    return y.reshape(batch, channels, T).permute(0, 2, 1)


def make_patches(x: torch.Tensor, patch_len: int, stride: int) -> torch.Tensor:
    """(B*, L) -> (B*, N, P) overlapping patches (a copy, as the
    reference's gather)."""
    num_patches(x.shape[-1], patch_len, stride)
    return x.unfold(-1, patch_len, stride).contiguous()


def init_patch_embed(generator: torch.Generator, patch_len: int,
                     n_patches: int, d_model: int, *, dtype=torch.float32,
                     device=None):
    w_p = torch.randn((patch_len, d_model), generator=generator,
                      device=device) * patch_len ** -0.5
    w_pos = torch.randn((n_patches, d_model), generator=generator,
                        device=device) * 0.02
    return {"w_p": w_p.to(dtype), "w_pos": w_pos.to(dtype)}   # Eq. (1)


def patch_embed(params, patches: torch.Tensor) -> torch.Tensor:
    """Eq. (1): X_d = X_p W_p + W_pos.  (B*, N, P) -> (B*, N, D)."""
    x = patches @ params["w_p"].to(patches.dtype)
    return x + params["w_pos"][None].to(patches.dtype)
