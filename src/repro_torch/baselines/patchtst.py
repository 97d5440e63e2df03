"""PatchTST baseline (Nie et al., ICLR 2023) and its federated variant
Fed-PatchTST (paper §4.2).

RevIN + channel independence + patching + bidirectional transformer
encoder + flatten head.  Reuses the FedTime front end with a small dense
encoder config and full (non-causal) attention: the architectural deltas
against FedTime are exactly the paper's: no LLM backbone, no LoRA
(federation ships full weights), no DPO.  The encoder is the port's plain
``forward_hidden`` in f32; no kernel lies on it.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import FedTimeConfig, ModelConfig
from repro_torch.core.patching import (channel_merge, channel_split,
                                       init_patch_embed, make_patches,
                                       num_patches, patch_embed)
from repro_torch.core.revin import init_revin, revin_denorm, revin_norm
from repro_torch.models.layers.linear import dense, init_dense
from repro_torch.models.layers.norms import init_rmsnorm
from repro_torch.models.transformer import forward_hidden, init_blocks


def make_config(*, lookback: int = 512, horizon: int = 96,
                d_model: int = 128, num_layers: int = 3,
                num_heads: int = 16, d_ff: int = 256,
                patch_len: int = 16, stride: int = 8) -> ModelConfig:
    """PatchTST/64-flavored encoder config."""
    return ModelConfig(
        name="patchtst", family="dense", num_layers=num_layers,
        d_model=d_model, num_heads=num_heads, num_kv_heads=num_heads,
        d_ff=d_ff, vocab_size=1, activation="gelu",
        param_dtype="float32", compute_dtype="float32",
        fedtime=FedTimeConfig(lookback=lookback, horizon=horizon,
                              patch_len=patch_len, patch_stride=stride,
                              qlora=False),
        source="arXiv:2211.14730 (PatchTST)")


def init(cfg: ModelConfig, generator: torch.Generator, *,
         num_channels: int = 1, device="cuda"):
    """Weights drawn from ``generator`` (which must live on ``device``)."""
    ft = cfg.fedtime
    N = num_patches(ft.lookback, ft.patch_len, ft.patch_stride)
    return {
        "patch": init_patch_embed(generator, ft.patch_len, N, cfg.d_model,
                                  device=device),
        "layers": init_blocks(cfg, generator, device),
        "final_norm": init_rmsnorm(cfg.d_model, device=device),
        "head": init_dense(generator, N * cfg.d_model, ft.horizon,
                           device=device),
        "revin": init_revin(num_channels, device=device),
    }


def forward(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """x: (B, L, M) -> (B, T, M).  Bidirectional encoder (PatchTST)."""
    ft = cfg.fedtime
    B, L, M = x.shape
    xn, stats = revin_norm(params["revin"], x.float())
    u = channel_split(xn)
    p = make_patches(u, ft.patch_len, ft.patch_stride)
    h = patch_embed(params["patch"], p)
    N = h.shape[1]
    h = forward_hidden({"layers": params["layers"],
                        "final_norm": params["final_norm"]}, cfg, h,
                       positions=torch.arange(N, dtype=torch.int32,
                                              device=h.device),
                       kind="full")
    y = dense(params["head"], h.reshape(B * M, N * cfg.d_model))
    y = channel_merge(y, B, M)
    return revin_denorm(params["revin"], y, stats)


def loss(params, cfg: ModelConfig, batch):
    pred = forward(params, cfg, batch["x"])
    return torch.mean(torch.square(pred - batch["y"]))
