"""The FedTime forecasting model (paper C1): RevIN/instance-norm ->
channel independence -> patching -> patch+position embedding -> LLM
backbone (LLaMA-style decoder blocks) -> flatten -> linear forecast head ->
de-normalization.

The backbone is the port's dense block stack
(``repro_torch.models.transformer.forward_hidden``), so LoRA/QLoRA
(``repro_torch.core.lora``) applies to this model as to the served ones.
Gradients reach the adapters through the stacked leaves: a layer's
parameters are views of them (``transformer.layer``), and nothing on the
path writes in place.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.patching import (channel_merge, channel_split,
                                       init_patch_embed, make_patches,
                                       num_patches, patch_embed)
from repro_torch.core.revin import (init_revin, instance_norm, revin_denorm,
                                    revin_norm)
from repro_torch.models.layers.linear import dense, init_dense
from repro_torch.models.layers.norms import init_rmsnorm
from repro_torch.models.losses import mse
from repro_torch.models.transformer import (dtype_of, forward_hidden,
                                            init_blocks)

PHASES = ("sft", "forecast")


def init(cfg: ModelConfig, generator: torch.Generator, *,
         num_channels: int = 1, device="cuda") -> dict:
    """Random parameters drawn from ``generator`` (which must live on
    ``device``), with the reference's shapes, dtypes and scales."""
    ft = cfg.fedtime
    dtype = dtype_of(cfg.param_dtype)
    N = num_patches(ft.lookback, ft.patch_len, ft.patch_stride)
    return {
        "patch": init_patch_embed(generator, ft.patch_len, N, cfg.d_model,
                                  dtype=dtype, device=device),
        "layers": init_blocks(cfg, generator, device),
        "final_norm": init_rmsnorm(cfg.d_model, device=device),
        "head": init_dense(generator, N * cfg.d_model, ft.horizon,
                           dtype=dtype, device=device),
        "revin": init_revin(num_channels, device=device),
    }


def forward(params, cfg: ModelConfig, x: torch.Tensor, *,
            phase: str = "forecast") -> torch.Tensor:
    """x: (B, L, M) history -> (B, T, M) forecast.

    phase='sft'      : plain instance norm (paper phase 1)
    phase='forecast' : RevIN with learnable affine (paper phase 2)
    """
    if phase not in PHASES:
        raise ValueError(f"phase {phase!r}: choose from {PHASES}")
    ft = cfg.fedtime
    B, L, M = x.shape
    x = x.float()
    if phase == "sft":
        xn, stats = instance_norm(x)
    else:
        xn, stats = revin_norm(params["revin"], x)

    u = channel_split(xn.to(dtype_of(cfg.compute_dtype)))      # (B*M, L)
    p = make_patches(u, ft.patch_len, ft.patch_stride)          # (B*M, N, P)
    h = patch_embed(params["patch"], p)                         # (B*M, N, D)
    N = h.shape[1]
    positions = torch.arange(N, dtype=torch.int32, device=h.device)
    h = forward_hidden({"layers": params["layers"],
                        "final_norm": params["final_norm"]},
                       cfg, h, positions=positions)
    flat = h.reshape(B * M, N * cfg.d_model)
    y = dense(params["head"], flat)                             # (B*M, T)
    y = channel_merge(y.float(), B, M)                          # (B, T, M)
    if phase == "sft":
        return y * stats["sd"] + stats["mu"]
    return revin_denorm(params["revin"], y, stats)


def loss(params, cfg: ModelConfig, batch, *, phase: str = "forecast"):
    """Paper Eq. (5): MSE over channels and horizon."""
    return mse(forward(params, cfg, batch["x"], phase=phase), batch["y"])
