"""DLinear baseline (Zeng et al., AAAI 2023): series decomposition
(moving-average trend + remainder) with per-component linear maps L -> T,
channel-independent."""

from __future__ import annotations

import torch


def init(generator: torch.Generator, lookback: int, horizon: int, *,
         device="cuda"):
    """Weights drawn from ``generator`` (which must live on ``device``)."""
    s = lookback ** -0.5
    return {name: torch.randn((lookback, horizon), generator=generator,
                              device=device) * s
            for name in ("w_trend", "w_season")}


def _moving_avg(x: torch.Tensor, k: int = 25) -> torch.Tensor:
    """x: (B, L, M) -> trend by a centred moving average over ``k`` steps
    (edge-padded), from cumulative sums as the reference takes it."""
    pad_l, pad_r = (k - 1) // 2, k // 2
    xp = torch.cat([x[:, :1].expand(-1, pad_l, -1), x,
                    x[:, -1:].expand(-1, pad_r, -1)], dim=1)
    c = torch.cumsum(xp, dim=1)
    c = torch.cat([torch.zeros_like(c[:, :1]), c], dim=1)
    return (c[:, k:] - c[:, :-k]) / k


def forward(params, x: torch.Tensor) -> torch.Tensor:
    """x: (B, L, M) -> (B, T, M)."""
    trend = _moving_avg(x)
    season = x - trend
    yt = torch.einsum("blm,lt->btm", trend, params["w_trend"])
    ys = torch.einsum("blm,lt->btm", season, params["w_season"])
    return yt + ys


def loss(params, batch):
    pred = forward(params, batch["x"])
    return torch.mean(torch.square(pred - batch["y"]))
