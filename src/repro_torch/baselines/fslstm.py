"""FSLSTM baseline: federated stacked LSTM (Abdel-Sater & Hamza 2021,
paper reference [1]).  Two stacked LSTM layers over the multivariate
series, last hidden state -> linear head to the full horizon.  Federation
ships FULL weights (no PEFT): the paper's communication-overhead
strawman.

``params["layers"]`` is a list, one dict a layer, as the reference's.
The reference's ``lax.scan`` over time is a Python loop here: one
``h @ wh`` and the gates a step.
"""

from __future__ import annotations

import torch


def _init_lstm_layer(generator, d_in: int, d_hidden: int, device):
    wx = torch.randn((d_in, 4 * d_hidden), generator=generator,
                     device=device) * d_in ** -0.5
    wh = torch.randn((d_hidden, 4 * d_hidden), generator=generator,
                     device=device) * d_hidden ** -0.5
    b = torch.zeros((4 * d_hidden,), dtype=torch.float32, device=device)
    b[d_hidden:2 * d_hidden] = 1.0                      # forget-gate bias 1
    return {"wx": wx, "wh": wh, "b": b}


def init(generator: torch.Generator, *, channels: int, horizon: int,
         d_hidden: int = 128, layers: int = 2, device="cuda"):
    """Weights drawn from ``generator`` (which must live on ``device``)."""
    stack = [_init_lstm_layer(generator, channels if i == 0 else d_hidden,
                              d_hidden, device) for i in range(layers)]
    head = torch.randn((d_hidden, horizon * channels), generator=generator,
                       device=device) * d_hidden ** -0.5
    return {"layers": stack, "head": head}


def _lstm_scan(lp, x: torch.Tensor) -> torch.Tensor:
    """x: (B, L, d_in) -> hidden sequence (B, L, dh)."""
    B, L, _ = x.shape
    dh = lp["wh"].shape[0]
    xw = x @ lp["wx"] + lp["b"][None, None, :]
    h = torch.zeros((B, dh), dtype=xw.dtype, device=x.device)
    c = torch.zeros_like(h)
    hs = []
    for t in range(L):
        gates = xw[:, t] + h @ lp["wh"]
        i, f, g, o = torch.chunk(gates, 4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs.append(h)
    return torch.stack(hs, dim=1)


def forward(params, x: torch.Tensor) -> torch.Tensor:
    """x: (B, L, M) -> (B, T, M), each series normalised by its own mean
    and standard deviation."""
    B, L, M = x.shape
    mu = x.mean(dim=1, keepdim=True)
    sd = x.std(dim=1, keepdim=True, unbiased=False) + 1e-5
    h = (x - mu) / sd
    for lp in params["layers"]:
        h = _lstm_scan(lp, h)
    T = params["head"].shape[1] // M          # horizon from head shape
    y = (h[:, -1, :] @ params["head"]).reshape(B, T, M)
    return y * sd + mu


def loss(params, batch):
    pred = forward(params, batch["x"])
    return torch.mean(torch.square(pred - batch["y"]))
