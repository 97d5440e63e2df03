"""Direct Preference Optimization for time-series alignment (paper C4).

A preference pair is (history x, preferred forecast y_w, dispreferred
forecast y_l); the "log-likelihood" of a forecast is the Gaussian
log-density -||y - f(x)||^2 / 2, so DPO's logit becomes a difference of
squared errors, the regression analogue of token log-probabilities:

    L = -log sigmoid( beta [ (log pi(y_w|x) - log pi_ref(y_w|x))
                           - (log pi(y_l|x) - log pi_ref(y_l|x)) ] )

The reference forward runs under ``torch.no_grad()`` (the reference's
``stop_gradient``), so only the policy carries a graph.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core import fedtime


def _logp(pred, y):
    """Per-sample Gaussian log-density (up to a constant), summed over
    (T, M): (B,)."""
    d = (pred - y).float()
    return -0.5 * torch.sum(torch.square(d), dim=(1, 2))


def dpo_loss(params, ref_params, cfg, batch, *, beta: float = 0.1,
             phase: str = "sft"):
    """batch: {"x": (B, L, M), "y_w": (B, T, M), "y_l": (B, T, M)}."""
    pred = fedtime.forward(params, cfg, batch["x"], phase=phase)
    with torch.no_grad():
        ref_pred = fedtime.forward(ref_params, cfg, batch["x"], phase=phase)
    logit = ((_logp(pred, batch["y_w"]) - _logp(ref_pred, batch["y_w"])) -
             (_logp(pred, batch["y_l"]) - _logp(ref_pred, batch["y_l"])))
    return -torch.mean(F.logsigmoid(beta * logit))


def make_preference_pairs(generator: Optional[torch.Generator], x, y, *,
                          noise_lo: float = 0.05, noise_hi: float = 0.5):
    """Synthesize (y_w, y_l) from the ground truth: y_w a light
    perturbation, y_l a heavy one (better and worse forecast feedback).
    The noise comes from ``generator`` (on y's device), so it cannot equal
    the reference's ``jax.random`` draws; a parity test hands both sides
    the same pairs instead."""
    scale = torch.std(y, dim=1, keepdim=True, correction=0) + 1e-6
    n_w = torch.randn(y.shape, generator=generator, device=y.device)
    n_l = torch.randn(y.shape, generator=generator, device=y.device)
    return {"x": x, "y_w": y + noise_lo * scale * n_w,
            "y_l": y + noise_hi * scale * n_l}
