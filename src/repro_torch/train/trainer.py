"""Scoring of a fitted forecaster (the paper's Table 2/3 metrics).  The
reference's centralized ``fit`` loop is not ported yet."""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import tree as tree_util


@torch.no_grad()
def evaluate_forecaster(forward_fn, params, x_test: np.ndarray,
                        y_test: np.ndarray, *, batch: int = 64):
    """MSE / MAE over a test window set.  ``forward_fn(params, x)`` runs on
    the device of ``params``; windows go there ``batch`` at a time."""
    device = tree_util.leaves(params)[0].device
    preds = []
    for i in range(0, len(x_test), batch):
        x = torch.from_numpy(np.ascontiguousarray(x_test[i:i + batch]))
        preds.append(forward_fn(params, x.to(device)).float().cpu().numpy())
    pred = np.concatenate(preds)[:len(y_test)]
    err = pred - y_test
    return {"mse": float(np.mean(err ** 2)),
            "mae": float(np.mean(np.abs(err)))}
