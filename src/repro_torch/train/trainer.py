"""Centralized trainer: the paper's comparison point (Fig. 3's
'centralized LLaMA', Table 2's baselines) and the generic single-host
training loop; and the scoring of a fitted forecaster (the paper's Table
2/3 metrics)."""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch import tree as tree_util
from repro_torch.optim.adamw import adamw_init, adamw_step_
from repro_torch.optim.schedules import cosine_warmup


@dataclasses.dataclass
class TrainLog:
    step: int
    loss: float
    seconds: float


def fit(loss_fn: Callable, params, batch_iter, *, steps: int,
        lr: float = 1e-3, warmup: int = 10, mask=None,
        eval_fn: Optional[Callable] = None, eval_every: int = 50,
        progress: Optional[Callable[[str], None]] = None):
    """AdamW under ``cosine_warmup``, on the device where ``params`` live.

    loss_fn(params, batch) -> scalar tensor; batch_iter yields trees of
    numpy arrays or tensors, moved to that device.  Gradients are taken by
    autograd for the leaves ``mask`` trains (all floating-point leaves
    when it is None); a leaf masked ``False``, and any integer leaf (NF4
    codes), keeps its tensor.  Each step replaces a leaf's parameter and
    moments one leaf at a time, so the old ones go as the new ones come.
    The caller's tree is not changed, and no leaf of either tree requires
    a gradient after the call.  Returns (params, List[TrainLog],
    eval_history)."""
    opt = adamw_init(params)
    flat_p = [p.detach() for p in tree_util.leaves(params)]
    flat_mu = tree_util.leaves(opt["mu"])
    flat_nu = tree_util.leaves(opt["nu"])
    del opt
    marks = (tree_util.leaves(mask) if mask is not None
             else [True] * len(flat_p))
    train = [m is not False and p.is_floating_point()
             for p, m in zip(flat_p, marks)]
    device = flat_p[0].device

    logs: List[TrainLog] = []
    evals = []
    t0 = time.time()
    for i in range(steps):
        batch = tree_util.map_(lambda a: torch.as_tensor(a).to(device),
                               next(batch_iter))
        live = [p.requires_grad_(True) for p, on in zip(flat_p, train)
                if on]
        with torch.enable_grad():
            loss = loss_fn(tree_util.unflatten(params, flat_p), batch)
            got = iter(torch.autograd.grad(loss, live, allow_unused=True))
        for p in live:
            p.requires_grad_(False)
        del live
        flat_g = [None] * len(flat_p)
        for j, on in enumerate(train):
            if on:
                g = next(got)
                flat_g[j] = torch.zeros_like(flat_p[j]) if g is None else g
        del got
        lr_i = cosine_warmup(i, base_lr=lr, warmup=warmup, total=steps)
        adamw_step_(flat_p, flat_g, flat_mu, flat_nu, train, i + 1,
                    lr=float(lr_i))
        l = float(loss.detach())
        del loss
        logs.append(TrainLog(i, l, time.time() - t0))
        if eval_fn is not None and (i + 1) % eval_every == 0:
            evals.append((i, eval_fn(tree_util.unflatten(params, flat_p))))
        if progress and (i + 1) % max(steps // 10, 1) == 0:
            progress(f"step {i + 1}/{steps} loss={l:.4f}")
    return tree_util.unflatten(params, flat_p), logs, evals


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
