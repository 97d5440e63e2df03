"""K-means clustering of edge devices (paper §3.1: pre-learning step).

Clients are embedded by their local-data statistics (mean/std/trend of the
load curve, dataset size, and a device-capability proxy) and clustered so
each cluster trains its own global model.  Runs in f32 on the host's CPU:
the features are a handful of numbers per client.

The reference draws the first centre from a ``jax.random`` key; here it
comes from a ``torch.Generator``, or is given as ``first`` (so a test can
pass the reference's).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def client_features(series_list, capabilities=None) -> torch.Tensor:
    """series_list: list of (L_s, M) arrays (lengths may differ).  Returns
    the (S, F) feature matrix, standardized per feature."""
    feats = []
    for i, s in enumerate(series_list):
        s = torch.as_tensor(np.asarray(s, np.float32)).reshape(
            s.shape[0], -1)
        L = s.shape[0]
        t = torch.arange(L, dtype=torch.float32)
        tc = t - t.mean()
        trend = (tc[:, None] * (s - s.mean(0))).sum(0) / \
            torch.clamp((tc ** 2).sum(), min=1e-9)
        cap = 1.0 if capabilities is None else float(capabilities[i])
        feats.append(torch.stack([
            s.mean(0).mean(), s.std(0, unbiased=False).mean(),
            trend.mean(), torch.log1p(torch.tensor(float(L))),
            torch.tensor(cap)]))
    X = torch.stack(feats)
    mu, sd = X.mean(0), X.std(0, unbiased=False) + 1e-9
    return (X - mu) / sd


def kmeans(X: torch.Tensor, k: int, *, iters: int = 50,
           first: Optional[int] = None,
           generator: Optional[torch.Generator] = None):
    """Lloyd's algorithm after a greedy farthest-point start.  Returns
    (assignments (S,), centers (k, F), inertia).  ``first`` is the index of
    the first centre; without it, one drawn from ``generator``."""
    S, F = X.shape
    k = min(k, S)
    if first is None:
        first = int(torch.randint(0, S, (), generator=generator))
    centers = torch.zeros((k, F), dtype=X.dtype)
    centers[0] = X[first]
    inf = torch.tensor(float("inf"))
    for i in range(1, k):
        d = ((X[:, None, :] - centers[None]) ** 2).sum(-1)
        d = d + torch.where(torch.arange(k)[None] >= i, inf,
                            torch.tensor(0.0))
        centers[i] = X[torch.argmax(d.min(dim=1).values)]
    assign = torch.zeros((S,), dtype=torch.int64)
    for _ in range(iters):
        d = ((X[:, None, :] - centers[None]) ** 2).sum(-1)        # (S, k)
        assign = torch.argmin(d, dim=1)
        onehot = torch.nn.functional.one_hot(assign, k).float()   # (S, k)
        counts = onehot.sum(0)
        sums = onehot.T @ X
        centers = torch.where(counts[:, None] > 0,
                              sums / torch.clamp(counts[:, None], min=1),
                              centers)
    d = ((X - centers[assign]) ** 2).sum(-1)
    return assign, centers, d.sum()


def cluster_clients(series_list, k: int, *, capabilities=None,
                    first: Optional[int] = None,
                    generator: Optional[torch.Generator] = None):
    X = client_features(series_list, capabilities)
    return kmeans(X, k, first=first, generator=generator)
