"""Non-IID client partitioning for the federated experiments (numpy only;
the port's copy of the reference's, same arrays for the same seed).

Each edge device (EV charging station / sensor) sees a different slice of
the channel set and time range, plus a device-specific scale/offset —
producing the skewed distributions the paper's clustering step targets.
"""

from __future__ import annotations

from typing import List

import numpy as np

from repro_torch.data.timeseries import make_windows


def partition_clients(series: np.ndarray, num_clients: int, *,
                      seed: int = 0, channels_per_client: int = 0,
                      hetero_scale: float = 0.5) -> List[np.ndarray]:
    """(T, M) -> list of per-client (T_s, M_s) series (non-IID)."""
    rng = np.random.default_rng(seed)
    T, M = series.shape
    cpc = channels_per_client or max(1, M // 4)
    cpc = min(cpc, M)
    out = []
    for c in range(num_clients):
        chans = rng.choice(M, size=cpc, replace=False)
        # staggered time ranges (devices come online at different times)
        start = rng.integers(0, T // 4)
        length = rng.integers(T // 2, T - start)
        local = series[start:start + length][:, chans].copy()
        # device-specific affine skew
        scale = 1.0 + hetero_scale * rng.normal(0, 1)
        offset = hetero_scale * rng.normal(0, 1)
        out.append((local * scale + offset).astype(np.float32))
    return out


def client_windows(client_series: List[np.ndarray], lookback: int,
                   horizon: int, *, max_windows: int = 512, seed: int = 0):
    """Per-client (x, y) window arrays, subsampled to ``max_windows``."""
    rng = np.random.default_rng(seed)
    out = []
    for s in client_series:
        if len(s) < lookback + horizon + 1:
            # pad short clients by tiling
            reps = (lookback + horizon + 1) // max(len(s), 1) + 1
            s = np.tile(s, (reps, 1))
        x, y = make_windows(s, lookback, horizon)
        if len(x) > max_windows:
            sel = rng.choice(len(x), max_windows, replace=False)
            x, y = x[sel], y[sel]
        out.append((x, y))
    return out


def client_weights(client_data) -> np.ndarray:
    """Paper's w_{s,c}: aggregation weight = local dataset size."""
    return np.array([len(x) for x, _ in client_data], dtype=np.float32)
