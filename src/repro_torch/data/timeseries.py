"""Time-series data for the federated fit (numpy only).

The port's own copy of the reference's simulators and windowing: the seven
benchmark datasets of the paper's Table 1 and the ACN EV-charging sites are
statistical simulators matched to their published characteristics, and the
same seed gives the same arrays in both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    features: int
    timesteps: int
    steps_per_day: int            # granularity -> daily period in steps
    trend: float = 0.0            # per-step linear drift (std units)
    weekly: bool = True
    noise: float = 0.3


# Table 1 of the paper
DATASETS = {
    "weather":     DatasetSpec("weather", 21, 52_696, 144, 0.0, False, 0.25),
    "traffic":     DatasetSpec("traffic", 862, 17_544, 24, 0.0, True, 0.2),
    "electricity": DatasetSpec("electricity", 321, 26_304, 24, 1e-5, True, 0.2),
    "etth1":       DatasetSpec("etth1", 7, 17_420, 24, 0.0, True, 0.3),
    "etth2":       DatasetSpec("etth2", 7, 17_420, 24, 0.0, True, 0.35),
    "ettm1":       DatasetSpec("ettm1", 7, 69_680, 96, 0.0, True, 0.3),
    "ettm2":       DatasetSpec("ettm2", 7, 69_680, 96, 0.0, True, 0.35),
    # ACN (paper §4.3): 2 sites, strong weekday pattern, upward trend
    "acn-caltech": DatasetSpec("acn-caltech", 54, 13_870, 24, 4e-5, True, 0.4),
    "acn-jpl":     DatasetSpec("acn-jpl", 40, 13_870, 24, 5e-5, True, 0.4),
}


def generate(spec: DatasetSpec, *, seed: int = 0,
             timesteps: Optional[int] = None) -> np.ndarray:
    """Simulate (T, M) multivariate series with daily/weekly structure."""
    rng = np.random.default_rng(seed)
    T = timesteps or spec.timesteps
    M = spec.features
    t = np.arange(T, dtype=np.float32)
    day = spec.steps_per_day
    # per-channel random phase/amplitude daily cycle
    phase = rng.uniform(0, 2 * np.pi, M).astype(np.float32)
    amp = rng.uniform(0.5, 1.5, M).astype(np.float32)
    x = amp[None] * np.sin(2 * np.pi * t[:, None] / day + phase[None])
    # harmonics
    x += 0.3 * amp[None] * np.sin(4 * np.pi * t[:, None] / day + 2 * phase[None])
    if spec.weekly:
        week = day * 7
        wd = ((t % week) < day * 5).astype(np.float32)   # weekday indicator
        x += 0.8 * wd[:, None] * rng.uniform(0.3, 1.0, M)[None].astype(np.float32)
    if spec.trend:
        x += spec.trend * t[:, None]
    # cross-channel correlation via low-rank mixing
    mix = rng.normal(0, 1, (M, M)).astype(np.float32)
    mix = 0.85 * np.eye(M, dtype=np.float32) + 0.15 * mix / np.sqrt(M)
    x = x @ mix
    # AR(1) noise
    eps = rng.normal(0, spec.noise, (T, M)).astype(np.float32)
    for i in range(1, T):
        eps[i] += 0.7 * eps[i - 1]
    return (x + eps).astype(np.float32)


def load_csv(path: str) -> np.ndarray:
    """Real-data entry point: CSV of shape (T, M) (header allowed)."""
    return np.genfromtxt(path, delimiter=",", skip_header=1,
                         dtype=np.float32)


def train_test_split(series: np.ndarray,
                     train_frac: float = 0.8) -> Tuple[np.ndarray, np.ndarray]:
    """Paper §4.1: 80% / 20% chronological split."""
    n = int(len(series) * train_frac)
    return series[:n], series[n:]


def make_windows(series: np.ndarray, lookback: int, horizon: int,
                 *, stride: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """(T, M) -> x: (n, L, M), y: (n, T_h, M) sliding windows."""
    T = len(series)
    n = (T - lookback - horizon) // stride + 1
    if n <= 0:
        raise ValueError(f"series of {T} steps is shorter than lookback "
                         f"{lookback} + horizon {horizon}")
    idx = np.arange(n) * stride
    x = np.stack([series[i:i + lookback] for i in idx])
    y = np.stack([series[i + lookback:i + lookback + horizon] for i in idx])
    return x, y


def batches(x: np.ndarray, y: np.ndarray, batch_size: int, *,
            seed: int = 0, drop_last: bool = True
            ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """One pass over the windows in a seeded random order."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(x))
    end = len(x) - (len(x) % batch_size if drop_last else 0)
    for i in range(0, end, batch_size):
        sel = order[i:i + batch_size]
        yield x[sel], y[sel]


def sample_batch(x: np.ndarray, y: np.ndarray, batch_size: int, *,
                 seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """``batch_size`` windows drawn with replacement."""
    rng = np.random.default_rng(seed)
    sel = rng.integers(0, len(x), batch_size)
    return x[sel], y[sel]
