"""Mergeable streaming quantile sketches (DDSketch-style log buckets).

The reservoir :class:`~repro_torch.obs.trace.Histogram` is the right tool for one
process watching one stream, but it cannot AGGREGATE: merging two
reservoirs re-biases the sample, so fleet-scale questions ("p99 client fit
time across 10k simulated clients, per cluster and overall") were
unanswerable.  :class:`QuantileSketch` fixes that with the DDSketch
construction [Masson et al., VLDB'19]:

  * **Log-bucketed counts.**  A positive value ``v`` lands in bucket
    ``ceil(log_gamma(v))`` with ``gamma = (1 + a) / (1 - a)`` for relative
    accuracy ``a``; the bucket midpoint ``2·gamma^i / (gamma + 1)``
    reconstructs any quantile with *value-relative* error ≤ ``a``
    (documented guarantee: ``|q_est - q_true| <= a * |q_true|`` for
    nonzero quantiles, exact rank resolution at bucket granularity).
    Negative values mirror into their own bucket map; zeros count
    separately — the full real line is covered.
  * **Exact-small fallback.**  Up to ``exact_threshold`` samples the
    sketch keeps every value and quantiles match
    ``numpy.percentile(..., method="linear")`` bitwise — tiny streams
    (per-cluster ledgers with a handful of clients) pay no bucket error
    at all.  Crossing the threshold spills every retained value into the
    buckets, so the spill is order-independent.
  * **Associative, commutative ``merge()``.**  Bucket maps add counts;
    exact stores concatenate (spilling if the union crosses the
    threshold).  Because the spill quantizes each value independently,
    ``merge(a, b)`` has *identical* bucket content to a single sketch fed
    the concatenated stream — merged quantiles equal concatenated-stream
    quantiles exactly, which is what makes per-cluster → fleet roll-ups
    trustworthy (``tests/test_torch_obs.py`` holds it against the JAX
    package's copy).
  * **O(1) memory.**  Bucket count is bounded by ``max_buckets``; on
    overflow the lowest-magnitude buckets collapse into their neighbour
    (the DDSketch collapse rule), preserving the accuracy of the upper
    quantiles that matter for straggler detection.

``add_many(np.ndarray)`` ingests a vector in one numpy pass (1M samples in
~ms), and ``to_dict``/``from_dict`` round-trip the sketch through JSON so
``fleet.json`` ledgers can be merged across processes.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional

__all__ = ["QuantileSketch", "merge_all"]


class QuantileSketch:
    """Bounded, mergeable streaming quantile sketch; see module docstring.

    ``rel_acc`` is the value-relative accuracy ``a`` of bucket-mode
    quantiles; ``exact_threshold`` the sample count below which quantiles
    are exact; ``max_buckets`` bounds memory (per sign)."""

    __slots__ = ("rel_acc", "exact_threshold", "max_buckets", "count",
                 "total", "min", "max", "_gamma", "_lg", "_exact", "_pos",
                 "_neg", "_zero")

    def __init__(self, rel_acc: float = 0.01, exact_threshold: int = 128,
                 max_buckets: int = 2048):
        if not 0.0 < rel_acc < 1.0:
            raise ValueError(f"rel_acc must be in (0, 1): {rel_acc}")
        self.rel_acc = rel_acc
        self.exact_threshold = exact_threshold
        self.max_buckets = max_buckets
        self._gamma = (1.0 + rel_acc) / (1.0 - rel_acc)
        self._lg = math.log(self._gamma)
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self._exact: Optional[List[float]] = []   # None once spilled
        self._pos: Dict[int, int] = {}
        self._neg: Dict[int, int] = {}
        self._zero = 0

    # -- ingest --------------------------------------------------------------

    def _bucket(self, mag: float) -> int:
        return int(math.ceil(math.log(mag) / self._lg))

    def _bucket_value(self, idx: int) -> float:
        # bucket i covers (gamma^(i-1), gamma^i]; the midpoint reconstructs
        # any member within rel_acc
        return 2.0 * self._gamma ** idx / (self._gamma + 1.0)

    def _spill(self) -> None:
        """Move the exact store into buckets (order-independent: each value
        quantizes alone, so spilling now or at stream position k yields the
        same bucket content)."""
        vals, self._exact = self._exact, None
        for v in vals:
            self._bucket_add(v, 1)

    def _bucket_add(self, v: float, n: int) -> None:
        if v == 0.0:
            self._zero += n
        elif v > 0.0:
            i = self._bucket(v)
            self._pos[i] = self._pos.get(i, 0) + n
        else:
            i = self._bucket(-v)
            self._neg[i] = self._neg.get(i, 0) + n
        if len(self._pos) > self.max_buckets:
            self._collapse(self._pos)
        if len(self._neg) > self.max_buckets:
            self._collapse(self._neg)

    @staticmethod
    def _collapse(buckets: Dict[int, int]) -> None:
        """DDSketch collapse: fold the lowest bucket into its neighbour so
        upper quantiles (the straggler end) keep full accuracy."""
        lo = min(buckets)
        n = buckets.pop(lo)
        nxt = min(buckets)
        buckets[nxt] = buckets.get(nxt, 0) + n

    def add(self, value: float) -> None:
        v = float(value)
        self.count += 1
        self.total += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        if self._exact is not None:
            self._exact.append(v)
            if len(self._exact) > self.exact_threshold:
                self._spill()
        else:
            self._bucket_add(v, 1)

    def add_many(self, values) -> None:
        """Vectorized ingest of a 1-D array-like (one numpy pass for the
        bucket assignment — million-sample streams in milliseconds)."""
        import numpy as np
        vals = np.asarray(values, np.float64).reshape(-1)
        if vals.size == 0:
            return
        self.count += int(vals.size)
        self.total += float(vals.sum())
        self.min = min(self.min, float(vals.min()))
        self.max = max(self.max, float(vals.max()))
        if self._exact is not None:
            if len(self._exact) + vals.size <= self.exact_threshold:
                self._exact.extend(float(v) for v in vals)
                return
            self._spill()
        self._zero += int((vals == 0.0).sum())
        for sign, store in ((1.0, self._pos), (-1.0, self._neg)):
            part = vals[sign * vals > 0.0] * sign
            if part.size == 0:
                continue
            idx = np.ceil(np.log(part) / self._lg).astype(np.int64)
            uniq, cnt = np.unique(idx, return_counts=True)
            for i, n in zip(uniq, cnt):
                store[int(i)] = store.get(int(i), 0) + int(n)
            while len(store) > self.max_buckets:
                self._collapse(store)

    # -- merge ---------------------------------------------------------------

    def merge(self, other: "QuantileSketch") -> "QuantileSketch":
        """Fold ``other`` into ``self`` (in place; returns self).  Requires
        matching ``rel_acc`` — merging sketches of different resolutions
        would silently void the accuracy guarantee."""
        if abs(other.rel_acc - self.rel_acc) > 1e-12:
            raise ValueError(
                f"cannot merge sketches with different rel_acc: "
                f"{self.rel_acc} vs {other.rel_acc}")
        self.count += other.count
        self.total += other.total
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)
        if self._exact is not None and other._exact is not None and \
                len(self._exact) + len(other._exact) <= self.exact_threshold:
            self._exact.extend(other._exact)
            return self
        if self._exact is not None:
            self._spill()
        if other._exact is not None:
            for v in other._exact:
                self._bucket_add(v, 1)
        else:
            self._zero += other._zero
            for i, n in other._pos.items():
                self._pos[i] = self._pos.get(i, 0) + n
            for i, n in other._neg.items():
                self._neg[i] = self._neg.get(i, 0) + n
            while len(self._pos) > self.max_buckets:
                self._collapse(self._pos)
            while len(self._neg) > self.max_buckets:
                self._collapse(self._neg)
        return self

    def copy(self) -> "QuantileSketch":
        out = QuantileSketch(self.rel_acc, self.exact_threshold,
                             self.max_buckets)
        out.count, out.total = self.count, self.total
        out.min, out.max = self.min, self.max
        out._exact = None if self._exact is None else list(self._exact)
        out._pos, out._neg = dict(self._pos), dict(self._neg)
        out._zero = self._zero
        return out

    # -- quantiles -----------------------------------------------------------

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    @property
    def is_exact(self) -> bool:
        return self._exact is not None

    @property
    def num_buckets(self) -> int:
        return len(self._pos) + len(self._neg)

    def quantile(self, q: float) -> float:
        """q in [0, 100].  Exact mode: numpy's linear interpolation.
        Bucket mode: the midpoint of the bucket holding rank
        ``q/100·(count−1)`` (value-relative error ≤ ``rel_acc``)."""
        if self.count == 0:
            return 0.0
        if self._exact is not None:
            xs = sorted(self._exact)
            pos = (q / 100.0) * (len(xs) - 1)
            lo = int(pos)
            hi = min(lo + 1, len(xs) - 1)
            frac = pos - lo
            return xs[lo] * (1.0 - frac) + xs[hi] * frac
        rank = (q / 100.0) * (self.count - 1)
        seen = 0
        # negatives descend from the most-negative value: iterate magnitude
        # buckets high -> low
        for i in sorted(self._neg, reverse=True):
            seen += self._neg[i]
            if seen > rank:
                return -self._bucket_value(i)
        seen += self._zero
        if seen > rank:
            return 0.0
        for i in sorted(self._pos):
            seen += self._pos[i]
            if seen > rank:
                return self._bucket_value(i)
        return self._bucket_value(max(self._pos)) if self._pos else 0.0

    # Histogram-compatible alias: Tracer.hist consumers call percentile()
    percentile = quantile

    def summary(self) -> Dict[str, float]:
        if not self.count:
            return {"count": 0}
        return {
            "count": self.count,
            "mean": self.mean,
            "min": self.min,
            "max": self.max,
            "p50": self.quantile(50),
            "p95": self.quantile(95),
            "p99": self.quantile(99),
            "rel_acc": self.rel_acc,
            "exact": self._exact is not None,
        }

    # -- serialization -------------------------------------------------------

    def to_dict(self) -> dict:
        return {
            "rel_acc": self.rel_acc,
            "exact_threshold": self.exact_threshold,
            "max_buckets": self.max_buckets,
            "count": self.count,
            "total": self.total,
            "min": self.min if self.count else None,
            "max": self.max if self.count else None,
            "exact": self._exact,
            "pos": {str(k): v for k, v in self._pos.items()},
            "neg": {str(k): v for k, v in self._neg.items()},
            "zero": self._zero,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "QuantileSketch":
        out = cls(d["rel_acc"], d["exact_threshold"], d["max_buckets"])
        out.count = d["count"]
        out.total = d["total"]
        out.min = d["min"] if d["min"] is not None else float("inf")
        out.max = d["max"] if d["max"] is not None else float("-inf")
        out._exact = list(d["exact"]) if d["exact"] is not None else None
        out._pos = {int(k): v for k, v in d["pos"].items()}
        out._neg = {int(k): v for k, v in d["neg"].items()}
        out._zero = d["zero"]
        return out


def merge_all(sketches: Iterable[QuantileSketch]) -> QuantileSketch:
    """Merge an iterable of sketches into a fresh one (the per-cluster ->
    fleet roll-up).  Raises on an empty iterable only implicitly via the
    first sketch's parameters — pass at least one."""
    it = iter(sketches)
    try:
        first = next(it)
    except StopIteration:
        raise ValueError("merge_all needs at least one sketch") from None
    out = first.copy()
    for s in it:
        out.merge(s)
    return out
