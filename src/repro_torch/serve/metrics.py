"""Serving metrics: throughput, latency percentiles, slot/block occupancy.

Host-side counters; the engine calls the record hooks and ``summary()``
folds them into one dict.  TTFT (submit -> first token, one sample per
finished request) and inter-token latency (wall time of one batched decode
step: every active request receives its next token at the step boundary)
are kept as samples and reported as p50/p95/p99.

``wall_s`` spans from construction to the last recorded event.
``steady_tok_per_s`` excludes the first decode step, which carries the
kernels' first-use cost (build or load, first launches).

Fault tolerance is counted in requests: ``requests_submitted`` (accepted
submits), ``shed`` (backpressure rejections), ``deadline_misses`` (SLO
cancellations of either kind, ``ttft_slo_misses`` the first-token ones)
and ``quarantined`` (by reason on the dataclass, their total in the
summary); ``deadline_miss_rate`` is misses over accepted submits.

The swap tier counts lanes and bytes: ``swap_outs`` / ``swap_out_bytes``
(lanes snapshotted to the host, device bytes their blocks held) and
``swap_ins`` / ``swap_in_bytes`` (lanes restored, bytes re-inserted).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np


def _pct(samples: List[float], q: float) -> float:
    return float(np.percentile(samples, q)) if samples else 0.0


@dataclasses.dataclass
class EngineMetrics:
    num_slots: int
    pool_blocks: int = 0                      # physical cache blocks (paged:
                                              # real blocks; lanes otherwise)
    started: float = dataclasses.field(default_factory=time.perf_counter)
    last_event_at: float = 0.0                # latest decode step OR finish
    decode_steps: int = 0
    decode_tokens: int = 0                    # tokens sampled in decode steps
    prefill_tokens: int = 0                   # real (unpadded) prompt tokens
    requests_finished: int = 0
    occupancy_sum: float = 0.0                # sum over steps of active/slots
    block_util_sum: float = 0.0               # sum over steps of used/pool
    peak_in_flight: int = 0                   # max resident requests
    parked_events: int = 0                    # block-grant failures (paged)
    evictions: int = 0                        # livelock-breaking evictions
    share_hits: int = 0                       # admissions sharing >=1 block
    full_prompt_hits: int = 0                 # prefill skipped entirely
    shared_blocks: int = 0                    # blocks mapped, not allocated
    cow_copies: int = 0
    cow_bytes: int = 0
    swap_outs: int = 0
    swap_out_bytes: int = 0
    swap_ins: int = 0
    swap_in_bytes: int = 0
    frag_sum: float = 0.0                     # sum over steps of pool frag
    peak_fragmentation: float = 0.0
    ttft_s: List[float] = dataclasses.field(default_factory=list)
    itl_s: List[float] = dataclasses.field(default_factory=list)
    first_step_s: float = 0.0
    steady_decode_s: float = 0.0              # decode wall time past step 1
    # fault tolerance (requests, not steps):
    requests_submitted: int = 0               # accepted submits (verdict ok)
    requests_shed: int = 0                    # backpressure rejections
    deadline_misses: int = 0                  # SLO cancellations, either kind
    ttft_slo_misses: int = 0                  # subset: first-token SLO
    quarantined: Dict[str, int] = dataclasses.field(default_factory=dict)

    def record_admit(self, prompt_len: int) -> None:
        self.prefill_tokens += prompt_len

    def record_decode_step(self, active: int, tokens_out: int,
                           elapsed_s: float, *, in_flight: int = 0,
                           blocks_in_use: int = 0,
                           fragmentation: float = 0.0) -> None:
        """One batched decode step: ``active`` lanes produced
        ``tokens_out`` tokens in ``elapsed_s`` wall seconds."""
        if self.decode_steps == 0:
            self.first_step_s = elapsed_s
        else:
            self.steady_decode_s += elapsed_s
            self.itl_s.append(elapsed_s)
        self.decode_steps += 1
        self.decode_tokens += tokens_out
        self.occupancy_sum += active / max(self.num_slots, 1)
        self.block_util_sum += blocks_in_use / max(self.pool_blocks, 1)
        self.frag_sum += fragmentation
        self.peak_fragmentation = max(self.peak_fragmentation, fragmentation)
        self.peak_in_flight = max(self.peak_in_flight, in_flight or active)
        self.last_event_at = time.perf_counter()

    def record_park(self) -> None:
        self.parked_events += 1

    def record_evict(self) -> None:
        self.evictions += 1

    def record_share(self, blocks: int, full_hit: bool) -> None:
        self.share_hits += 1
        self.shared_blocks += blocks
        self.full_prompt_hits += bool(full_hit)

    def record_cow(self, nbytes: int) -> None:
        self.cow_copies += 1
        self.cow_bytes += nbytes

    def record_swap_out(self, nbytes: int) -> None:
        self.swap_outs += 1
        self.swap_out_bytes += nbytes

    def record_swap_in(self, nbytes: int) -> None:
        self.swap_ins += 1
        self.swap_in_bytes += nbytes

    def record_finish(self, ttft_s: Optional[float] = None) -> None:
        """``ttft_s=None`` counts the finish without a TTFT sample: an SLO
        cancellation before the first token has no TTFT."""
        self.requests_finished += 1
        if ttft_s is not None:
            self.ttft_s.append(ttft_s)
        self.last_event_at = time.perf_counter()

    def record_submit(self) -> None:
        self.requests_submitted += 1

    def record_shed(self) -> None:
        self.requests_shed += 1

    def record_deadline_miss(self, *, ttft: bool = False) -> None:
        """One SLO cancellation; ``ttft=True`` when the first-token SLO was
        the one missed."""
        self.deadline_misses += 1
        self.ttft_slo_misses += bool(ttft)

    def record_quarantine(self, reason: str) -> None:
        self.quarantined[reason] = self.quarantined.get(reason, 0) + 1

    def summary(self) -> Dict[str, float]:
        span = (self.last_event_at or time.perf_counter()) - self.started
        if self.decode_steps > 1 and self.steady_decode_s > 0:
            steady_tokens = (self.decode_tokens *
                             (self.decode_steps - 1) / self.decode_steps)
            steady = steady_tokens / self.steady_decode_s
        else:
            steady = 0.0
        steps = self.decode_steps
        return {
            "requests": self.requests_finished,
            "decode_steps": steps,
            "decode_tokens": self.decode_tokens,
            "prefill_tokens": self.prefill_tokens,
            "wall_s": span,
            "tok_per_s": self.decode_tokens / span if span > 0 else 0.0,
            "steady_tok_per_s": steady,
            "mean_ttft_s": (sum(self.ttft_s) / len(self.ttft_s)
                            if self.ttft_s else 0.0),
            "max_ttft_s": max(self.ttft_s) if self.ttft_s else 0.0,
            "ttft_p50_s": _pct(self.ttft_s, 50),
            "ttft_p95_s": _pct(self.ttft_s, 95),
            "ttft_p99_s": _pct(self.ttft_s, 99),
            "itl_p50_s": _pct(self.itl_s, 50),
            "itl_p95_s": _pct(self.itl_s, 95),
            "itl_p99_s": _pct(self.itl_s, 99),
            "mean_occupancy": self.occupancy_sum / steps if steps else 0.0,
            "mean_block_utilization": (self.block_util_sum / steps
                                       if steps else 0.0),
            "pool_blocks": self.pool_blocks,
            "peak_in_flight": self.peak_in_flight,
            "parked_events": self.parked_events,
            "evictions": self.evictions,
            "share_hits": self.share_hits,
            "full_prompt_hits": self.full_prompt_hits,
            "shared_blocks": self.shared_blocks,
            "cow_copies": self.cow_copies,
            "cow_bytes": self.cow_bytes,
            "swap_outs": self.swap_outs,
            "swap_out_bytes": self.swap_out_bytes,
            "swap_ins": self.swap_ins,
            "swap_in_bytes": self.swap_in_bytes,
            "mean_fragmentation": self.frag_sum / steps if steps else 0.0,
            "peak_fragmentation": self.peak_fragmentation,
            "requests_submitted": self.requests_submitted,
            "shed": self.requests_shed,
            "deadline_misses": self.deadline_misses,
            "ttft_slo_misses": self.ttft_slo_misses,
            "quarantined": int(sum(self.quarantined.values())),
            "deadline_miss_rate": (
                self.deadline_misses / self.requests_submitted
                if self.requests_submitted else 0.0),
        }
