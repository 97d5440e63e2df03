"""FIFO admission control with prefill chunking for the serving engine.

Two budgets bound what one engine step may admit:

  * ``max_tokens_in_flight`` — worst-case token footprint (prompt + full
    horizon) summed over resident requests;
  * ``prefill_chunk`` — prompt tokens prefillable per engine step, so a
    burst of admissions is spread across steps and resident streams keep
    decoding.  A prompt longer than the chunk is admitted alone.

``bucket_len`` pads prompt lengths up to a bucket multiple (the pad is
masked downstream via ``prefill(..., true_len=...)``).
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Deque, List, Optional

from repro_torch import obs
from repro_torch.serve.request import Request


def bucket_len(n: int, bucket: int) -> int:
    """Smallest multiple of ``bucket`` >= n (identity when bucket <= 0)."""
    if bucket <= 0:
        return n
    return -(-n // bucket) * bucket


@dataclasses.dataclass
class SchedulerConfig:
    max_tokens_in_flight: int = 0             # 0 == unbounded
    prefill_chunk: int = 0                    # 0 == unbounded per step


class FIFOScheduler:
    """Arrival-ordered admission: the head request admits as soon as a slot
    and the budgets allow; later arrivals never jump the queue."""

    def __init__(self, config: Optional[SchedulerConfig] = None):
        self.config = config or SchedulerConfig()
        self._queue: Deque[Request] = deque()

    def submit(self, request: Request) -> None:
        self._queue.append(request)

    def requeue_front(self, requests: List[Request]) -> None:
        """Push displaced requests back at the head, list order preserved
        (``requests[0]`` pops first).  A tick's victims arrive in ONE call,
        oldest submit first, so FIFO order survives multi-eviction ticks."""
        for r in reversed(requests):
            obs.instant("sched.requeue", track=f"req:{r.id}", id=r.id,
                        queue_depth=len(self._queue))
            self._queue.appendleft(r)

    @property
    def pending(self) -> int:
        return len(self._queue)

    def pending_tokens(self) -> int:
        """Worst-case token footprint queued (the engine's retry-after
        hint divides this by the slot count)."""
        return sum(r.total_tokens for r in self._queue)

    def queued(self) -> List[Request]:
        """Snapshot of the queue, head first (the engine's shed-victim
        choice reads it; changes go through ``remove``/``cancel_where``,
        which keep FIFO order)."""
        return list(self._queue)

    def remove(self, request: Request) -> bool:
        """Drop one queued request (load shedding), the order of the rest
        untouched.  False if it already left the queue."""
        try:
            self._queue.remove(request)
            return True
        except ValueError:
            return False

    def cancel_where(self, pred: Callable[[Request], bool]
                     ) -> List[Request]:
        """Remove every queued request matching ``pred`` (the SLO sweep),
        keeping the survivors' FIFO order.  Returns the removed requests in
        queue order."""
        flags = [bool(pred(r)) for r in self._queue]
        removed = [r for r, f in zip(self._queue, flags) if f]
        if removed:
            kept = [r for r, f in zip(self._queue, flags) if not f]
            self._queue.clear()
            self._queue.extend(kept)
        return removed

    def admit(self, *, now_step: int, free_slots: int,
              tokens_in_flight: int, free_blocks: int = -1,
              blocks_needed: Optional[Callable[[Request], int]] = None
              ) -> List[Request]:
        """Pop the FIFO prefix admissible this step.

        With a paged pool admission is priced in blocks: ``free_blocks`` is
        the free-list size and ``blocks_needed(req)`` a request's prefill
        block count (shared prefix blocks cost nothing).  ``free_blocks``
        < 0 (contiguous lanes) disables block accounting."""
        cfg = self.config
        out: List[Request] = []
        prefill_used = 0
        blocks_used = 0
        while self._queue and len(out) < free_slots:
            req = self._queue[0]
            if req.arrival_step > now_step:
                break                          # trace time not reached (FIFO)
            if cfg.max_tokens_in_flight > 0 and tokens_in_flight + \
                    req.total_tokens > cfg.max_tokens_in_flight:
                break
            if free_blocks >= 0 and blocks_needed is not None and \
                    blocks_used + blocks_needed(req) > free_blocks:
                break                          # pool full — wait for frees
            if cfg.prefill_chunk > 0 and prefill_used > 0 and \
                    prefill_used + req.prompt_len > cfg.prefill_chunk:
                break                          # chunk full — next step
            out.append(self._queue.popleft())
            prefill_used += req.prompt_len
            tokens_in_flight += req.total_tokens
            if blocks_needed is not None:
                blocks_used += blocks_needed(req)
        return out
