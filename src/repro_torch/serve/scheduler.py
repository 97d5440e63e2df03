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
            self._queue.appendleft(r)

    @property
    def pending(self) -> int:
        return len(self._queue)

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
