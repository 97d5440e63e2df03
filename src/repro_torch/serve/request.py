"""Request / generation state for the continuous-batching engine.

A ``Request`` is one client's query: a tokenized prompt, a generation
budget, and per-request sampling parameters.  ``GenState`` is the engine's
per-slot host-side bookkeeping while the request is in flight; the decode
step only ever sees the fixed-shape per-slot batch rows the engine packs.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import numpy as np

# streaming callback: (request_id, token, is_last) fired per generated token
StreamFn = Callable[[str, int, bool], None]


@dataclasses.dataclass
class SamplingParams:
    """Per-request sampling knobs; ``temperature <= 0`` decodes greedily."""
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 0.0
    seed: int = 0


@dataclasses.dataclass
class Request:
    """One serving request.

    SLOs are measured on the engine's clock from the request's first
    submit (a shed and retried request starts a fresh window; an evicted
    or journal-replayed one keeps its original): ``deadline_s`` bounds the
    whole request, ``ttft_slo_s`` its first token.

    ``resume`` is engine-internal: a request re-queued mid-decode (evicted
    to recompute, or replayed from the journal) carries its generated
    tokens in the prompt and records ``{"generated": [...], "prompt_len":
    orig}`` so that its output and sampling counters stay those of the
    original request."""
    id: str
    prompt: Sequence[int]
    max_new_tokens: int
    sampling: SamplingParams = dataclasses.field(default_factory=SamplingParams)
    eos_id: Optional[int] = None              # optional stop token
    arrival_step: int = 0                     # earliest engine step admitting
    stream: Optional[StreamFn] = None         # per-token streaming callback
    deadline_s: Optional[float] = None
    ttft_slo_s: Optional[float] = None
    resume: Optional[dict] = None

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32)
        if self.prompt.ndim != 1 or self.prompt.size == 0:
            raise ValueError(f"request {self.id}: prompt must be a non-empty "
                             f"1-D token sequence")
        if self.max_new_tokens < 1:
            raise ValueError(f"request {self.id}: max_new_tokens must be >= 1")
        for name in ("deadline_s", "ttft_slo_s"):
            v = getattr(self, name)
            if v is not None and not (float(v) > 0.0):
                raise ValueError(
                    f"request {self.id}: {name} must be > 0 when set")

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def total_tokens(self) -> int:
        """Worst-case footprint: prompt + full horizon (admission budget).
        A resumed request's prompt carries tokens its horizon already
        counts, so they are subtracted."""
        resumed = len(self.resume["generated"]) if self.resume else 0
        return self.prompt_len - resumed + self.max_new_tokens


@dataclasses.dataclass
class GenState:
    """Per-slot in-flight state (host side)."""
    request: Request
    slot: int
    pos: int                                  # position of the NEXT decode
    generated: List[int] = dataclasses.field(default_factory=list)
    admitted_step: int = 0
    admitted_time: float = 0.0
    first_token_time: float = 0.0
    # a resume's generated tokens still to re-decode (fed as the step's
    # inputs, not emitted again)
    forced: List[int] = dataclasses.field(default_factory=list)

    @property
    def remaining(self) -> int:
        return self.request.max_new_tokens - len(self.generated)

    def emit(self, token: int, *, is_last: bool, now: float) -> None:
        if not self.generated:
            self.first_token_time = now
        self.generated.append(int(token))
        if self.request.stream is not None:
            self.request.stream(self.request.id, int(token), is_last)


@dataclasses.dataclass
class FinishedRequest:
    """Engine output record for one retired request.  ``reason`` is
    ``"length"``/``"eos"`` for clean completions, ``"deadline"``/
    ``"ttft_slo"`` for SLO cancellations (``tokens`` then holds whatever
    was generated before the miss)."""
    id: str
    tokens: np.ndarray                        # (n_generated,) int32
    prompt_len: int
    admitted_step: int
    finished_step: int
    ttft_s: float                             # submit -> first token
    reason: str


@dataclasses.dataclass(frozen=True)
class SubmitVerdict:
    """What ``ForecastEngine.submit`` tells the caller happened.

    ``verdict``:
      * ``"ok"``          — queued (``shed_id`` names a *different*, older
        queued request this submit displaced, if any);
      * ``"shed"``        — the submitted request itself was shed by
        backpressure; retry after ``retry_after_s`` engine seconds;
      * ``"quarantined"`` — rejected at submit (malformed prompt); never
        queued, audited in ``engine.quarantined``.
    """
    id: str
    verdict: str                              # "ok" | "shed" | "quarantined"
    retry_after_s: float = 0.0                # shed: suggested resubmit delay
    shed_id: Optional[str] = None             # ok: queued victim it displaced
    reason: Optional[str] = None              # quarantined: audit reason

    @property
    def ok(self) -> bool:
        return self.verdict == "ok"


@dataclasses.dataclass(frozen=True)
class QuarantinedRequest:
    """Audit record for a poisoned or malformed request parked by the
    engine: why, when, and how far decode got before the screen fired."""
    id: str
    reason: str                    # "malformed_prompt" | "nonfinite_logits"
    step: int                      # engine step the quarantine fired on
    prompt_len: int
    generated: int                 # tokens emitted before quarantine
