"""Declarative, deterministic request-scoped fault schedules for serving.

A :class:`ServingFaultPlan` maps a request's index in submission order to
one fault kind, which a chaos harness consumes declaratively.  Plans are
plain data, deterministic from their construction (or from the seed of
:meth:`ServingFaultPlan.random`, drawn with numpy as the reference's
are), so a chaos trace replays bit for bit and the same plan drives the
reference's engine and the port's.

The federated fit's per-client ``FaultPlan`` is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np

__all__ = ["SERVE_FAULT_KINDS", "ServingFaultPlan"]

#: Request-scoped fault kinds, one per request:
#: malformed — prompt carries out-of-vocabulary token ids (quarantined at
#:             submit, before any device work)
#: poison    — NaN injected into the request's logits row mid-decode
#:             (quarantined by the in-step guard; neighbours untouched)
#: deadline  — the request's deadline is set tighter than its decode can
#:             finish (cancelled mid-decode with full reclamation)
#: burst     — the request arrives inside a submit burst that overflows
#:             the bounded queue (exercises cost-aware load shedding)
#: kill      — the engine process dies while this request is mid-decode
#:             (journal replay must resume it bit for bit)
SERVE_FAULT_KINDS = ("malformed", "poison", "deadline", "burst", "kill")


@dataclass(frozen=True)
class ServingFaultPlan:
    """Per-request fault schedule for the serving chaos harness.

    ``faults`` maps a request's index in submission order to one of
    :data:`SERVE_FAULT_KINDS`: ``malformed`` rewrites the prompt via
    :meth:`malform_prompt` before submit, ``poison`` arms the engine's NaN
    injector for that request id, ``deadline`` submits with an unmeetable
    deadline, ``burst`` batches the submit into an overflow burst, ``kill``
    marks where the harness stops the engine."""

    faults: Dict[int, str] = field(default_factory=dict)
    seed: int = 0

    def __post_init__(self):
        for idx, kind in self.faults.items():
            if kind not in SERVE_FAULT_KINDS:
                raise ValueError(f"serving fault kind {kind!r} for request "
                                 f"{idx}: choose from {SERVE_FAULT_KINDS}")

    def kind_for(self, request_idx: int) -> Optional[str]:
        return self.faults.get(int(request_idx))

    def indices(self, kind: str) -> Tuple[int, ...]:
        """Request indices carrying ``kind``, in submission order."""
        return tuple(sorted(i for i, k in self.faults.items() if k == kind))

    def fault_rate(self, n_requests: int) -> float:
        return len(self.faults) / max(n_requests, 1)

    def malform_prompt(self, request_idx: int, prompt: np.ndarray,
                       vocab_size: int) -> np.ndarray:
        """Deterministically damage one prompt token to an
        out-of-vocabulary id (the submit-time screen must catch it)."""
        rng = np.random.default_rng((self.seed, int(request_idx)))
        bad = np.array(prompt, dtype=np.int32, copy=True)
        bad[int(rng.integers(bad.shape[0]))] = vocab_size + int(
            rng.integers(1, 7))
        return bad

    @classmethod
    def random(cls, n_requests: int, rate: float, *, seed: int = 0,
               kinds: Tuple[str, ...] = SERVE_FAULT_KINDS[:4]
               ) -> "ServingFaultPlan":
        """~``rate`` of the requests each get one uniformly chosen fault
        kind; the same seed gives the same plan, bit for bit.  ``kill`` is
        left out of the default kinds: a harness stops the engine at a
        chosen step rather than per request."""
        rng = np.random.default_rng(seed)
        faults: Dict[int, str] = {}
        for idx in range(n_requests):
            if rng.random() < rate:
                faults[idx] = kinds[int(rng.integers(len(kinds)))]
        return cls(faults, seed=seed)
