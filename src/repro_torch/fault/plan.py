"""Declarative, deterministic fault schedules: per client for the
federated fit, per request for serving.

A :class:`FaultPlan` maps client ids to lists of :class:`Fault` specs and
answers two questions the round loop asks:

  * :meth:`FaultPlan.attempt`: given a client's base (virtual) fit
    duration, how long until its upload arrives, and does it arrive at
    all?  Crash, hang, transient and delay faults act here, entirely on
    the virtual clock.
  * :meth:`FaultPlan.mutate_delta`: what does the server actually
    receive?  Corrupt (NaN/Inf) and byzantine (norm-scaled) faults act
    here, on the post-wire (dequantized) delta tree.

A :class:`ServingFaultPlan` maps a request's index in submission order to
one fault kind, which a chaos harness consumes declaratively.

Plans are plain data, deterministic from their construction (or from the
seed of ``random``, drawn with numpy as the reference's are), so a chaos
run replays bit for bit and the same plan drives the reference and the
port.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as tree_util

__all__ = ["FAULT_KINDS", "SERVE_FAULT_KINDS", "Fault", "FaultPlan",
           "Attempt", "ServingFaultPlan"]

#: crash   — client computes but dies before upload (nothing arrives)
#: hang    — client never returns (arrival at +inf; the deadline excludes it)
#: transient — ``fails`` failed attempts with exponential backoff, then
#:             success
#: corrupt — upload arrives with non-finite values (NaN/Inf)
#: byzantine — upload arrives scaled by ``scale`` (norm attack)
#: delay   — upload arrives ``delay_s`` virtual seconds late
FAULT_KINDS = ("crash", "hang", "transient", "corrupt", "byzantine", "delay")

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
class Fault:
    """One fault spec.  ``rounds=None`` fires every round, otherwise only
    on the given rounds."""

    kind: str
    rounds: Optional[FrozenSet[int]] = None
    delay_s: float = 0.0           # delay: extra virtual seconds
    fails: int = 2                 # transient: failed attempts before success
    backoff_s: float = 0.25        # transient: base backoff, doubles per retry
    scale: float = 100.0           # byzantine: delta multiplier
    mode: str = "nan"              # corrupt: "nan" | "inf"

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"fault kind {self.kind!r}: choose from {FAULT_KINDS}")

    def active(self, round_idx: int) -> bool:
        return self.rounds is None or round_idx in self.rounds


@dataclass(frozen=True)
class Attempt:
    """Outcome of one client's round attempt on the virtual clock."""

    client: int
    round: int
    outcome: str                   # "ok" | "crash" | "hang"
    virtual_s: float               # total virtual duration incl. retries
    retries: int = 0
    kinds: Tuple[str, ...] = ()

    @property
    def uploads(self) -> bool:
        """Does a payload ever reach the server?"""
        return self.outcome == "ok"


@dataclass
class FaultPlan:
    """Per-client fault schedule; see the module docstring.

    ``base_fit_s``: if set, every fit costs exactly this many virtual
    seconds (fully deterministic timelines, which a resume relies on).  If
    ``None``, the measured wall time of the real fit is the base (what the
    ``slow_clients`` shim keeps, so straggler detection still sees real
    compute skew plus the injected delay).
    """

    faults: Dict[int, List[Fault]] = field(default_factory=dict)
    base_fit_s: Optional[float] = None
    seed: int = 0

    # -- queries -------------------------------------------------------------

    def faults_for(self, client: int, round_idx: int) -> List[Fault]:
        return [f for f in self.faults.get(int(client), ())
                if f.active(round_idx)]

    def kinds_for(self, client: int, round_idx: int) -> Tuple[str, ...]:
        return tuple(f.kind for f in self.faults_for(client, round_idx))

    def will_upload(self, client: int, round_idx: int) -> bool:
        """False when a crash/hang fault means the fit result is never
        delivered: the round loop skips the (expensive) real fit then."""
        return not ({"crash", "hang"} &
                    set(self.kinds_for(client, round_idx)))

    def fault_rate(self, n_clients: int) -> float:
        return len(self.faults) / max(n_clients, 1)

    # -- timing --------------------------------------------------------------

    def attempt(self, client: int, round_idx: int,
                base_s: float) -> Attempt:
        """Resolve this client's round on the virtual clock.  ``base_s``
        is the duration of one clean fit (``base_fit_s`` overrides the
        caller's measurement when set)."""
        base = self.base_fit_s if self.base_fit_s is not None else base_s
        virtual = base
        retries = 0
        outcome = "ok"
        kinds = self.kinds_for(client, round_idx)
        for f in self.faults_for(client, round_idx):
            if f.kind == "delay":
                virtual += f.delay_s
            elif f.kind == "transient":
                # each failed attempt costs a full fit plus its backoff
                for i in range(f.fails):
                    virtual += base + f.backoff_s * (2 ** i)
                retries += f.fails
            elif f.kind == "crash":
                outcome = "crash"            # dies at upload time
            elif f.kind == "hang":
                outcome = "hang"
                virtual = math.inf
        return Attempt(int(client), round_idx, outcome, virtual,
                       retries, kinds)

    # -- payload -------------------------------------------------------------

    @torch.no_grad()
    def mutate_delta(self, client: int, round_idx: int, delta):
        """Apply corrupt/byzantine faults to the delta tree the server
        receives (post-wire: the damage is on the upload path, not in the
        client's honest EF quantization).  A fault that acts returns a new
        tree; the caller's is never written."""
        for f in self.faults_for(client, round_idx):
            if f.kind == "corrupt":
                bad = math.nan if f.mode == "nan" else math.inf

                def corrupt(l, bad=bad):
                    if not l.numel():
                        return l
                    out = l.reshape(-1).clone()
                    out[0] = bad
                    return out.reshape(l.shape)

                delta = tree_util.map_(corrupt, delta)
            elif f.kind == "byzantine":
                delta = tree_util.map_(lambda l, s=f.scale: l * s, delta)
        return delta

    # -- constructors --------------------------------------------------------

    @classmethod
    def from_slow_clients(cls, slow: Dict[int, float]) -> "FaultPlan":
        """The ``slow_clients={id: seconds}`` kwarg as a plan: pure virtual
        delay over the measured base."""
        return cls({int(c): [Fault("delay", delay_s=float(s))]
                    for c, s in slow.items()})

    @classmethod
    def random(cls, n_clients: int, rate: float, rounds: int, *,
               seed: int = 0, kinds: Tuple[str, ...] = FAULT_KINDS[:5],
               per_round_p: float = 0.6,
               base_fit_s: float = 1.0) -> "FaultPlan":
        """Deterministic chaos: ~``rate`` of the clients get one fault of
        a random kind, firing independently per round with probability
        ``per_round_p`` (at least one round always fires).  The same seed
        gives the same plan, bit for bit, as the reference's."""
        rng = np.random.default_rng(seed)
        faults: Dict[int, List[Fault]] = {}
        for cid in range(n_clients):
            if rng.random() >= rate:
                continue
            kind = kinds[int(rng.integers(len(kinds)))]
            active = frozenset(int(r) for r in range(rounds)
                               if rng.random() < per_round_p)
            if not active:
                active = frozenset({int(rng.integers(max(rounds, 1)))})
            faults[cid] = [Fault(kind, rounds=active)]
        return cls(faults, base_fit_s=base_fit_s, seed=seed)


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
