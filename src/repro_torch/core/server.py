"""Server-side aggregation (paper Algorithm 1, lines 12-14).

Per cluster: weighted FedAvg of the client adapter deltas, then FedAdam on
the cluster's global adapters (the paper uses FedAdam to update the QLoRA
parameters, §4.1 Implementation Details).

Fault tolerance:

  * :meth:`ClusterServer.apply_deltas`: under partial participation the
    cohort is whatever survived the deadline plus whatever drained from
    the staleness buffer; weights are renormalized to sum to 1 over exactly
    that cohort before the FedAdam step.
  * :class:`StalenessBuffer`: server-side accumulation of late client
    deltas on the virtual clock.  Deltas arriving after a round's deadline
    buffer until the cluster's next aggregation; a drained delta ``s``
    rounds old is down-weighted by ``decay**s`` and rejected outright at or
    beyond ``limit`` rounds (bounded staleness).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, List, Tuple

import torch

from repro_torch import tree as tree_util
from repro_torch.optim.fedadam import fedadam_init, fedadam_update, fedavg


class ClusterServer:
    """Holds one cluster's global adapter state + FedAdam moments."""

    def __init__(self, adapters, *, lr: float = 1e-2):
        self.adapters = adapters
        self.opt = fedadam_init(adapters)
        self.lr = lr
        self.round = 0

    def aggregate(self, client_adapters, weights):
        """client_adapters: list of adapter trees; weights: per-device w_s
        (paper: w_{s,c}, e.g. local dataset sizes)."""
        deltas = [tree_util.map_(lambda a, g: a.float() - g.float(), ad,
                                 self.adapters) for ad in client_adapters]
        return self.apply_deltas(deltas, weights)

    def apply_deltas(self, deltas, weights):
        """FedAdam step from client adapter DELTAS; ``weights`` are
        renormalized to sum to 1 over this cohort."""
        if not deltas:
            raise ValueError("apply_deltas needs a non-empty cohort")
        w = torch.as_tensor(weights, dtype=torch.float32)
        if tuple(w.shape) != (len(deltas),):
            raise ValueError(
                f"weights shape {tuple(w.shape)} != cohort size "
                f"{len(deltas)}")
        if float(w.sum()) <= 0.0:
            raise ValueError("cohort weights must sum to a positive value")
        avg_delta = fedavg(deltas, w)
        self.adapters, self.opt = fedadam_update(
            self.adapters, avg_delta, self.opt, lr=self.lr)
        self.round += 1
        return self.adapters


# ---------------------------------------------------------------------------
# Staleness-bounded async buffering
# ---------------------------------------------------------------------------

@dataclass
class BufferedDelta:
    """One late client delta parked server-side until its cluster's next
    aggregation window."""

    client: int
    cluster: int
    origin_round: int          # the round whose global the delta is against
    ready_at: float            # virtual arrival time
    weight: float              # raw client weight (pre-decay)
    loss: float
    delta: Any                 # adapter-delta tree (post-wire view)


class StalenessBuffer:
    """Bounded-staleness accumulation of late deltas; see the module
    docstring.  ``drain`` returns ``(apply, reject)``: the entries whose
    arrival fell inside the closing window, split by the staleness bound,
    each applied entry's weight multiplied by ``decay**s``.

    ``limit`` is exclusive: an entry whose staleness equals ``limit`` is
    rejected, by ``drain`` and by the trainer's apply path alike (both call
    :meth:`is_stale`).  Since :meth:`staleness_of` floors staleness at 1,
    ``limit`` must be >= 2 for a buffered delta ever to apply."""

    def __init__(self, limit: int = 2, decay: float = 0.5):
        if limit < 0 or not (0.0 < decay <= 1.0):
            raise ValueError(f"bad staleness bound limit={limit} "
                             f"decay={decay}")
        self.limit = limit
        self.decay = decay
        self.entries: List[BufferedDelta] = []

    @staticmethod
    def staleness_of(round_idx: int, origin_round: int) -> int:
        """Rounds a buffered delta has aged, floored at 1."""
        return max(round_idx - origin_round, 1)

    def is_stale(self, staleness: int) -> bool:
        """True when ``staleness`` is at or beyond ``limit``."""
        return staleness >= self.limit

    def add(self, entry: BufferedDelta) -> None:
        if not math.isfinite(entry.ready_at):
            raise ValueError("non-arriving (hung) uploads never buffer")
        self.entries.append(entry)

    def __len__(self) -> int:
        return len(self.entries)

    def drain(self, cluster: int, round_idx: int, window_end: float
              ) -> Tuple[List[Tuple[BufferedDelta, float]],
                         List[Tuple[BufferedDelta, int]]]:
        """Pull this cluster's entries that arrived by ``window_end``.
        Returns ``(apply, reject)``: ``apply`` pairs each entry with its
        decayed weight, ``reject`` each with its (too large) staleness."""
        ready = [e for e in self.entries
                 if e.cluster == cluster and e.ready_at <= window_end]
        taken = {id(e) for e in ready}
        self.entries = [e for e in self.entries if id(e) not in taken]
        apply, reject = [], []
        for e in ready:
            staleness = self.staleness_of(round_idx, e.origin_round)
            if self.is_stale(staleness):
                reject.append((e, staleness))
            else:
                apply.append((e, e.weight * self.decay ** staleness))
        return apply, reject
