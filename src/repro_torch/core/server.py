"""Server-side aggregation (paper Algorithm 1, lines 12-14).

Per cluster: weighted FedAvg of the client adapter deltas, then FedAdam on
the cluster's global adapters (the paper uses FedAdam to update the QLoRA
parameters, §4.1 Implementation Details).  The reference's
``StalenessBuffer`` (late uploads under a deadline) is not ported yet.
"""

from __future__ import annotations

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
