"""Finite screens: server-side delta validation, and the serve step's
per-lane logits screen.

Applied to every upload of a round's cohort:

  * **finite** — any NaN/Inf anywhere in the delta rejects it
    (``reason="corrupt"``);
  * **norm** — a delta whose L2 norm exceeds ``byz_k`` × the cohort median
    norm rejects (``reason="byzantine"``).

``logits_finite`` is the serving mirror of the finite screen: the guarded
serve step evaluates it on every decode step's logits, and the engine
quarantines a lane that fails it.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import tree as tree_util


def logits_finite(logits: torch.Tensor) -> torch.Tensor:
    """Per-lane finite screen of a ``(B, V)`` logits slice: a ``(B,)`` bool
    tensor, False where any entry of that lane's row is NaN or Inf.  It
    stays on the logits' device (no synchronization)."""
    return torch.isfinite(logits).all(dim=-1)


def delta_norm(tree) -> float:
    """Global L2 norm of a delta tree (NaN if any leaf is non-finite)."""
    leaves = tree_util.leaves(tree)
    if not leaves:
        return 0.0
    return float(torch.sqrt(sum(torch.sum(torch.square(l.float()))
                                for l in leaves)))


def validate_deltas(deltas: Sequence, *, byz_k: float = 25.0
                    ) -> List[Tuple[bool, Optional[str], float]]:
    """One ``(ok, reason, norm)`` per delta of the cohort, ``reason`` in
    ``{"corrupt", "byzantine", None}``."""
    norms = [delta_norm(d) for d in deltas]
    finite = [n for n in norms if math.isfinite(n)]
    med = float(np.median(finite)) if finite else 0.0
    out: List[Tuple[bool, Optional[str], float]] = []
    for n in norms:
        if not math.isfinite(n):
            out.append((False, "corrupt", n))
        elif med > 0.0 and n > byz_k * med:
            out.append((False, "byzantine", n))
        else:
            out.append((True, None, n))
    return out
