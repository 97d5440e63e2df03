"""Atomic round-state snapshots for mid-round crash recovery.

The federated trainer's mutable round state is small but scattered:
per-cluster server adapters and FedAdam moments, per-client EF wire
residuals, the staleness buffer of late deltas, the participation clock,
the numpy RNG driving cohort sampling, and the virtual clock.
``save_round_state`` packs all of it into one tree and writes it through
:mod:`repro_torch.train.checkpoint` (temp file, fsync, atomic rename), so a
kill -9 mid-write leaves either the previous complete snapshot or the new
one.  ``load_round_state`` refuses anything that is not a valid snapshot
of the expected schema.

Array state rides as ordinary checkpoint leaves (bit-exact restore);
non-array state (the PCG64 state, the participation clock, buffered-entry
metadata, round logs) rides as the checkpoint's JSON metadata: numpy's
PCG64 state holds 128-bit integers that no tensor dtype holds, and JSON
does.  The file is the port's own (``RTCKPT01``): the reference's snapshots
(msgpack, ``RPCKPT01``) do not load here, nor the port's there.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Tuple

from repro_torch.train import checkpoint

__all__ = ["SNAPSHOT_SCHEMA", "save_round_state", "load_round_state"]

SNAPSHOT_SCHEMA = "repro.fault.roundstate/v1"


def save_round_state(path: str, arrays: Dict[str, Any],
                     meta: Dict[str, Any]) -> int:
    """Write one atomic snapshot.  ``arrays`` is a tree of string-keyed
    dicts of tensors; ``meta`` is any JSON-serializable metadata.  Returns
    the bytes written."""
    return checkpoint.save(path, arrays, {**meta, "schema": SNAPSHOT_SCHEMA})


def load_round_state(path: str, device="cuda"
                     ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Load a snapshot as ``(meta, arrays)``, the arrays on ``device``.
    Raises ``ValueError`` on a missing or incompatible schema
    (``checkpoint.read`` itself raises on truncated or corrupt files)."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"round-state snapshot not found: {path}")
    meta, arrays = checkpoint.read(path, device)
    if not isinstance(meta, dict) or "schema" not in meta:
        raise ValueError(f"{path} is not a round-state snapshot "
                         "(no schema in its metadata)")
    if meta["schema"] != SNAPSHOT_SCHEMA:
        raise ValueError(
            f"{path}: snapshot schema {meta['schema']!r} != "
            f"{SNAPSHOT_SCHEMA!r}")
    return meta, arrays
