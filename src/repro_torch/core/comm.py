"""Communication accounting of the federated rounds (paper C5 / Figure 5).

Counts exact bytes and messages per round and models wall time from link
characteristics.  Wire formats (``REPRO_FED_WIRE``, read on every call as
the reference reads it): the payload crosses the wire as f32, bf16, or int8
codes with one f32 absmax scale per ``REPRO_FED_QBLOCK`` values (default
128).  Byte counts equal the reference's exactly.  The reference's ring
plan (the multi-chip all-reduce) is not ported yet.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass

from repro_torch.core.lora import count_params, lora_tree

WIRE_FORMATS = ("f32", "bf16", "int8")
_WIRE_CODE_BYTES = {"f32": 4, "bf16": 2, "int8": 1}


def _check_wire(wire: str) -> str:
    if wire not in WIRE_FORMATS:
        raise ValueError(f"wire format {wire!r}: choose from {WIRE_FORMATS}")
    return wire


def wire_format(default: str = "f32") -> str:
    """Effective federated wire format (``REPRO_FED_WIRE``)."""
    return _check_wire(os.environ.get("REPRO_FED_WIRE", default))


def wire_qblock() -> int:
    """Absmax-scale block size of the int8 wire (``REPRO_FED_QBLOCK``)."""
    return int(os.environ.get("REPRO_FED_QBLOCK", "128"))


def wire_payload_bytes(n_elems: int, wire: str = None,
                       qblock: int = None) -> int:
    """Point-to-point upload size of an ``n_elems`` f32 payload on the
    given wire (client -> server): codes + absmax scales."""
    wire = _check_wire(wire) if wire else wire_format()
    qblock = qblock or wire_qblock()
    bytes_ = n_elems * _WIRE_CODE_BYTES[wire]
    if wire == "int8":
        bytes_ += 4 * math.ceil(n_elems / qblock)
    return bytes_


@dataclass(frozen=True)
class LinkModel:
    """Edge federation link characteristics (paper's EV-charging setting)."""
    uplink_bps: float = 100e6          # 100 Mbit/s edge uplink
    downlink_bps: float = 300e6
    latency_s: float = 0.030           # per message


@dataclass
class RoundStats:
    bytes_up: int
    bytes_down: int
    messages: int
    time_s: float

    @property
    def megabytes(self) -> float:
        return (self.bytes_up + self.bytes_down) / 1e6


def fedtime_round(params, *, clients_per_round: int, num_clusters: int,
                  link: LinkModel = LinkModel(),
                  wire: str = None) -> RoundStats:
    """LoRA-only payload: each participating client uploads its adapter
    delta; each cluster broadcasts one aggregated adapter back."""
    payload = wire_payload_bytes(count_params(lora_tree(params)), wire)
    up = payload * clients_per_round
    down = payload * clients_per_round        # broadcast back to participants
    msgs = 2 * clients_per_round + num_clusters   # +cluster->server merges
    t = (up / link.uplink_bps * 8 + down / link.downlink_bps * 8 +
         msgs * link.latency_s)
    return RoundStats(up, down, msgs, t)
