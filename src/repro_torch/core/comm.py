"""Communication accounting of the federated rounds (paper C5 / Figure 5).

Counts exact bytes and messages per round and models wall time from link
characteristics.  Three strategies are compared, as in the paper's Figure
5:

  * fedtime      — LoRA adapters only (the paper's method)
  * fed_full     — full model weights each way (naive FedAvg)
  * centralized  — raw windowed data shipped to the server once per epoch

Wire formats (``REPRO_FED_WIRE``, read on every call as the reference
reads it): the payload crosses the wire as f32, bf16, or int8 codes with
one f32 absmax scale per ``REPRO_FED_QBLOCK`` values (default 128).
``ring_wire_plan`` is the chunk geometry and per-hop transfer size of the
bidirectional ring all-reduce that aggregates across ranks
(``repro_torch.kernels.ring_allreduce``).  Byte counts equal the
reference's exactly.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass

from repro_torch.core.lora import count_params, lora_tree, tree_nbytes

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


@dataclass(frozen=True)
class RingWirePlan:
    """Chunk geometry of one n-way bidirectional ring all-reduce.

    The payload (``elems`` f32 values) is carved into ``n_chunks = 2·n``
    chunks, n rotating each way round the ring.  ``chunk_elems`` is
    ceil(elems / 2n), rounded up to a ``qblock`` multiple on the quantized
    wires; the padding is real wire bytes and is counted.  Every device
    sends each direction's chunk once a reduce-scatter hop and once an
    all-gather hop: ``sends = 2 phases · (n-1) hops · 2 directions``.  For
    the f32 wire on a divisible payload this is the classic 2·P·(n-1)/n.
    """
    wire: str
    n: int
    qblock: int
    elems: int
    chunk_elems: int
    n_chunks: int
    code_bytes: int      # per chunk
    scale_bytes: int     # per chunk (int8 wire only)
    sends: int           # chunk transfers per device per round

    @property
    def chunk_bytes(self) -> int:
        return self.code_bytes + self.scale_bytes

    @property
    def per_device_bytes(self) -> int:
        return self.sends * self.chunk_bytes


def ring_wire_plan(n_elems: int, n: int, wire: str = None,
                   qblock: int = None) -> RingWirePlan:
    """The chunking of an n-way ring all-reduce of ``n_elems`` values."""
    wire = _check_wire(wire) if wire else wire_format()
    qblock = qblock or wire_qblock()
    if n <= 1:
        return RingWirePlan(wire, n, qblock, n_elems, n_elems, 1, 0, 0, 0)
    c = math.ceil(n_elems / (2 * n))
    if wire in ("int8", "bf16"):
        c = math.ceil(c / qblock) * qblock
    code = c * _WIRE_CODE_BYTES[wire]
    scale = 4 * (c // qblock) if wire == "int8" else 0
    return RingWirePlan(wire, n, qblock, n_elems, c, 2 * n, code, scale,
                        sends=4 * (n - 1))


def ring_wire_bytes(n_elems: int, n: int, wire: str = None,
                    qblock: int = None) -> int:
    """Per-device bytes one n-way bidirectional ring all-reduce moves."""
    return ring_wire_plan(n_elems, n, wire, qblock).per_device_bytes


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


def fed_full_round(params, *, clients_per_round: int, num_clusters: int,
                   link: LinkModel = LinkModel()) -> RoundStats:
    """Full weights each way: naive FedAvg's round."""
    payload = tree_nbytes(params)
    up = payload * clients_per_round
    down = payload * clients_per_round
    msgs = 2 * clients_per_round + num_clusters
    t = (up / link.uplink_bps * 8 + down / link.downlink_bps * 8 +
         msgs * link.latency_s)
    return RoundStats(up, down, msgs, t)


def centralized_epoch(num_samples: int, lookback: int, horizon: int,
                      channels: int, *, num_clients: int,
                      link: LinkModel = LinkModel()) -> RoundStats:
    """Raw data shipped to the server (the centralized baseline's cost)."""
    sample_bytes = (lookback + horizon) * channels * 4
    up = num_samples * sample_bytes
    msgs = num_clients
    t = up / link.uplink_bps * 8 + msgs * link.latency_s
    return RoundStats(up, 0, msgs, t)


def collective_bytes_per_round(params, mesh_shape,
                               wire: str = None) -> dict:
    """Per-device bytes crossing each mesh axis for one aggregation round
    when the federation is mapped onto a mesh (clients -> ``data``, sites
    -> ``pod``), in the ``wire`` encoding: the ring plan of
    ``ring_wire_plan`` over the adapter payload.  ``mesh_shape`` is a
    ``{axis: size}`` dict or a mesh (a ``DeviceMesh``, or anything whose
    ``.shape`` is such a dict); a missing axis has size 1.  The ring's
    byte ledger and ``dist.fed.expected_collective_bytes`` give the same
    numbers."""
    from repro_torch.dist.sharding import _mesh_shape
    shape = _mesh_shape(mesh_shape)
    elems = count_params(lora_tree(params))
    return {axis: ring_wire_bytes(elems, shape.get(axis, 1), wire)
            for axis in ("data", "pod")}
