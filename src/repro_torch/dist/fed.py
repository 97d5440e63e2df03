"""FedTime's federation mapped onto mesh axes (Algorithm 1; the reference's
``src/repro/dist/fed.py``).

Cluster aggregation (Algorithm 1, lines 12-14) is a weighted sum of the
LoRA adapter deltas over the ``data`` axis: each data slice of the mesh
plays a block of cluster members.  The cross-site aggregation of the
paper's two-site (Caltech/JPL) ACN setting crosses the ``pod`` axis.  The
adapters are replicated (``repro_torch.dist.sharding``), so the payload a
round is exactly the LoRA tree, FedTime's communication profile (paper
Fig. 5): the base weights get no gradient and no traffic.

The aggregation runs on the ring by default:
``repro_torch.dist.fedcomm.ring_aggregate`` on the ``REPRO_FED_WIRE``
wire, with f32 accumulation and an error-feedback residual carried between
rounds.  ``REPRO_FED_RING=0`` reduces by ``collectives.psum`` instead.

``expected_collective_bytes`` recomputes the per-device ring bytes of this
axis mapping from the exact chunk plan; ``core.comm
.collective_bytes_per_round`` counts the same from the accounting side,
and the ring's byte ledger measures it from the buffers it sends: one
number, three ways.
"""

from __future__ import annotations

import torch

from repro_torch import tree as tree_util
from repro_torch.core.comm import ring_wire_bytes, wire_format
from repro_torch.core.lora import count_params, lora_tree, tree_nbytes
from repro_torch.dist import collectives, fedcomm
from repro_torch.dist.sharding import _mesh_shape

# Who carries what: every slice along ``data`` is a block of cluster
# members; the ``pod`` axis separates sites.
CLUSTER_AXIS = "data"
CROSS_SITE_AXIS = "pod"


def aggregation_axes(mesh) -> tuple:
    """Mesh axes the federated sum reduces over, innermost first."""
    shape = _mesh_shape(mesh)
    return tuple(ax for ax in (CLUSTER_AXIS, CROSS_SITE_AXIS)
                 if shape.get(ax, 1) > 1)


def ring_allreduce_bytes(payload_bytes: int, n: int, *,
                         wire: str = "f32") -> int:
    """Per-device bytes of an ``n``-way bidirectional ring all-reduce of an
    f32 payload of ``payload_bytes``, in the ``wire`` encoding: the exact
    chunk plan (``core.comm.ring_wire_plan``), padding and int8 scales
    counted."""
    return ring_wire_bytes(-(-payload_bytes // 4), n, wire)


def adapter_payload_bytes(params) -> int:
    """Bytes of the federated payload: the LoRA tree only."""
    return tree_nbytes(lora_tree(params))


def expected_collective_bytes(params, mesh, wire: str = None) -> dict:
    """Per-axis ring bytes for one aggregation round under this mapping,
    on ``wire`` (default ``REPRO_FED_WIRE``).  Counts payload elements, so
    it agrees with ``core.comm.collective_bytes_per_round`` and with the
    ring's byte ledger whatever dtype the adapters are stored in."""
    shape = _mesh_shape(mesh)
    elems = count_params(lora_tree(params))
    wire = wire or wire_format()
    return {ax: ring_wire_bytes(elems, shape.get(ax, 1), wire)
            for ax in (CLUSTER_AXIS, CROSS_SITE_AXIS)}


def fed_psum(tree, mesh):
    """Sum a tree over the federation axes: every rank of ``mesh`` calls
    it with its own tree and gets the sum."""
    axes = aggregation_axes(mesh)
    if not axes:
        return tree
    return tree_util.map_(lambda x: collectives.psum(x, mesh, axes), tree)


def mask_members(member_adapters, weights, alive):
    """Partial participation: zero dropped members' rows AND weights, and
    renormalize the surviving weights to sum to 1.  Zeroing the rows
    matters: a crashed member's buffer can hold NaN or Inf, and 0·NaN is
    NaN.  Returns ``(masked_adapters, renormalized_weights)`` shaped like
    the inputs."""
    dev = tree_util.leaves(member_adapters)[0].device
    alive = torch.as_tensor(alive).to(dev).bool()
    w = torch.as_tensor(weights, dtype=torch.float32).to(dev) * alive.float()
    total = w.sum()
    w = torch.where(total > 0,
                    w / torch.where(total > 0, total, torch.ones_like(total)),
                    w)

    def zero_dead(a):
        m = alive.reshape((alive.shape[0],) + (1,) * (a.ndim - 1))
        return torch.where(m, a, torch.zeros_like(a))

    return tree_util.map_(zero_dead, member_adapters), w


@torch.no_grad()
def aggregate_adapters(member_adapters, weights, mesh=None, *, alive=None,
                       wire: str = None, state: dict = None,
                       byte_ledger: list = None):
    """Algorithm 1, lines 12-14: Σ_k w_k·Δ_k with Σ w_k = 1 (w_k = n_k / n
    cluster sizes).

    Every leaf of ``member_adapters`` carries a leading member dim of
    ``len(weights)``.  Without a ``DeviceMesh`` with live federation axes
    this reduces locally.  On such a mesh every rank passes the whole tree,
    takes its block of members, and the reduction is the ring on ``wire``
    (``fedcomm.ring_aggregate``, which also takes the error-feedback
    ``state`` and the ``byte_ledger``; with ``state`` this returns
    ``(tree, new_state)``), or with ``REPRO_FED_RING=0`` a ``psum`` over
    the federation axes.  ``alive`` (bool / 0-1 over the member dim) drops
    members first through ``mask_members``, on either path."""
    if alive is not None:
        member_adapters, weights = mask_members(member_adapters, weights,
                                                alive)
    mesh_ok = mesh is not None and fedcomm._is_device_mesh(mesh)
    axes = aggregation_axes(mesh) if mesh is not None else ()
    if axes and mesh_ok and fedcomm.ring_enabled():
        return fedcomm.ring_aggregate(member_adapters, weights, mesh,
                                      wire=wire, state=state,
                                      byte_ledger=byte_ledger)
    dev = tree_util.leaves(member_adapters)[0].device
    weights = torch.as_tensor(weights, dtype=torch.float32).to(dev)
    if not axes or not mesh_ok:
        out = fedcomm.weighted_sum(weights, member_adapters)
        return out if state is None else (out, state)
    local, w = fedcomm._member_block(member_adapters, weights, mesh, axes)
    out = tree_util.map_(lambda x: collectives.psum(x, mesh, axes),
                         fedcomm.weighted_sum(w, local))
    return out if state is None else (out, state)
