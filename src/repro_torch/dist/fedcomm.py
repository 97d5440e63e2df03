"""Federated communication: how Algorithm 1's aggregation moves.

``repro_torch.dist.fed`` maps the aggregation onto mesh axes; this module
owns how those collectives move: the bidirectional ring all-reduce of
``repro_torch.kernels.ring_allreduce`` on the ``REPRO_FED_WIRE`` wire
(int8 codes with absmax scales, bf16, or f32) with an error-feedback
residual carried between rounds.

Two call sites share the wire machinery:

  * ``ring_aggregate`` -- the mesh path.  Every rank of a ``DeviceMesh``
    (``repro_torch.launch.mesh``) plays its block of cluster members: it
    sums its members' weighted deltas into ONE payload vector and pushes it
    round the ring of each federation axis (``data``, then ``pod`` across
    sites).  Every hop runs the fused hop kernel
    (``repro_torch.kernels.wire_hop``) in its received form.  Each rank
    carries its own residual a ring, so repeated rounds stay unbiased on
    the int8 wire.
  * ``quantize_update`` -- the host-loop path.  ``train/fed_trainer`` runs
    the paper's client/server simulation outside any mesh; each client's
    uploaded delta passes through the same encode (the hop kernel's
    quantize-only form) with its residual, so Algorithm 1 aggregates
    exactly what the wire delivers.

``REPRO_FED_RING=0`` makes ``fed.aggregate_adapters`` reduce by
``collectives.psum`` instead (the reference's A/B baseline).  The
reference caches one compiled aggregation per mesh and payload
(``_AGG_CACHE``), a jit artefact; the port runs its hop schedule eagerly
and has nothing to cache, so it records the byte ledger every round.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch import tree as tree_util
from repro_torch.core.comm import wire_format, wire_qblock
from repro_torch.dist.collectives import axis_size, block_index
from repro_torch.kernels.ring_allreduce import residual_len, ring_allreduce
from repro_torch.kernels.wire_hop import dequant_chunk, fused_hop


def ring_enabled() -> bool:
    """The ring is the default on a live mesh; ``REPRO_FED_RING=0`` falls
    back to ``collectives.psum``."""
    return os.environ.get("REPRO_FED_RING", "1") != "0"


def _member_elems(member_adapters) -> int:
    """Elements of ONE member's adapter payload (leaves carry a leading
    member dim)."""
    return sum(l.numel() // l.shape[0]
               for l in tree_util.leaves(member_adapters))


def _is_device_mesh(mesh) -> bool:
    return getattr(mesh, "mesh_dim_names", None) is not None


def _member_block(member_adapters, weights, mesh, axes):
    """This rank's rows of the member dim and of ``weights``: block
    ``block_index(mesh, axes)`` of ``prod(axes)`` (``P(axes)`` on the member
    dim, major axis first)."""
    prod = 1
    for ax in axes:
        prod *= axis_size(mesh, ax)
    n = weights.shape[0]
    if n % prod:
        raise ValueError(
            f"member dim {n} must divide the federation axes {axes} ({prod})")
    per = n // prod
    lo = block_index(mesh, axes) * per
    rows = slice(lo, lo + per)
    return (tree_util.map_(lambda a: a[rows], member_adapters),
            weights[rows])


def weighted_sum(weights, member_adapters):
    """Σ_k w_k·a_k over each leaf's leading member dim, in the leaf's
    dtype, one member at a time in member order (the same roundings on the
    card as on the CPU)."""
    def wsum(a):
        w = weights.to(device=a.device, dtype=a.dtype)
        out = w[0] * a[0]
        for k in range(1, a.shape[0]):
            out = out + w[k] * a[k]
        return out
    return tree_util.map_(wsum, member_adapters)


def init_state(member_adapters, mesh, *, wire: str = None,
               qblock: int = None) -> dict:
    """Zero error-feedback state for ``ring_aggregate``: ``{axis: (L,)}``
    f32 on the members' device, ``L = residual_len`` of the axis.  Each
    rank holds its own residual; gathered in block order, the ranks'
    residuals are the rows of the reference's ``(prod, L)`` state."""
    from repro_torch.dist.fed import aggregation_axes
    wire = wire or wire_format()
    elems = _member_elems(member_adapters)
    dev = tree_util.leaves(member_adapters)[0].device
    return {ax: torch.zeros(residual_len(elems, axis_size(mesh, ax), wire,
                                         qblock),
                            dtype=torch.float32, device=dev)
            for ax in aggregation_axes(mesh)}


@torch.no_grad()
def ring_aggregate(member_adapters, weights, mesh, *, wire: str = None,
                   qblock: int = None, state: dict = None,
                   byte_ledger: list = None):
    """Algorithm 1, lines 12-14 over the ring: Σ_k w_k·Δ_k, the member dim
    split over the federation axes, the cross-member reduction a
    bidirectional ring all-reduce on the wire.

    SPMD: every rank passes the whole member tree and weights (the
    reference's global arrays) and takes its own rows; the result is
    replicated, f32, shaped as one member.  ``state`` (``init_state``)
    carries this rank's residuals between rounds; with ``state=None`` the
    quantization error is dropped, which re-applies a correlated bias every
    round on a quantized wire.  ``byte_ledger`` (a list) receives
    ``(axis, nbytes)`` per transfer.  Returns the tree, or ``(tree,
    new_state)`` when ``state`` is given.

    Drop members before the call with ``fed.mask_members`` (rows zeroed,
    weights renormalized): this reduces whatever rows it is handed."""
    from repro_torch.dist.fed import aggregation_axes
    wire = wire or wire_format()
    qblock = qblock or wire_qblock()
    dev = tree_util.leaves(member_adapters)[0].device
    weights = torch.as_tensor(weights, dtype=torch.float32).to(dev)

    axes = aggregation_axes(mesh) if mesh is not None else ()
    if not axes or not _is_device_mesh(mesh):
        out = weighted_sum(weights, member_adapters)
        return out if state is None else (out, state)

    carry_state = state is not None
    local, w = _member_block(member_adapters, weights, mesh, axes)
    summed = weighted_sum(w, local)
    ledger = [] if byte_ledger is None else byte_ledger
    with obs.span("fedcomm.ring_aggregate", device=True, wire=wire,
                  axes=",".join(axes)):
        red, new_res = ring_allreduce(
            tree_util.ravel(summed), mesh, axes, wire=wire, qblock=qblock,
            residuals=state, byte_ledger=ledger)
    ls = tree_util.leaves(summed)
    parts = torch.split(red, [l.numel() for l in ls])
    out = tree_util.unflatten(summed, [p.reshape(l.shape)
                                       for p, l in zip(parts, ls)])
    _trace_ring_round(ledger, wire)
    if not carry_state:
        return out
    return out, {ax: new_res[ax] for ax in state}


def _trace_ring_round(ledger, wire: str) -> None:
    """One round's measured ledger into the tracer: a ``ring.hop`` instant
    per chunk transfer, the ``ring.hop_bytes`` sketch, a per-axis
    ``ring.wire_bytes.<axis>`` counter (its increment a round equals
    ``fed.expected_collective_bytes`` for that axis) and ``ring.rounds``."""
    if not ledger or not obs.enabled():
        return
    per_axis: dict = {}
    for i, (ax, nbytes) in enumerate(ledger):
        obs.instant("ring.hop", track=f"ring:{ax}", axis=ax, seq=i,
                    nbytes=nbytes, wire=wire)
        obs.hist("ring.hop_bytes", float(nbytes), sketch=True)
        per_axis[ax] = per_axis.get(ax, 0) + nbytes
    for ax, nbytes in per_axis.items():
        obs.counter(f"ring.wire_bytes.{ax}", nbytes)
    obs.counter("ring.rounds", 1)


# ---------------------------------------------------------------------------
# Host-loop wire emulation (train/fed_trainer)
# ---------------------------------------------------------------------------

@torch.no_grad()
def quantize_update(tree, residual=None, *, wire: str = None,
                    qblock: int = None):
    """One client upload through the wire: quantize the delta tree (EF
    residual added in), return what the server dequantizes plus the new
    residual (flat f32, padded to whole ``qblock`` rows, carried to this
    client's next round).  The f32 wire is the identity.  Leaves are laid
    end to end in the reference's order (sorted keys), so the residual and
    the blocks line up with the reference's."""
    wire = wire or wire_format()
    qblock = qblock or wire_qblock()
    if wire == "f32":
        return tree, residual
    flat = tree_util.ravel(tree)
    padded = F.pad(flat, (0, -flat.numel() % qblock))
    res = (torch.zeros_like(padded) if residual is None
           else residual.float())
    # encode t = value + residual, keep the wire's loss as the new residual
    t = padded + res
    _, codes, scales, new_res = fused_hop(t, None, None, torch.zeros_like(t),
                                          wire=wire, qblock=qblock)
    deq = dequant_chunk(codes, scales, wire=wire, qblock=qblock)
    return tree_util.unravel(tree, deq), new_res
