"""The bidirectional ring all-reduce over the federated LoRA payload (the
reference's ``src/repro/kernels/ring_allreduce.py`` schedule).

The payload is flattened and carved into ``2·n`` chunks, n rotating each
way round the ring (``repro_torch.core.comm.ring_wire_plan``):

  reduce-scatter   n-1 hops a direction; each hop a rank receives its
                   neighbour's partial chunk and runs the fused hop
                   (``repro_torch.kernels.wire_hop.fused_hop``: dequantize
                   what came in, accumulate in f32, requantize with error
                   feedback), the CUDA kernel on the card;
  all-gather       n-1 hops; the fully reduced owned chunk, quantized once,
                   is forwarded verbatim, so every rank dequantizes the same
                   codes and the result is replicated bit for bit.

Wires (``REPRO_FED_WIRE``): f32 (the identity, no error feedback), bf16,
and int8 codes with one f32 absmax scale a ``REPRO_FED_QBLOCK`` row.
Accumulation is f32 whatever the wire, and the hop order is fixed.  Each
rank keeps an error-feedback residual over its padded chunk layout
(``residual_len``): every quantization adds it in and stores back what the
wire dropped, so carried across rounds the bias telescopes away.

The port runs SPMD: these functions run in every rank of a
``DeviceMesh`` (``repro_torch.launch.mesh``), and each hop's transfer is
``repro_torch.dist.collectives.ppermute`` on the axis's process group.
``byte_ledger`` receives ``(axis, nbytes)`` for every transfer (codes and
scales summed), the measured side of the byte agreement with
``ring_wire_plan``; each hop's transfer and arithmetic run inside an
``obs`` span and an ``obs.cost.scope`` named as the reference's scope,
``obs.ring.<axis>.d<dir>.rs_hop<h>`` / ``ag_hop<h>``, so a cost counter
files each hop's bytes, kernel and transfer under it.
"""

from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch.obs import cost
from repro_torch.core.comm import ring_wire_plan, wire_format, wire_qblock
from repro_torch.dist.collectives import axis_index, axis_size, ppermute
from repro_torch.kernels.wire_hop import dequant_chunk, fused_hop


def _ledger_add(ledger, axis: str, *bufs) -> None:
    if ledger is not None:
        ledger.append((axis, sum(b.numel() * b.element_size() for b in bufs
                                 if b is not None)))


def _chunk(x: torch.Tensor, idx: int, c: int) -> torch.Tensor:
    """x: (n·c,) -> its (c,) chunk ``idx`` (a view)."""
    return x[idx * c:(idx + 1) * c]


def _set_chunk(x: torch.Tensor, idx: int, v: torch.Tensor, c: int) -> None:
    x[idx * c:(idx + 1) * c] = v


def _ring_one_axis(flat, mesh, axis: str, n: int, *, wire: str, qblock: int,
                   residual, byte_ledger):
    """One n-way bidirectional ring all-reduce of this rank's flat f32
    contribution over ``axis``.  ``residual`` is the carried (2·n·c,) EF
    residual, or None for zeros.  Returns (the reduced (len(flat),) vector,
    the same on every rank of the axis; the new residual)."""
    plan = ring_wire_plan(flat.numel(), n, wire, qblock)
    c = plan.chunk_elems
    total = plan.n_chunks * c
    me = axis_index(mesh, axis)
    dev = flat.device

    padded = torch.zeros(total, dtype=torch.float32, device=dev)
    padded[:flat.numel()] = flat
    res = (torch.zeros(total, dtype=torch.float32, device=dev)
           if residual is None
           else residual.reshape(total).to(torch.float32).clone())
    out = torch.empty(total, dtype=torch.float32, device=dev)

    for d in (0, 1):
        sgn = 1 if d == 0 else -1              # d0: i -> i+1, d1: i -> i-1
        half = slice(d * n * c, (d + 1) * n * c)
        acc = padded[half]
        rsd = res[half]                        # views: updated in place

        def s_idx(h):
            return (me - sgn * h) % n

        # -- reduce-scatter: n-1 hops, fused dequant/accumulate/requant --
        first = _chunk(acc, s_idx(0), c)
        if wire == "f32":
            codes, scales = first, None          # identity wire, no EF
        else:
            _, codes, scales, r_new = fused_hop(
                first, None, None, _chunk(rsd, s_idx(0), c).contiguous(),
                wire=wire, qblock=qblock)
            _set_chunk(rsd, s_idx(0), r_new, c)
        for h in range(n - 1):
            name = f"obs.ring.{axis}.d{d}.rs_hop{h}"
            with obs.span(name), cost.scope(name):
                _ledger_add(byte_ledger, axis, codes, scales)
                codes, scales = ppermute((codes, scales), mesh, axis, sgn)
                r_idx = s_idx(h + 1)
                if wire == "f32":
                    new_acc = _chunk(acc, r_idx, c) + codes
                    codes = new_acc
                else:
                    new_acc, codes, scales, r_new = fused_hop(
                        _chunk(acc, r_idx, c).contiguous(), codes, scales,
                        _chunk(rsd, r_idx, c).contiguous(), wire=wire,
                        qblock=qblock)
                    _set_chunk(rsd, r_idx, r_new, c)
                _set_chunk(acc, r_idx, new_acc, c)

        # -- all-gather: the quantized owned chunk forwarded verbatim --
        outd = out[half]
        own = s_idx(n - 1)
        _set_chunk(outd, own, codes if wire == "f32" else dequant_chunk(
            codes, scales, wire=wire, qblock=qblock), c)
        for h in range(n - 1):
            name = f"obs.ring.{axis}.d{d}.ag_hop{h}"
            with obs.span(name), cost.scope(name):
                _ledger_add(byte_ledger, axis, codes, scales)
                codes, scales = ppermute((codes, scales), mesh, axis, sgn)
                # the chunk owned by my (h+1)-away upstream neighbour
                _set_chunk(outd, s_idx(h), codes if wire == "f32"
                           else dequant_chunk(codes, scales, wire=wire,
                                              qblock=qblock), c)

    return out[:flat.numel()], res


def ring_allreduce(x, mesh, axes, *, wire: str = None, qblock: int = None,
                   residuals: dict = None, byte_ledger: list = None):
    """Bidirectional ring all-reduce of ``x`` over ``axes`` of ``mesh``
    (hierarchical: one ring an axis, in the order given, innermost first,
    so the bytes of each axis match ``collective_bytes_per_round``'s).

    Every rank of the mesh calls it with its own ``x``.  ``residuals`` maps
    axis -> carried EF residual (``residual_len`` long); None gives fresh
    zeros, and the quantization error is then dropped (biased: fine for a
    one-shot reduction, wrong for training rounds).  Returns (reduced x in
    x's dtype, {axis: new residual})."""
    wire = wire or wire_format()
    qblock = qblock or wire_qblock()
    flat = x.reshape(-1).to(torch.float32)
    new_res = {}
    for ax in axes:
        n = axis_size(mesh, ax)
        if n <= 1:
            continue
        flat, new_res[ax] = _ring_one_axis(
            flat, mesh, ax, n, wire=wire, qblock=qblock,
            residual=(residuals or {}).get(ax), byte_ledger=byte_ledger)
    return flat.reshape(x.shape).to(x.dtype), new_res


def residual_len(n_elems: int, n: int, wire: str = None,
                 qblock: int = None) -> int:
    """Length of the per-axis error-feedback residual: the padded chunk
    layout (2·n·chunk_elems) of the ring plan."""
    plan = ring_wire_plan(n_elems, n, wire, qblock)
    return plan.n_chunks * plan.chunk_elems
