"""Sequence-sharded flash-decode (the reference's ``src/repro/dist/decode.py``).

``REPRO_CACHE_SHARD=seq`` -- the default layout -- puts the ring cache's
slot axis on the ``model`` mesh axis, so no rank attends to the whole
cache.  A decode step then needs a cross-shard softmax: each model rank
runs the flash-decode kernel over its own slots with
``return_partials=True`` (its merged, unnormalized (m, l, acc)), and the
combine

    m* = pmax(m, model)
    out = psum(exp(m - m*) * acc, model) / psum(exp(m - m*) * l, model)

is the kernel's own split merge lifted onto collectives.  Masks need no
adjustment: slots carry absolute positions in ``kv_pos``, which shard with
the cache, so ring validity, causal, window and prefix masks are facts of
each shard, and so is an inactive lane (``q_pos`` -1): a lane with no
valid slot anywhere decodes to exactly 0.

A paged pool (``block_tables``) shards its block axis instead: each rank
owns an ``n_blocks/m`` stripe of physical blocks, the replicated table is
localized entry by entry (an entry off the stripe becomes -1, masked), and
the same combine stitches the stripes together.  A block shared by several
rows (copy-on-write prefix sharing) sits at the same logical index in each
row, so each localizes to the same stripe-local tile.

The port runs SPMD: every rank passes the whole (global) q, cache and
table, as the reference's ``shard_map`` takes them, and slices its own
stripe (and its batch rows over the data axes) before the kernel.  Only
the stripe reaches the kernel.  Wiring this into the attention layer's
decode step needs the cache and the model laid over ranks, which the
launch stack does; the port has not reached it yet.
"""

from __future__ import annotations

import os

import torch

from repro_torch.dist import collectives
from repro_torch.dist.sharding import _batch_axes, _mesh_shape, current_mesh
from repro_torch.kernels import ops
from repro_torch.kernels.flash_decode import _rows


def seq_shard_mesh(cache_len: int):
    """The ambient mesh when the seq-sharded decode path applies, else
    None."""
    mesh = current_mesh()
    if mesh is None:
        return None
    shape = _mesh_shape(mesh)
    if shape.get("model", 1) <= 1:
        return None
    if os.environ.get("REPRO_CACHE_SHARD", "seq") != "seq":
        return None
    if cache_len % shape["model"]:
        return None
    return mesh


def _stripe(n: int, ways: int, idx: int) -> slice:
    size = n // ways
    return slice(idx * size, (idx + 1) * size)


@torch.no_grad()
def sharded_flash_decode(q, k, v, kv_pos, q_pos, mesh, *, k_scale=None,
                         v_scale=None, kind: str = "causal", window: int = 0,
                         prefix_len=None, softcap: float = 0.0,
                         block_kv: int = 0, block_tables=None):
    """One decode step against a cache sharded over ``model``: the slot
    axis of per-request rings, or the block axis of a paged pool
    (``block_tables`` given: k/v are (n_blocks, block_size, Hk, D)).  Same
    arguments and result as ``repro_torch.kernels.ops.flash_decode``, with
    ``kv_pos`` (B, S) for a ring; every rank gets the whole (B, 1, H, D)
    output."""
    paged = block_tables is not None
    B = q.shape[0]
    shape = _mesh_shape(mesh)
    m_ways = shape.get("model", 1)
    bax = _batch_axes(B, shape)
    rows = slice(0, B)
    if bax is not None:
        ways = 1
        for ax in collectives._axes(bax):
            ways *= shape[ax]
        rows = _stripe(B, ways, collectives.block_index(mesh, bax))
    me = collectives.axis_index(mesh, "model") if m_ways > 1 else 0

    if paged:
        nb = k.shape[0]
        if nb % m_ways:
            raise ValueError(f"{nb} pool blocks do not split {m_ways} ways")
        cut = _stripe(nb, m_ways, me)

        def local(x):
            return None if x is None else x[cut]
        kv_loc = local(kv_pos)
        tbl = block_tables[rows].to(torch.int32)
        lo, nb_loc = cut.start, cut.stop - cut.start
        tbl = torch.where((tbl >= lo) & (tbl < lo + nb_loc), tbl - lo,
                          torch.full_like(tbl, -1)).contiguous()
    else:
        S = k.shape[1]
        if S % m_ways:
            raise ValueError(f"{S} cache slots do not split {m_ways} ways")
        cut = _stripe(S, m_ways, me)

        def local(x):
            return None if x is None else x[rows, cut].contiguous()
        kv_loc = local(kv_pos.expand(B, S) if kv_pos.ndim == 1 else kv_pos)
        tbl = None
    m, l, acc = ops.flash_decode(
        q[rows].contiguous(), local(k), local(v), kv_loc,
        _rows(q_pos, B, q.device)[rows].contiguous(),
        k_scale=local(k_scale), v_scale=local(v_scale), kind=kind,
        window=window, prefix_len=_rows(prefix_len, B, q.device)[rows]
        .contiguous(), softcap=softcap, block_kv=block_kv, block_tables=tbl,
        return_partials=True)
    m_g = collectives.pmax(m, mesh, "model")
    w = torch.exp(m - m_g)
    l_g = collectives.psum(l * w, mesh, "model")
    acc_g = collectives.psum(acc * w, mesh, "model")
    out = acc_g / torch.clamp(l_g, min=1e-30)          # (B_loc, Hk, G, D)
    out = out.reshape(out.shape[0], 1, -1, out.shape[-1]).to(q.dtype)
    if bax is not None:
        out = collectives.all_gather(out, mesh, bax, dim=0)
    return out
