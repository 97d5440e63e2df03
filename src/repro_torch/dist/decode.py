"""Sequence-sharded flash-decode (the reference's ``src/repro/dist/decode.py``).

``REPRO_CACHE_SHARD=seq`` -- the default layout -- puts the ring cache's
slot axis on the ``model`` mesh axis, so no rank attends to the whole
cache.  A decode step then needs a cross-shard softmax: each model rank
runs the flash-decode kernel over its own slots with
``return_partials=True`` (its merged, unnormalized (m, l, acc)), and the
combine

    m* = pmax(m, model)
    out = psum(exp(m - m*) * acc, model) / psum(exp(m - m*) * l, model)

is the kernel's own split merge lifted onto collectives (the two sums go
in one all-reduce).  Masks need no adjustment: slots carry absolute
positions in ``kv_pos``, which shard with the cache, so ring validity,
causal, window and prefix masks are facts of each shard, and so is an
inactive lane (``q_pos`` -1): a lane with no valid slot anywhere decodes
to exactly 0.

A paged pool (``block_tables``) shards its block axis instead: each rank
owns an ``n_blocks/m`` stripe of physical blocks, the replicated table is
localized entry by entry (an entry off the stripe becomes -1, masked), and
the same combine stitches the stripes together.  A block shared by several
rows (copy-on-write prefix sharing) sits at the same logical index in each
row, so each localizes to the same stripe-local tile.

Two entries.  ``stripe_flash_decode`` is the core: it takes this rank's
own rows and its own stripe, runs the kernel and the combine, and returns
its rows' output; it slices nothing and gathers nothing.  The attention
layer's decode step calls it on the cache a rank holds under a mesh
(``repro_torch.models.layers.attention.attn_decode``), so no rank ever
holds another's stripe.  ``sharded_flash_decode`` keeps the reference's
signature: every rank passes the whole (global) q, cache and table, as the
reference's ``shard_map`` takes them; it slices its rows and stripe, runs
the core, and gathers the rows over the batch axes.
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


def model_ways(mesh) -> int:
    """The size of ``mesh``'s ``model`` axis (1 for no mesh)."""
    return 1 if mesh is None else _mesh_shape(mesh).get("model", 1)


def stripe_start(mesh, n_local: int) -> int:
    """The first global slot (or pool block) of this rank's stripe of
    ``n_local`` (0 without a ``model`` axis)."""
    if model_ways(mesh) <= 1:
        return 0
    return collectives.axis_index(mesh, "model") * n_local


# What a mesh's cache may look like: the message of the layouts refused.
SHARDED_LAYOUTS = (
    "a cache sharded over 'model' is supported on its slot (ring) or block "
    "(pool) axis only, with REPRO_CACHE_SHARD=seq and a length that divides "
    "the model axis; 'model' on the KV heads or the head dim needs "
    "tensor-parallel projections (ROADMAP Queue 1: tensor-parallel "
    "projections and the heads cache layout)")


def cache_stripe(n_global: int):
    """This rank's stripe of a cache axis of ``n_global`` slots (a ring) or
    blocks (a pool) under the ambient mesh: ``(mesh, lo, size)``, the
    stripe holding global entries ``[lo, lo + size)``; ``(None, 0,
    n_global)`` where no mesh with a real ``model`` axis is in use.  Raises
    ``NotImplementedError`` where the cache's spec would put ``model`` on
    anything but that axis (``REPRO_CACHE_SHARD=heads``, or a length that
    does not divide)."""
    mesh = current_mesh()
    ways = model_ways(mesh)
    if ways <= 1:
        return None, 0, n_global
    if seq_shard_mesh(n_global) is None:
        raise NotImplementedError(f"{n_global} cache entries on {ways} "
                                  f"model ranks: {SHARDED_LAYOUTS}")
    size = n_global // ways
    return mesh, stripe_start(mesh, size), size


def pool_specs(pool, mesh):
    """Specs of a paged pool's layer-stacked leaves (k/v (L, n_blocks, bs,
    Hk, D), their scales, kv_pos (L, n_blocks, bs)): the block axis over
    ``model``, the decode's own layout (the reference's
    ``P("model", ...)`` in ``sharded_flash_decode``), replicated over the
    data axes.  Raises ``ValueError`` when the block count does not
    divide."""
    m = model_ways(mesh)

    def spec(name, leaf):
        nd = leaf.ndim
        d = nd - (2 if name == "kv_pos" else 4)
        if m <= 1:
            return ()
        if leaf.shape[d] % m:
            raise ValueError(f"{leaf.shape[d]} pool blocks do not split "
                             f"{m} ways")
        return tuple("model" if i == d else None for i in range(nd))

    return {name: spec(name, leaf) for name, leaf in pool.items()}


@torch.no_grad()
def stripe_flash_decode(q, k, v, kv_pos, q_pos, mesh, *, k_scale=None,
                        v_scale=None, kind: str = "causal", window: int = 0,
                        prefix_len=None, softcap: float = 0.0,
                        block_kv: int = 0, block_tables=None):
    """One decode step of this rank's rows against its own stripe: q
    (B_loc, 1, H, D), ``q_pos`` and ``prefix_len`` of those rows; a ring
    stripe k/v (B_loc, S_loc, Hk, D) with its kv_pos (B_loc, S_loc), or a
    pool stripe k/v (n_blocks_loc, bs, Hk, D) with the rows' global block
    table (B_loc, T), localized here (an entry off the stripe becomes -1).
    The kernel's (m, l, acc) partials are combined over ``model``; the
    result is the rows' (B_loc, 1, H, D) output in q's dtype."""
    B = q.shape[0]
    tbl = None
    if block_tables is not None:
        nb_loc = k.shape[0]
        lo = stripe_start(mesh, nb_loc)
        tbl = block_tables.to(torch.int32)
        tbl = torch.where((tbl >= lo) & (tbl < lo + nb_loc), tbl - lo,
                          torch.full_like(tbl, -1)).contiguous()
    m, l, acc = ops.flash_decode(
        q.contiguous(), k, v, kv_pos, _rows(q_pos, B, q.device),
        k_scale=k_scale, v_scale=v_scale, kind=kind, window=window,
        prefix_len=_rows(prefix_len, B, q.device), softcap=softcap,
        block_kv=block_kv, block_tables=tbl, return_partials=True)
    m_g = collectives.pmax(m, mesh, "model")
    w = torch.exp(m - m_g)
    # l and acc summed in one all-reduce: (..., 1 + D)
    la = collectives.psum(torch.cat([l * w, acc * w], dim=-1), mesh, "model")
    out = la[..., 1:] / torch.clamp(la[..., :1], min=1e-30)
    return out.reshape(B, 1, -1, out.shape[-1]).to(q.dtype)


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
        tbl = block_tables[rows]
    else:
        S = k.shape[1]
        if S % m_ways:
            raise ValueError(f"{S} cache slots do not split {m_ways} ways")
        cut = _stripe(S, m_ways, me)

        def local(x):
            return None if x is None else x[rows, cut].contiguous()
        kv_loc = local(kv_pos.expand(B, S) if kv_pos.ndim == 1 else kv_pos)
        tbl = None
    out = stripe_flash_decode(
        q[rows], local(k), local(v), kv_loc,
        _rows(q_pos, B, q.device)[rows], mesh, k_scale=local(k_scale),
        v_scale=local(v_scale), kind=kind, window=window,
        prefix_len=_rows(prefix_len, B, q.device)[rows], softcap=softcap,
        block_kv=block_kv, block_tables=tbl)
    if bax is not None:
        out = collectives.all_gather(out, mesh, bax, dim=0)
    return out
