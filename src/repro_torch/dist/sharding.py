"""Mesh-aware partition rules for parameters and optimizer state (the
reference's ``src/repro/dist/sharding.py``).

All rules are pure functions of (path, shape, mesh shape): they need only
each leaf's ``.shape``, so they work on tensors, on the meta device and on
anything shaped, and they touch no process group.  A dim that does not
divide its mesh axis replicates instead of failing, which is what lets one
table cover every family.

A spec is a tuple of axis entries, one a dim, as the reference's
``PartitionSpec`` is: an entry is ``None`` (replicated), an axis name, or a
tuple of names read major first; ``()`` is fully replicated.

Layout summary
  params    — Megatron tensor parallelism over ``model``: column-parallel
              sites shard the output dim, row-parallel sites the input dim,
              embeddings the vocab dim.  LoRA adapters are replicated: the
              federated payload must be a pure sum (``repro_torch.dist.fed``).
  opt state — ZeRO-1: the param spec widened over ``data`` (+``pod``) on
              the first still-replicated dim that divides, so the f32 AdamW
              moments never cost more a device than the bf16 params
              (``repro_torch.optim.adamw.adamw_update_zero1``).
  caches    — ``REPRO_CACHE_SHARD=seq`` (default): batch -> data axes,
              ring slots -> ``model`` (the sequence-sharded decode's
              layout).  ``REPRO_CACHE_SHARD=heads``: batch -> data axes, KV
              heads -> ``model``, falling through to the head dim.
  batches   — the leading batch dim over the combined (``pod``, ``data``)
              axes, then ``data`` alone, then replicated.

Placed on a mesh, a tree is each rank's own piece of every leaf, a plain
tensor (``local_shard``): the port's counterpart of a global array under a
``NamedSharding``.  The serving path holds its cache that way
(``repro_torch.launch.steps``); parameters stay replicated, since
tensor-parallel projections are not ported.  A paged pool is laid out by
the decode's own spec, not by ``cache_specs`` (``dist.decode.pool_specs``).
"""

from __future__ import annotations

import contextlib
import math
import os
from typing import NamedTuple, Optional

_MESHES: list = []


def _div(n: int, k: int) -> bool:
    """True when an ``n``-sized dim splits evenly ``k`` ways."""
    return k > 0 and n % k == 0


def _mesh_shape(mesh) -> dict:
    """``{axis: size}`` of a ``DeviceMesh`` (its dim names and sizes), of a
    plain dict, or of anything whose ``.shape`` is such a mapping (the
    reference's ``Mesh``)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(getattr(mesh, "shape", mesh))


def _axis_candidates(shape: dict):
    """Data-parallel axis combinations to try, widest first: the combined
    (``pod``, ``data``) axes, then ``data`` alone.  Shared by batch
    sharding and ZeRO-1 widening so the two fallback chains never
    diverge."""
    axes = [ax for ax in ("pod", "data") if shape.get(ax, 1) > 1]
    candidates = [axes] if axes else []
    if len(axes) > 1:
        candidates.append(["data"])
    return candidates


def _axis_entry(cand, shape: dict):
    """(spec entry, total ways) for one candidate axis combination."""
    prod = 1
    for ax in cand:
        prod *= shape[ax]
    return (tuple(cand) if len(cand) > 1 else cand[0]), prod


def _batch_axes(n: int, shape: dict):
    """Axis (or axis tuple) an ``n``-sized batch dim shards over: the
    combined (``pod``, ``data``) axes when their product divides, else
    ``data`` alone, else None (replicate)."""
    for cand in _axis_candidates(shape):
        entry, prod = _axis_entry(cand, shape)
        if _div(n, prod):
            return entry
    return None


def _maybe_spec(entries) -> tuple:
    """The full-length spec, or ``()`` when fully replicated."""
    return tuple(entries) if any(e is not None for e in entries) else ()


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

# Column-parallel sites (shard the output dim): the first matmul of each
# pair in the Megatron decomposition.
_COL_SITES = frozenset((
    "wq", "wk", "wv",
    "gate", "up", "gate_proj", "up_proj",
    "in_proj", "w_in", "ffn_gate", "ffn_up",
    "lm_head", "vis_proj", "frame_proj",
))

# Row-parallel sites (shard the input dim): the second matmul of each pair.
_ROW_SITES = frozenset((
    "wo", "down", "down_proj", "out_proj", "ffn_down",
))

# The federated payload is a pure sum, so the adapters stay replicated.
_LORA_LEAVES = frozenset(("lora_a", "lora_b", "lora_scale"))


def _spec_for_param(path: str, leaf, model: int) -> tuple:
    """Partition spec for one parameter leaf.

    ``path`` is "/"-joined dict keys ("/layers/attn/wq/w"); ``leaf`` needs
    only ``.shape``; ``model`` is the size of the ``model`` axis.
    Everything unmatched (norm scales, biases, routers, NF4 codes)
    replicates."""
    parts = [p for p in str(path).split("/") if p]
    tail = parts[-1]
    parent = parts[-2] if len(parts) > 1 else ""
    shape = tuple(leaf.shape)
    nd = len(shape)

    if tail in _LORA_LEAVES:
        return ()
    if model <= 1 or nd < 2:
        return ()

    # linear sites carry their weight as a "w" leaf; stacked MoE expert
    # weights are direct leaves
    site = parent if tail == "w" else tail
    if site in _COL_SITES and _div(shape[-1], model):
        return (*([None] * (nd - 1)), "model")
    if site in _ROW_SITES and _div(shape[-2], model):
        return (*([None] * (nd - 2)), "model", None)
    if tail == "table" and nd == 2 and _div(shape[0], model):
        return ("model", None)                      # vocab-sharded embedding
    return ()


def _map_with_path(tree, fn, path: str = ""):
    if isinstance(tree, dict):
        return {k: _map_with_path(v, fn, f"{path}/{k}")
                for k, v in tree.items()}
    return fn(path, tree)


def param_specs(params, mesh):
    """Partition specs for a parameter tree: tensor parallelism over
    ``model``, everything else (the LoRA payload too) replicated."""
    model = _mesh_shape(mesh).get("model", 1)
    return _map_with_path(
        params, lambda path, leaf: _spec_for_param(path, leaf, model))


# ---------------------------------------------------------------------------
# Optimizer state (ZeRO-1)
# ---------------------------------------------------------------------------

def opt_state_specs(params, mesh):
    """ZeRO-1 specs for AdamW moments: the base param spec, widened over
    the ``data`` (+``pod``) axes on the first still-replicated dim that
    divides."""
    shape = _mesh_shape(mesh)
    model = shape.get("model", 1)
    candidates = _axis_candidates(shape)

    def widen(path, leaf):
        base = _spec_for_param(path, leaf, model)
        entries = list(base) + [None] * (len(leaf.shape) - len(base))
        for cand in candidates:
            entry, prod = _axis_entry(cand, shape)
            for d, e in enumerate(entries):
                if e is None and _div(leaf.shape[d], prod):
                    entries[d] = entry
                    return _maybe_spec(entries)
        return _maybe_spec(entries)

    return _map_with_path(params, widen)


# ---------------------------------------------------------------------------
# KV caches
# ---------------------------------------------------------------------------

# Cache leaf layouts as offsets from the END of the shape: leading dims are
# layer stacks, so negative indexing stays stable across families.
_CACHE_DIMS = {
    # attention ring buffers: (..., B, S, Hk, dh)
    "k":       {"batch": -4, "seq": -3, "heads": -2, "dh": -1},
    "v":       {"batch": -4, "seq": -3, "heads": -2, "dh": -1},
    "mem_k":   {"batch": -4, "seq": -3, "heads": -2, "dh": -1},
    "mem_v":   {"batch": -4, "seq": -3, "heads": -2, "dh": -1},
    # int8-KV absmax scales: (..., B, S, Hk, 1), the trailing dim never shards
    "k_scale": {"batch": -4, "seq": -3, "heads": -2},
    "v_scale": {"batch": -4, "seq": -3, "heads": -2},
    # slot-position maps: (..., B, S)
    "kv_pos":  {"batch": -2, "seq": -1},
    "mem_pos": {"batch": -2, "seq": -1},
    # Mamba2: state (..., B, H, P, N), conv tail (..., B, W-1, channels)
    "ssm_state": {"batch": -4, "heads": -3, "dh": -2},
    "conv_buf":  {"batch": -3, "dh": -1},
    # mLSTM: C (..., B, H, dh, dh), n (..., B, H, dh), m (..., B, H)
    "C": {"batch": -4, "heads": -3, "dh": -1},
    "n": {"batch": -3, "heads": -2, "dh": -1},
    "m": {"batch": -2, "heads": -1},
}

# sLSTM's scalar-memory state is (..., B, d); its "n"/"m" leaves collide
# with mLSTM's names, so the enclosing subtree selects the table.
_SLSTM_CACHE_DIMS = {
    name: {"batch": -2, "dh": -1} for name in ("c", "n", "m", "h")
}


def cache_specs(cache, mesh, mode: Optional[str] = None):
    """Partition specs for a KV/SSM cache tree (the reference's rule).

    ``mode`` (default from ``REPRO_CACHE_SHARD``, then "seq"):
      seq   — batch -> data axes, ring slots -> ``model``;
      heads — batch -> data axes, KV heads -> ``model``, falling through to
              the head dim when the head count does not divide.
    A leaf without the preferred dim, or whose dim does not divide, falls
    through the same chain; what cannot shard replicates.

    The table reads a leaf by its name and rank only: a paged pool's
    ``(L, n_blocks, bs, Hk, D)`` reads as if ``n_blocks`` were the batch and
    ``bs`` the slots, exactly as in the reference.  The port lays a pool out
    by the decode's spec instead (``repro_torch.dist.decode.pool_specs``).
    """
    shape = _mesh_shape(mesh)
    model = shape.get("model", 1)
    mode = mode or os.environ.get("REPRO_CACHE_SHARD", "seq")
    order = ("seq", "heads", "dh") if mode == "seq" else ("heads", "dh")

    def spec(path, leaf):
        parts = [p for p in path.split("/") if p]
        table = _SLSTM_CACHE_DIMS if "slstm" in parts else _CACHE_DIMS
        dims = table.get(parts[-1])
        nd = len(leaf.shape)
        if dims is None or nd == 0:
            return ()

        def dim_at(key):
            off = dims.get(key)
            return None if off is None or nd + off < 0 else nd + off

        entries = [None] * nd
        b = dim_at("batch")
        if b is not None:
            entries[b] = _batch_axes(leaf.shape[b], shape)
        if model > 1:
            for key in order:
                d = dim_at(key)
                if d is not None and entries[d] is None and \
                        _div(leaf.shape[d], model):
                    entries[d] = "model"
                    break
        return _maybe_spec(entries)

    return _map_with_path(cache, spec)


# ---------------------------------------------------------------------------
# Input batches
# ---------------------------------------------------------------------------

def _leading(leaf):
    """The leaf's shape: a tensor's, a list's length (sampling's per-row
    generators), or ``()`` for a Python number."""
    if isinstance(leaf, (list, tuple)):
        return (len(leaf),)
    return tuple(getattr(leaf, "shape", ()))


def data_specs(batch, mesh):
    """Shard the leading batch dim of every input leaf over the combined
    (``pod``, ``data``) axes, falling back to ``data`` alone, then to
    replication (scalars such as ``pos``, and a batch of one).  A list leaf
    shards by its length; a Python number replicates."""
    shape = _mesh_shape(mesh)

    def spec(path, leaf):
        dims = _leading(leaf)
        if not dims:
            return ()
        ax = _batch_axes(dims[0], shape)
        if ax is None:
            return ()
        return (ax, *([None] * (len(dims) - 1)))

    return _map_with_path(batch, spec)


# ---------------------------------------------------------------------------
# Placement: each rank's own piece
# ---------------------------------------------------------------------------

class Placement(NamedTuple):
    """Where a leaf lives on a mesh: its spec, the mesh and its global
    shape (None when only the spec was given).  The port's counterpart of
    the reference's ``NamedSharding``."""
    spec: tuple
    mesh: object
    shape: Optional[tuple] = None

    def local_shape(self) -> tuple:
        """The shape of each rank's piece."""
        sizes = _mesh_shape(self.mesh)
        return tuple(n // _ways(e, sizes) for n, e in
                     zip(self.shape, _entries(self.spec, len(self.shape))))


def _zip_map(fn, specs, tree):
    if isinstance(specs, dict):
        return {k: _zip_map(fn, specs[k], None if tree is None else tree[k])
                for k in specs}
    return fn(specs, tree)


def to_shardings(specs, mesh, like=None):
    """Spec tree -> ``Placement`` tree on ``mesh``; ``like`` (a tree of
    shaped leaves) adds each leaf's global shape."""
    return _zip_map(lambda s, leaf: Placement(
        s, mesh, None if leaf is None else _leading(leaf)), specs, like)


def _entries(spec, nd: int) -> tuple:
    return tuple(spec) + (None,) * (nd - len(spec))


def _ways(entry, sizes: dict) -> int:
    if entry is None:
        return 1
    axes = (entry,) if isinstance(entry, str) else entry
    return math.prod(sizes.get(ax, 1) for ax in axes)


def _coords(mesh) -> dict:
    """This rank's coordinate on each axis of a ``DeviceMesh``."""
    return {ax: mesh.get_local_rank(ax) for ax in mesh.mesh_dim_names}


def _block(entry, sizes: dict, coords: dict) -> int:
    """The block index over ``entry``'s axes, major axis first (as
    ``dist.collectives.block_index``)."""
    axes = (entry,) if isinstance(entry, str) else entry
    idx = 0
    for ax in axes:
        idx = idx * sizes.get(ax, 1) + coords.get(ax, 0)
    return idx


def local_shard(tree, specs, mesh, coords: Optional[dict] = None):
    """Each leaf's piece at this rank's coordinates on ``mesh`` (a
    ``DeviceMesh``), or at ``coords`` (``{axis: index}``, with ``mesh`` any
    mesh or a plain ``{axis: size}``): along every dim its spec shards,
    block ``i`` of the dim's ``ways`` equal blocks, ``i`` read major axis
    first.  A sharded tensor leaf comes back as its own copy, so the whole
    leaf can be freed; a replicated leaf comes back as it is.  A list leaf
    is cut along its length."""
    sizes = _mesh_shape(mesh)
    coords = _coords(mesh) if coords is None else coords

    def piece(spec, leaf):
        cut = False
        nd = len(_leading(leaf))
        for d, e in enumerate(_entries(spec, nd)):
            ways = _ways(e, sizes)
            if ways == 1:
                continue
            n = _leading(leaf)[d]
            if n % ways:
                raise ValueError(f"dim {d} of {n} does not split {ways} ways")
            size, i = n // ways, _block(e, sizes, coords)
            if isinstance(leaf, (list, tuple)):
                leaf = leaf[i * size:(i + 1) * size]
            else:
                leaf, cut = leaf.narrow(d, i * size, size), True
        return leaf.clone() if cut else leaf

    return _zip_map(piece, specs, tree)


# ---------------------------------------------------------------------------
# The ambient mesh
# ---------------------------------------------------------------------------

def current_mesh():
    """The innermost ``use_mesh`` context's mesh, or None."""
    return _MESHES[-1] if _MESHES else None


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` the ambient mesh (the reference's ``with mesh:``)."""
    _MESHES.append(mesh)
    try:
        yield mesh
    finally:
        _MESHES.pop()


def residual_constraint(x, *, decode: bool = False):
    """The reference pins the residual stream to (batch -> data axes, seq ->
    ``model``) between blocks when a mesh is active, an XLA layout hint.
    In the port each rank already computes exactly its own rows, with no
    layout for a compiler to choose, so ``x`` comes back unchanged, under a
    mesh or not."""
    del decode
    return x
