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

The reference's cache, batch and residual-stream rules (``cache_specs``,
``data_specs``, ``to_shardings``, ``residual_constraint``) are consumed by
its launch stack, which the port has not reached yet.
"""

from __future__ import annotations

import contextlib

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
