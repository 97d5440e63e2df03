"""Dry-run arguments: fake stand-ins and their layouts for every
(architecture x input shape) pair, with no allocation anywhere (the
reference's ``src/repro/launch/specs.py``).

The reference builds ``jax.ShapeDtypeStruct`` trees through
``jax.eval_shape`` and gives each a ``NamedSharding``; XLA partitions the
global program.  The port runs rank 0's step of the world as it is, so
its stand-ins are fake tensors (``torch._subclasses.fake_tensor``: shapes,
types, no data) of what rank 0 holds: ``local_shard`` of each tree under
its spec, and the batch rows ``launch.steps.row_split`` gives the rank.

The fakes carry the CPU device: a CPU build of PyTorch cannot index a
fake CUDA tensor (its Python indexing takes a CUDA device guard), and the
same fakes then serve on a CPU-only machine and on the card's.  A fake stands
for a tensor on the card whatever its device: the kernel entries
(``repro_torch.kernels.ops``) send fakes to their shape rules, never to
the plain versions.  One ``FakeTensorMode`` makes every fake of a pair,
and ``launch.dryrun.measure`` runs the step in it.

Parameters are what the port holds: whole on every rank (tensor-parallel
projections are not ported), where the reference shards them over
``model``.  ``in_specs`` says so (every parameter ``()``), so what the dry
run reports is the port's own layout.  A recurrent family's state is
likewise whole over ``model`` (``_rows_only``): the port has no
model-parallel recurrent decode, so each model rank holds its rows' whole
state, where the reference's rule shards it.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import tree as tree_util
from repro_torch.configs.base import SHAPES_BY_NAME, ModelConfig
from repro_torch.core.lora import (FAMILY_TARGETS, attach_lora, lora_tree,
                                   quantize_base)
from repro_torch.dist.sharding import (_maybe_spec, cache_specs, data_specs,
                                       local_shard, opt_state_specs)
from repro_torch.launch.steps import RECURRENT_FAMILIES, decode_force_window
from repro_torch.models.registry import (decode_batch_shapes, get_model,
                                         train_batch_shapes)
from repro_torch.optim.adamw import adamw_init, zero1_init

# The device the fakes carry (module docstring).
FAKE_DEVICE = "cpu"


def fake_mode() -> FakeTensorMode:
    """A fresh mode for one pair's fakes.  Real tensors may meet them (a
    constant such as the NF4 code book is a real CPU tensor)."""
    return FakeTensorMode(allow_non_fake_inputs=True)


def fakes_like(tree, mode):
    """Fakes in ``mode`` of ``tree``'s tensors (shapes, strides, types) on
    ``FAKE_DEVICE``, whatever device those are on: a real run's own trees
    as the dry run's stand-ins, with nothing allocated.  Other leaves are
    kept."""
    def fake(t):
        if not isinstance(t, torch.Tensor):
            return t
        return torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                                   device=FAKE_DEVICE)
    with mode:
        return tree_util.map_(fake, tree)


def _replicated(tree):
    return tree_util.map_(lambda _: (), tree)


def param_shapes(cfg: ModelConfig, *, fed: bool = False, mode=None):
    """The port's parameter tree as fakes (no allocation): ``init``, and
    with ``fed`` ``attach_lora`` and ``quantize_base`` at the family's
    ``FAMILY_TARGETS`` with the config's rank, alpha and block, as the
    reference's ``param_shapes``.  The draws come from a CPU generator,
    which a fake draw accepts for any device, so the tree is the same on
    every machine.  ``mode``: the fake mode to make them in (a fresh one by
    default)."""
    with mode or fake_mode():
        g = torch.Generator().manual_seed(0)
        p = get_model(cfg).init(cfg, g, device=FAKE_DEVICE)
        if fed:
            ft = cfg.fedtime
            targets = FAMILY_TARGETS[cfg.family]
            p = attach_lora(p, g, rank=ft.lora_rank, alpha=ft.lora_alpha,
                            targets=targets)
            if ft.qlora:
                p = quantize_base(p, qblock=ft.qlora_block, targets=targets)
    return p


def _fake_batch(shapes: dict) -> dict:
    return {k: torch.zeros(shp, dtype=dt, device=FAKE_DEVICE)
            for k, (shp, dt) in shapes.items()}


def _rows_only(specs):
    """A cache spec tree with ``model`` taken out of every entry: a
    recurrent state split over the batch's rows only."""
    if isinstance(specs, dict):
        return {k: _rows_only(v) for k, v in specs.items()}
    return _maybe_spec([None if e == "model" else e for e in specs])


def _cache_specs(cfg, cache, mesh):
    """The port's layout of a cache: the reference's rule, but whole over
    ``model`` for a recurrent family."""
    specs = cache_specs(cache, mesh)
    return _rows_only(specs) if cfg.family in RECURRENT_FAMILIES else specs


def _meta_cache(cfg, batch: int, seq: int, force_window: int):
    """The global cache's leaves on the meta device: shapes for its specs,
    nothing allocated."""
    return get_model(cfg).init_cache(cfg, batch, seq,
                                     force_window=force_window,
                                     dtype=torch.bfloat16, device="meta")


def dryrun_args(arch_cfg: ModelConfig, shape_name: str, mesh, *,
                fed: bool = False) -> Tuple[str, tuple, tuple, tuple]:
    """``(step kind, args, in_specs, out_specs)`` of rank 0 of ``mesh`` (a
    ``DeviceMesh`` in a ``launch.mesh.dry_world``) for one input shape
    (``step_args`` at the shape's global batch and length)."""
    shape = SHAPES_BY_NAME[shape_name]
    return step_args(arch_cfg, shape.kind, shape.global_batch,
                     shape.seq_len, mesh, fed=fed)


def step_args(cfg: ModelConfig, kind: str, batch: int, seq: int,
              mesh=None, *, fed: bool = False):
    """``(step kind, args, in_specs, out_specs)`` of rank 0 of ``mesh``
    (None: one rank, no mesh) for a global batch of ``batch`` rows of
    ``seq`` tokens and a shape ``kind`` of ``train``, ``prefill`` or
    ``decode``.

    The args are rank 0's own fakes, made in one fake mode (each fake's
    ``fake_mode``): train ``(params, opt_state, batch, step)``
    with the rank's ZeRO-1 moment blocks (of the adapters only with
    ``fed``) and its rows of the global batch; prefill ``(params, batch)``
    without labels; decode ``(params, cache, batch)``, the cache the rank's
    stripe of a bf16 ring of ``seq`` at ``decode_force_window`` and the
    batch its rows of ``{"token", "pos"}``.  The specs are the layouts of
    the global trees (``dist.sharding``'s rules), the parameters
    replicated: what the port holds."""
    mode = fake_mode()
    params = param_shapes(cfg, fed=fed, mode=mode)
    p_spec = _replicated(params)

    def place(tree, specs):
        return tree if mesh is None else local_shard(tree, specs, mesh)

    one = {"data": 1}                        # no mesh: every spec is ()
    with mode:
        if kind == "train":
            trained = lora_tree(params) if fed else params
            opt = (zero1_init(trained, mesh) if mesh is not None
                   else adamw_init(trained))
            o_spec = opt_state_specs(trained, mesh or one)
            rows = _fake_batch(train_batch_shapes(cfg, batch, seq))
            b_spec = data_specs(rows, mesh or one)
            opt_spec = {"mu": o_spec, "nu": o_spec}
            return ("fed_train" if fed else "train",
                    (params, opt, place(rows, b_spec), 0),
                    (p_spec, opt_spec, b_spec, ()),
                    (p_spec, opt_spec, ()))

        if kind == "prefill":
            rows = _fake_batch(train_batch_shapes(cfg, batch, seq))
            rows.pop("labels")
            b_spec = data_specs(rows, mesh or one)
            c_spec = _cache_specs(cfg, _meta_cache(cfg, batch, seq, 0),
                                  mesh or one)
            return ("prefill", (params, place(rows, b_spec)),
                    (p_spec, b_spec), (c_spec, ()))

        fw = decode_force_window(cfg, seq)
        c_spec = _cache_specs(cfg, _meta_cache(cfg, batch, seq, fw),
                              mesh or one)
        cache = place(get_model(cfg).init_cache(
            cfg, batch, seq, force_window=fw, dtype=torch.bfloat16,
            device=FAKE_DEVICE), c_spec)
        rows = _fake_batch(decode_batch_shapes(cfg, batch))
        b_spec = data_specs(rows, mesh or one)
        return ("serve", (params, cache, place(rows, b_spec)),
                (p_spec, c_spec, b_spec), (b_spec["token"], c_spec))
