"""The dry run: rank 0's step of every (architecture x input shape) on the
production meshes, on fake tensors, with its FLOPs, bytes, collectives
and memory (the reference's ``src/repro/launch/dryrun.py``).

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b \\
      --shape decode_32k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

The reference lowers and compiles each step for 256 or 512 emulated
devices and reads XLA's analyses.  The port compiles nothing: it starts a
fake group of that many ranks in this process (``launch.mesh.dry_world``),
builds rank 0's arguments as fake tensors (``launch.specs.dryrun_args``)
and runs the port's own step on them once, as it is, under the cost
counter (``obs.cost.CostCounter``).  No card is needed and nothing
is allocated; a step fails here where it would fail on the card (the
kernels' shape rules run their own checks).

Results land in ``experiments/dryrun_torch/<arch>__<shape>__<mesh>
[__fed].json`` with the reference's keys, every number rank 0's:
``flops_per_device``, ``bytes_accessed_per_device``,
``collectives.{bytes,counts,total_bytes}`` and ``memory``:
``argument_bytes`` (the rank's arguments), ``output_bytes``,
``temp_bytes`` (the step's peak of live bytes above its arguments, which
the card reads as ``max_memory_allocated`` less what was allocated before
the step) and ``alias_bytes`` (outputs that share an argument's storage:
the cache updated in place, the leaves a step returns untouched).
``lower_s`` is the set-up (world, mesh, fakes) and ``compile_s`` the fake
step's run, under the reference's names.  There are no ``xla_*`` keys;
``port`` and ``torch`` say whose numbers they are.

Env knobs as in the reference: ``REPRO_ACCUM`` (else 8 / 4 / 1 by
``d_model`` >= 4096 / >= 1024), ``REPRO_CACHE_SHARD`` (``heads`` raises
the port's ``NotImplementedError``: a ``FAIL`` line), ``REPRO_KV_INT8``,
``REPRO_GRAD_DTYPE``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback

import torch

from repro_torch.configs import (ALL_ARCHS, ASSIGNED_ARCHS, INPUT_SHAPES,
                                 SHAPES_BY_NAME, get_config)
from repro_torch.dist.sharding import use_mesh
from repro_torch.launch.hlo_cost import analyze, count
from repro_torch.launch.mesh import (PRODUCTION_MESH_SHAPES, dry_world,
                                     make_production_mesh)
from repro_torch.launch.specs import dryrun_args
from repro_torch.launch.steps import (decode_force_window,
                                      make_fed_train_step, make_prefill_step,
                                      make_serve_step, make_train_step,
                                      row_split)
from repro_torch.obs.cost import is_fake, tensor_bytes, tensors_in
from repro_torch.obs.devmem import scope_costs

OUTDIR = "experiments/dryrun_torch"


def accum_for(cfg) -> int:
    """The reference's accumulation policy: ``REPRO_ACCUM``, else 8 / 4 / 1
    microbatches by ``d_model`` >= 4096 / >= 1024."""
    return int(os.environ.get("REPRO_ACCUM", "0")) or \
        (8 if cfg.d_model >= 4096 else 4 if cfg.d_model >= 1024 else 1)


def step_for(cfg, kind: str, shape_name: str, accum: int):
    """The port's step of ``kind`` for the dry run, as the reference picks
    it."""
    if kind == "train":
        return make_train_step(cfg, accum=accum)
    if kind == "fed_train":
        return make_fed_train_step(cfg)
    if kind == "prefill":
        return make_prefill_step(cfg)
    fw = decode_force_window(cfg, SHAPES_BY_NAME[shape_name].seq_len)
    return make_serve_step(cfg, force_window=fw)


def measure(step, args, mesh=None):
    """Run ``step(*args)`` once under a fresh ``CostCounter`` (and
    ``use_mesh(mesh)``): ``(the counter, the reference's memory keys)``.
    On fakes it runs under the fakes' mode; on real tensors (the card's
    check of the prediction) as it is."""
    fake = next((t for t in tensors_in(args) if is_fake(t)), None)
    with (fake.fake_mode if fake is not None else contextlib.nullcontext()), \
            (use_mesh(mesh) if mesh is not None
             else contextlib.nullcontext()):
        out, counter = count(step, *args)
    held = {id(t.untyped_storage()) for t in tensors_in(args)}
    return counter, {
        "argument_bytes": tensor_bytes(args),
        "output_bytes": tensor_bytes(out),
        "temp_bytes": counter.peak_bytes,
        "alias_bytes": tensor_bytes([t for t in tensors_in(out)
                                     if id(t.untyped_storage()) in held])}


def run_one(arch: str, shape_name: str, *, multi_pod: bool,
            fed: bool = False, outdir: str = OUTDIR) -> dict:
    """Rank 0's step of ``arch`` at ``shape_name`` on the single or the
    multi-pod mesh, on fakes in a fake world; writes and returns its
    JSON record."""
    cfg = get_config(arch)
    mesh_name = "multi" if multi_pod else "single"
    world = math.prod(PRODUCTION_MESH_SHAPES[mesh_name].values())
    t0 = time.time()
    with dry_world(world):
        mesh = make_production_mesh(multi_pod=multi_pod)
        kind, args, in_specs, _ = dryrun_args(cfg, shape_name, mesh,
                                              fed=fed)
        accum = accum_for(cfg)
        fn = step_for(cfg, kind, shape_name, accum)
        t_setup = time.time() - t0
        counter, mem = measure(fn, args, mesh)
        t_run = time.time() - t0 - t_setup
        axes, ways, _ = row_split(mesh)
    parsed = analyze(counter)
    result = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "step_kind": kind, "fed": fed,
        "accum": accum if kind == "train" else 1,
        "num_devices": world,
        "lower_s": round(t_setup, 2), "compile_s": round(t_run, 2),
        "flops_per_device": parsed["flops_per_device"],
        "bytes_accessed_per_device": parsed["bytes_per_device"],
        "collectives": {"bytes": parsed["collective_bytes"],
                        "counts": parsed["collective_counts"],
                        "total_bytes": parsed["collective_total_bytes"]},
        "memory": mem,
        "scopes": scope_costs(counter),
        "layout": {"params": "whole on every rank",
                   "rows": {"axes": list(axes), "ways": ways},
                   "cache": (in_specs[1].get("k") if kind == "serve"
                             else None)},
        "port": "torch", "torch": torch.__version__,
    }
    os.makedirs(outdir, exist_ok=True)
    tag = f"{arch}__{shape_name}__{mesh_name}" + ("__fed" if fed else "")
    with open(os.path.join(outdir, tag + ".json"), "w") as f:
        json.dump(result, f, indent=2)
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=ALL_ARCHS)
    ap.add_argument("--shape", choices=[s.name for s in INPUT_SHAPES])
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--fed", action="store_true",
                    help="the paper's LoRA-federated train step")
    ap.add_argument("--all", action="store_true",
                    help="all assigned archs x shapes")
    ap.add_argument("--outdir", default=OUTDIR)
    args = ap.parse_args(argv)
    if not args.all and (args.arch is None or args.shape is None):
        ap.error("--arch and --shape, or --all")

    archs = ASSIGNED_ARCHS if args.all else [args.arch]
    shapes = [s.name for s in INPUT_SHAPES] if args.all else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    ok, fail = 0, 0
    for a in archs:
        for s in shapes:
            for mp in meshes:
                tag = f"{a} x {s} x {'multi' if mp else 'single'}" + \
                    (" [fed]" if args.fed else "")
                try:
                    r = run_one(a, s, multi_pod=mp, fed=args.fed,
                                outdir=args.outdir)
                    print(f"OK   {tag}: compile={r['compile_s']}s "
                          f"flops/dev={r['flops_per_device']:.3e} "
                          f"coll={r['collectives']['total_bytes']:.3e}B "
                          f"temp={r['memory']['temp_bytes'] / 2**30:.2f}GiB",
                          flush=True)
                    ok += 1
                except Exception as e:          # reported, then counted
                    print(f"FAIL {tag}: {type(e).__name__}: {e}", flush=True)
                    traceback.print_exc()
                    fail += 1
    print(f"dryrun: {ok} ok, {fail} failed", flush=True)
    if fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
