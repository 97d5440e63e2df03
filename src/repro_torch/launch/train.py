"""Training launcher (the reference's ``src/repro/launch/train.py``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
      --steps 20 --batch 8 --seq 256 [--smoke | --full-config] [--fed]

Full fine-tuning (``launch.steps.make_train_step``) or, with ``--fed``, the
paper's federated step on LoRA adapters of rank 4 at the family's target
sites (``make_fed_train_step``), on Markov-chain tokens
(``data.tokens``).  The smoke config is the default; ``--full-config``
runs the published widths.  Weights are random, drawn from ``--seed`` on
the device.  Everything runs on ``cuda`` unless ``--device cpu`` is given
(a smoke-sized run only).

Under a process group the launcher runs on a mesh of its ranks:
``(data, model)`` with ``--model-parallel`` model ways
(``launch.mesh.make_host_mesh``).  The group is the caller's
(``launch.mesh.spawn_local``) or, when ``WORLD_SIZE`` is set by a launcher
such as ``torchrun``, one the launcher joins on gloo.  Every rank draws
the same weights and the same global batch and steps on its rows of it;
AdamW's moments are ZeRO-1 blocks.  Without a group it runs as one rank
with no mesh.

``--trace-out PATH`` writes the ``repro_torch.obs`` timeline (a
``train.step`` span a step, the ``train.loss`` gauge, device-memory
watermarks) as Chrome trace-event JSON for Perfetto / chrome://tracing.

``--scope-costs`` first runs one step on fakes of the run's own
parameters, moments and batch (``launch.hlo_cost``: nothing is computed or
allocated, and the real parameters are untouched) and prints its FLOPs
and bytes by ``obs.*`` scope, ordered by FLOPs, as the reference prints
its compiled step's; then it trains.  It counts a one-rank step: under a
process group it is refused, since the step's collectives would meet
fakes.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import time
from typing import Callable, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import obs
from repro_torch import tree as tree_util
from repro_torch.configs import ALL_ARCHS, get_config, get_smoke_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core.lora import FAMILY_TARGETS, attach_lora, lora_tree
from repro_torch.data.tokens import lm_batches, markov_tokens
from repro_torch.dist.sharding import data_specs, local_shard, use_mesh
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import (make_fed_train_step,
                                      make_train_step, row_split)
from repro_torch.models.registry import get_model, train_batch_shapes
from repro_torch.optim.adamw import adamw_init, zero1_init

TOKENS = 200_000        # the Markov stream's length, as the reference's


@dataclasses.dataclass
class TrainRun:
    """What a run leaves: the final parameters and moments, each step's
    loss and wall (s, host clock; each step ends with its loss read back,
    which waits for its device work) and tokens a second over the loop."""
    cfg: ModelConfig
    params: dict
    opt_state: dict
    losses: List[float]
    walls: List[float]
    tokens_per_s: float
    mesh_shape: Optional[dict]


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=ALL_ARCHS, default="smollm-360m")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full-config", dest="smoke", action="store_false")
    ap.add_argument("--fed", action="store_true",
                    help="LoRA-federated step (the paper's training mode)")
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--trace-out", default="",
                    help="write the repro_torch.obs span timeline as Chrome "
                         "trace-event JSON (Perfetto / chrome://tracing)")
    ap.add_argument("--scope-costs", action="store_true",
                    help="print one step's FLOPs and bytes by obs.* scope "
                         "(counted on fakes) before training")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def synth_batch(cfg, batch: int, seq: int, it, device="cuda") -> dict:
    """The next ``lm_batches`` draw cut to ``train_batch_shapes``, on
    ``device``."""
    b = next(it)
    out = {}
    for k, (shp, dt) in train_batch_shapes(cfg, batch, seq).items():
        if k in ("tokens", "labels"):
            out[k] = torch.from_numpy(np.ascontiguousarray(
                b[k][:, :shp[1]])).to(device)
        else:
            out[k] = torch.zeros(shp, dtype=dt, device=device)
    return out


def setup(cfg, *, fed: bool, lr: float, seed: int = 0, device="cuda",
          mesh=None):
    """``(params, opt_state, step_fn)``: weights drawn from ``seed`` on
    ``device`` (adapters from ``seed + 1`` with ``fed``), zero moments of
    what the step trains (the adapter tree with ``fed``; this rank's ZeRO-1
    blocks on ``mesh``) and the step."""
    dev = torch.device(device)
    params = get_model(cfg).init(
        cfg, torch.Generator(device=dev).manual_seed(seed), device=dev)
    if fed:
        params = attach_lora(
            params, torch.Generator(device=dev).manual_seed(seed + 1),
            rank=4, alpha=8.0, targets=FAMILY_TARGETS[cfg.family])
        step_fn, trained = make_fed_train_step(cfg, lr=lr), lora_tree(params)
    else:
        step_fn, trained = make_train_step(cfg, lr=lr), params
    opt = zero1_init(trained, mesh) if mesh is not None else \
        adamw_init(trained)
    return params, opt, step_fn


def train(cfg, params, opt_state, step_fn, *, steps: int, batch: int,
          seq: int, device="cuda", mesh=None,
          log: Optional[Callable[[str], None]] = print) -> TrainRun:
    """``steps`` steps of ``step_fn`` on Markov tokens of ``cfg``'s vocab,
    ``batch`` x ``seq`` a step (the global batch on a mesh, of which each
    rank steps on its rows), printing the reference's progress lines
    through ``log``."""
    ways = row_split(mesh)[1]
    if batch % ways:
        raise ValueError(f"a batch of {batch} rows does not split over the "
                         f"mesh's {ways} data ways")
    dev = torch.device(device)
    it = lm_batches(markov_tokens(TOKENS, cfg.vocab_size, seed=0), batch,
                    seq + 1, seed=0)
    losses, walls = [], []
    ctx = use_mesh(mesh) if mesh is not None else contextlib.nullcontext()
    with ctx:
        t0 = time.time()
        for i in range(steps):
            b = synth_batch(cfg, batch, seq, it, dev)
            if mesh is not None:
                b = local_shard(b, data_specs(b, mesh), mesh)
            ts = time.perf_counter()
            with obs.step_span("train.step", i, batch=batch, seq=seq):
                params, opt_state, loss = step_fn(params, opt_state, b, i)
                loss = float(loss)      # device sync inside the span
            walls.append(time.perf_counter() - ts)
            losses.append(loss)
            obs.gauge("train.loss", loss)
            if i < 3 or (i + 1) % 5 == 0:
                tok_s = batch * seq * (i + 1) / (time.time() - t0)
                if log:
                    log(f"step {i + 1}/{steps} loss={loss:.4f} "
                        f"({tok_s:.0f} tok/s)")
                if obs.enabled():
                    obs.watermark("train.step", dev)
        tok_s = batch * seq * steps / max(time.time() - t0, 1e-9)
    shape = (dict(zip(mesh.mesh_dim_names, mesh.shape))
             if mesh is not None else None)
    return TrainRun(cfg, params, opt_state, losses, walls, tok_s, shape)


def _join_group(dev: torch.device) -> bool:
    """Join the gloo group a launcher describes through ``WORLD_SIZE``
    (and ``RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) when none is running.
    True when this call made the group."""
    if dist.is_initialized() or int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return False
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0"))
                              % torch.cuda.device_count())
    dist.init_process_group("gloo")
    return True


def print_scope_costs(cfg, params, opt_state, step_fn, *, batch: int,
                      seq: int, log: Callable[[str], None] = print) -> dict:
    """One step of ``step_fn`` on fakes of ``params``, ``opt_state`` and a
    ``batch`` x ``seq`` batch, under the cost counter: logs the reference's
    per-scope table (scope, FLOPs, share of the step's, bytes; by FLOPs)
    and returns the scope costs."""
    from repro_torch.launch.dryrun import measure
    from repro_torch.launch.specs import fake_mode, fakes_like
    rows = {k: torch.empty(shp, dtype=dt, device="meta") for k, (shp, dt)
            in train_batch_shapes(cfg, batch, seq).items()}
    args = fakes_like((params, opt_state, rows), fake_mode()) + (0,)
    counter, _ = measure(step_fn, args)
    costs = obs.devmem.scope_costs(counter)
    total = sum(v["flops"] for v in costs.values()) or 1.0
    log("per-scope cost attribution (one step, counted on fakes):")
    for scope, v in sorted(costs.items(), key=lambda kv: -kv[1]["flops"]):
        log(f"  {scope:<28} flops={v['flops']:.3e} "
            f"({v['flops'] / total:5.1%})  bytes={v['bytes']:.3e}")
    return costs


def run(args: argparse.Namespace) -> TrainRun:
    """The launcher's run for parsed ``args`` (``parse_args``), in this
    process: on a mesh of the running group's ranks, else on one."""
    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device (pass --device cpu for a plain "
                         "PyTorch run at smoke size)")
    own = _join_group(dev)
    try:
        mesh = (make_host_mesh(model=args.model_parallel,
                               device_type=dev.type)
                if dist.is_initialized() else None)
        lead = mesh is None or dist.get_rank() == 0
        log = print if lead else None
        shape = (dict(zip(mesh.mesh_dim_names, mesh.shape))
                 if mesh is not None else None)
        if log:
            log(f"arch={cfg.name} device={dev} ranks="
                f"{dist.get_world_size() if mesh is not None else 1} "
                f"mesh={shape}")
        if args.scope_costs and mesh is not None:
            raise SystemExit("--scope-costs counts a one-rank step; under a "
                             "process group its collectives would meet "
                             "fakes")
        params, opt, step_fn = setup(cfg, fed=args.fed, lr=args.lr,
                                     seed=args.seed, device=dev, mesh=mesh)
        if log:
            n = sum(x.numel() for x in tree_util.leaves(params))
            log(f"params: {n / 1e6:.1f}M")
        if args.scope_costs:
            print_scope_costs(cfg, params, opt, step_fn, batch=args.batch,
                              seq=args.seq, log=log)
        out = train(cfg, params, opt, step_fn, steps=args.steps,
                    batch=args.batch, seq=args.seq, device=dev, mesh=mesh,
                    log=log)
        if log:
            log("done")
        if args.trace_out and lead:
            path = obs.dump(args.trace_out, provenance={
                "device": str(dev), "arch": cfg.name, "mesh": shape,
                "fed": args.fed,
                "card": (torch.cuda.get_device_name(dev)
                         if dev.type == "cuda" else None)})
            log(f"trace: wrote {path} "
                f"(open at https://ui.perfetto.dev or chrome://tracing)")
        return out
    finally:
        if own:
            dist.destroy_process_group()


def main(argv=None) -> None:
    run(parse_args(argv))


if __name__ == "__main__":
    main()
