"""Meshes of ranks on ``torch.distributed``, and a local world to run them.

The reference lays its devices out as a ``jax.sharding.Mesh`` with named
axes (``data``, ``model``, and ``pod`` across sites) and runs its
collectives inside ``shard_map``.  The port is SPMD instead: one process a
rank, one ``torch.distributed`` group over them, and a
``torch.distributed.device_mesh.DeviceMesh`` whose named dimensions give
each axis its own process group (``repro_torch.dist.collectives`` runs the
reference's ``jax.lax`` collectives over those groups).

``spawn_local`` is the port's counterpart of the reference's emulated host
devices (``--xla_force_host_platform_device_count``): it starts ``world``
processes on this host, joins them in one group and returns what each
rank's function returned.  Its rendezvous is a ``FileStore`` in a fresh
temporary directory, so no TCP port is chosen and two worlds started at
once never meet.  The group's backend is gloo: NCCL refuses two ranks on
one GPU, so ranks that share a card talk through gloo, which takes CUDA
tensors for ``all_reduce`` and ``broadcast`` and which
``dist.collectives`` stages through the host for the rest.  A world of one
rank a card would join NCCL the same way; the collectives need no change
for it.

Nothing here touches ``torch.distributed`` at import time.
"""

from __future__ import annotations

import contextlib
import math
import os
import pickle
import queue
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Callable, Sequence

import torch
import torch.distributed as dist

# Canonical production mesh shapes, keyed by the reference's dry-run mesh
# name (``src/repro/launch/mesh.py``): one pod of 16 x 16, or two pods.
PRODUCTION_MESH_SHAPES = {
    "single": {"data": 16, "model": 16},
    "multi": {"pod": 2, "data": 16, "model": 16},
}


def make_mesh(shape: Sequence[int], names: Sequence[str],
              device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` with axes ``names`` over the ranks of
    the running group (which must hold ``prod(shape)`` ranks).  Every rank
    calls it, in the same order as every other mesh it makes."""
    from torch.distributed.device_mesh import init_device_mesh
    shape, names = tuple(int(s) for s in shape), tuple(names)
    if len(shape) != len(names):
        raise ValueError(f"mesh shape {shape} and names {names} differ in "
                         f"length")
    if math.prod(shape) != dist.get_world_size():
        raise ValueError(f"mesh {dict(zip(names, shape))} needs "
                         f"{math.prod(shape)} ranks; the group has "
                         f"{dist.get_world_size()}")
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The reference's production mesh over the running group: ``(data
    16, model 16)``, or with ``multi_pod`` ``(pod 2, data 16, model 16)``
    (``PRODUCTION_MESH_SHAPES``); the group must hold 256 or 512 ranks, a
    ``dry_world`` of them in the dry run."""
    shape = PRODUCTION_MESH_SHAPES["multi" if multi_pod else "single"]
    return make_mesh(tuple(shape.values()), tuple(shape), device_type)


@contextlib.contextmanager
def dry_world(world: int):
    """A fake group of ``world`` ranks with this process as rank 0, for the
    dry run: ``torch.distributed``'s ``fake`` backend, whose collectives
    return at once and move nothing, so one process runs rank 0's step of
    a 256- or 512-rank world.  Refuses to start while another group is
    running, and always destroys its own on exit.  Rank 0 holds block 0
    on every axis."""
    if dist.is_initialized():
        raise RuntimeError("dry_world: a process group is already running "
                           "in this process; a dry world needs none")
    # importing it registers the ``fake`` backend's process group
    import torch.testing._internal.distributed.fake_pg  # noqa: F401
    dist.init_process_group("fake", store=dist.HashStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_host_mesh(*, model: int = 1, device_type: str = "cuda"):
    """``(data, model)`` over the ranks that are running, ``model`` cut to
    the world's size."""
    n = dist.get_world_size()
    model = min(model, n)
    return make_mesh((n // model, model), ("data", "model"), device_type)


# ---------------------------------------------------------------------------
# A world of local processes
# ---------------------------------------------------------------------------

def _rank_main(rank: int, world: int, tmp: str, device_type: str,
               timeout_s: float, results) -> None:
    """One rank: join the group, run the world's ``fn(*args)``, report its
    result or its traceback, leave the group."""
    try:
        torch.set_num_threads(1)
        with open(os.path.join(tmp, "call.pkl"), "rb") as f:
            fn, args = pickle.load(f)
        if device_type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        store = dist.FileStore(os.path.join(tmp, "store"), world)
        dist.init_process_group("gloo", store=store, rank=rank,
                                world_size=world,
                                timeout=timedelta(seconds=timeout_s))
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:                          # reported, then re-raised
        results.put((rank, False, traceback.format_exc()))
        raise


def _kill(procs) -> None:
    for p in procs:
        if p.is_alive():
            p.kill()
    for p in procs:
        p.join(timeout=10)


def spawn_local(world: int, fn: Callable, *args, device_type: str = "cuda",
                timeout_s: float = 300.0, store_dir: str = None) -> list:
    """Run ``fn(*args)`` in ``world`` fresh processes joined in one gloo
    group and return their results, rank 0 first.

    ``fn`` must be importable by name (a module-level function) and its
    arguments and result picklable; it reads its rank from
    ``torch.distributed``.  Each rank runs one torch thread; on
    ``device_type="cuda"`` rank r uses card ``r % device_count``.  The group
    and ``spawn_local`` itself time out after ``timeout_s``: a rank that
    raises, dies or is still running then makes this raise, after every
    process of the world has been killed.  ``store_dir`` is where the
    rendezvous file goes (a fresh temporary directory by default)."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="repro_mesh_",
                                     dir=store_dir) as tmp:
        # the call goes through a file, not the process arguments: a start
        # blocks until its child has read those, and a child reads them
        # only after importing the parent's main module
        with open(os.path.join(tmp, "call.pkl"), "wb") as f:
            pickle.dump((fn, args), f)
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank_main,
                             args=(r, world, tmp, device_type, timeout_s,
                                   results),
                             name=f"repro-rank-{r}", daemon=True)
                 for r in range(world)]
        out, failed = {}, None
        deadline = time.monotonic() + timeout_s
        try:
            for p in procs:
                p.start()
            while len(out) < world and failed is None:
                left = deadline - time.monotonic()
                if left <= 0:
                    failed = (f"ranks {sorted(set(range(world)) - set(out))}"
                              f" still running after {timeout_s} s")
                    break
                try:
                    rank, ok, payload = results.get(timeout=min(left, 0.5))
                except queue.Empty:
                    dead = [p.name for p in procs
                            if p.exitcode not in (None, 0)]
                    if dead:
                        failed = f"{dead} died without a result"
                    continue
                if ok:
                    out[rank] = payload
                else:
                    failed = f"rank {rank} raised:\n{payload}"
            # a rank that raised closes its group first, so its peers may
            # report their broken connections before it reports its cause:
            # keep what the others say for a moment
            grace = time.monotonic() + 2.0
            while failed is not None and time.monotonic() < grace:
                try:
                    rank, ok, payload = results.get(timeout=0.2)
                except queue.Empty:
                    continue
                if not ok:
                    failed += f"\nrank {rank} raised:\n{payload}"
        finally:
            if failed is None:
                for p in procs:
                    p.join(timeout=max(1.0, deadline - time.monotonic()))
            _kill(procs)
            results.close()
        if failed is not None:
            raise RuntimeError(f"spawn_local({world}): {failed}")
    return [out[r] for r in range(world)]
