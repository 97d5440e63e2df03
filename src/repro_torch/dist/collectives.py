"""The reference's ``jax.lax`` collectives, over a ``DeviceMesh``'s axes.

Inside ``shard_map`` the reference calls ``axis_index``, ``ppermute``,
``psum``, ``pmax`` and ``all_gather`` on named mesh axes.  The port runs
SPMD (one process a rank, ``repro_torch.launch.mesh``), and each named
dimension of a ``torch.distributed.device_mesh.DeviceMesh`` has its own
process group; these functions are those collectives over those groups.
Every rank of the axis's group must make the same calls in the same order.

Axes: one name, or a tuple of names read major axis first, as
``PartitionSpec(("data", "pod"))`` orders them (the block index of a rank
is ``data_idx * pod + pod_idx``).  A reduction over several axes runs one
axis at a time.

Host staging happens here and only here: gloo moves CUDA tensors for
``all_reduce`` but not for point-to-point sends or ``all_gather``, so on a
gloo group a CUDA tensor goes to the host for those two, and comes back to
its device after.  Ranks that share one card (NCCL refuses them) take that
path; on NCCL every call stays on the device.

Every collective the port issues goes through here, so this is where a
cost counter (``repro_torch.obs.cost``) learns of them: each
transfer is one collective of the reference's kind (``psum`` / ``pmax``
an ``all-reduce`` an axis, ``all_gather`` an ``all-gather`` an axis,
``ppermute`` a ``collective-permute`` a tensor), at its result's bytes.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.obs.cost import record_collective

Axes = Union[str, Sequence[str]]


def _axes(axes: Axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def axis_size(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate on ``axis``."""
    return mesh.get_local_rank(axis)


def block_index(mesh, axes: Axes) -> int:
    """This rank's block over ``axes``, major axis first."""
    idx = 0
    for ax in _axes(axes):
        idx = idx * axis_size(mesh, ax) + axis_index(mesh, ax)
    return idx


def _staged(t: torch.Tensor, group) -> bool:
    """True where gloo cannot take ``t`` on its device for a send or a
    gather: a CUDA tensor on a gloo group."""
    return t.device.type == "cuda" and dist.get_backend(group) == "gloo"


def ppermute(xs, mesh, axis: str, shift: int = 1):
    """Send ``xs`` to the rank ``shift`` steps ahead on ``axis`` and return
    what the rank ``shift`` steps behind sent (a ring: ``jax.lax.ppermute``
    with the permutation ``i -> (i + shift) % n``).

    ``xs`` is a tensor or a tuple of tensors and ``None`` (a ``None`` stays
    ``None``); each tensor goes with its own tag, so codes and their scales
    never cross, even on a 2-rank ring where both neighbours are one
    rank."""
    single = isinstance(xs, torch.Tensor)
    items = (xs,) if single else tuple(xs)
    n = axis_size(mesh, axis)
    if n == 1 or shift % n == 0:
        return xs
    group = mesh.get_group(axis)
    me = axis_index(mesh, axis)
    dst = dist.get_global_rank(group, (me + shift) % n)
    src = dist.get_global_rank(group, (me - shift) % n)
    ops, outs = [], []
    for tag, x in enumerate(items):
        if x is None:
            outs.append(None)
            continue
        send = x.contiguous()
        if _staged(send, group):
            send = send.cpu()
        recv = torch.empty_like(send)
        ops.append(dist.P2POp(dist.isend, send, dst, group, tag))
        ops.append(dist.P2POp(dist.irecv, recv, src, group, tag))
        outs.append(recv)
        record_collective("collective-permute", recv)
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    outs = [None if o is None else o.to(x.device)
            for o, x in zip(outs, items)]
    return outs[0] if single else tuple(outs)


def _reduce(x: torch.Tensor, mesh, axes: Axes, op) -> torch.Tensor:
    y = x.clone().contiguous()
    for ax in _axes(axes):
        if axis_size(mesh, ax) > 1:
            dist.all_reduce(y, op=op, group=mesh.get_group(ax))
            record_collective("all-reduce", y)
    return y


def psum(x: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    """Sum of ``x`` over the ranks of ``axes`` (a new tensor)."""
    return _reduce(x, mesh, axes, dist.ReduceOp.SUM)


def pmax(x: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    """Elementwise maximum of ``x`` over the ranks of ``axes``."""
    return _reduce(x, mesh, axes, dist.ReduceOp.MAX)


def all_gather(x: torch.Tensor, mesh, axes: Axes,
               dim: int = 0) -> torch.Tensor:
    """The ranks' ``x`` laid end to end along ``dim`` in block order over
    ``axes`` (``jax.lax.all_gather(..., tiled=True)``): the minor axis is
    gathered first, then each axis out to the major one."""
    axes = [ax for ax in _axes(axes) if axis_size(mesh, ax) > 1]
    if not axes:
        return x
    y = x.contiguous()
    staged = _staged(y, mesh.get_group(axes[0]))
    if staged:
        y = y.cpu()
    for ax in reversed(axes):
        parts = [torch.empty_like(y) for _ in range(axis_size(mesh, ax))]
        dist.all_gather(parts, y, group=mesh.get_group(ax))
        y = torch.cat(parts, dim=dim)
        record_collective("all-gather", y)
    return y.to(x.device) if staged else y
