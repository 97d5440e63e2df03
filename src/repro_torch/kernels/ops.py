"""Dispatch for the port's kernels.

A tensor on the CPU takes the kernel's plain PyTorch version; any other
tensor takes the CUDA kernel, which launches or raises.  Nothing falls back:
a kernel that fails to build or launch is an error, not a slower path.
Unlike the reference's ``ops.flash_decode`` there is no cache length below
which the plain version runs: on the card the kernel always runs.
"""

from __future__ import annotations

from repro_torch.kernels import flash_decode as _fd


def flash_decode(q, k, v, kv_pos, q_pos, **kw):
    """One decode step over the ring or paged cache; see
    ``repro_torch.kernels.flash_decode.flash_decode_ref`` for the
    signature and semantics."""
    if q.device.type == "cpu":
        return _fd.flash_decode_ref(q, k, v, kv_pos, q_pos, **kw)
    return _fd.flash_decode_cuda(q, k, v, kv_pos, q_pos, **kw)


def block_copy(pool_leaf, src: int, dst: int):
    """Copy block ``src``'s tile to block ``dst`` in every layer of the
    layer-stacked pool leaf ``(L, n_blocks, ...)``, in place (the paged
    pool's copy-on-write move).  Exact for every dtype."""
    if pool_leaf.device.type == "cpu":
        return _fd.paged_block_copy_ref(pool_leaf, src, dst)
    return _fd.paged_block_copy_cuda(pool_leaf, src, dst)
