"""Dispatch for the port's kernels.

A tensor on the CPU takes the kernel's plain PyTorch version; any other
tensor takes the CUDA kernel, which launches or raises.  Nothing falls back:
a kernel that fails to build or launch is an error, not a slower path.
Unlike the reference's ``ops.flash_decode`` there is no cache length below
which the plain version runs: on the card the kernel always runs.

The names and positional signatures are the reference's
(``repro/kernels/ops.py``); its TPU tile arguments (``bm``, ``bn``, ``bk``,
``bq``) are not carried over.  As in the reference, ``qlora_matmul``,
``flash_attention`` and ``rmsnorm`` lie on no model path: their callers are
the tests and ``chip_smoke.py``.
"""

from __future__ import annotations

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import flash_decode as _fd
from repro_torch.kernels import qlora_matmul as _qm
from repro_torch.kernels import rmsnorm as _rn


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


def block_copy_leaves(pool_leaves, src: int, dst: int):
    """``block_copy`` of every leaf of a copy-on-write event at once: on
    the card one kernel launch for all of them.  Returns the leaves."""
    leaves = list(pool_leaves)
    if leaves and leaves[0].device.type == "cpu":
        return _fd.paged_block_copy_leaves_ref(leaves, src, dst)
    return _fd.paged_block_copy_leaves_cuda(leaves, src, dst)


def qlora_matmul(x, w_nf4, absmax, lora_a, lora_b, lora_scale):
    """``y = x . dequant_nf4(Wq) + s . (x . A) . B`` with f32 products, in
    x's type; see ``repro_torch.kernels.qlora_matmul`` for the layouts.
    Raises ``ValueError`` on an absmax that is not (K, N/qblock)."""
    if x.device.type == "cpu":
        return _qm.qlora_matmul_ref(x, w_nf4, absmax, lora_a, lora_b,
                                    lora_scale)
    return _qm.qlora_matmul_cuda(x, w_nf4, absmax, lora_a, lora_b,
                                 lora_scale)


def flash_attention(q, k, v, *, causal: bool = True):
    """Causal or full attention over q, k, v (B, H, S, D), f32 softmax."""
    if q.device.type == "cpu":
        return _fa.flash_attention_ref(q, k, v, causal)
    return _fa.flash_attention_cuda(q, k, v, causal)


def rmsnorm(x, scale, *, eps: float = 1e-6):
    """RMSNorm of x (..., d) by scale (d,), f32 inside, in x's type."""
    if x.device.type == "cpu":
        return _rn.rmsnorm_ref(x, scale, eps)
    return _rn.rmsnorm_cuda(x, scale, eps)
