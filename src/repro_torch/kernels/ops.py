"""Dispatch for the port's kernels.

A tensor on the CPU takes the kernel's plain PyTorch version; a CUDA tensor
takes the CUDA kernel, which launches or raises; a fake tensor (the dry
run's, ``repro_torch.launch.dryrun``) takes the kernel's shape rule: the
kernel's own argument checks, then outputs of its shapes and types, with
no card query, so a dry run fails where the card would.  Nothing falls
back: a kernel that fails to build or launch is an error, not a slower
path.  Unlike the reference's ``ops.flash_decode`` there is no cache length
below which the plain version runs: on the card the kernel always runs.

Each entry is one kernel under the reference's ``obs.*`` scope
(``obs.flash_decode``, ``obs.block_copy``, ``obs.qlora_matmul``,
``obs.flash_attention``, ``obs.rmsnorm``), dispatched by
``repro_torch.obs.cost.run_kernel``: while a cost counter is active a call
counts at its kernel's cost rule, whatever implements it; with none active
that costs one global read and nothing else.

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
from repro_torch.obs.cost import run_kernel


def flash_decode(q, k, v, kv_pos, q_pos, **kw):
    """One decode step over the ring or paged cache; see
    ``repro_torch.kernels.flash_decode.flash_decode_ref`` for the
    signature and semantics."""
    return run_kernel("obs.flash_decode", _fd.flash_decode_cost,
                      _fd.flash_decode_shape, _fd.flash_decode_ref,
                      _fd.flash_decode_cuda, q, q, k, v, kv_pos, q_pos, **kw)


def block_copy(pool_leaf, src: int, dst: int):
    """Copy block ``src``'s tile to block ``dst`` in every layer of the
    layer-stacked pool leaf ``(L, n_blocks, ...)``, in place (the paged
    pool's copy-on-write move).  Exact for every dtype."""
    block_copy_leaves([pool_leaf], src, dst)
    return pool_leaf


def block_copy_leaves(pool_leaves, src: int, dst: int):
    """``block_copy`` of every leaf of a copy-on-write event at once: on
    the card one kernel launch for all of them.  Returns the leaves."""
    leaves = list(pool_leaves)
    return run_kernel(
        "obs.block_copy", _fd.paged_block_copy_cost,
        _fd.paged_block_copy_leaves_shape, _fd.paged_block_copy_leaves_ref,
        _fd.paged_block_copy_leaves_cuda, leaves[0], leaves, src, dst)


def qlora_matmul(x, w_nf4, absmax, lora_a, lora_b, lora_scale):
    """``y = x . dequant_nf4(Wq) + s . (x . A) . B`` with f32 products, in
    x's type; see ``repro_torch.kernels.qlora_matmul`` for the layouts.
    Raises ``ValueError`` on an absmax that is not (K, N/qblock)."""
    return run_kernel("obs.qlora_matmul", _qm.qlora_matmul_cost,
                      _qm.qlora_matmul_shape, _qm.qlora_matmul_ref,
                      _qm.qlora_matmul_cuda, x, x, w_nf4, absmax, lora_a,
                      lora_b, lora_scale)


def flash_attention(q, k, v, *, causal: bool = True):
    """Causal or full attention over q, k, v (B, H, S, D), f32 softmax."""
    return run_kernel("obs.flash_attention", _fa.flash_attention_cost,
                      _fa.flash_attention_shape, _fa.flash_attention_ref,
                      _fa.flash_attention_cuda, q, q, k, v, causal)


def rmsnorm(x, scale, *, eps: float = 1e-6):
    """RMSNorm of x (..., d) by scale (d,), f32 inside, in x's type."""
    return run_kernel("obs.rmsnorm", _rn.rmsnorm_cost, _rn.rmsnorm_shape,
                      _rn.rmsnorm_ref, _rn.rmsnorm_cuda, x, x, scale, eps)
