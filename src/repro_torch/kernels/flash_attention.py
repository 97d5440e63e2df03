"""Causal or full attention over (B, H, S, D) with an online softmax.

``flash_attention_cuda`` (``csrc/flash_attention.cu``) replaces the TPU
kernel ``repro/kernels/flash_attention.py::flash_attention``;
``flash_attention_ref`` is its plain PyTorch version, with the arithmetic
of the reference's oracle ``repro/kernels/ref.py::flash_attention_ref``:
f32 scores scaled by D^-0.5, the causal mask filled with the finite
``finfo(f32).min``, an f32 softmax, and ``p`` cast to v's type before the
product with v.  Both of the kernel's paths run on the tensor cores and
keep ``p`` finer than the oracle.  For f32 inputs every product is taken
as three TF32 products (each f32 operand split into two TF32 halves),
which keeps the f32 limit.  For bf16 inputs ``p`` is two bf16 values
``p_hi + p_lo`` (about 16 bits), so a bf16 output stays within half a bf16
step of the plain version run in f32.

q, k and v share one shape and one type (f32 or bf16); S may be ragged; the
kernel takes D in {64, 128} (the reference's tested head dims and the
ported models') and raises on any other.

As in the reference, no model path calls this kernel: the port's attention
is plain PyTorch.  ``repro_torch.kernels.ops.flash_attention`` dispatches to
it.  ``LAUNCHES`` counts the kernel's launches, added where the wrapper
launches and nowhere else; ``flash_attention_launcher`` is the wrapper
without its count, to time the bare kernel.  ``flash_attention_shape`` is
its shape rule (the checks, then the output, with no card query: for the
dry run's fake tensors) and ``flash_attention_cost`` its cost rule.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels.build import library
from repro_torch.obs.cost import aligned16, on_card, tensor_bytes

LAUNCHES: Dict[str, int] = {"flash_attention": 0}

_HEAD_DIMS = (64, 128)
_MAX_HEADS = 65535               # B * H: the grid's second axis


def reset_launches() -> None:
    LAUNCHES["flash_attention"] = 0


def flash_attention_ref(q, k, v, causal: bool = True):
    """The plain version: q, k, v (B, H, S, D) -> (B, H, S, D) in q's type."""
    S = q.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * (
        q.shape[-1] ** -0.5)
    if causal:
        mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, torch.finfo(torch.float32).min)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v).to(q.dtype)


def _lib():
    fn = library("flash_attention").fa_flash_attention
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, I, I, I, I, I, ctypes.c_float, P]
        fn.restype = I
    return fn


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"flash_attention kernel: {msg}")


def _check(q, k, v):
    """The kernel's argument checks (no card needed)."""
    _require(on_card(q), "q must be a CUDA tensor")
    _require(q.dtype in (torch.float32, torch.bfloat16), "q must be f32/bf16")
    _require(q.ndim == 4 and q.numel() > 0, "q must be a non-empty "
             "(B, H, S, D)")
    B, H, S, D = q.shape
    _require(D in _HEAD_DIMS, f"D must be one of {_HEAD_DIMS}, not {D}")
    _require(B * H <= _MAX_HEADS, f"B * H must be at most {_MAX_HEADS}")
    for t in (k, v):
        _require(t.shape == q.shape and t.dtype == q.dtype,
                 "k and v must have q's shape and type")
        _require(t.device == q.device, "k and v on q's device")
    for t in (q, k, v):
        _require(t.is_contiguous(), "q, k and v must be contiguous")
        _require(aligned16(t), "q, k and v must be 16B aligned")


def flash_attention_shape(q, k, v, causal: bool = True):
    """The shape rule: the kernel's checks, then its output, unwritten."""
    del causal
    _check(q, k, v)
    return torch.empty_like(q)


def flash_attention_cost(q, k, v, causal: bool = True):
    """``(flops, bytes)`` of one call: QK and PV over the (query, key)
    pairs the kernel computes (S (S + 1) / 2 under the causal mask, S^2
    without), 4 B H D pairs; q, k and v read once, o written once."""
    B, H, S, D = q.shape
    pairs = S * (S + 1) // 2 if causal else S * S
    return 4 * B * H * D * pairs, tensor_bytes((q, k, v)) + tensor_bytes(q)


def flash_attention_launcher(q, k, v, causal: bool = True):
    """Check the arguments and allocate the output.

    Returns ``(launch, o)``: ``launch()`` runs the kernel on the current
    stream into ``o``, raises when the launch fails, and counts nothing.
    Raises on a device, type, shape or layout the kernel does not take."""
    _require(q.is_cuda, "q must be a CUDA tensor")
    _check(q, k, v)
    B, H, S, D = q.shape
    o = torch.empty_like(q)
    fn = _lib()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            int(q.dtype == torch.bfloat16), B * H, S, D, int(bool(causal)),
            float(D ** -0.5))

    def launch():
        rc = fn(*args, torch.cuda.current_stream(q.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"flash_attention kernel launch failed (code "
                               f"{rc})")

    # the tensors behind the pointers, outputs included, live as long as
    # the launcher
    launch.tensors = (q, k, v, o)
    return launch, o


def flash_attention_cuda(q, k, v, causal: bool = True):
    """The CUDA kernel; same arguments and result as
    ``flash_attention_ref``."""
    launch, o = flash_attention_launcher(q, k, v, causal)
    launch()
    LAUNCHES["flash_attention"] += 1
    return o
