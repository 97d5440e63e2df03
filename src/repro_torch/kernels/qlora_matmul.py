"""Fused QLoRA matmul: ``y = x . dequant_nf4(Wq) + s . (x . A) . B``.

``qlora_matmul_cuda`` (``csrc/qlora_matmul.cu``) replaces the TPU kernel
``repro/kernels/qlora_matmul.py::qlora_matmul``; ``qlora_matmul_ref`` is
its plain PyTorch version, with the arithmetic of the reference's oracle
``repro/kernels/ref.py::qlora_matmul_ref``: NF4 dequantized to f32, every
product in f32, the result cast to x's type.  A call launches one kernel,
chosen by x's type, both on the tensor cores: for bf16 x
``qlora_mma_kernel`` (the dequantized weight as two bf16 values ``w_hi +
w_lo``, A as three, f32 sums), for f32 x ``qlora_tf32_kernel`` (3xTF32:
x, w and A each split into TF32 halves, ``lo . hi + hi . lo + hi . hi``
summed in f32).  Both keep the reference's limit
(``tests/test_torch_kernel_designs.py`` emulates both arithmetics on the
CPU).

Layouts (the reference's kernel contract): x (M, K) f32 or bf16; w_nf4 u8
(K, N/2), two codes a byte, the high nibble the even column; absmax f32
(K, N/qblock), one scale per (row, column block), ``qblock`` read off its
shape; lora_a f32 (K, r), lora_b f32 (r, N), r <= 64; lora_scale a number.
That view of the codes holds only when N % qblock == 0.  Where
``core.lora.quantize_base`` picked a block that crosses rows, absmax cannot
be laid out so: the kernel and the plain version both refuse it
(``ValueError``), and nothing runs in its place.  M, N and K may be
ragged.

As in the reference, no model path calls this kernel: the port's ``dense``
dequantizes and leaves the product to ``torch.matmul``.
``repro_torch.kernels.ops.qlora_matmul`` dispatches to it.  ``LAUNCHES``
counts the kernel's launches, added where the wrapper launches and nowhere
else; ``qlora_matmul_launcher`` is the wrapper without its count, to time
the bare kernel.  ``qlora_matmul_shape`` is its shape rule (the checks,
then the output, with no card query: for the dry run's fake tensors) and
``qlora_matmul_cost`` its cost rule.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.core.quant import code_book, nf4_dequant
from repro_torch.kernels.build import library
from repro_torch.obs.cost import on_card, tensor_bytes

LAUNCHES: Dict[str, int] = {"qlora_matmul": 0}

_MAX_RANK = 64


def reset_launches() -> None:
    LAUNCHES["qlora_matmul"] = 0


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"qlora_matmul: {msg}")


def _shapes(x, w_nf4, absmax, lora_a, lora_b):
    """(M, N, K, r, qblock) of a call in the kernel's layout; raises
    ``ValueError`` on any other, a cross-row absmax among them."""
    _require(x.ndim == 2 and x.numel() > 0, "x must be a non-empty (M, K)")
    M, K = x.shape
    _require(w_nf4.ndim == 2 and w_nf4.shape[0] == K and w_nf4.shape[1] > 0,
             f"w_nf4 must be ({K}, N/2)")
    N = 2 * w_nf4.shape[1]
    _require(absmax.ndim == 2 and absmax.shape[0] == K
             and absmax.shape[1] > 0 and N % absmax.shape[1] == 0,
             f"absmax must be (K, N/qblock) = ({K}, {N}/qblock), one scale "
             f"per row and column block; got {tuple(absmax.shape)} (a block "
             f"that crosses rows has no such layout)")
    r = lora_a.shape[-1]
    _require(lora_a.shape == (K, r) and 1 <= r <= _MAX_RANK,
             f"lora_a must be ({K}, r), 1 <= r <= {_MAX_RANK}")
    _require(lora_b.shape == (r, N), f"lora_b must be ({r}, {N})")
    return M, N, K, r, N // absmax.shape[1]


def qlora_matmul_ref(x, w_nf4, absmax, lora_a, lora_b, lora_scale):
    """The plain version: x (M, K) -> (M, N) in x's type; layouts as in the
    module docstring, and refused as the kernel refuses them."""
    _shapes(x, w_nf4, absmax, lora_a, lora_b)
    w = nf4_dequant(w_nf4, absmax.reshape(-1))
    x32 = x.float()
    lora = (x32 @ lora_a.float()) @ lora_b.float()
    return (x32 @ w + float(lora_scale) * lora).to(x.dtype)


def _lib():
    fn = library("qlora_matmul").qm_qlora_matmul
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, I, P, P, P, P, P, P, I, I, I, I, I, ctypes.c_float,
                       I, P]
        fn.restype = I
    return fn


def _check(x, w_nf4, absmax, lora_a, lora_b):
    """The kernel's argument checks (no card needed); ``_shapes``' tuple."""
    _require(on_card(x), "x must be a CUDA tensor")
    M, N, K, r, qblock = _shapes(x, w_nf4, absmax, lora_a, lora_b)
    _require(x.dtype in (torch.float32, torch.bfloat16), "x must be f32/bf16")
    _require(w_nf4.dtype == torch.uint8, "w_nf4 must be u8")
    _require(all(t.dtype == torch.float32 for t in (absmax, lora_a, lora_b)),
             "absmax, lora_a and lora_b must be f32")
    for t in (w_nf4, absmax, lora_a, lora_b):
        _require(t.device == x.device, "all tensors on x's device")
    for t in (x, w_nf4, absmax, lora_a, lora_b):
        _require(t.is_contiguous(), "tensors must be contiguous")
    return M, N, K, r, qblock


def qlora_matmul_shape(x, w_nf4, absmax, lora_a, lora_b, lora_scale):
    """The shape rule: the kernel's checks, then its (M, N) output in x's
    type, unwritten."""
    del lora_scale
    M, N, _, _, _ = _check(x, w_nf4, absmax, lora_a, lora_b)
    return torch.empty((M, N), dtype=x.dtype, device=x.device)


def qlora_matmul_cost(x, w_nf4, absmax, lora_a, lora_b, lora_scale):
    """``(flops, bytes)`` of one call: the three products, 2 M K N + 2 M K r
    + 2 M r N; every input read once and y written once."""
    del lora_scale
    (M, K), r, N = x.shape, lora_a.shape[-1], 2 * w_nf4.shape[-1]
    y = M * N * x.element_size()
    return (2 * M * K * N + 2 * M * K * r + 2 * M * r * N,
            tensor_bytes((x, w_nf4, absmax, lora_a, lora_b)) + y)


def qlora_matmul_launcher(x, w_nf4, absmax, lora_a, lora_b, lora_scale):
    """Check the arguments and allocate the output.

    Returns ``(launch, y)``: ``launch()`` runs the kernel on the current
    stream into ``y``, raises when the launch fails, and counts nothing.
    ``lora_scale`` goes to the kernel by value (a tensor is read once,
    here).  Raises on a device, type, shape or layout the kernel does not
    take."""
    _require(x.is_cuda, "x must be a CUDA tensor")
    M, N, K, r, qblock = _check(x, w_nf4, absmax, lora_a, lora_b)
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    code = code_book(x.device)
    xvec = int(K % (16 // x.element_size()) == 0 and x.data_ptr() % 16 == 0)
    fn = _lib()
    args = (x.data_ptr(), int(x.dtype == torch.bfloat16), w_nf4.data_ptr(),
            absmax.data_ptr(), lora_a.data_ptr(), lora_b.data_ptr(),
            code.data_ptr(), y.data_ptr(), M, N, K, r, qblock,
            float(lora_scale), xvec)

    def launch():
        rc = fn(*args, torch.cuda.current_stream(x.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"qlora_matmul kernel launch failed (code "
                               f"{rc})")

    # the tensors behind the pointers, outputs included, live as long as
    # the launcher
    launch.tensors = (x, w_nf4, absmax, lora_a, lora_b, code, y)
    return launch, y


def qlora_matmul_cuda(x, w_nf4, absmax, lora_a, lora_b, lora_scale):
    """The CUDA kernel; same arguments and result as ``qlora_matmul_ref``."""
    launch, y = qlora_matmul_launcher(x, w_nf4, absmax, lora_a, lora_b,
                                      lora_scale)
    launch()
    LAUNCHES["qlora_matmul"] += 1
    return y
