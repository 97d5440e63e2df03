"""RMSNorm over the last axis, f32 inside, cast back to the input type.

``rmsnorm_cuda`` (``csrc/rmsnorm.cu``) replaces the TPU kernel
``repro/kernels/rmsnorm.py::rmsnorm``; ``rmsnorm_ref`` is its plain PyTorch
version, with the arithmetic of the reference's oracle
``repro/kernels/ref.py::rmsnorm_ref``.  Any leading shape; the rows are not
padded to a tile.  The kernel is bound by bytes on the H100 (its source says
how it meets that).

As in the reference, no model path calls this kernel: the port's norms
(``models/layers/norms.py``) are plain PyTorch.  ``repro_torch.kernels.ops.
rmsnorm`` dispatches to it.  ``LAUNCHES`` counts the kernel's launches,
added where the wrapper launches and nowhere else; ``rmsnorm_launcher`` is
the wrapper without its count, to time the bare kernel.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels.build import library

LAUNCHES: Dict[str, int] = {"rmsnorm": 0}

_TYPES = (torch.float32, torch.bfloat16)
_MAX_CHUNKS = 16 * 256          # 16-byte chunks a row: csrc/rmsnorm.cu


def reset_launches() -> None:
    LAUNCHES["rmsnorm"] = 0


def rmsnorm_ref(x, scale, eps: float = 1e-6):
    """The plain version: x (..., d), scale (d,) -> x's shape and type."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * (var + eps) ** -0.5 * scale.float()).to(x.dtype)


def _lib():
    fn = library("rmsnorm").rn_rmsnorm
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, I, P, I, P, ctypes.c_longlong, I, ctypes.c_float,
                       I, P]
        fn.restype = I
    return fn


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"rmsnorm kernel: {msg}")


def rmsnorm_launcher(x, scale, eps: float = 1e-6):
    """Check the arguments and allocate the output.

    Returns ``(launch, y)``: ``launch()`` runs the kernel on the current
    stream into ``y``, raises when the launch fails, and counts nothing.
    Raises on a device, type or shape the kernel does not take."""
    _require(x.is_cuda, "x must be a CUDA tensor")
    _require(x.dtype in _TYPES and scale.dtype in _TYPES,
             "x and scale must be f32 or bf16")
    _require(x.ndim >= 1 and x.numel() > 0, "x must be a non-empty (..., d)")
    d = x.shape[-1]
    _require(scale.shape == (d,), f"scale must be ({d},)")
    per_chunk = 16 // x.element_size()
    _require(-(-d // per_chunk) <= _MAX_CHUNKS,
             f"d must be at most {_MAX_CHUNKS * per_chunk}")
    _require(scale.device == x.device, "scale on x's device")
    _require(x.is_contiguous() and scale.is_contiguous(),
             "x and scale must be contiguous")
    y = torch.empty_like(x)
    vec = int(d % per_chunk == 0 and x.data_ptr() % 16 == 0)
    fn = _lib()
    args = (x.data_ptr(), int(x.dtype == torch.bfloat16), scale.data_ptr(),
            int(scale.dtype == torch.bfloat16), y.data_ptr(),
            x.numel() // d, d, float(eps), vec)

    def launch():
        rc = fn(*args, torch.cuda.current_stream(x.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"rmsnorm kernel launch failed (code {rc})")

    # the tensors behind the pointers, outputs included, live as long as
    # the launcher
    launch.tensors = (x, scale, y)
    return launch, y


def rmsnorm_cuda(x, scale, eps: float = 1e-6):
    """The CUDA kernel; same arguments and result as ``rmsnorm_ref``."""
    launch, y = rmsnorm_launcher(x, scale, eps)
    launch()
    LAUNCHES["rmsnorm"] += 1
    return y
