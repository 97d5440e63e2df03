"""RMSNorm over the last axis, f32 inside, cast back to the input type.

``rmsnorm_cuda`` (``csrc/rmsnorm.cu``) replaces the TPU kernel
``repro/kernels/rmsnorm.py::rmsnorm``; ``rmsnorm_ref`` is its plain PyTorch
version, with the arithmetic of the reference's oracle
``repro/kernels/ref.py::rmsnorm_ref``.  Any leading shape; the rows are not
padded to a tile.  The kernel is bound by bytes on the H100, and at small
shapes by latency (its source says how it meets both);
``rmsnorm_layout`` picks how its grid covers the card.

As in the reference, no model path calls this kernel: the port's norms
(``models/layers/norms.py``) are plain PyTorch.  ``repro_torch.kernels.ops.
rmsnorm`` dispatches to it.  ``LAUNCHES`` counts the kernel's launches,
added where the wrapper launches and nowhere else; ``rmsnorm_launcher`` is
the wrapper without its count, to time the bare kernel.  ``rmsnorm_shape``
is its shape rule (the checks, then the output, with no card query: for
the dry run's fake tensors) and ``rmsnorm_cost`` its cost rule (no
products; x and scale read once, y written once).
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple

import torch

from repro_torch.kernels.build import library
from repro_torch.obs.cost import on_card, tensor_bytes

LAUNCHES: Dict[str, int] = {"rmsnorm": 0}

_TYPES = (torch.float32, torch.bfloat16)
# csrc/rmsnorm.cu: at most 512 threads a block, 4 chunks a thread, 2
# blocks a row
_MAX_THREADS, _MAX_NV = 512, 4
_MAX_CHUNKS = _MAX_THREADS * _MAX_NV * 2   # 16-byte chunks a row
_SMS: Dict[int, int] = {}                  # device index -> SM count


class Layout(NamedTuple):
    """How a launch covers the rows: ``tpr`` threads a row in a block,
    ``rpb`` rows a block, ``cl`` blocks a row (a thread-block cluster) and
    ``nv`` 16-byte chunks a thread."""
    tpr: int
    rpb: int
    cl: int
    nv: int


def _pow2_at_least(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def rmsnorm_layout(rows: int, d: int, itemsize: int, sms: int) -> Layout:
    """The kernel's layout for ``rows`` rows of ``d`` values of
    ``itemsize`` bytes on a card of ``sms`` SMs.

    Chosen by measurement on the H100 (``tools/rmsnorm_layouts.py``,
    ``PERF.md`` §6): a row is one block's work, at most 2 of its
    16-byte chunks a thread up to 256 threads, then up to 4 a thread; a
    row too long for one block of 512 threads is split over a cluster of 2.
    Splitting a row over a cluster only to cover the card (rows fewer than
    SMs) measured slower than one block a row: the cluster barriers cost
    more than the idle SMs.  Blocks take several rows only where the rows
    are many (at least 4 blocks an SM), up to 256 threads."""
    chunks = -(-d * itemsize // 16)
    tpr = min(max(_pow2_at_least(-(-chunks // 2)), 32), 256)
    if chunks > 4 * tpr:
        tpr = _MAX_THREADS
    nv = _pow2_at_least(-(-chunks // tpr))
    cl = max(nv // _MAX_NV, 1)
    nv //= cl
    rpb = 1
    while tpr * rpb * 2 <= 256 and -(-rows // (rpb * 2)) >= 4 * sms:
        rpb *= 2
    return Layout(tpr, rpb, cl, nv)


def _sm_count(device) -> int:
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


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
                       I, I, I, I, I, P]
        fn.restype = I
    return fn


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"rmsnorm kernel: {msg}")


def _check(x, scale) -> int:
    """The kernel's argument checks (no card needed); returns d."""
    _require(on_card(x), "x must be a CUDA tensor")
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
    return d


def rmsnorm_shape(x, scale, eps: float = 1e-6):
    """The shape rule: the kernel's checks, then its output, unwritten."""
    del eps
    _check(x, scale)
    return torch.empty_like(x)


def rmsnorm_cost(x, scale, eps: float = 1e-6):
    """``(flops, bytes)`` of one call: no products; x and scale read once,
    y written once."""
    del eps
    return 0, 2 * tensor_bytes(x) + tensor_bytes(scale)


def rmsnorm_launcher(x, scale, eps: float = 1e-6, layout: Layout = None):
    """Check the arguments and allocate the output.

    Returns ``(launch, y)``: ``launch()`` runs the kernel on the current
    stream into ``y``, raises when the launch fails, and counts nothing.
    Raises on a device, type or shape the kernel does not take.
    ``layout`` overrides ``rmsnorm_layout``'s choice (to time others)."""
    _require(x.is_cuda, "x must be a CUDA tensor")
    d = _check(x, scale)
    per_chunk = 16 // x.element_size()
    y = torch.empty_like(x)
    rows = x.numel() // d
    lay = layout or rmsnorm_layout(rows, d, x.element_size(),
                                   _sm_count(x.device))
    _require(lay.tpr * lay.rpb <= _MAX_THREADS and lay.tpr % 32 == 0
             and lay.cl in (1, 2, 4) and lay.nv in (1, 2, 4)
             and lay.nv * lay.tpr * lay.cl * per_chunk >= d,
             f"layout {lay} does not cover d {d}")
    # a thread's scale values for one chunk of x are read as one vector
    vec = int(d % per_chunk == 0 and x.data_ptr() % 16 == 0
              and scale.data_ptr() % (per_chunk * scale.element_size()) == 0)
    fn = _lib()
    args = (x.data_ptr(), int(x.dtype == torch.bfloat16), scale.data_ptr(),
            int(scale.dtype == torch.bfloat16), y.data_ptr(), rows, d,
            float(eps), vec, *lay)

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
