"""The fused wire hop of the federated upload: dequantize what was received,
accumulate in f32, requantize with error feedback.

One CUDA source (``csrc/wire_hop.cu``) holds both wires, with the plain
PyTorch version beside it:

  * ``wire="int8"`` replaces the TPU kernel
    ``repro/kernels/ring_allreduce.py::_hop_int8_kernel``: int8 codes with
    one f32 absmax scale per ``qblock`` row.
  * ``wire="bf16"`` replaces ``::_hop_bf16_kernel``: round-to-nearest-even
    bf16 codes.

Both are bound by bytes on the H100 (about 18 B per element on the int8
wire, 20 B on bf16).  The kernel's output equals the plain version's bit for
bit, and so does the reference's own host-loop path (``_hop_jnp`` as
``quantize_update`` runs it, op by op); the source says which roundings
that takes.

``fused_hop`` dispatches: a CPU tensor takes ``fused_hop_ref``, a CUDA
tensor the kernel, which launches or raises, and a fake tensor (the dry
run's) ``wire_hop_shape``, the kernel's checks and outputs with no card
query.  Under a cost counter (``repro_torch.obs.cost``) a hop counts at
``wire_hop_cost``, in the ring hop's ``obs.ring.*`` scope.  ``LAUNCHES``
counts the kernel's launches per wire, added where the wrapper launches
and nowhere else; ``wire_hop_launcher`` is the wrapper without its count,
to time the bare kernel.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from repro_torch.kernels.build import library
from repro_torch.obs.cost import aligned16, on_card, run_kernel, \
    tensor_bytes

LAUNCHES: Dict[str, int] = {"wire_hop_int8": 0, "wire_hop_bf16": 0}

_WIRES = ("int8", "bf16")
_CODE_DTYPES = {"int8": torch.int8, "bf16": torch.bfloat16}
_KERNEL_QBLOCKS = (32, 64, 128, 256, 512, 1024)
_RESIDENT_BLOCKS_PER_SM = 8            # 256-thread blocks, 2048 threads/SM


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _zero_codes(acc, *, wire: str, qblock: int):
    codes = torch.zeros(acc.shape, dtype=_CODE_DTYPES[wire],
                        device=acc.device)
    scales = (torch.zeros((acc.numel() // qblock,), dtype=torch.float32,
                          device=acc.device) if wire == "int8" else None)
    return codes, scales


def _quant_rows(t):
    """(R, Q) f32 -> (codes as f32, (R, 1) f32 absmax scales).  Both
    quotients are true divisions by a tensor: torch turns a division by a
    Python number on the card into a product with its reciprocal, which
    rounds differently."""
    amax = t.abs().amax(dim=1, keepdim=True)
    s = torch.clamp(amax / torch.full_like(amax, 127.0), min=1e-30)
    q = torch.clamp(torch.round(t / s), -127.0, 127.0)
    return q, s


def fused_hop_ref(acc, codes, scales, res, *, wire: str, qblock: int):
    """The plain version: the reference's ``_hop_jnp`` op by op.  Same
    arguments and results as ``fused_hop``."""
    if codes is None:
        codes, scales = _zero_codes(acc, wire=wire, qblock=qblock)
    if wire == "int8":
        deq = (codes.reshape(-1, qblock).float() *
               scales.reshape(-1, 1)).reshape(acc.shape)
    else:
        deq = codes.float()
    acc = acc + deq
    t = acc + res
    if wire == "int8":
        t2 = t.reshape(-1, qblock)
        q, s = _quant_rows(t2)
        return (acc, q.to(torch.int8).reshape(acc.shape), s[:, 0],
                (t2 - q * s).reshape(acc.shape))
    o = t.to(torch.bfloat16)
    return acc, o, None, t - o.float()


def dequant_chunk(codes, scales, *, wire: str, qblock: int):
    """What the receiver reads from the wire: codes (and scales) -> flat
    f32.  Plain PyTorch, as the reference's ``_dequant_chunk``."""
    if wire == "int8":
        return (codes.reshape(-1, qblock).float() *
                scales.reshape(-1, 1)).reshape(-1)
    return codes.float()


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int


def _hop_lib():
    fn = library("wire_hop").wh_wire_hop
    if fn.argtypes is None:
        fn.argtypes = [_I, _P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_longlong,
                       _I, _I, _P]
        fn.restype = _I
    return fn


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"wire_hop kernel: {msg}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _check(acc, codes, scales, res, *, wire: str, qblock: int):
    """The kernel's argument checks (no card needed): ``(rows, the input
    tensors)``."""
    _require(wire in _WIRES, f"wire must be one of {_WIRES}, not {wire!r}")
    _require(on_card(acc), "acc must be a CUDA tensor")
    dev = acc.device
    n = acc.numel()
    _require(qblock in _KERNEL_QBLOCKS,
             f"qblock must be one of {_KERNEL_QBLOCKS}")
    _require(n > 0 and n % qblock == 0, "acc must hold whole qblock rows")
    rows = n // qblock
    _require(acc.dtype == torch.float32 and res.dtype == torch.float32,
             "acc and res must be f32")
    _require(res.shape == acc.shape, "res must have acc's shape")
    int8 = wire == "int8"
    tensors = [acc, res]
    if codes is not None:
        _require(codes.dtype == _CODE_DTYPES[wire]
                 and codes.shape == acc.shape,
                 f"codes must be {_CODE_DTYPES[wire]} of acc's shape")
        tensors.append(codes)
        if int8:
            _require(scales is not None and scales.dtype == torch.float32
                     and scales.numel() == rows,
                     "the int8 wire needs one f32 scale per row")
            tensors.append(scales)
    for t in tensors:
        _require(t.device == dev, "all tensors on acc's device")
        _require(t.is_contiguous(), "tensors must be contiguous")
        _require(aligned16(t), "tensors must be 16B aligned")
    return rows, tensors


def _outputs(acc, rows: int, wire: str):
    oscales = (torch.empty((rows,), dtype=torch.float32, device=acc.device)
               if wire == "int8" else None)
    return (torch.empty_like(acc),
            torch.empty(acc.shape, dtype=_CODE_DTYPES[wire],
                        device=acc.device),
            oscales, torch.empty_like(acc))


def wire_hop_shape(acc, codes, scales, res, *, wire: str, qblock: int):
    """The shape rule: the kernel's checks, then its outputs ``(acc',
    codes', scales', res')``, unwritten."""
    rows, _ = _check(acc, codes, scales, res, wire=wire, qblock=qblock)
    return _outputs(acc, rows, wire)


def wire_hop_cost(acc, codes, scales, res, *, wire: str, qblock: int):
    """``(flops, bytes)`` of one hop: no products; every input read once,
    every output (acc', codes', scales', res') written once."""
    rows = acc.numel() // qblock
    out = (2 * tensor_bytes(acc) + acc.numel() * _CODE_DTYPES[wire].itemsize
           + (rows * 4 if wire == "int8" else 0))
    return 0, tensor_bytes((acc, codes, scales, res)) + out


def wire_hop_launcher(acc, codes, scales, res, *, wire: str, qblock: int):
    """Check the arguments and allocate the outputs.

    Returns ``(launch, (acc', codes', scales', res'))``: ``launch()`` runs
    the kernel on the current stream into those outputs, raises when the
    launch fails, and counts nothing.  ``codes=None`` is the quantize-only
    form.  Raises on a device, type, shape or layout the kernel does not
    take."""
    _require(acc.is_cuda, "acc must be a CUDA tensor")
    rows, tensors = _check(acc, codes, scales, res, wire=wire,
                           qblock=qblock)
    dev, int8 = acc.device, wire == "int8"
    oacc, ocodes, oscales, ores = _outputs(acc, rows, wire)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    grid = min(-(-rows // 8), sms * _RESIDENT_BLOCKS_PER_SM)
    fn = _hop_lib()
    args = (int(int8), acc.data_ptr(), _ptr(codes),
            _ptr(scales) if codes is not None else None, res.data_ptr(),
            oacc.data_ptr(), ocodes.data_ptr(), _ptr(oscales),
            ores.data_ptr(), rows, qblock, grid)

    def launch():
        rc = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"wire_hop kernel launch failed (code {rc})")

    # the tensors behind the pointers, outputs included, live as long as
    # the launcher
    launch.tensors = (*tensors, oacc, ocodes, oscales, ores)
    return launch, (oacc, ocodes, oscales, ores)


def fused_hop_cuda(acc, codes, scales, res, *, wire: str, qblock: int):
    """The CUDA kernel; same arguments and results as ``fused_hop``."""
    launch, outs = wire_hop_launcher(acc, codes, scales, res, wire=wire,
                                     qblock=qblock)
    launch()
    LAUNCHES[f"wire_hop_{wire}"] += 1
    return outs


def fused_hop(acc, codes, scales, res, *, wire: str, qblock: int):
    """deq(recv) + accumulate + error-feedback requant, one fused step.

    acc/res: (c,) f32 master chunk and its residual; codes: (c,) received
    chunk in the wire's type (int8 or bf16); scales: (c // qblock,) f32
    absmax scales (int8 wire only, else None).  Returns (new_acc,
    send_codes, send_scales, new_res); ``codes=None`` is the quantize-only
    form (nothing received yet: encode the local value)."""
    return run_kernel(None, wire_hop_cost, wire_hop_shape, fused_hop_ref,
                      fused_hop_cuda, acc, acc, codes, scales, res,
                      wire=wire, qblock=qblock)
