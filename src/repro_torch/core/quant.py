"""NF4 (4-bit NormalFloat) blockwise quantization — QLoRA's weight format
(Dettmers et al. 2023).

The port's copy of the reference's codes and layout: two codes packed per
byte along the output dim, ``w_nf4`` uint8 (..., in, out // 2), and one f32
absmax per ``qblock`` values of the row-major flattened weight.  Codes
equal the reference's bit for bit: the nearest code book entry, ties to the
first (``torch.argmin``, as ``jnp.argmin``).
"""

from __future__ import annotations

import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensor

# bitsandbytes NF4 code book (quantiles of N(0,1), normalized to [-1, 1])
NF4_CODE = np.array([
    -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
    -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
    0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
    0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
    0.7229568362236023, 1.0], dtype=np.float32)


# The code book on each device it is used on, copied there once: a copy
# from host memory on every call would synchronise the stream.
_CODES = {}


def code_book(device) -> torch.Tensor:
    code = _CODES.get(device)
    if code is None:
        code = torch.from_numpy(NF4_CODE).to(device)
        # under a fake mode (the dry run) the copy is a fake, which must
        # not stand in for the real book after the mode is left
        if not isinstance(code, FakeTensor):
            _CODES[device] = code
    return code


def nf4_quantize(w: torch.Tensor, qblock: int = 64):
    """w: (..., in, out) float -> (w_nf4 uint8 (..., in, out // 2), absmax
    f32 (..., n_blocks)).  Holds a (n, 16) f32 distance tensor: quantize a
    full-width stack one layer at a time (``core.lora.quantize_base`` does)."""
    *lead, din, dout = w.shape
    n = din * dout
    if dout % 2 or n % qblock:
        raise ValueError(f"nf4_quantize: out {dout} must be even and "
                         f"in*out {n} a multiple of qblock {qblock}")
    flat = w.float().reshape(*lead, n // qblock, qblock)
    absmax = flat.abs().amax(dim=-1)
    scaled = flat / torch.clamp(absmax[..., None], min=1e-12)
    idx = torch.argmin((scaled[..., None] - code_book(w.device)).abs(),
                       dim=-1)
    idx = idx.to(torch.uint8).reshape(*lead, din, dout)
    packed = (idx[..., 0::2] << 4) | idx[..., 1::2]
    return packed, absmax


def nf4_dequant(w_nf4: torch.Tensor, absmax: torch.Tensor) -> torch.Tensor:
    """Inverse of ``nf4_quantize`` -> float32 (..., in, out)."""
    *lead, din, half = w_nf4.shape
    dout = half * 2
    nb = absmax.shape[-1]
    qblock = (din * dout) // nb
    idx = torch.stack([w_nf4 >> 4, w_nf4 & 0xF], dim=-1).long()
    vals = code_book(w_nf4.device)[idx].reshape(*lead, nb, qblock)
    return (vals * absmax[..., None]).reshape(*lead, din, dout)


def quant_error(w: torch.Tensor, qblock: int = 64) -> float:
    """Relative L2 round-trip error (used by tests/benchmarks)."""
    q, a = nf4_quantize(w, qblock)
    wd = nf4_dequant(q, a)
    return float(torch.linalg.norm(wd - w) /
                 torch.clamp(torch.linalg.norm(w), min=1e-12))


def nbytes_nf4(w_shape, qblock: int = 64) -> int:
    n = int(np.prod(w_shape))
    return n // 2 + (n // qblock) * 4
