"""Learning-rate schedules, computed in f32 tensors as the reference's jnp
code computes them, so that each value is the same f32 number.

The one transcendental, the cosine, is the C library's ``cosf``: that is
what XLA's CPU backend calls for an f32 ``jnp.cos``.  ``torch.cos`` and
numpy evaluate their own vectorised polynomials, which differ from it in
the last bit at a few percent of arguments.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools
import math

import torch


@functools.lru_cache(maxsize=None)
def _cosf():
    libm = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
    fn = libm.cosf
    fn.argtypes, fn.restype = [ctypes.c_float], ctypes.c_float
    return fn


def _cos(x: torch.Tensor) -> torch.Tensor:
    """f32 cosine of a 0-d f32 tensor by ``cosf``."""
    return torch.tensor(_cosf()(float(x)), dtype=torch.float32)


def cosine_warmup(step, *, base_lr: float, warmup: int, total: int,
                  min_frac: float = 0.1) -> torch.Tensor:
    """Linear warm-up over ``warmup`` steps, then a cosine decay to
    ``min_frac`` of ``base_lr`` at ``total``.  ``step`` is a number: the
    value is a 0-d f32 tensor on the CPU."""
    step = torch.tensor(step, dtype=torch.float32)
    warm = base_lr * torch.clamp(step / max(warmup, 1), max=1.0)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0, 1)
    pi = torch.tensor(math.pi, dtype=torch.float32)
    cos = base_lr * (min_frac + (1 - min_frac) * 0.5 * (1 + _cos(pi * prog)))
    return torch.where(step < warmup, warm, cos)


def constant(step, *, base_lr: float) -> torch.Tensor:
    del step
    return torch.tensor(base_lr, dtype=torch.float32)
