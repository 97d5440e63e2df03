"""Linear projection with LoRA / QLoRA.

The parameter dict ``p`` dispatches the math, as the reference's ``dense``:

  {"w"}                                   -> x @ w
  {"w", "lora_a", "lora_b", "lora_scale"} -> x @ w + s * (x @ A) @ B   (LoRA)
  {"w_nf4", "absmax", ...}                -> x @ dequant(W) [+ LoRA]   (QLoRA)

``w`` is stored (in, out).  A quantized base is dequantized to f32 and cast
to ``x``'s dtype, and the product is left to ``torch.matmul``, as the
reference leaves it to XLA: no path of the reference runs its
``qlora_matmul`` kernel.  NF4 layout: see ``repro_torch.core.quant``.
"""

from __future__ import annotations

import torch

from repro_torch.core.quant import nf4_dequant


def draw_normal(generator: torch.Generator, shape, scale: float, *,
                dtype=torch.float32, device=None,
                stacked: bool = False) -> torch.Tensor:
    """Normal(0, ``scale``) values of ``dtype``, drawn in f32 from
    ``generator``.  A ``stacked`` leaf (a leading layer axis) is filled one
    layer slice at a time into a tensor of ``dtype``, so the f32 draw never
    holds more than one slice: a whole-leaf draw of gemma2-27b's MLP
    (23 x 4608 x 36864) would take 31 GB of f32 beside its 7.8 GB."""
    out = torch.empty(shape, dtype=dtype, device=device)
    for piece in (out if stacked else out[None]):
        draw = torch.randn(piece.shape, generator=generator, device=device)
        piece.copy_(draw.mul_(scale))
        del draw
    return out


def init_dense(generator: torch.Generator, in_dim: int, out_dim: int, *,
               layers: int = 0, dtype=torch.float32, device=None,
               scale: float | None = None):
    """Normal(0, in_dim^-1/2) weight; ``layers`` > 0 stacks a leading layer
    axis (drawn a layer at a time, ``draw_normal``)."""
    if scale is None:
        scale = in_dim ** -0.5
    shape = (layers, in_dim, out_dim) if layers else (in_dim, out_dim)
    return {"w": draw_normal(generator, shape, scale, dtype=dtype,
                             device=device, stacked=bool(layers))}


def dense(p, x: torch.Tensor) -> torch.Tensor:
    """Apply a (possibly LoRA-adapted, possibly NF4-quantized) linear map in
    ``x``'s dtype."""
    if "w_nf4" in p:
        w = nf4_dequant(p["w_nf4"], p["absmax"]).to(x.dtype)
    else:
        w = p["w"].to(x.dtype)
    y = x @ w
    if "lora_a" in p:
        a = p["lora_a"].to(x.dtype)
        b = p["lora_b"].to(x.dtype)
        y = y + (x @ a) @ b * p["lora_scale"].to(x.dtype)
    return y
