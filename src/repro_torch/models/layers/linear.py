"""Linear projection.

The reference's ``dense`` also dispatches LoRA (``lora_a``/``lora_b``) and
NF4-quantized (``w_nf4``/``absmax``) weights; those belong to the
fine-tuning slice of the port.  Here only the plain ``{"w"}`` form runs,
with ``w`` stored (in, out) so that ``x @ w`` is the reference's product.
"""

from __future__ import annotations

import torch

_LATER = ("w_nf4", "absmax", "lora_a", "lora_b", "lora_scale")


def init_dense(generator: torch.Generator, in_dim: int, out_dim: int, *,
               layers: int = 0, dtype=torch.float32, device=None,
               scale: float | None = None):
    """Normal(0, in_dim^-1/2) weight; ``layers`` > 0 stacks a leading layer
    axis."""
    if scale is None:
        scale = in_dim ** -0.5
    shape = (layers, in_dim, out_dim) if layers else (in_dim, out_dim)
    w = torch.randn(shape, generator=generator, device=device) * scale
    return {"w": w.to(dtype)}


def dense(p, x: torch.Tensor) -> torch.Tensor:
    """Apply the linear map ``x @ w`` in ``x``'s dtype."""
    later = [k for k in _LATER if k in p]
    if later:
        raise NotImplementedError(
            f"dense: {later} (LoRA / QLoRA) are not ported yet")
    return x @ p["w"].to(x.dtype)
