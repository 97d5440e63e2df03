"""Device-memory watermarks on the card's caching allocator, and the
per-scope cost attribution of a step.

:func:`memory_snapshot` reads ``torch.cuda.memory_stats`` (bytes held by
live tensors now and at peak, the allocations behind them) and the card's
total memory; :func:`watermark` samples a snapshot onto the tracer as a
``devmem`` counter track plus gauges, and the serving engine calls it at
sampled decode steps.  :func:`peak_bytes` is the allocator's peak.  None
of it synchronizes the card: the allocator keeps its counts on the host.

Where there is no card (a CPU run) every number is 0: PyTorch keeps no
allocator statistics for host tensors.

**Which scope is the cost?**  The reference stamps ``jax.named_scope(
"obs.*")`` around every kernel dispatch and ring hop and re-parses the
compiled HLO to bucket its costs by scope.  The port marks the same
places with ``obs.cost.scope(name)``, and the cost counter
(``obs.cost.CostCounter``) files each op it counts under the innermost
open name: ``scope_costs`` reads those buckets, and
``compiled_scope_costs`` runs a step once under a counter (the port
compiles nothing, so "compiled" is the reference's name only).
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.obs.cost import CostCounter

__all__ = ["memory_snapshot", "peak_bytes", "watermark", "scope_costs",
           "compiled_scope_costs"]


def _cuda_index(device):
    """The CUDA device index ``device`` names, or None for no card."""
    if device is None:
        return (torch.cuda.current_device() if torch.cuda.is_available()
                else None)
    dev = torch.device(device) if not isinstance(device, int) else \
        torch.device("cuda", device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None
    return dev.index if dev.index is not None else \
        torch.cuda.current_device()


def memory_snapshot(device=None) -> Dict[str, int]:
    """Memory stats of one card (default: the current one).

    Returns ``{"bytes_in_use", "peak_bytes_in_use", "bytes_limit",
    "live_buffer_bytes", "live_buffers"}``: bytes allocated to tensors now
    and at the allocator's peak (since the last
    ``torch.cuda.reset_peak_memory_stats``), the card's total memory, and
    the live allocations' bytes and count.  Zeros without a card."""
    out = {"bytes_in_use": 0, "peak_bytes_in_use": 0, "bytes_limit": 0,
           "live_buffer_bytes": 0, "live_buffers": 0}
    idx = _cuda_index(device)
    if idx is None:
        return out
    stats = torch.cuda.memory_stats(idx)
    out["bytes_in_use"] = int(stats.get("allocated_bytes.all.current", 0))
    out["peak_bytes_in_use"] = int(stats.get("allocated_bytes.all.peak", 0))
    out["bytes_limit"] = int(torch.cuda.get_device_properties(idx)
                             .total_memory)
    out["live_buffer_bytes"] = out["bytes_in_use"]
    out["live_buffers"] = int(stats.get("allocation.all.current", 0))
    return out


def peak_bytes(device=None) -> int:
    """The allocator's peak bytes on the card (0 without one)."""
    idx = _cuda_index(device)
    return int(torch.cuda.max_memory_allocated(idx)) if idx is not None \
        else 0


def watermark(tag: str, device=None) -> Dict[str, int]:
    """Sample a snapshot onto the tracer: one ``devmem`` counter-track
    point plus ``devmem.<tag>.*`` gauges.  Returns the snapshot so call
    sites can also log it."""
    from repro_torch import obs

    snap = memory_snapshot(device)
    in_use = snap["bytes_in_use"] or snap["live_buffer_bytes"]
    obs.counter_track("devmem", bytes_in_use=in_use,
                      live_buffers=snap["live_buffers"])
    obs.gauge(f"devmem.{tag}.bytes_in_use", float(in_use))
    if snap["peak_bytes_in_use"]:
        obs.gauge(f"devmem.{tag}.peak_bytes", float(snap["peak_bytes_in_use"]))
    return snap


# -- per-scope cost attribution ----------------------------------------------

def scope_costs(counter) -> Dict[str, Dict[str, float]]:
    """``{scope: {"flops", "bytes", "ops"}}`` of a counter's record
    (``obs.cost.CostCounter``): each op's FLOPs and
    bytes under the innermost ``obs.*`` scope open when it ran, a kernel at
    its own cost rule under its own scope, the rest under
    ``obs.cost.UNSCOPED``."""
    return {k: dict(v) for k, v in counter.scopes.items()}


def compiled_scope_costs(step, *args,
                         **kwargs) -> Dict[str, Dict[str, float]]:
    """The scope costs of one call ``step(*args, **kwargs)``, run under a
    fresh counter (on fake tensors it costs no device work).  The
    reference reads them from a compiled step's HLO; the port compiles
    nothing, so it runs the step.  The call's result is dropped."""
    with CostCounter() as counter:
        step(*args, **kwargs)
    return scope_costs(counter)
