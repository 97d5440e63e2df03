"""The step cost model's totals: FLOPs, bytes, collectives and live memory
of what one rank dispatches (the counterpart of the reference's
``src/repro/launch/hlo_cost.py``, under its name so that a reader finds
it).

The reference parses a compiled step's HLO.  The port compiles nothing,
so it counts dispatched aten ops, not HLO: the counter is
``repro_torch.obs.cost.CostCounter`` (what it counts, and how kernels and
collectives report to it, is in that module's docstring).  ``count`` runs
one call under a fresh counter and ``analyze`` reads the reference's keys
off its record, one rank's numbers.
"""

from __future__ import annotations

from repro_torch.obs.cost import CostCounter


def analyze(counter: CostCounter) -> dict:
    """The reference's ``analyze`` keys from a counter's record, one rank's
    numbers, plus ``peak_bytes`` (the live-bytes high-water mark)."""
    tot = counter.totals()
    return {
        "flops_per_device": tot["flops"],
        "bytes_per_device": tot["bytes"],
        "collective_bytes": dict(counter.collective_bytes),
        "collective_counts": dict(counter.collective_counts),
        "collective_total_bytes": sum(counter.collective_bytes.values()),
        "ops": tot["ops"],
        "peak_bytes": counter.peak_bytes,
    }


def count(fn, *args, **kwargs):
    """``(fn(*args, **kwargs), its counter)``: one call under a fresh
    ``CostCounter``."""
    with CostCounter() as c:
        out = fn(*args, **kwargs)
    return out, c
