"""Virtual time for the serving engine's SLO clock.

Request deadlines and first-token SLOs can be measured on this clock
instead of the wall clock: the engine advances it by a fixed step a tick,
so a chaos trace with deadlines runs without ``time.sleep`` and its
timeline is exactly reproducible.
"""

from __future__ import annotations

__all__ = ["VirtualClock"]


class VirtualClock:
    """Monotonic virtual clock.  ``now()`` is seconds since the start of
    the simulation; ``advance``/``advance_to`` move it forward (never
    backward — a deadline that already passed costs nothing extra).
    """

    def __init__(self, start: float = 0.0):
        self._t = float(start)

    def now(self) -> float:
        return self._t

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"cannot advance virtual clock by {dt} < 0")
        self._t += dt
        return self._t

    def advance_to(self, t: float) -> float:
        """Move to ``t`` if it is in the future; no-op otherwise."""
        self._t = max(self._t, float(t))
        return self._t

    def __repr__(self) -> str:                # pragma: no cover - cosmetic
        return f"VirtualClock(t={self._t:.3f}s)"
