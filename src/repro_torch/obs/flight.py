"""Crash-dump flight recorder: the last N events, always, for ~nothing.

Production serving debugging has a chicken-and-egg problem: the full
tracer is off (``REPRO_TRACE=0``) precisely in the long-running deployments
where a park-storm, an eviction cascade, or a crash most needs a timeline.
The flight recorder closes it: a fixed-size ring buffer that passively
retains the most recent span/instant/counter events *even when the tracer
is disabled*, at the cost of one tuple append per event (no dict build, no
lock, no JSON until a dump is actually requested).

Dump triggers (all no-ops unless ``REPRO_FLIGHT_OUT=<path>.json`` names a
destination):

  * **atexit** — the tail of every run survives as a post-mortem.
  * **unhandled exception** — a chaining ``sys.excepthook`` writes the
    dump *before* the traceback prints, with the exception in
    ``metadata.reason``.
  * **engine distress** — ``serve/engine.py`` calls :func:`maybe_dump` on
    quarantine, on livelock-breaking displacement (park-storm victim
    selection) and on recompute eviction, so the steps leading up to the
    fault are on disk the moment it happens.

The dump is ordinary Chrome trace-event JSON (same schema as
``Tracer.dump`` — Perfetto opens it directly) with
``metadata.flight_recorder`` describing capacity/retained/dropped counts.

Knobs: ``REPRO_FLIGHT=0`` disables recording entirely (restores the pure
no-op disabled-tracer path); ``REPRO_FLIGHT_CAP`` sizes the ring (default
4096 events); ``REPRO_FLIGHT_OUT`` arms the auto-dump triggers.
"""

from __future__ import annotations

import atexit
import json
import os
import sys
import threading
import time
from collections import deque
from typing import Optional

__all__ = ["FlightRecorder", "get_flight", "flight_enabled", "maybe_dump"]


def flight_enabled() -> bool:
    """Recording is on by default (read per call like every REPRO_ flag);
    ``REPRO_FLIGHT=0`` disables it."""
    return os.environ.get("REPRO_FLIGHT", "1") != "0"


def _flight_cap() -> int:
    return int(os.environ.get("REPRO_FLIGHT_CAP", "4096"))


class FlightRecorder:
    """Fixed-size ring of compact event tuples; see module docstring.

    Events are ``(ph, name, cat, t0, dur, track, args)`` with ``t0`` a raw
    ``time.perf_counter()`` stamp — conversion to Chrome-trace microseconds
    and track→tid allocation happen only at dump time, so steady-state cost
    is one deque append (appends are GIL-atomic; no lock taken)."""

    def __init__(self, capacity: int = 0):
        self.capacity = capacity or _flight_cap()
        self._buf: deque = deque(maxlen=self.capacity)
        self._epoch = time.perf_counter()
        self.recorded = 0                     # total ever, incl. overwritten

    def record(self, ph: str, name: str, cat: str, t0: float,
               dur: float = 0.0, track: Optional[str] = None,
               args: Optional[dict] = None) -> None:
        self._buf.append((ph, name, cat, t0, dur, track, args))
        self.recorded += 1

    def __len__(self) -> int:
        return len(self._buf)

    def reset(self) -> None:
        self._buf.clear()
        self.recorded = 0
        self._epoch = time.perf_counter()

    # -- export --------------------------------------------------------------

    def to_chrome_trace(self, reason: str = "") -> dict:
        """Build the Chrome trace-event document from the retained tail.
        Thread names come from the recorded virtual tracks (``None`` events
        land on tid 1, "flight")."""
        events = list(self._buf)              # snapshot (GIL-atomic copy)
        tids = {None: 1}
        out = [{"name": "thread_name", "ph": "M", "pid": 0, "tid": 1,
                "args": {"name": "flight"}}]
        for ph, name, cat, t0, dur, track, args in events:
            tid = tids.get(track)
            if tid is None:
                tid = tids[track] = len(tids) + 1
                out.append({"name": "thread_name", "ph": "M", "pid": 0,
                            "tid": tid, "args": {"name": track}})
            ev = {"name": name, "cat": cat or "repro", "ph": ph,
                  "ts": (t0 - self._epoch) * 1e6, "pid": 0, "tid": tid,
                  "args": args or {}}
            if ph == "X":
                ev["dur"] = max(dur * 1e6, 0.0)
            elif ph == "i":
                ev["s"] = "t"
            out.append(ev)
        return {
            "traceEvents": out,
            "displayTimeUnit": "ms",
            "metadata": {
                "tool": "repro_torch.obs.flight",
                "flight_recorder": {
                    "capacity": self.capacity,
                    "retained": len(events),
                    "recorded": self.recorded,
                    "dropped": max(self.recorded - len(events), 0),
                },
                **({"reason": reason} if reason else {}),
            },
        }

    def dump(self, path: str, reason: str = "") -> str:
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(reason), f)
        return path


_FLIGHT = FlightRecorder()
_dump_lock = threading.Lock()


def get_flight() -> FlightRecorder:
    return _FLIGHT


def maybe_dump(reason: str) -> Optional[str]:
    """Write the post-mortem dump if ``REPRO_FLIGHT_OUT`` is armed (no-op
    otherwise — the engine calls this on every distress event).  Later
    dumps overwrite earlier ones: the file is always the view at the most
    recent trigger."""
    out = os.environ.get("REPRO_FLIGHT_OUT")
    if not out or not len(_FLIGHT):
        return None
    with _dump_lock:
        try:
            return _FLIGHT.dump(out, reason)
        except OSError:                        # pragma: no cover - disk full
            return None


@atexit.register
def _dump_at_exit() -> None:                   # pragma: no cover - atexit
    maybe_dump("atexit")


_prev_excepthook = sys.excepthook


def _flight_excepthook(exc_type, exc, tb):     # pragma: no cover - crash path
    maybe_dump(f"exception: {exc_type.__name__}: {exc}")
    _prev_excepthook(exc_type, exc, tb)


sys.excepthook = _flight_excepthook
