"""Host-side structured span tracer — the repo's one observability spine.

Everything the serving engine and its launcher report flows through one
process-global :class:`Tracer`:

  * **Spans** — nested, thread-safe wall-clock intervals.  ``span()`` is a
    context manager; ``add_span()`` records a retroactive interval (the
    engine stamps request-lifecycle phases from timestamps it already
    keeps).  Spans land as Chrome trace-event ``"X"`` (complete) events, so
    the dump opens directly in ``chrome://tracing`` or the Perfetto UI.
  * **Instants / counter tracks** — point events (``"i"``) and ``"C"``
    counter series (block-pool utilization, active lanes) that Perfetto
    renders as step charts above the span tracks.
  * **Counters / gauges / histograms** — host-side aggregates.  Histograms
    keep a bounded reservoir so p50/p95/p99 stay O(1) memory over
    million-token runs; below the reservoir capacity the percentiles are
    EXACT (same linear interpolation as ``numpy.percentile``).
  * **Device alignment** — ``span(..., device=True)`` additionally enters
    ``torch.profiler.record_function`` and ``step_span`` one named
    ``<name>#<step>``, so when a ``torch.profiler`` trace is captured the
    host spans line up with the card's kernels.  No span synchronizes the
    card: a span's wall time is the host's, and device time is read from
    the profiler.  torch is imported at the first device span.

``REPRO_TRACE=0`` turns every entry point into a no-op (one dict lookup +
an early return), so
instrumentation can stay in hot paths unconditionally.  ``REPRO_TRACE_OUT=
path.json`` dumps the default tracer's Chrome trace at interpreter exit;
the serving launcher exposes the same via ``--trace-out``.

Even with the tracer off, the **flight recorder** (``obs.flight``)
passively retains the last N span/instant/counter events in a fixed ring —
one tuple append per event — so a crash or an engine distress signal can
still dump a post-mortem timeline.  ``REPRO_FLIGHT=0`` disables that too,
restoring the pure no-op path.

Unbounded streams that must AGGREGATE across processes/clients use
``hist(name, v, sketch=True)``: the sample lands in a mergeable
``repro_torch.obs.sketch.QuantileSketch`` instead of the reservoir
``Histogram`` (reservoirs cannot merge without re-biasing; sketches merge
associatively).

Virtual tracks: pass ``track="req:r0"`` to pin events to a named Perfetto
track (one per request) instead of the calling thread's track.
"""

from __future__ import annotations

import atexit
import json
import os
import random
import threading
import time
from typing import Any, Dict, List, Optional

from repro_torch.obs import flight as _flight
from repro_torch.obs.sketch import QuantileSketch

__all__ = [
    "Tracer", "Histogram", "get_tracer", "trace_enabled", "span",
    "add_span", "instant", "counter", "gauge", "hist", "counter_track",
    "step_span", "dump", "reset", "span_count",
]


def trace_enabled() -> bool:
    """Tracing is on by default; ``REPRO_TRACE=0`` compiles the whole
    subsystem down to no-ops (read per call like every REPRO_ flag)."""
    return os.environ.get("REPRO_TRACE", "1") != "0"


def _record_function(name: str):
    """A ``torch.profiler.record_function`` range (entered by the caller);
    outside a profiler it records nothing on the card and never
    synchronizes."""
    from torch.profiler import record_function
    return record_function(name)


# ---------------------------------------------------------------------------
# Histogram with reservoir percentiles
# ---------------------------------------------------------------------------

class Histogram:
    """Streaming histogram: exact count/sum/min/max plus a bounded
    reservoir (Vitter's algorithm R, deterministic seed) for percentiles.

    Up to ``capacity`` samples the reservoir holds EVERY value, so
    ``percentile`` matches ``numpy.percentile(..., method="linear")``
    bitwise; past it the estimate is unbiased with O(1/sqrt(capacity))
    error.  Thread-safe under the owning tracer's lock (standalone use is
    single-thread)."""

    __slots__ = ("count", "total", "min", "max", "_res", "_cap", "_rng")

    def __init__(self, capacity: int = 4096, seed: int = 0x5EED):
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self._res: List[float] = []
        self._cap = capacity
        self._rng = random.Random(seed)

    def add(self, value: float) -> None:
        v = float(value)
        self.count += 1
        self.total += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        if len(self._res) < self._cap:
            self._res.append(v)
        else:
            j = self._rng.randrange(self.count)
            if j < self._cap:
                self._res[j] = v

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def percentile(self, q: float) -> float:
        """q in [0, 100], linear interpolation over the reservoir (numpy's
        default method)."""
        if not self._res:
            return 0.0
        xs = sorted(self._res)
        pos = (q / 100.0) * (len(xs) - 1)
        lo = int(pos)
        hi = min(lo + 1, len(xs) - 1)
        frac = pos - lo
        return xs[lo] * (1.0 - frac) + xs[hi] * frac

    def summary(self) -> Dict[str, float]:
        if not self.count:
            return {"count": 0}
        return {
            "count": self.count,
            "mean": self.mean,
            "min": self.min,
            "max": self.max,
            "p50": self.percentile(50),
            "p95": self.percentile(95),
            "p99": self.percentile(99),
        }


# ---------------------------------------------------------------------------
# Tracer
# ---------------------------------------------------------------------------

class _NullSpan:
    """Shared no-op context manager — the entire cost of a disabled span."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _FlightSpan:
    """Span surrogate for the disabled-tracer path: records nothing in the
    tracer, but stamps the interval into the flight recorder's ring (one
    tuple append) so post-mortem dumps have a timeline even under
    ``REPRO_TRACE=0``."""
    __slots__ = ("name", "cat", "track", "args", "t0")

    def __init__(self, name: str, cat: str, track: Optional[str],
                 args: Dict[str, Any]):
        self.name = name
        self.cat = cat
        self.track = track
        self.args = args

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t0 = self.t0
        _flight.get_flight().record("X", self.name, self.cat, t0,
                                    time.perf_counter() - t0, self.track,
                                    self.args)
        return False


class _Span:
    __slots__ = ("_tr", "name", "cat", "args", "device", "track", "t0",
                 "_ann")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 device: bool, track: Optional[str],
                 args: Dict[str, Any]):
        self._tr = tracer
        self.name = name
        self.cat = cat
        self.args = args
        self.device = device
        self.track = track
        self._ann = None

    def __enter__(self):
        self.t0 = time.perf_counter()
        if self.device:
            self._ann = _record_function(self.name)
            self._ann.__enter__()
        return self

    def __exit__(self, *exc):
        if self._ann is not None:
            self._ann.__exit__(*exc)
        self._tr._complete(self.name, self.cat, self.t0,
                           time.perf_counter(), self.track, self.args)
        return False


class _StepSpan(_Span):
    """Span + a ``record_function`` range named ``<name>#<step>`` — marks
    one engine step so a profiler trace groups the card's work per step."""
    __slots__ = ("step",)

    def __init__(self, tracer, name, step: int, args):
        super().__init__(tracer, name, "step", False, None, args)
        self.step = step

    def __enter__(self):
        self.t0 = time.perf_counter()
        self._ann = _record_function(f"{self.name}#{self.step}")
        self._ann.__enter__()
        return self


class Tracer:
    """Thread-safe structured tracer; see module docstring.

    One event buffer, bounded by ``max_events`` (overflow counted in
    ``dropped_events``, never raises).  Chrome-trace timestamps are
    microseconds relative to the tracer's epoch."""

    def __init__(self, max_events: int = 1 << 20):
        self._lock = threading.Lock()
        self._max_events = max_events
        self.reset()

    # -- lifecycle -----------------------------------------------------------

    def reset(self) -> None:
        with getattr(self, "_lock", threading.Lock()):
            self._epoch = time.perf_counter()
            self._events: List[dict] = []
            self._tracks: Dict[str, int] = {}   # virtual track name -> tid
            self._thread_tids: Dict[int, int] = {}
            self._next_tid = 1
            self.dropped_events = 0
            self.counters: Dict[str, float] = {}
            self.gauges: Dict[str, float] = {}
            self.hists: Dict[str, Histogram] = {}

    @property
    def enabled(self) -> bool:
        return trace_enabled()

    # -- track / tid plumbing ------------------------------------------------

    def _tid(self, track: Optional[str]) -> int:
        """tid for a virtual track name (allocating + emitting the
        thread_name metadata event on first use) or the calling thread."""
        if track is not None:
            tid = self._tracks.get(track)
            if tid is None:
                tid = self._next_tid = self._next_tid + 1
                self._tracks[track] = tid
                self._push({"name": "thread_name", "ph": "M", "pid": 0,
                            "tid": tid, "args": {"name": track}})
            return tid
        ident = threading.get_ident()
        tid = self._thread_tids.get(ident)
        if tid is None:
            tid = self._next_tid = self._next_tid + 1
            self._thread_tids[ident] = tid
            name = threading.current_thread().name
            self._push({"name": "thread_name", "ph": "M", "pid": 0,
                        "tid": tid, "args": {"name": name}})
        return tid

    def _push(self, ev: dict) -> None:
        if len(self._events) >= self._max_events:
            self.dropped_events += 1
            return
        self._events.append(ev)

    def _us(self, t: float) -> float:
        return (t - self._epoch) * 1e6

    def _complete(self, name: str, cat: str, t0: float, t1: float,
                  track: Optional[str], args: Dict[str, Any]) -> None:
        with self._lock:
            self._push({"name": name, "cat": cat or "repro", "ph": "X",
                        "ts": self._us(t0),
                        "dur": max(self._us(t1) - self._us(t0), 0.0),
                        "pid": 0, "tid": self._tid(track),
                        "args": args or {}})
        if _flight.flight_enabled():
            _flight.get_flight().record("X", name, cat, t0, t1 - t0,
                                        track, args)

    # -- spans / events ------------------------------------------------------

    def span(self, name: str, cat: str = "", device: bool = False,
             track: Optional[str] = None, **args):
        """Context manager timing a live region.  ``device=True`` also
        enters a ``torch.profiler.record_function`` range so the host span
        lines up with the card's kernels under the profiler; ``track`` pins
        the span to a named virtual track instead of the calling thread."""
        if not trace_enabled():
            if _flight.flight_enabled():
                return _FlightSpan(name, cat, track, args)
            return _NULL_SPAN
        return _Span(self, name, cat, device, track, args)

    def step_span(self, name: str, step: int, **args):
        """``span`` + a ``record_function`` range ``<name>#<step>``."""
        if not trace_enabled():
            if _flight.flight_enabled():
                return _FlightSpan(name, "step", None, args)
            return _NULL_SPAN
        args.setdefault("step", step)
        return _StepSpan(self, name, step, args)

    def add_span(self, name: str, t0: float, t1: float, cat: str = "",
                 track: Optional[str] = None, **args) -> None:
        """Retroactive span from ``time.perf_counter()`` stamps already in
        hand (request lifecycle phases the engine times anyway)."""
        if not trace_enabled():
            if _flight.flight_enabled():
                _flight.get_flight().record("X", name, cat, t0, t1 - t0,
                                            track, args)
            return
        self._complete(name, cat, t0, t1, track, args)

    def instant(self, name: str, cat: str = "", track: Optional[str] = None,
                **args) -> None:
        if not trace_enabled():
            if _flight.flight_enabled():
                _flight.get_flight().record("i", name, cat,
                                            time.perf_counter(),
                                            track=track, args=args)
            return
        with self._lock:
            self._push({"name": name, "cat": cat or "repro", "ph": "i",
                        "ts": self._us(time.perf_counter()), "s": "t",
                        "pid": 0, "tid": self._tid(track),
                        "args": args or {}})
        if _flight.flight_enabled():
            _flight.get_flight().record("i", name, cat, time.perf_counter(),
                                        track=track, args=args)

    def counter_track(self, name: str, **series: float) -> None:
        """One ``"C"`` sample on the named counter track (Perfetto renders
        the series as a stacked step chart)."""
        traced = trace_enabled()
        if not traced and not _flight.flight_enabled():
            return
        series_f = {k: float(v) for k, v in series.items()}
        if _flight.flight_enabled():
            _flight.get_flight().record("C", name, "repro",
                                        time.perf_counter(), args=series_f)
        if not traced:
            return
        with self._lock:
            self._push({"name": name, "cat": "repro", "ph": "C",
                        "ts": self._us(time.perf_counter()), "pid": 0,
                        "args": series_f})

    # -- aggregates ----------------------------------------------------------

    def counter(self, name: str, value: float = 1.0) -> None:
        """Monotonic accumulator (wire bytes, events)."""
        if not trace_enabled():
            return
        with self._lock:
            self.counters[name] = self.counters.get(name, 0.0) + float(value)

    def gauge(self, name: str, value: float) -> None:
        """Last-value-wins sample (residual norms, losses)."""
        if not trace_enabled():
            return
        with self._lock:
            self.gauges[name] = float(value)

    def hist(self, name: str, value: float, *, sketch: bool = False) -> None:
        """Histogram sample (latencies); percentiles via ``summary()``.

        ``sketch=True`` binds the name to a mergeable
        :class:`~repro_torch.obs.sketch.QuantileSketch` instead of the
        reservoir ``Histogram`` — use it for unbounded streams that must
        aggregate across processes (the first call for a name picks the
        representation; both expose ``add``/``percentile``/``summary``)."""
        if not trace_enabled():
            return
        with self._lock:
            h = self.hists.get(name)
            if h is None:
                h = self.hists[name] = (QuantileSketch() if sketch
                                        else Histogram())
            h.add(value)

    def sketch(self, name: str) -> Optional[QuantileSketch]:
        """The sketch bound to ``name`` by ``hist(..., sketch=True)``, or
        None (absent, or reservoir-bound)."""
        h = self.hists.get(name)
        return h if isinstance(h, QuantileSketch) else None

    # -- inspection / export -------------------------------------------------

    def events(self, name: Optional[str] = None) -> List[dict]:
        with self._lock:
            evs = list(self._events)
        if name is None:
            return evs
        return [e for e in evs if e["name"] == name]

    def span_count(self, name: str) -> int:
        """Number of completed ``"X"`` spans with this name — the
        trace-validity checks key off this (one ``req.lifecycle`` span per
        finished request, and so on)."""
        return sum(1 for e in self.events(name) if e["ph"] == "X")

    def summary(self) -> dict:
        with self._lock:
            return {
                "counters": dict(self.counters),
                "gauges": dict(self.gauges),
                "hists": {k: h.summary() for k, h in self.hists.items()},
                "events": len(self._events),
                "dropped_events": self.dropped_events,
            }

    def to_chrome_trace(self, provenance: Optional[dict] = None) -> dict:
        """The Chrome trace-event JSON object (``chrome://tracing`` /
        Perfetto UI both open it).  Aggregates ride in ``metadata`` so one
        artifact carries the whole observability picture."""
        with self._lock:
            events = list(self._events)
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "metadata": {
                "tool": "repro_torch.obs",
                "summary": self.summary(),
                **({"provenance": provenance} if provenance else {}),
            },
        }

    def dump(self, path: str, provenance: Optional[dict] = None) -> str:
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(provenance), f)
        return path


# ---------------------------------------------------------------------------
# Process-global default tracer + module-level conveniences
# ---------------------------------------------------------------------------

_TRACER = Tracer()


def get_tracer() -> Tracer:
    return _TRACER


def span(name: str, cat: str = "", device: bool = False, **args):
    return _TRACER.span(name, cat, device=device, **args)


def step_span(name: str, step: int, **args):
    return _TRACER.step_span(name, step, **args)


def add_span(name: str, t0: float, t1: float, **kw) -> None:
    _TRACER.add_span(name, t0, t1, **kw)


def instant(name: str, **kw) -> None:
    _TRACER.instant(name, **kw)


def counter(name: str, value: float = 1.0) -> None:
    _TRACER.counter(name, value)


def gauge(name: str, value: float) -> None:
    _TRACER.gauge(name, value)


def hist(name: str, value: float, *, sketch: bool = False) -> None:
    _TRACER.hist(name, value, sketch=sketch)


def counter_track(name: str, **series: float) -> None:
    _TRACER.counter_track(name, **series)


def span_count(name: str) -> int:
    return _TRACER.span_count(name)


def dump(path: str, provenance: Optional[dict] = None) -> str:
    return _TRACER.dump(path, provenance)


def reset() -> None:
    _TRACER.reset()


@atexit.register
def _dump_at_exit() -> None:                   # pragma: no cover - atexit
    out = os.environ.get("REPRO_TRACE_OUT")
    if out and trace_enabled() and _TRACER.events():
        try:
            _TRACER.dump(out)
        except OSError:
            pass
