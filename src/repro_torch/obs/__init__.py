"""``repro_torch.obs`` — the port's observability layer.

One process-global structured tracer (``obs.trace``) threads through the
serving engine, the federated fit and the launcher; mergeable quantile
sketches live in ``obs.sketch``, the federated fit's per-client round
ledger in ``obs.fleet``, device-memory watermarks on the caching allocator
in ``obs.devmem``, and the crash-dump flight recorder in ``obs.flight``.
Import this package, not the submodules, from instrumented code::

    from repro_torch import obs

    with obs.span("engine.decode_step", device=True, step=i):
        ...
    obs.counter("serve.shed", 1)
    obs.hist("serve.itl_s", dt, sketch=True)      # mergeable percentiles
    obs.dump("trace.json")        # -> chrome://tracing / Perfetto UI

``REPRO_TRACE=0`` turns every call into a no-op; ``REPRO_TRACE_OUT=f.json``
dumps the trace at exit.  Even with the tracer off, the flight recorder
keeps the last ``REPRO_FLIGHT_CAP`` events and ``REPRO_FLIGHT_OUT=f.json``
arms post-mortem dumps (atexit / unhandled exception / engine distress);
``REPRO_FLIGHT=0`` disables that last layer too.

The step cost counter, its ``obs.*`` scopes and the kernels' dispatch
hook live in ``obs.cost`` (per-scope costs: ``obs.devmem.scope_costs``).
The reference's ``bench_gate`` (benchmark provenance) is not part of the
port's layer.
"""

from repro_torch.obs import devmem, fleet
from repro_torch.obs.devmem import memory_snapshot, peak_bytes, watermark
from repro_torch.obs.fleet import ClientRecord, FleetLedger
from repro_torch.obs.flight import (FlightRecorder, flight_enabled,
                                    get_flight,
                                    maybe_dump as flight_maybe_dump)
from repro_torch.obs.sketch import QuantileSketch, merge_all
from repro_torch.obs.trace import (Histogram, Tracer, add_span, counter,
                                   counter_track, dump, gauge, get_tracer,
                                   hist, instant, reset, span, span_count,
                                   step_span, trace_enabled)

enabled = trace_enabled

__all__ = [
    "ClientRecord", "FleetLedger", "FlightRecorder", "Histogram",
    "QuantileSketch", "Tracer", "add_span", "counter", "counter_track",
    "devmem", "dump", "enabled", "fleet", "flight_enabled",
    "flight_maybe_dump", "gauge", "get_flight",
    "get_tracer", "hist", "instant", "memory_snapshot", "merge_all",
    "peak_bytes", "reset", "span", "span_count", "step_span",
    "trace_enabled", "watermark",
]
