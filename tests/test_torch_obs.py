"""The port's observability layer (``repro_torch.obs``) against the JAX
package's ``repro.obs`` on the same calls, on the CPU.

  * the tracer: nested spans on named tracks, retroactive spans, instants,
    counter tracks, counters, gauges, reservoir and sketch histograms give
    the same events (timestamps aside) and the same summary; the disabled
    tracer records nothing and its flight recorder the same tail;
  * the quantile sketch and the reservoir histogram: equal quantiles,
    merges and serialized forms on the same streams;
  * the flight recorder: the same ring and the same dump;
  * the engine's trace: both engines, on the same trace, emit the same
    request-track events in the same order, and one ``req.lifecycle`` span
    for each finished request;
  * a device span enters ``torch.profiler.record_function``.

Every event here is on a named track or on the main thread: the reference's
own thread-track test can fail when the OS reuses a finished thread's
ident, which this file never relies on.
"""

import json

import jax
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models.registry import get_model as jax_get_model
from repro.obs.flight import FlightRecorder as JaxFlightRecorder
from repro.obs.sketch import QuantileSketch as JaxSketch
from repro.obs.sketch import merge_all as jax_merge_all
from repro.obs.trace import Histogram as JaxHistogram
from repro.obs.trace import Tracer as JaxTracer
from repro.serve import ForecastEngine as JaxEngine
from repro.serve import Request as JaxRequest
from repro_torch import bridge
from repro_torch import obs
from repro_torch.configs import get_smoke_config
from repro_torch.obs.flight import FlightRecorder
from repro_torch.obs.sketch import QuantileSketch, merge_all
from repro_torch.obs.trace import Histogram, Tracer
from repro_torch.serve.engine import ForecastEngine
from repro_torch.serve.request import Request


def _strip(events):
    """Events without their clock readings."""
    return [{k: v for k, v in e.items() if k not in ("ts", "dur")}
            for e in events]


def _script(tr):
    """One fixed sequence of tracer calls, on the main thread."""
    with tr.span("outer", track="req:a", depth=0):
        with tr.span("inner", cat="kern", track="req:a", depth=1):
            pass
        tr.instant("mark", track="req:b", n=3)
    with tr.span("engine.decode_step", device=True, step=0, active=2):
        pass
    with tr.step_span("fed.round", 4, clients=2):
        pass
    tr.add_span("req.lifecycle", 1.0, 1.5, track="req:a", reason="length")
    tr.counter_track("pool", blocks_in_use=3, active_lanes=2)
    for v in (1.0, 2.5, 2.5):
        tr.counter("serve.shed", v)
    tr.gauge("loss", 0.25)
    tr.gauge("loss", 0.125)
    for x in np.linspace(0.0, 1.0, 50):
        tr.hist("itl_s", float(x))
        tr.hist("fit_s", float(x) * 3, sketch=True)


def test_tracer_events_and_summary_match_reference(monkeypatch):
    monkeypatch.setenv("REPRO_TRACE", "1")
    want, got = JaxTracer(), Tracer()
    _script(want)
    _script(got)
    assert _strip(got.events()) == _strip(want.events())
    assert got.summary() == want.summary()
    assert got.span_count("inner") == want.span_count("inner") == 1
    assert got.sketch("fit_s").to_dict() == want.sketch("fit_s").to_dict()
    assert got.sketch("itl_s") is None
    doc = got.to_chrome_trace({"arch": "x"})
    assert json.loads(json.dumps(doc))["metadata"]["provenance"] == \
        {"arch": "x"}


def test_disabled_tracer_records_nothing_flight_keeps_the_tail(monkeypatch):
    monkeypatch.setenv("REPRO_TRACE", "0")
    monkeypatch.setenv("REPRO_FLIGHT", "1")
    tails = []
    for mod, tr in ((jobs, JaxTracer()), (obs, Tracer())):
        flight = mod.get_flight()
        flight.reset()
        _script(tr)
        assert tr.events() == [] and tr.summary()["counters"] == {}
        tails.append(_strip(flight.to_chrome_trace()["traceEvents"]))
        flight.reset()
    assert tails[1] == tails[0] and len(tails[0]) > 5
    monkeypatch.setenv("REPRO_FLIGHT", "0")
    tr = Tracer()
    assert tr.span("x") is tr.span("y")          # the shared null span
    obs.get_flight().reset()
    _script(tr)
    assert len(obs.get_flight()) == 0


@pytest.mark.parametrize("capacity", [4, 8])
def test_flight_recorder_matches_reference(capacity, tmp_path, monkeypatch):
    dumps = []
    for cls in (JaxFlightRecorder, FlightRecorder):
        fr = cls(capacity)
        for i in range(6):
            fr.record("X", f"s{i}", "", 10.0 + i, 0.5, f"req:r{i % 2}",
                      {"i": i})
        fr.record("i", "mark", "c", 20.0, track=None, args={"k": 1})
        doc = fr.to_chrome_trace("reason")
        doc["metadata"].pop("tool")
        doc["traceEvents"] = _strip(doc["traceEvents"])
        dumps.append(doc)
    assert dumps[1] == dumps[0]
    assert dumps[1]["metadata"]["flight_recorder"]["dropped"] == \
        max(7 - capacity, 0)
    # the armed dump of the process-global recorder
    out = tmp_path / "flight.json"
    monkeypatch.setenv("REPRO_FLIGHT_OUT", str(out))
    monkeypatch.setenv("REPRO_FLIGHT", "1")
    obs.get_flight().reset()
    obs.instant("serve.quarantine", track="req:q", reason="nonfinite")
    assert obs.flight_maybe_dump("engine.quarantine") == str(out)
    doc = json.loads(out.read_text())
    assert doc["metadata"]["reason"] == "engine.quarantine"
    assert any(e["name"] == "serve.quarantine" for e in doc["traceEvents"])
    obs.get_flight().reset()


SKETCH_STREAMS = {
    "small_exact": lambda rng: rng.random(100),
    "large": lambda rng: rng.lognormal(0.0, 2.0, 5000),
    "signed_zero": lambda rng: np.concatenate(
        [rng.normal(0, 1, 400), np.zeros(50), -rng.random(300)]),
}


@pytest.mark.parametrize("stream", sorted(SKETCH_STREAMS))
def test_sketch_matches_reference(stream):
    xs = SKETCH_STREAMS[stream](np.random.default_rng(3))
    parts = np.array_split(xs, 3)
    got, want = QuantileSketch(), JaxSketch()
    got.add_many(parts[0])
    want.add_many(parts[0])
    for x in parts[1]:
        got.add(x)
        want.add(x)
    qs = (0, 1, 25, 50, 90, 99, 100)
    assert [got.quantile(q) for q in qs] == [want.quantile(q) for q in qs]
    g2, w2 = QuantileSketch(max_buckets=64), JaxSketch(max_buckets=64)
    g2.add_many(parts[2])
    w2.add_many(parts[2])
    assert QuantileSketch.from_dict(got.to_dict()).to_dict() == \
        JaxSketch.from_dict(want.to_dict()).to_dict()
    gm, wm = merge_all([got, g2]), jax_merge_all([want, w2])
    assert gm.to_dict() == wm.to_dict()
    assert gm.summary() == wm.summary()
    assert gm.count == len(xs)


def test_reservoir_histogram_matches_reference():
    rng = np.random.default_rng(5)
    got, want = Histogram(capacity=64), JaxHistogram(capacity=64)
    for x in rng.random(1000):
        got.add(x)
        want.add(x)
    assert got.summary() == want.summary()
    assert got._res == want._res                  # the same seeded reservoir


def test_device_span_enters_record_function(monkeypatch):
    """``span(device=True)`` and ``step_span`` open profiler ranges; the
    host span is recorded either way and nothing waits on a device."""
    monkeypatch.setenv("REPRO_TRACE", "1")
    tr = Tracer()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tr.span("engine.decode_step", device=True, step=3):
            torch.ones(4).sum()
        with tr.step_span("engine.tick", 7):
            pass
        with tr.span("host.only"):
            pass
    names = {e.key for e in prof.key_averages()}
    assert {"engine.decode_step", "engine.tick#7"} <= names
    assert "host.only" not in names
    assert [e["name"] for e in tr.events() if e["ph"] == "X"] == [
        "engine.decode_step", "engine.tick", "host.only"]


def test_devmem_without_a_card(monkeypatch):
    monkeypatch.setenv("REPRO_TRACE", "1")
    snap = obs.memory_snapshot("cpu")
    assert set(snap) == {"bytes_in_use", "peak_bytes_in_use", "bytes_limit",
                         "live_buffer_bytes", "live_buffers"}
    assert all(v == 0 for v in snap.values())
    assert obs.peak_bytes("cpu") == 0
    obs.reset()
    assert obs.watermark("engine.decode", "cpu") == snap
    tr = obs.get_tracer()
    assert [e["name"] for e in tr.events()] == ["devmem"]
    assert tr.summary()["gauges"] == {"devmem.engine.decode.bytes_in_use":
                                      0.0}
    obs.reset()


def _request_tracks(tracer):
    """{track name: [event names in order]} for the request tracks."""
    evs = tracer.events()
    names = {e["tid"]: e["args"]["name"] for e in evs if e["ph"] == "M"}
    out = {}
    for e in evs:
        track = names.get(e.get("tid"), "")
        if e["ph"] in ("X", "i") and track.startswith("req:"):
            out.setdefault(track, []).append(e["name"])
    return out


def test_engine_trace_matches_reference(monkeypatch):
    """The same trace through both engines (shared-prefix cluster, so
    share hits and copy-on-write fire; one poisoned request): the same
    request-track events in the same order, one lifecycle span for each
    finished request, and a decode-step span for each decode step."""
    monkeypatch.setenv("REPRO_TRACE", "1")
    jcfg = jax_smoke_config("qwen3-0.6b")
    cfg = get_smoke_config("qwen3-0.6b")
    jparams = jax_get_model(jcfg).init(jcfg, jax.random.PRNGKey(0))
    params = bridge.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                    device="cpu")
    rng = np.random.default_rng(2)
    core = rng.integers(0, cfg.vocab_size, 20).tolist()
    prompts = [core, core + [5, 6], core,
               rng.integers(0, cfg.vocab_size, 9).tolist()]
    tracks, counts = [], []
    for mod, Engine, Req, kw in (
            (jobs, JaxEngine, JaxRequest,
             dict(params=jparams, cfg=jcfg)),
            (obs, ForecastEngine, Request,
             dict(params=params, cfg=cfg, device="cpu"))):
        mod.reset()
        eng = Engine(kw.pop("cfg"), kw.pop("params"), num_slots=3,
                     cache_len=48, block_size=8, **kw)
        for i, p in enumerate(prompts):
            eng.submit(Req(id=f"r{i}", prompt=p, max_new_tokens=5,
                           arrival_step=i))
        eng.poison("r3")
        eng.run(max_steps=200)
        tr = mod.get_tracer()
        tracks.append(_request_tracks(tr))
        counts.append((tr.span_count("req.lifecycle"),
                       eng.metrics.requests_finished,
                       tr.span_count("engine.decode_step"),
                       eng.metrics.decode_steps,
                       eng.metrics.cow_copies))
        mod.reset()
    assert tracks[1] == tracks[0]
    assert counts[1] == counts[0]
    lifecycle, finished, steps, decode_steps, cow = counts[1]
    assert lifecycle == finished == 3 and steps == decode_steps and cow >= 1
    assert "serve.quarantine" in tracks[1]["req:r3"]
    assert tracks[1]["req:r0"][:3] == ["req.submit", "req.queued",
                                       "req.prefill"]
