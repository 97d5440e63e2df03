"""The port's fleet ledger (``repro_torch.obs.fleet``) against the JAX
package's (``repro.obs.fleet``), on the CPU, fed the same records.

Everything is equal exactly: records, the staleness clock, per-cluster
wire bytes, straggler flags and their reasons, rejections by reason, the
cluster and fleet sketches (the port's sketch equals the reference's, see
``tests/test_torch_obs.py``), ``to_json`` key for key and value for value,
and the events ``to_trace`` puts on the tracer (timestamps aside).
"""

import json

import numpy as np
import pytest

from repro import obs as jobs
from repro.obs.fleet import SCHEMA as JSCHEMA
from repro.obs.fleet import FleetLedger as JFleetLedger
from repro_torch import obs
from repro_torch.obs.fleet import SCHEMA, ClientRecord, FleetLedger


def _script(led):
    """One ledger history: two rounds of three clusters, exclusions with
    reasons, extras, a p99 straggler, a MAD straggler and a buffered
    upload."""
    rng = np.random.default_rng(5)
    for r in range(2):
        for i, w in enumerate([1.0, 1.0, 1.0, 1.0, 10.0]):
            led.record(r, 0, i, wall_s=w, wire_bytes=100, ef_norm=0.5,
                       delta_norm=0.25, t0=100.0 + i)
        for i, w in enumerate([0.98, 1.0, 1.0, 1.02, 1.5]):
            led.record(r, 1, 10 + i, wall_s=w, wire_bytes=100, t0=50.0)
        for i in range(200):
            led.record(r, 2, 100 + i, wall_s=float(rng.lognormal()),
                       wire_bytes=7)
        led.record(r, 1, 30, participated=False, reason="crash")
        led.record(r, 1, 31, wall_s=2.5, wire_bytes=100,
                   participated=False, reason="byzantine")
    led.record(2, 1, 30, participated=False, reason="deadline")
    led.record(2, 1, 30, wire_bytes=100, buffered_staleness=1)
    led.record(2, 0, 4, participated=False, reason="stale",
               staleness_rejected=True)
    led.record(2, 0, 99, participated=False)


@pytest.fixture(scope="module")
def ledgers():
    led, jled = FleetLedger(), JFleetLedger()
    _script(led)
    _script(jled)
    return led, jled


def test_records_and_rollups_equal_reference(ledgers):
    led, jled = ledgers
    assert [r.to_dict() for r in led.records] == \
        [r.to_dict() for r in jled.records]
    assert [r.staleness for r in led.records] == \
        [r.staleness for r in jled.records]
    assert led._last_round == jled._last_round
    assert led.clusters == jled.clusters == [0, 1, 2]
    for rnd in (None, 0, 1, 2):
        assert led.wire_bytes_by_cluster(rnd) == \
            jled.wire_bytes_by_cluster(rnd)
    assert led.total_wire_bytes() == jled.total_wire_bytes()
    for c in (None, 0, 1):
        assert led.rejections_by_reason(c) == jled.rejections_by_reason(c)
    assert led.rejections_by_reason() == {"crash": 2, "byzantine": 2,
                                          "deadline": 1, "stale": 1,
                                          "unknown": 1}


def test_stragglers_and_sketch_merge_equal_reference(ledgers):
    led, jled = ledgers
    got = [(r.round, r.cluster, r.client, why) for r, why in led.stragglers()]
    want = [(r.round, r.cluster, r.client, why)
            for r, why in jled.stragglers()]
    assert got == want
    assert {(c, cl) for _, c, cl, _ in got} >= {(0, 4), (1, 14)}
    for name in ("wall_s", "staleness", "wire_bytes"):
        fs, jfs = led.fleet_sketch(name), jled.fleet_sketch(name)
        assert fs.to_dict() == jfs.to_dict()
        direct = led.cluster_sketch(0, name).copy()
        direct.merge(led.cluster_sketch(1, name)).merge(
            led.cluster_sketch(2, name))
        for q in (50, 95, 99):
            assert fs.quantile(q) == direct.quantile(q) == jfs.quantile(q)


def test_to_json_equals_reference(ledgers, tmp_path):
    led, jled = ledgers
    assert SCHEMA == JSCHEMA == "repro.fleet/v1"
    got = json.loads(json.dumps(led.to_json()))
    want = json.loads(json.dumps(jled.to_json()))
    assert got == want
    assert got["records"][-3]["extra"] == {"buffered_staleness": 1}
    path = led.dump(str(tmp_path / "fleet.json"))
    assert json.load(open(path)) == want
    assert isinstance(led.records[0], ClientRecord)


def test_to_trace_equals_reference(ledgers, monkeypatch):
    led, jled = ledgers
    monkeypatch.setenv("REPRO_TRACE", "1")
    try:
        obs.reset()
        jobs.reset()
        led.to_trace()
        jled.to_trace()
        strip = lambda evs: [{k: v for k, v in e.items()  # noqa: E731
                              if k not in ("ts", "dur")} for e in evs]
        got, want = obs.get_tracer().events(), jobs.get_tracer().events()
        assert strip(got) == strip(want)
        names = {e["name"] for e in got}
        assert {"client4.fit", "client30.skipped"} <= names
        fit4 = [e for e in got if e["name"] == "client4.fit"]
        assert fit4[0]["args"]["straggler"] == "p99"
    finally:
        obs.reset()
        jobs.reset()
