"""The port's federated fit at fleet scale, on the CPU and the port alone:
the counterparts of the reference's 64-client acceptance runs
(``tests/test_fleet.py::test_fed_64_clients_wire_invariant_and_straggler``,
``tests/test_fault.py::test_chaos_64_clients_converges_within_tolerance``)
and of its ``slow_clients`` shim test.  ``tests/test_torch_fed_faults.py``
holds the fit against the reference's at a smaller size; these cases run
the same code at 64 clients without a second reference run.  One more
case holds the fit's screen and buffer limits at values other than their
defaults.

Checks, as the reference's: the fleet ledger's per-cluster wire bytes equal
the round logs' bytes up exactly (``REPRO_FLEET_OUT`` writes the same
numbers to ``fleet.json``); an injected slow client is flagged as a
straggler on the virtual clock without any sleep; under 25% injected
faults of every kind, every on-time upload lands inside its window, no
NaN reaches the adapters, and the final round loss stays within 10% of a
fault-free run's.
"""

import dataclasses
import json
import time

import numpy as np
import pytest
import torch

from repro_torch import tree as tree_util
from repro_torch.configs import get_smoke_config
from repro_torch.core import comm
from repro_torch.fault import Fault, FaultPlan
from repro_torch.obs.fleet import SCHEMA
from repro_torch.train.fed_trainer import federated_fit


@pytest.fixture(autouse=True, scope="module")
def _torch_one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_env(monkeypatch):
    for name in ("REPRO_FED_WIRE", "REPRO_FED_QBLOCK", "REPRO_FORCE_KERNELS",
                 "REPRO_SECAGG_STEP", "REPRO_FLEET_OUT"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("REPRO_TRACE", "0")


def _mini(n_clients, clusters=2):
    cfg = get_smoke_config("fedtime-llama2-7b")
    cfg = cfg.replace(fedtime=dataclasses.replace(
        cfg.fedtime, num_clusters=clusters, clients_per_round=n_clients))
    ft = cfg.fedtime
    rng = np.random.default_rng(0)
    data = []
    for i in range(n_clients):
        shift = 0.0 if i < n_clients // 2 else 5.0
        data.append(
            (rng.standard_normal((4, ft.lookback, 2)).astype(np.float32)
             + shift,
             rng.standard_normal((4, ft.horizon, 2)).astype(np.float32)
             + shift))
    return cfg, data


def test_slow_clients_shim_runs_without_sleeping():
    """A 30-virtual-second straggler costs no 30 wall seconds, and the
    fleet ledger flags it."""
    cfg, data = _mini(8)
    t0 = time.monotonic()
    res = federated_fit(cfg, data, rounds=1, batch_size=4, device="cpu",
                        slow_clients={0: 30.0})
    assert time.monotonic() - t0 < 25.0        # virtual, not slept
    rec0 = [r for r in res.fleet.records if r.client == 0][0]
    assert rec0.participated and rec0.wall_s > 30.0
    assert 0 in {r.client for r, _ in res.fleet.stragglers()}


def test_fed_64_clients_wire_invariant_and_straggler(tmp_path, monkeypatch):
    cfg, data = _mini(64)
    out = tmp_path / "fleet.json"
    monkeypatch.setenv("REPRO_FLEET_OUT", str(out))
    res = federated_fit(cfg, data, rounds=1, batch_size=4, device="cpu",
                        wire="int8", slow_clients={0: 0.4})
    led = res.fleet
    assert len([r for r in led.records if r.participated]) == 64
    assert all(r.staleness == 0 for r in led.records)   # first sighting
    by_cluster = led.wire_bytes_by_cluster(round=0)
    for log in res.logs:
        assert by_cluster[log.cluster] == log.comm.bytes_up, log.cluster
    n_params = comm.count_params(res.adapters_per_cluster[0])
    assert led.total_wire_bytes() == \
        64 * comm.wire_payload_bytes(n_params, "int8")
    assert 0 in {r.client for r, _ in led.stragglers()}
    assert all(r.ef_norm >= 0.0 and r.delta_norm > 0.0
               for r in led.records if r.participated)
    doc = json.load(open(out))
    assert doc["schema"] == SCHEMA
    assert doc["fleet"]["wire_bytes"] == led.total_wire_bytes()
    assert any(s["client"] == 0 for s in doc["fleet"]["stragglers"])
    assert sum(c["fits"] for c in doc["clusters"].values()) == 64


def test_chaos_64_clients_converges_within_tolerance():
    cfg, data = _mini(64)
    plan = FaultPlan.random(64, 0.25, 3, seed=3, base_fit_s=1.0)
    assert plan.fault_rate(64) >= 0.20
    kinds = {f.kind for fs in plan.faults.values() for f in fs}
    assert kinds == {"crash", "hang", "transient", "corrupt", "byzantine"}
    deadline = 3.0
    kw = dict(rounds=3, batch_size=4, device="cpu", wire="int8")
    chaos = federated_fit(cfg, data, fault_plan=plan, deadline_s=deadline,
                          **kw)
    clean = federated_fit(cfg, data, **kw)
    led = chaos.fleet
    rej = led.rejections_by_reason()
    assert sum(rej.values()) > 0 and set(rej) <= {
        "crash", "hang", "deadline", "corrupt", "byzantine", "stale"}
    for r in led.records:
        if r.participated and not (r.extra or {}).get("buffered_staleness"):
            assert r.wall_s <= deadline + 1e-9
    for ad in chaos.adapters_per_cluster:
        assert all(bool(torch.isfinite(l).all())
                   for l in tree_util.leaves(ad))
    want = {}
    for log in chaos.logs:
        want[log.cluster] = want.get(log.cluster, 0) + log.comm.bytes_up
    assert led.wire_bytes_by_cluster() == want

    def final_loss(res):
        last = max(l.round for l in res.logs)
        return float(np.mean([l.train_loss for l in res.logs
                              if l.round == last]))

    lf, lc = final_loss(chaos), final_loss(clean)
    assert np.isfinite(lf) and np.isfinite(lc)
    assert abs(lf - lc) <= 0.10 * abs(lc), (lf, lc)


@pytest.mark.parametrize("byz_k,limit", [(25.0, 2), (1e6, 3)])
def test_screen_and_staleness_limits_reach_the_fit(byz_k, limit):
    """``byzantine_norm_k`` and ``staleness_limit`` are the caller's: at
    the defaults a x1000 upload rejects as byzantine and an upload two
    rounds late as stale; with a looser screen and limit both apply."""
    cfg, data = _mini(8, clusters=1)
    plan = FaultPlan({4: [Fault("byzantine", scale=1e3)],
                      6: [Fault("delay", delay_s=5.5,
                                rounds=frozenset({0}))]}, base_fit_s=0.5)
    res = federated_fit(cfg, data, rounds=3, batch_size=4, device="cpu",
                        wire="int8", fault_plan=plan, deadline_s=2.0,
                        byzantine_norm_k=byz_k, staleness_limit=limit)
    byz = [r.participated for r in res.fleet.records if r.client == 4]
    late = [r.extra for r in res.fleet.records
            if r.client == 6 and r.round == 2 and r.extra]
    if limit == 2:
        assert byz == [False] * 3
        assert late == [{"reason": "stale", "staleness_rejected": True}]
    else:
        assert byz == [True] * 3
        assert late == [{"buffered_staleness": 2}]
