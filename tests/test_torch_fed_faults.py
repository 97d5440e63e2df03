"""The port's fault-tolerant federated fit against the JAX package's, on
the CPU, at the reference's ``_mini`` size (``tests/test_fault.py``: the
fedtime-llama2-7b smoke config, bimodal client data, every cluster member
sampled each round).

Three fits run on each side, once per module, from the same base
parameters, adapters and first K-means centre (the reference's, carried
over by the bridge):
  * ``plan``: the int8 wire under a deadline with one client each of
    crash, hang, transient retry, corrupt (NaN), byzantine (x1000) and two
    delays: one upload buffered and applied a round later (staleness 1),
    one buffered and rejected at the staleness limit's boundary (2 == 2);
    traced, so that the names of the spans, instants, counters, gauges and
    histograms can be held equal; ``staleness_decay`` 0.25, not its
    default, weighs the applied late upload;
  * ``secure_int8``: secure aggregation on the int8 wire with a hung
    client every round and a crash in round 1: dropout recovery; the
    clients train on a ``loss_fn`` of the caller's own (mean absolute
    error), each side's own function;
  * ``secure_f32``: secure aggregation in f32 with ``straggler_prob`` and
    ``slow_clients`` past a deadline (a late masked upload is a dropout).

Tolerances, and why:
  * the fleet ledger's (round, cluster, client, participated, extras, wire
    bytes, staleness), the virtual fit times where the plan fixes them,
    the round logs' bytes and messages, the rejections by reason: exact;
  * the secure int8 wire's unmasked code sums: exact, and each equal to
    the plain sum of that round's survivors' codes on both sides;
  * round losses: within 1e-5 of the loss; final adapters: as
    ``tests/test_torch_fed_fit.py`` holds them (within 1e-4 of the largest
    adapter value; on a quantized wire all but the elements one wire step
    can reach, and those within 2 x lr).  The secure f32 wire adds masks of
    scale 1e-2 that cancel to f32 rounding on both sides, the port's drawn
    from torch, the reference's from jax.random.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import fedtime as jfedtime
from repro.core import lora as jlora
from repro.core import secure_agg as jsa
from repro.fault import Fault as JFault
from repro.fault import FaultPlan as JFaultPlan
from repro.train import fed_trainer as jfed_trainer
from repro_torch import bridge, obs
from repro_torch import tree as tree_util
from repro_torch.configs import get_smoke_config
from repro_torch.core import fedtime
from repro_torch.core import secure_agg as sa
from repro_torch.fault import Fault, FaultPlan
from repro_torch.train import fed_trainer

ENV = ("REPRO_FED_WIRE", "REPRO_FED_QBLOCK", "REPRO_FORCE_KERNELS",
       "REPRO_SECAGG_STEP", "REPRO_FLEET_OUT", "REPRO_TRACE")


def _plan(mod):
    F = Fault if mod == "port" else JFault
    P = FaultPlan if mod == "port" else JFaultPlan
    return P({0: [F("crash")], 1: [F("hang")],
              2: [F("transient", fails=1, backoff_s=0.25)],
              3: [F("corrupt")], 4: [F("byzantine", scale=1e3)],
              5: [F("delay", delay_s=3.5, rounds=frozenset({0}))],
              6: [F("delay", delay_s=5.5, rounds=frozenset({0}))]},
             base_fit_s=0.5)


def _secure_plan(mod):
    F = Fault if mod == "port" else JFault
    P = FaultPlan if mod == "port" else JFaultPlan
    return P({1: [F("hang")], 4: [F("crash", rounds=frozenset({1}))]},
             base_fit_s=1.0)


CASES = {
    # name: (clients, rounds, fit keywords, the plan for each side)
    "plan": (8, 3, dict(wire="int8", deadline_s=2.0, staleness_limit=2,
                        staleness_decay=0.25), _plan),
    "secure_int8": (6, 2, dict(wire="int8", secure_aggregation=True,
                               deadline_s=5.0), _secure_plan),
    "secure_f32": (8, 2, dict(wire="f32", secure_aggregation=True,
                              straggler_prob=0.3, slow_clients={2: 1000.0},
                              deadline_s=100.0), None),
}


def _data(n_clients, ft):
    rng = np.random.default_rng(0)
    data = []
    for i in range(n_clients):
        shift = 0.0 if i < n_clients // 2 else 5.0
        data.append(
            (rng.standard_normal((4, ft.lookback, 2)).astype(np.float32)
             + shift,
             rng.standard_normal((4, ft.horizon, 2)).astype(np.float32)
             + shift))
    return data


def _mae(mod, cfg):
    """A caller's own loss: the mean absolute error of the forecast."""
    if mod == "port":
        return lambda p, b: (fedtime.forward(p, cfg, b["x"])
                             - b["y"]).abs().mean()
    return lambda p, b: jnp.mean(jnp.abs(jfedtime.forward(p, cfg, b["x"])
                                         - b["y"]))


def _names(tracer):
    summ = tracer.summary()
    return {"spans": {e["name"] for e in tracer.events() if e["ph"] == "X"},
            "instants": {e["name"] for e in tracer.events()
                         if e["ph"] == "i"},
            "counter_tracks": {e["name"] for e in tracer.events()
                               if e["ph"] == "C"},
            "counters": set(summ["counters"]), "gauges": set(summ["gauges"]),
            "hists": set(summ["hists"])}


class _Codes:
    """Wraps a secure_agg module's ``secure_encode`` and ``unmask_sum``:
    every encode's codes in order, every unmasked code sum."""

    def __init__(self, mod, mp):
        self.codes, self.sums = [], []
        enc, unmask = mod.secure_encode, mod.unmask_sum

        def encode(*a, **k):
            out = enc(*a, **k)
            self.codes.append(out[0].copy())
            return out

        def unmask_sum(masked, survivors, **k):
            self.sums.append((list(survivors), unmask(masked, survivors,
                                                      **k).copy()))
            return self.sums[-1][1]

        mp.setattr(mod, "secure_encode", encode)
        mp.setattr(mod, "unmask_sum", unmask_sum)


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        try:
            _run_fits(mp, out, tmp_path_factory)
        finally:
            obs.reset()
            jobs.reset()
            torch.set_num_threads(n)
    return out


def _run_fits(mp, out, tmp_path_factory):
    """The three fits on each side, their names, codes and fleet files
    into ``out``."""
    for name in ENV:
        mp.delenv(name, raising=False)
    jcfg0 = jax_smoke_config("fedtime-llama2-7b")
    ft0 = jcfg0.fedtime
    k_init, k_lora, k_cl = jax.random.split(jax.random.PRNGKey(0), 3)
    jbase = jfedtime.init(jcfg0, k_init, num_channels=2)
    ad0 = jlora.lora_tree(jlora.attach_lora(
        jbase, k_lora, rank=ft0.lora_rank, alpha=ft0.lora_alpha))
    np_ = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    # only the secure int8 case encodes on the shared grid
    jcodes, codes = _Codes(jsa, mp), _Codes(sa, mp)
    for name, (n_clients, rounds, kw, plan) in CASES.items():
        fedcfg = dict(num_clusters=1, clients_per_round=n_clients)
        jcfg = dataclasses.replace(jcfg0, fedtime=dataclasses.replace(
            ft0, **fedcfg))
        cfg = get_smoke_config("fedtime-llama2-7b")
        cfg = cfg.replace(fedtime=dataclasses.replace(cfg.fedtime,
                                                      **fedcfg))
        data = _data(n_clients, ft0)
        first = int(jax.random.randint(k_cl, (), 0, n_clients))
        fleet = tmp_path_factory.mktemp(name)
        traced = name == "plan"
        own_loss = name == "secure_int8"
        mp.setenv("REPRO_TRACE", "1" if traced else "0")
        obs.reset()
        jobs.reset()
        jres = jfed_trainer.federated_fit(
            jcfg, data, rounds=rounds, batch_size=4,
            key=jax.random.PRNGKey(0), base_params=jbase,
            init_adapters=ad0, fleet_out=str(fleet / "ref.json"),
            **({"loss_fn": _mae("ref", jcfg)} if own_loss else {}),
            **kw, **({"fault_plan": plan("ref")} if plan else {}))
        res = fed_trainer.federated_fit(
            cfg, data, rounds=rounds, batch_size=4,
            base_params=bridge.params_from_jax(np_(jbase), cfg, "cpu"),
            init_adapters=bridge.tree_to_torch(np_(ad0), "cpu"),
            kmeans_first=first, device="cpu",
            fleet_out=str(fleet / "port.json"),
            **({"loss_fn": _mae("port", cfg)} if own_loss else {}),
            **kw, **({"fault_plan": plan("port")} if plan else {}))
        out[name] = dict(
            res=res, jres=jres, codes=codes, jcodes=jcodes,
            names=_names(obs.get_tracer()) if traced else None,
            jnames=_names(jobs.get_tracer()) if traced else None,
            fleet=json.load(open(fleet / "port.json")),
            jfleet=json.load(open(fleet / "ref.json")))


def _ledger(res, wall=True):
    return [(r.round, r.cluster, r.client, r.participated, r.extra,
             r.wire_bytes, r.staleness) + ((r.wall_s,) if wall else ())
            for r in res.fleet.records]


@pytest.mark.parametrize("case", list(CASES))
def test_ledger_equals_reference(fits, case):
    f = fits[case]
    wall = case != "secure_f32"          # measured fit times there
    assert _ledger(f["res"], wall) == _ledger(f["jres"], wall)
    assert f["res"].fleet.rejections_by_reason() == \
        f["jres"].fleet.rejections_by_reason()
    want = {"plan": {"crash": 3, "hang": 3, "deadline": 2, "corrupt": 3,
                     "byzantine": 3, "stale": 1},
            "secure_int8": {"hang": 2, "crash": 1}}.get(case)
    if want is not None:
        assert f["res"].fleet.rejections_by_reason() == want
    else:
        rej = f["res"].fleet.rejections_by_reason()
        assert rej["deadline"] >= 1 and rej["sampled_out"] >= 1


def test_plan_buffers_applies_and_rejects_at_the_limit(fits):
    led = fits["plan"]["res"].fleet
    buffered = [(r.client, r.round, r.extra) for r in led.records
                if r.client in (5, 6) and r.extra]
    assert buffered == [
        (6, 0, {"reason": "deadline"}), (5, 0, {"reason": "deadline"}),
        (5, 1, {"buffered_staleness": 1}),
        (6, 2, {"reason": "stale", "staleness_rejected": True})]
    retried = [r for r in led.records if r.client == 2]
    assert all(r.participated and r.wall_s == 1.25 for r in retried)


@pytest.mark.parametrize("case", list(CASES))
def test_logs_and_adapters_within_tolerance(fits, case):
    res, jres = fits[case]["res"], fits[case]["jres"]
    assert len(res.logs) == len(jres.logs) > 0
    for log, jlog in zip(res.logs, jres.logs):
        assert (log.round, log.cluster) == (jlog.round, jlog.cluster)
        assert (log.comm.bytes_up, log.comm.bytes_down, log.comm.messages) \
            == (jlog.comm.bytes_up, jlog.comm.bytes_down,
                jlog.comm.messages)
        assert log.train_loss == pytest.approx(jlog.train_loss, rel=1e-5)
    assert res.fleet.wire_bytes_by_cluster() == {
        0: sum(l.comm.bytes_up for l in res.logs)}
    top = max(float(np.abs(np.asarray(x)).max())
              for x in jax.tree.leaves(jres.adapters_per_cluster))
    diffs = [np.abs(g.numpy() - np.asarray(w)) for g, w in zip(
        [t for ad in res.adapters_per_cluster
         for t in tree_util.leaves(ad)],
        [t for ad in jres.adapters_per_cluster
         for t in jax.tree.leaves(ad)])]
    assert all(np.isfinite(d).all() for d in diffs)
    worst = max(float(d.max()) for d in diffs)
    if CASES[case][2]["wire"] == "f32":
        assert worst <= 1e-4 * top, (worst, top)
    else:
        flipped = sum(int((d > 1e-4 * top).sum()) for d in diffs)
        total = sum(d.size for d in diffs)
        assert worst <= 2e-2, worst
        assert flipped <= total // 100, (flipped, total)


def test_secure_int8_code_sums_exact(fits):
    """Both sides unmask each round's survivors to the same code sum, and
    on each side that sum is the plain sum of the survivors' codes (the
    encodes run in cohort order: each round's participants, then the
    next round's)."""
    f = fits["secure_int8"]
    got, want = f["codes"].sums, f["jcodes"].sums
    assert len(got) == len(want) == 2
    for (s, total), (js, jtotal) in zip(got, want):
        assert s == js
        assert total.dtype == np.int32
        np.testing.assert_array_equal(total, jtotal)
    for side in (f["codes"], f["jcodes"]):
        encoded = iter(side.codes)
        for survivors, total in side.sums:
            codes = [next(encoded) for _ in survivors]
            np.testing.assert_array_equal(total, np.sum(codes, axis=0))
    assert [sorted(s) for s, _ in got] == [[0, 2, 3, 4, 5], [0, 2, 3, 5]]


def test_fit_telemetry_names_equal_reference(fits):
    """With tracing on, the port's fit emits the reference's span,
    instant, counter-track, counter, gauge and histogram names."""
    got, want = fits["plan"]["names"], fits["plan"]["jnames"]
    assert got == want
    assert {"fed.round", "fed.client_fit", "fed.aggregate",
            "client7.fit"} <= got["spans"]
    assert {"fault.crash", "fault.hang", "fault.transient", "fault.corrupt",
            "fault.byzantine", "fault.delay", "fed.reject",
            "fed.deadline_miss", "client0.skipped"} <= got["instants"]
    assert {"fed.rejected.corrupt", "fed.rejected.byzantine",
            "fed.rejected.stale", "fed.buffered", "fed.retries",
            "fed.wire_bytes"} == got["counters"]
    assert {"fed.ef_residual_norm", "fed.adapter_delta_norm"} <= got["hists"]


def test_fleet_json_matches_reference(fits):
    """``fleet_out`` writes the reference's schema: the same keys at every
    level, and the same integer roll-ups."""
    for case in CASES:
        got, want = fits[case]["fleet"], fits[case]["jfleet"]

        def keys(d):
            return {k: keys(v) if isinstance(v, dict) else None
                    for k, v in d.items()}

        assert keys(got) == keys(want)
        assert got["schema"] == "repro.fleet/v1"
        for c, cl in want["clusters"].items():
            for k in ("clients", "fits", "skipped", "rejections",
                      "wire_bytes"):
                assert got["clusters"][c][k] == cl[k], (case, k)
        assert got["fleet"]["wire_bytes"] == want["fleet"]["wire_bytes"]
