"""The port's federated fault plans (``repro_torch.fault.plan.FaultPlan``)
and staleness buffer (``repro_torch.core.server.StalenessBuffer``) against
the JAX package's, on the CPU.

Everything here is equal exactly: plans are plain data drawn with numpy,
attempts are float sums in the same order, the mutated deltas set the same
element to NaN/Inf or multiply by the same f32 scale, and the buffer's
drain is integer and float bookkeeping done the same way.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.server import BufferedDelta as JBufferedDelta
from repro.core.server import StalenessBuffer as JStalenessBuffer
from repro.fault import Fault as JFault
from repro.fault import FaultPlan as JFaultPlan
from repro_torch import bridge
from repro_torch.core.server import BufferedDelta, StalenessBuffer
from repro_torch.fault import FAULT_KINDS, Fault, FaultPlan, VirtualClock


def _as_ref(plan: FaultPlan) -> JFaultPlan:
    return JFaultPlan({c: [JFault(**dataclasses.asdict(f)) for f in fs]
                       for c, fs in plan.faults.items()},
                      base_fit_s=plan.base_fit_s, seed=plan.seed)


def _fields(plan):
    return {c: [dataclasses.astuple(f) for f in fs]
            for c, fs in plan.faults.items()}


def test_fault_plan_timing():
    plan = FaultPlan({
        1: [Fault("delay", delay_s=2.0)],
        2: [Fault("transient", fails=2, backoff_s=0.25)],
        3: [Fault("crash")],
        4: [Fault("hang")],
    }, base_fit_s=1.0)
    assert plan.attempt(0, 0, 99.0).virtual_s == 1.0   # base_fit_s overrides
    assert plan.attempt(1, 0, 0.0).virtual_s == 3.0
    att = plan.attempt(2, 0, 0.0)       # (1 + .25) + (1 + .5), then the fit
    assert att.virtual_s == pytest.approx(3.75) and att.retries == 2
    assert not plan.attempt(3, 0, 0.0).uploads
    assert np.isinf(plan.attempt(4, 0, 0.0).virtual_s)
    assert not plan.will_upload(3, 0) and not plan.will_upload(4, 0)
    assert plan.will_upload(2, 0)
    with pytest.raises(ValueError):
        Fault("meteor")
    assert FAULT_KINDS == ("crash", "hang", "transient", "corrupt",
                           "byzantine", "delay")


@pytest.mark.parametrize("seed", [0, 1, 3, 7])
@pytest.mark.parametrize("base", [1.0, None])
def test_random_plans_and_attempts_equal_reference(seed, base):
    """``random`` draws the reference's plan; every (client, round)
    attempt, kinds and upload verdict then equal the reference's."""
    plan = FaultPlan.random(32, 0.3, 4, seed=seed)
    jplan = JFaultPlan.random(32, 0.3, 4, seed=seed)
    assert _fields(plan) == _fields(jplan)
    assert plan.fault_rate(32) == jplan.fault_rate(32)
    assert FaultPlan.random(32, 0.3, 4, seed=seed).faults == plan.faults
    plan.base_fit_s = jplan.base_fit_s = base
    for c in range(32):
        for r in range(4):
            got, want = plan.attempt(c, r, 0.37), jplan.attempt(c, r, 0.37)
            assert dataclasses.astuple(got) == dataclasses.astuple(want)
            assert got.uploads == want.uploads
            assert plan.kinds_for(c, r) == jplan.kinds_for(c, r)
            assert plan.will_upload(c, r) == jplan.will_upload(c, r)


def test_round_scoping_and_slow_clients_shim():
    plan = FaultPlan({0: [Fault("crash", rounds=frozenset({1}))]})
    assert plan.will_upload(0, 0) and not plan.will_upload(0, 1)
    assert plan.kinds_for(0, 1) == ("crash",) and plan.kinds_for(0, 0) == ()
    slow = FaultPlan.from_slow_clients({3: 30.0, 5: 0.4})
    jslow = JFaultPlan.from_slow_clients({3: 30.0, 5: 0.4})
    assert _fields(slow) == _fields(jslow) and slow.base_fit_s is None
    for c in (3, 5, 6):
        assert dataclasses.astuple(slow.attempt(c, 0, 0.125)) == \
            dataclasses.astuple(jslow.attempt(c, 0, 0.125))


@pytest.mark.parametrize("faults", [
    [Fault("corrupt")], [Fault("corrupt", mode="inf")],
    [Fault("byzantine", scale=1e3)], [Fault("delay", delay_s=1.0)],
    [Fault("corrupt", rounds=frozenset({0})), Fault("byzantine")]])
@pytest.mark.parametrize("round_idx", [0, 1])
def test_mutate_delta_equals_reference(faults, round_idx):
    rng = np.random.default_rng(4)
    delta = {"a": rng.normal(size=(4, 3)).astype(np.float32),
             "b": {"c": rng.normal(size=(5,)).astype(np.float32),
                   "d": np.zeros((0,), np.float32)}}
    plan = FaultPlan({2: faults})
    tdelta = bridge.tree_to_torch(delta, "cpu")
    got = plan.mutate_delta(2, round_idx, tdelta)
    want = _as_ref(plan).mutate_delta(2, round_idx,
                                      jax.tree.map(jnp.asarray, delta))
    for path in (("a",), ("b", "c"), ("b", "d")):
        g, w = got, want
        for k in path:
            g, w = g[k], w[k]
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the caller's tree is never written
    np.testing.assert_array_equal(tdelta["a"].numpy(), delta["a"])
    assert plan.mutate_delta(9, round_idx, tdelta) is tdelta


def test_virtual_clock():
    clk = VirtualClock()
    clk.advance(1.5)
    clk.advance_to(1.0)                    # never goes backward
    assert clk.now() == 1.5
    assert clk.advance_to(4.0) == 4.0
    with pytest.raises(ValueError):
        clk.advance(-1.0)


# ---------------------------------------------------------------------------
# staleness buffer
# ---------------------------------------------------------------------------

def _both(limit, decay, entries):
    buf, jbuf = StalenessBuffer(limit, decay), JStalenessBuffer(limit, decay)
    d = {"w": torch.ones(2)}
    for e in entries:
        buf.add(BufferedDelta(*e, delta=d))
        jbuf.add(JBufferedDelta(*e, delta={"w": np.ones(2, np.float32)}))
    return buf, jbuf


def _drained(out):
    apply, reject = out
    return ([(e.client, e.origin_round, w) for e, w in apply],
            [(e.client, e.origin_round, s) for e, s in reject])


def test_staleness_buffer_unit_equals_reference():
    entries = [(1, 0, 0, 1.0, 4.0, 0.1), (2, 0, 0, 9.0, 1.0, 0.1),
               (3, 1, 0, 1.0, 1.0, 0.1), (4, 0, 1, 2.5, 2.0, 0.2)]
    buf, jbuf = _both(3, 0.5, entries)
    for cluster, r, end in ((0, 1, 2.0), (1, 1, 2.0), (0, 2, 3.0),
                            (0, 5, 100.0)):
        got = _drained(buf.drain(cluster, r, end))
        assert got == _drained(jbuf.drain(cluster, r, end))
        assert len(buf) == len(jbuf)
    assert len(buf) == 0
    # the first drain applies client 1 at 4.0 * 0.5**1; the last rejects
    # client 2 at staleness 5
    buf, _ = _both(3, 0.5, entries)
    assert _drained(buf.drain(0, 1, 2.0)) == ([(1, 0, 2.0)], [])
    with pytest.raises(ValueError):
        buf.add(BufferedDelta(9, 0, 0, float("inf"), 1.0, 0.0, None))
    with pytest.raises(ValueError):
        StalenessBuffer(limit=-1)
    with pytest.raises(ValueError):
        StalenessBuffer(decay=0.0)


@pytest.mark.parametrize("limit", [1, 2, 3])
def test_staleness_limit_boundary_equals_reference(limit):
    """``limit`` is exclusive on both paths: ``is_stale`` at staleness ==
    limit, and a drain at that staleness rejects; one round younger
    applies (when the limit lets anything apply)."""
    buf, jbuf = StalenessBuffer(limit), JStalenessBuffer(limit)
    for s in range(0, 5):
        assert buf.is_stale(s) == jbuf.is_stale(s) == (s >= limit)
        assert buf.staleness_of(s, 0) == jbuf.staleness_of(s, 0)
    for r in (limit - 1, limit):
        buf, jbuf = _both(limit, 0.5, [(7, 0, 0, 1.0, 1.0, 0.1)])
        got = _drained(buf.drain(0, r, 5.0))
        assert got == _drained(jbuf.drain(0, r, 5.0))
        stale = max(r, 1) >= limit
        assert bool(got[1]) == stale and bool(got[0]) == (not stale)
