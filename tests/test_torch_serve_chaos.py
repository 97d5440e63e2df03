"""The port's fault-tolerant serving engine against the JAX package's, on
the CPU, at qwen3-0.6b's smoke config in f32 (the reference's weights
carried over by the bridge).

Each case of ``tests/test_serving_chaos.py`` drives both engines with the
same prompts, the same fault plan and the same virtual clock, and holds
the port to the reference:

  * finished records equal: ids, reasons and greedy tokens, bit for bit;
  * quarantine records equal (id, reason, step, prompt length, tokens
    before the screen fired), and the submit verdicts (shed victims and
    retry-after hints);
  * the fault-tolerance counters and the step and token counts of the
    metrics summary equal;
  * journals replay to equal states (the two files are not
    interchangeable: the reference writes msgpack, the port JSON).

Both engines run their defaults, the swap tier on.  Greedy decoding
only: the two samplers draw from different generators.

A resume (a journal replay here) is admitted differently: the reference
prefills the prompt and the generated tokens at once, the port prefills
the prompt and re-decodes the generated tokens through its batched step
(bit for bit the uninterrupted run's cache on the card, where one prefill
rounds differently in bf16).  So after a replay the tokens, reasons and
fault-tolerance counters are held equal, and the step, token and prefill
counts are not.
"""

import os
import struct
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.fault import FaultPlan as JaxFaultPlan
from repro.fault import ServingFaultPlan as JaxServingFaultPlan
from repro.fault.clock import VirtualClock as JaxVirtualClock
from repro.models.registry import get_model as jax_get_model
from repro.serve import ForecastEngine as JaxEngine
from repro.serve import Request as JaxRequest
from repro.serve import RequestJournal as JaxJournal
from repro.serve import SamplingParams as JaxSamplingParams
from repro.serve import replay_journal as jax_replay_journal
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.fault.clock import VirtualClock
from repro_torch.fault.plan import SERVE_FAULT_KINDS, ServingFaultPlan
from repro_torch.serve.engine import ForecastEngine
from repro_torch.serve.journal import RequestJournal, replay_journal
from repro_torch.serve.request import Request, SamplingParams

CACHE_LEN = 48

# counters of the metrics summary held equal between the two engines: the
# fault-tolerance ones always, the step and token ones where no request
# resumes
FT_COUNTERS = ("requests", "requests_submitted", "shed", "deadline_misses",
               "ttft_slo_misses", "quarantined")
COUNTERS = FT_COUNTERS + (
    "decode_steps", "decode_tokens", "prefill_tokens", "parked_events",
    "evictions", "share_hits", "full_prompt_hits", "cow_copies")


@pytest.fixture(autouse=True, scope="module")
def _torch_one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sides():
    """(reference side, port side): each a namespace of the engine's
    classes, its config and weights, and the extra engine arguments."""
    jcfg = jax_smoke_config("qwen3-0.6b")
    cfg = get_smoke_config("qwen3-0.6b")
    jparams = jax_get_model(jcfg).init(jcfg, jax.random.PRNGKey(0))
    params = bridge.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                    device="cpu")
    ref = SimpleNamespace(
        name="reference", cfg=jcfg, params=jparams, Engine=JaxEngine,
        Request=JaxRequest, Sampling=JaxSamplingParams,
        Clock=JaxVirtualClock, Journal=JaxJournal,
        replay=jax_replay_journal, kw={})
    port = SimpleNamespace(
        name="port", cfg=cfg, params=params, Engine=ForecastEngine,
        Request=Request, Sampling=SamplingParams, Clock=VirtualClock,
        Journal=RequestJournal, replay=replay_journal,
        kw=dict(device="cpu"))
    return ref, port


def _engine(side, **kw):
    return side.Engine(side.cfg, side.params, cache_len=kw.pop(
        "cache_len", CACHE_LEN), **side.kw, **kw)


def _prompts(vocab, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


def _outcome(eng, resumed=False):
    """What the two engines must agree on after a run (``resumed``: a run
    with resumes, whose step and token counts differ by design)."""
    summ = eng.metrics.summary()
    return {
        "finished": {k: (v.reason, v.tokens.tolist())
                     for k, v in sorted(eng.finished.items())},
        "quarantined": {k: (q.reason, q.step, q.prompt_len, q.generated)
                        for k, q in sorted(eng.quarantined.items())},
        "by_reason": dict(eng.metrics.quarantined),
        "counters": {k: summ[k]
                     for k in (FT_COUNTERS if resumed else COUNTERS)},
        "shed_log": dict(eng.shed_log),
        "free_slots": eng.pool.free_slots,
        "active": eng.active_requests,
    }


def _verdicts(vs):
    return [(v.id, v.verdict, v.shed_id, v.reason,
             round(v.retry_after_s, 9)) for v in vs]


def _both(sides, drive):
    """Run ``drive(side)`` on both sides; returns (reference's, port's)."""
    return tuple(drive(s) for s in sides)


# ---------------------------------------------------------------------------
# SLOs on the virtual clock
# ---------------------------------------------------------------------------

SLO_CASES = {
    # a deadline-busting request cancelled mid-decode, its neighbour intact
    "deadline_mid_decode": dict(
        lens=[6, 9], seed=11, slots=2, gens=[12, 5],
        slo=[dict(deadline_s=0.55), {}]),
    # a first-token SLO missed while queued behind a resident request
    "ttft_slo_queued": dict(
        lens=[6, 6], seed=12, slots=1, gens=[8, 4],
        slo=[{}, dict(ttft_slo_s=0.35)]),
}


@pytest.mark.parametrize("case", sorted(SLO_CASES))
def test_slo_cancellation_matches_reference(sides, case):
    c = SLO_CASES[case]

    def drive(side):
        prompts = _prompts(side.cfg.vocab_size, c["lens"], c["seed"])
        eng = _engine(side, num_slots=c["slots"], clock=side.Clock(),
                      step_time_s=0.1)
        vs = [eng.submit(side.Request(id=f"r{i}", prompt=p,
                                      max_new_tokens=g, **slo))
              for i, (p, g, slo) in enumerate(zip(prompts, c["gens"],
                                                  c["slo"]))]
        eng.run(max_steps=200)
        if eng.paged:
            eng.pool.assert_partition()
        return _verdicts(vs), _outcome(eng), eng.clock.now()

    want, got = _both(sides, drive)
    assert got == want
    reasons = {r for r, _ in got[1]["finished"].values()}
    assert reasons & {"deadline", "ttft_slo"}          # the SLO fired
    assert got[1]["free_slots"] == SLO_CASES[case]["slots"]


# ---------------------------------------------------------------------------
# load shedding
# ---------------------------------------------------------------------------

def test_load_shedding_order_matches_reference(sides):
    """Bounded queue of 2: cheapest-to-retry, newest-first victims, the
    same verdicts, shed log and retry hints, and the survivors' tokens."""
    def drive(side):
        prompts = _prompts(side.cfg.vocab_size, [6, 9, 6, 7, 6], seed=13)
        eng = _engine(side, num_slots=1, clock=side.Clock(), step_time_s=0.1,
                      max_queue=2)
        vs = [eng.submit(side.Request(id=f"s{i}", prompt=p,
                                      max_new_tokens=4))
              for i, p in enumerate(prompts)]
        eng.run(max_steps=200)
        return _verdicts(vs), _outcome(eng)

    want, got = _both(sides, drive)
    assert got == want
    assert [v[1] for v in got[0]] == ["ok", "ok", "shed", "ok", "shed"]
    assert set(got[1]["finished"]) == {"s1", "s3"}


def test_shedding_never_evicts_past_first_token_matches_reference(sides):
    def drive(side):
        prompts = _prompts(side.cfg.vocab_size, [6, 4], seed=14)
        eng = _engine(side, num_slots=1, max_queue=1)
        vs = [eng.submit(side.Request(
                  id="old", prompt=prompts[0], max_new_tokens=6,
                  resume={"generated": [3, 5], "prompt_len": 4})),
              eng.submit(side.Request(id="new", prompt=prompts[1],
                                      max_new_tokens=2))]
        return _verdicts(vs), [q.id for q in eng.scheduler.queued()]

    want, got = _both(sides, drive)
    assert got == want
    assert got[0][1][1] == "shed" and got[1] == ["old"]


# ---------------------------------------------------------------------------
# quarantine
# ---------------------------------------------------------------------------

def test_poison_quarantines_one_lane_matches_reference(sides):
    """NaN-poisoned logits quarantine only their lane; the neighbours,
    one of them in the poisoned decode step, decode as in the reference."""
    def drive(side):
        prompts = _prompts(side.cfg.vocab_size, [6, 9, 6, 11], seed=15)
        eng = _engine(side, num_slots=2)
        vs = [eng.submit(side.Request(id=f"r{i}", prompt=p,
                                      max_new_tokens=g))
              for i, (p, g) in enumerate(zip(prompts, [5, 6, 5, 4]))]
        eng.poison("r1")
        eng.run(max_steps=300)
        if eng.paged:
            eng.pool.assert_partition()
        return _verdicts(vs), _outcome(eng)

    want, got = _both(sides, drive)
    assert got == want
    assert got[1]["quarantined"]["r1"][0] == "nonfinite_logits"
    assert "r1" not in got[1]["finished"]
    assert set(got[1]["finished"]) == {"r0", "r2", "r3"}


def test_malformed_prompt_quarantined_at_submit_matches_reference(sides):
    plans = (JaxServingFaultPlan({0: "malformed"}, seed=3),
             ServingFaultPlan({0: "malformed"}, seed=3))

    def drive(side):
        plan = plans[side.name == "port"]
        good = _prompts(side.cfg.vocab_size, [7], seed=16)[0]
        bad = plan.malform_prompt(0, good, side.cfg.vocab_size)
        eng = _engine(side, num_slots=1)
        v = eng.submit(side.Request(id="m0", prompt=bad, max_new_tokens=4))
        return bad.tolist(), _verdicts([v]), eng.scheduler.pending, \
            _outcome(eng)

    want, got = _both(sides, drive)
    assert got == want
    assert got[1][0][1] == "quarantined" and got[2] == 0


# ---------------------------------------------------------------------------
# the write-ahead journal
# ---------------------------------------------------------------------------

def _state(st):
    """A JournalState in comparable form (the reference keeps a prompt as
    bytes, the port as a list)."""
    reqs = st.unfinished_requests()
    return dict(
        unfinished=st.unfinished_ids, tokens=st.tokens,
        finished=st.finished, torn=st.torn, records=st.records,
        requests=[(r.id, r.prompt.tolist(), r.resume, r.max_new_tokens,
                   r.deadline_s, r.ttft_slo_s, r.sampling.seed,
                   r.sampling.temperature) for r in reqs])


def test_journal_roundtrip_and_torn_tail_matches_reference(sides, tmp_path):
    """The same calls on both journals replay to the same state, before
    and after a torn tail, and an append-reopen truncates the tear."""
    def drive(side):
        path = str(tmp_path / f"{side.name}.jrnl")
        r0 = side.Request(id="a", prompt=[1, 2, 3], max_new_tokens=4,
                          deadline_s=2.0, sampling=side.Sampling(seed=7))
        r1 = side.Request(id="b", prompt=[4, 5], max_new_tokens=3,
                          ttft_slo_s=0.5)
        with side.Journal(path) as j:
            j.log_submit(r0)
            j.log_token("a", 11)
            j.log_submit(r1)
            j.log_token("b", 21)
            j.commit()
            j.log_finish("b", "length")
            j.log_finish("a", "shed")       # a shed retry: a new history
            j.log_submit(r0)
            j.log_token("a", 12)
        states = [_state(side.replay(path))]
        size = os.path.getsize(path)
        with open(path, "ab") as f:
            f.write(struct.pack("<II", 100, 0) + b"xx")
        states.append(_state(side.replay(path)))
        with side.Journal(path) as j:
            j.log_finish("a", "length")
        assert os.path.getsize(path) > size
        states.append(_state(side.replay(path)))
        return states

    want, got = _both(sides, drive)
    assert got == want
    assert got[0]["unfinished"] == ["a"] and not got[0]["torn"]
    assert got[1]["torn"] and got[2]["unfinished"] == []
    with open(tmp_path / "port.jrnl", "rb") as f:
        assert f.read(8) == b"RTJRNL01"


def test_journal_replay_resumes_matches_reference(sides, tmp_path):
    """An engine abandoned mid-trace, its journal replayed into a fresh
    engine: the same journal state on both sides, and the union of both
    generations' tokens equals the reference's."""
    def drive(side):
        path = str(tmp_path / f"replay-{side.name}.jrnl")
        prompts = _prompts(side.cfg.vocab_size, [6, 9, 6, 11], seed=17)
        eng1 = _engine(side, num_slots=2, journal=path)
        for i, (p, g) in enumerate(zip(prompts, [5, 3, 6, 4])):
            assert eng1.submit(side.Request(id=f"r{i}", prompt=p,
                                            max_new_tokens=g)).ok
        for _ in range(4):
            eng1.step()
        eng1.journal.close()
        st = side.replay(path)
        state = _state(st)
        eng2 = _engine(side, num_slots=2, journal=path)
        for r in st.unfinished_requests():
            assert eng2.submit(r).ok
        done2 = eng2.run(max_steps=300)
        eng2.journal.close()
        merged = {r: st.tokens[r] for r in st.finished}
        merged.update({r: d.tokens.tolist() for r, d in done2.items()})
        return state, _outcome(eng2, resumed=True), merged, \
            side.replay(path).unfinished_ids, \
            (eng2.metrics.prefill_tokens, sum(
                int((r.resume or {}).get("prompt_len", r.prompt_len))
                for r in st.unfinished_requests()))

    want, got = _both(sides, drive)
    assert got[:4] == want[:4]
    # the port prefills each resume's original prompt only
    assert got[4][0] == got[4][1] < want[4][0]
    assert 0 < len(got[0]["unfinished"]) < 4
    assert sorted(got[2]) == [f"r{i}" for i in range(4)]
    assert got[3] == []


# ---------------------------------------------------------------------------
# cancellation frees blocks in submit order
# ---------------------------------------------------------------------------

def test_cancellation_frees_blocks_in_submit_order_matches_reference(sides):
    """An SLO cancellation frees blocks mid-tick; with the slot-1 lane's
    submit order forced newest, the grant pass unparks the older lanes
    first on both engines, and every lane finishes as in the reference."""
    def drive(side):
        prompts = _prompts(side.cfg.vocab_size, [8, 8, 8, 8], seed=18)
        eng = _engine(side, num_slots=4, cache_len=32, paged=True,
                      block_size=8, pool_blocks=5, share_prefixes=False,
                      clock=side.Clock(), step_time_s=0.1)
        eng.submit(side.Request(id="r0", prompt=prompts[0],
                                max_new_tokens=10, deadline_s=0.25))
        for i in (1, 2, 3):
            eng.submit(side.Request(id=f"r{i}", prompt=prompts[i],
                                    max_new_tokens=6))
        for _ in range(3):
            eng.step()
        slot_of = {eng.slots[i].request.id: i
                   for i in range(4) if eng.slots[i] is not None}
        parked = [bool(eng._pos[slot_of[r]] < 0)
                  for r in ("r0", "r1", "r2", "r3")]
        eng._seq["r1"] = 99
        eng.step()
        after = {r: bool(eng._pos[slot_of[r]] >= 0)
                 for r in ("r1", "r2", "r3")}
        eng.run(max_steps=300)
        eng.pool.assert_partition()
        return parked, after, _outcome(eng)

    want, got = _both(sides, drive)
    assert got == want
    assert got[0] == [False, True, True, True]
    assert got[1] == {"r1": False, "r2": True, "r3": True}
    assert got[2]["finished"]["r0"][0] == "deadline"


# ---------------------------------------------------------------------------
# the chaos acceptance trace
# ---------------------------------------------------------------------------

def _chaos(side, plan, journal):
    """The reference acceptance test's trace: 16 staggered requests, 25%
    faults (malformed, poison, deadline, burst), a queue of 3 with
    shed-and-retry, on the virtual clock, journaled."""
    lens, gens = [6, 9, 7, 11], [5, 3, 6, 4]
    prompts = _prompts(side.cfg.vocab_size, [lens[i % 4] for i in range(16)],
                       seed=19)
    step_s = 0.1
    eng = _engine(side, num_slots=2, clock=side.Clock(), step_time_s=step_s,
                  max_queue=3, journal=journal)

    def build(i):
        kind = plan.kind_for(i)
        prompt = prompts[i]
        if kind == "malformed":
            prompt = plan.malform_prompt(i, prompt, side.cfg.vocab_size)
        return side.Request(id=f"c{i}", prompt=prompt,
                            max_new_tokens=gens[i % 4],
                            deadline_s=0.15 if kind == "deadline" else None)

    pending = sorted((0 if plan.kind_for(i) == "burst" else i // 2, i)
                     for i in range(16))
    events = []
    t = 0
    while pending or eng.scheduler.pending or eng.active_requests:
        assert t < 800, "chaos trace did not drain"
        still = []
        for due, i in pending:
            if due > t:
                still.append((due, i))
                continue
            v = eng.submit(build(i))
            events.append((t,) + _verdicts([v])[0])
            if plan.kind_for(i) == "poison" and v.ok:
                eng.poison(f"c{i}")
            if v.verdict == "shed":
                still.append((t + int(v.retry_after_s / step_s) + 1, i))
            elif v.shed_id is not None:
                j = int(v.shed_id[1:])
                still.append(
                    (t + int(eng.shed_log[v.shed_id] / step_s) + 1, j))
        pending = sorted(still)
        eng.step()
        t += 1
    if eng.paged:
        eng.pool.assert_partition()
    eng.journal.close()
    return events, _outcome(eng), _state(side.replay(journal)), t


def test_chaos_acceptance_trace_matches_reference(sides, tmp_path):
    plan_args = ({2: "malformed", 5: "poison", 9: "deadline", 12: "burst"},
                 5)
    plans = (JaxServingFaultPlan(*plan_args), ServingFaultPlan(*plan_args))
    want, got = (
        _chaos(s, plans[s.name == "port"],
               str(tmp_path / f"chaos-{s.name}.jrnl")) for s in sides)
    assert got == want
    events, out, state, _ = got
    assert set(out["quarantined"]) == {"c2", "c5"}
    assert out["quarantined"]["c2"][0] == "malformed_prompt"
    assert out["quarantined"]["c5"][0] == "nonfinite_logits"
    assert out["finished"]["c9"][0] == "deadline"
    assert set(out["finished"]) | set(out["quarantined"]) == \
        {f"c{i}" for i in range(16)}
    assert out["counters"]["shed"] == sum(
        1 for e in events if e[2] == "shed" or e[3] is not None)
    assert state["unfinished"] == []


def test_random_serving_plan_matches_reference():
    a = ServingFaultPlan.random(40, 0.3, seed=4)
    assert a == ServingFaultPlan.random(40, 0.3, seed=4)
    assert a.faults == JaxFaultPlan.random_serving(40, 0.3, seed=4).faults
    assert a.faults == JaxServingFaultPlan.random(40, 0.3, seed=4).faults
    assert all(k in SERVE_FAULT_KINDS[:4] for k in a.faults.values())
    assert ServingFaultPlan.random(40, 0.3, seed=9) != a
    with pytest.raises(ValueError):
        ServingFaultPlan({0: "meteor"})
    good = np.arange(7, dtype=np.int32)
    assert (ServingFaultPlan({1: "malformed"}, seed=3)
            .malform_prompt(1, good, 50).tolist()
            == JaxServingFaultPlan({1: "malformed"}, seed=3)
            .malform_prompt(1, good, 50).tolist())
