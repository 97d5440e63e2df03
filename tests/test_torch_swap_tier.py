"""The port's host swap tier against the JAX package's, on the CPU, at the
smoke configs of both served architectures in f32 (qwen3-0.6b, G = 2;
fedtime-llama2-7b, G = 1), the reference's weights carried over by the
bridge.

A pool cut below the lanes' joint footprint parks lanes; when nothing is
runnable the youngest parked lane leaves the pool.  With the swap tier on
(the default of both engines) it is snapshotted, requeued and restored
with no recompute.  Held exactly against the reference: the finished
tokens, the swap / evict / park / admit counters and the swap bytes.  The
port's own cases of ``tests/test_prefix_share.py`` (round trip against a
never-swapped run, the recompute fallback with the tier off, FIFO requeue
of same-tick victims, the flags refused without a paged pool) and a
deadline cancel of a swapped request follow.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.fault.clock import VirtualClock as JaxVirtualClock
from repro.models.registry import get_model as jax_get_model
from repro.serve import ForecastEngine as JaxEngine
from repro.serve import Request as JaxRequest
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.fault.clock import VirtualClock
from repro_torch.serve.engine import ForecastEngine
from repro_torch.serve.request import Request
from repro_torch.serve.scheduler import FIFOScheduler

CACHE_LEN = 48
ARCHS = ["qwen3-0.6b", "fedtime-llama2-7b"]
COUNTERS = ("requests", "decode_steps", "decode_tokens", "prefill_tokens",
            "parked_events", "evictions", "share_hits", "full_prompt_hits",
            "cow_copies", "swap_outs", "swap_out_bytes", "swap_ins",
            "swap_in_bytes")


@pytest.fixture(autouse=True, scope="module")
def _torch_one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=ARCHS)
def sides(request):
    """(reference, port): each (engine class, request class, clock class,
    config, weights, extra engine arguments)."""
    jcfg = jax_smoke_config(request.param)
    cfg = get_smoke_config(request.param)
    jparams = jax_get_model(jcfg).init(jcfg, jax.random.PRNGKey(0))
    params = bridge.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                    device="cpu")
    return ((JaxEngine, JaxRequest, JaxVirtualClock, jcfg, jparams, {}),
            (ForecastEngine, Request, VirtualClock, cfg, params,
             dict(device="cpu")))


def _prompts(vocab, seed=19):
    rng = np.random.default_rng(seed)
    core = rng.integers(0, vocab, 22).astype(np.int32)
    return {"identical": [core] * 4,
            "mixed": [core, core] + [rng.integers(0, vocab, n).astype(
                np.int32) for n in (17, 20)]}


def _run(side, prompts, *, gen=8, check_fifo=False, **kw):
    Engine, Req, _, cfg, params, extra = side
    eng = Engine(cfg, params, num_slots=8, cache_len=CACHE_LEN, paged=True,
                 block_size=8, **extra, **kw)
    for i, p in enumerate(prompts):
        eng.submit(Req(id=f"u{i}", prompt=p, max_new_tokens=gen))
    while eng.scheduler.pending or eng.active_requests:
        assert eng.step_count < 500, "engine did not drain"
        eng.step()
        if check_fifo:
            # displaced and queued requests stay in original submit order
            seqs = [eng._seq[r.id] for r in eng.scheduler.queued()]
            assert seqs == sorted(seqs), seqs
    eng.pool.assert_partition()
    assert eng.pool.blocks_in_use == 0
    summ = eng.metrics.summary()
    return ({k: v.tokens.tolist() for k, v in eng.finished.items()},
            {k: summ[k] for k in COUNTERS}, eng)


@pytest.mark.parametrize("trace,pool_blocks,gen",
                         [("identical", 4, 8), ("mixed", 4, 10),
                          ("mixed", 6, 10)])
def test_swap_tier_matches_reference(sides, trace, pool_blocks, gen):
    """Both engines with their default (tier on) over a pool that parks:
    tokens, counters and swap bytes exact."""
    ref, port = sides
    prompts = _prompts(port[3].vocab_size)[trace]
    want = _run(ref, prompts, gen=gen, pool_blocks=pool_blocks)
    got = _run(port, prompts, gen=gen, pool_blocks=pool_blocks)
    assert got[2].swap_tier and want[2].swap_tier
    assert got[:2] == want[:2]
    assert got[1]["swap_outs"] >= 1 and got[1]["evictions"] == 0
    assert got[1]["swap_ins"] == got[1]["swap_outs"]


def test_swap_roundtrip_matches_never_swapped(sides):
    """Identical prompts on a pool too small for simultaneous growth: lanes
    swap to host and back, never recompute, and every output equals the
    full-pool run bit for bit, with the queue in FIFO order on every
    tick."""
    port = sides[1]
    prompts = _prompts(port[3].vocab_size)["identical"]
    base, _, _ = _run(port, prompts, share_prefixes=False, swap_tier=False)
    tight, counts, eng = _run(port, prompts, share_prefixes=True,
                              swap_tier=True, pool_blocks=4, check_fifo=True)
    assert tight == base
    assert counts["swap_outs"] > 0 and counts["swap_ins"] > 0
    assert counts["evictions"] == 0          # swap replaced recompute
    assert counts["swap_out_bytes"] > 0 and counts["swap_in_bytes"] > 0
    assert not eng.swap and not eng._swap_pending
    for fin in eng.finished.values():        # TTFT from the first submit
        assert fin.ttft_s >= 0


def test_swap_disabled_falls_back_to_recompute(sides):
    port = sides[1]
    prompts = _prompts(port[3].vocab_size)["identical"]
    base, _, _ = _run(port, prompts, share_prefixes=False, swap_tier=False)
    rec, counts, _ = _run(port, prompts, share_prefixes=True,
                          swap_tier=False, pool_blocks=4, check_fifo=True)
    assert rec == base
    assert counts["evictions"] > 0 and counts["swap_outs"] == 0


def test_swap_tier_env_switch(sides, monkeypatch):
    """``REPRO_SWAP_TIER=0`` turns the default off; an explicit argument
    wins over it."""
    Engine, _, _, cfg, params, extra = sides[1]
    monkeypatch.setenv("REPRO_SWAP_TIER", "0")
    assert not Engine(cfg, params, **extra).swap_tier
    assert Engine(cfg, params, swap_tier=True, **extra).swap_tier
    monkeypatch.delenv("REPRO_SWAP_TIER")
    assert Engine(cfg, params, **extra).swap_tier


def test_requeue_front_batch_preserves_fifo():
    sched = FIFOScheduler()
    reqs = [Request(id=f"r{i}", prompt=np.zeros(4, np.int32),
                    max_new_tokens=2) for i in range(3)]
    sched.requeue_front(reqs)                  # one batched call
    out = sched.admit(now_step=0, free_slots=3, tokens_in_flight=0)
    assert [r.id for r in out] == ["r0", "r1", "r2"]


def test_flags_require_paged(sides):
    Engine, _, _, cfg, params, extra = sides[1]
    with pytest.raises(ValueError, match="paged"):
        Engine(cfg, params, num_slots=2, cache_len=CACHE_LEN, paged=False,
               share_prefixes=True, **extra)
    with pytest.raises(ValueError, match="paged"):
        Engine(cfg, params, num_slots=2, cache_len=CACHE_LEN, paged=False,
               swap_tier=True, **extra)
    eng = Engine(cfg, params, num_slots=2, cache_len=CACHE_LEN, paged=False,
                 **extra)
    assert not eng.swap_tier


def test_deadline_cancel_of_swapped_request_matches_reference(sides):
    """A request swapped out and then past its deadline while queued: the
    SLO sweep drops its handle and frees no block (its blocks went at the
    swap-out); the rest of the trace finishes as in the reference."""
    def drive(side):
        Engine, Req, Clock, cfg, params, extra = side
        prompts = _prompts(cfg.vocab_size)["identical"]
        eng = Engine(cfg, params, num_slots=8, cache_len=CACHE_LEN,
                     paged=True, block_size=8, pool_blocks=4,
                     clock=Clock(), step_time_s=0.1, **extra)
        for i, p in enumerate(prompts):
            eng.submit(Req(id=f"u{i}", prompt=p, max_new_tokens=8))
        while not eng.swap:
            assert eng.step_count < 100, "no lane was swapped out"
            eng.step()
        victim = next(iter(eng.swap))
        (queued,) = [q for q in eng.scheduler.queued() if q.id == victim]
        queued.deadline_s = 1e-6               # already past on the clock
        free, used = eng.pool.free_blocks, eng.pool.blocks_in_use
        eng._slo_sweep()
        swept = (victim in eng.swap, eng.pool.free_blocks - free,
                 eng.pool.blocks_in_use - used)
        eng.run(max_steps=300)
        eng.pool.assert_partition()
        summ = eng.metrics.summary()
        return (victim, swept, eng.finished[victim].reason,
                {k: v.tokens.tolist() for k, v in eng.finished.items()},
                {k: summ[k] for k in COUNTERS + ("deadline_misses",)},
                len(eng.swap), eng.pool.blocks_in_use)

    want, got = (drive(s) for s in sides)
    assert got == want
    assert got[1] == (False, 0, 0) and got[2] == "deadline"
    assert got[5] == 0 and got[6] == 0
