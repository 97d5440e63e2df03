"""The port's serving engine and sampling against the JAX package and
against its own invariants, on the smoke configs of both served
architectures in f32 (weights carried over from the reference by the
bridge): qwen3-0.6b (GQA, G = 2, D 64) and fedtime-llama2-7b (MHA, G = 1,
D 32), each a case of every engine test.

  * on the reference launcher's smoke trace the port engine's greedy tokens
    equal the JAX engine's;
  * the engine equals each request decoded alone, bit for bit, and the
    paged pool equals contiguous lanes bit for bit;
  * on the cluster-skew trace of benchmarks/serving_bench.py copy-on-write
    fires and the shared run equals the unshared one, each event one block
    copy of every leaf (``ops.block_copy_leaves``);
  * sampling: top-k / top-p masks equal JAX's, temperature 0 is the argmax,
    and sampled frequencies pass a chi-square test against the softmax.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.launch.serve import make_trace as jax_make_trace
from repro.models.registry import get_model as jax_get_model
from repro.serve import ForecastEngine as JaxEngine
from repro.serve import Request as JaxRequest
from repro.serve.sampling import sample_vec as jax_sample_vec
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import ops
from repro_torch.launch.serve import make_trace
from repro_torch.launch.steps import make_serve_step
from repro_torch.models.registry import get_model
from repro_torch.serve.engine import ForecastEngine
from repro_torch.serve.request import Request, SamplingParams
from repro_torch.serve.sampling import (masked_logits, row_generator,
                                        sample_vec)

CACHE_LEN = 48
ARCHS = ["qwen3-0.6b", "fedtime-llama2-7b"]


@pytest.fixture(autouse=True, scope="module")
def _torch_one_thread():
    """The shapes here are tiny: one intra-op thread, so that parallel test
    workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=ARCHS)
def dense(request):
    jcfg = jax_smoke_config(request.param)
    cfg = get_smoke_config(request.param)
    jparams = jax_get_model(jcfg).init(jcfg, jax.random.PRNGKey(0))
    params = bridge.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                    device="cpu")
    return jcfg, jparams, cfg, params


def _run(cfg, params, reqs, **kw):
    eng = ForecastEngine(cfg, params, device="cpu", **kw)
    for r in reqs:
        eng.submit(Request(**r))
    done = eng.run(max_steps=500)
    return {k: v.tokens.tolist() for k, v in done.items()}, eng


def _solo_greedy(cfg, params, prompt, gen, cache_len=CACHE_LEN):
    """One request alone: batch-1 prefill, then the serve step."""
    api = get_model(cfg)
    cache, logits = api.prefill(params, cfg,
                                {"tokens": torch.as_tensor(prompt[None])},
                                cache_len=cache_len)
    step = make_serve_step(cfg)
    tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    out = [int(tok)]
    for i in range(gen - 1):
        tok, cache = step(params, cache,
                          {"token": tok,
                           "pos": torch.tensor([len(prompt) + i])})
        out.append(int(tok))
    return out


def _trace(cfg):
    return make_trace(cfg, 6, gen=6, max_prompt=16, rate=0.5, seed=0)


def test_trace_matches_reference_launcher(dense):
    _, _, cfg, _ = dense
    jcfg = dense[0]
    assert _trace(cfg) == jax_make_trace(jcfg, 6, gen=6, max_prompt=16,
                                         rate=0.5, seed=0)


def test_engine_greedy_matches_jax_engine(dense):
    jcfg, jparams, cfg, params = dense
    trace = _trace(cfg)
    jeng = JaxEngine(jcfg, jparams, num_slots=4, cache_len=CACHE_LEN)
    for r in trace:
        jeng.submit(JaxRequest(id=r["id"], prompt=r["prompt"],
                               max_new_tokens=r["max_new_tokens"],
                               arrival_step=r["arrival_step"]))
    want = {k: v.tokens.tolist() for k, v in jeng.run(max_steps=500).items()}
    got, _ = _run(cfg, params, [dict(r) for r in trace], num_slots=4,
                  cache_len=CACHE_LEN)
    assert got == want


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contig"])
def test_engine_matches_solo(dense, paged):
    """Staggered requests through 2 slots (lane reuse) decode exactly as
    each request alone."""
    _, _, cfg, params = dense
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (6, 9, 6, 11, 9)]
    gens = [5, 3, 6, 4, 5]
    want = {f"r{i}": _solo_greedy(cfg, params, p, g)
            for i, (p, g) in enumerate(zip(prompts, gens))}
    reqs = [dict(id=f"r{i}", prompt=p, max_new_tokens=g, arrival_step=i)
            for i, (p, g) in enumerate(zip(prompts, gens))]
    got, eng = _run(cfg, params, reqs, num_slots=2, cache_len=CACHE_LEN,
                    paged=paged)
    assert got == want
    assert eng.metrics.requests_finished == 5


def test_paged_equals_contiguous(dense):
    _, _, cfg, params = dense
    reqs = [dict(id=r["id"], prompt=r["prompt"],
                 max_new_tokens=r["max_new_tokens"],
                 arrival_step=r["arrival_step"]) for r in _trace(cfg)]
    paged, eng_p = _run(cfg, params, reqs, num_slots=3, cache_len=CACHE_LEN,
                        paged=True, block_size=8)
    contig, _ = _run(cfg, params, reqs, num_slots=3, cache_len=CACHE_LEN,
                     paged=False)
    assert paged == contig
    eng_p.pool.assert_partition()
    assert eng_p.pool.blocks_in_use == 0


def _cluster_skew(cfg):
    """benchmarks/serving_bench.py::_cluster_skew_case (full=False): three
    clusters, each a donor, a divergent tail and two identical replays.  The
    22-token core ends inside its third 8-slot block, so a replay's first
    own token lands in a shared block and copy-on-write fires."""
    core_len, tail_len, n_clusters, n_dups = 22, 6, 3, 2
    rng = np.random.default_rng(7)
    cores = [rng.integers(0, cfg.vocab_size, core_len).astype(np.int32)
             for _ in range(n_clusters)]
    reqs = []
    for c in range(n_clusters):
        reqs.append(dict(id=f"c{c}d", prompt=cores[c], arrival_step=c))
        reqs.append(dict(id=f"c{c}t", prompt=np.concatenate(
            [cores[c], rng.integers(0, cfg.vocab_size, tail_len)
             .astype(np.int32)]), arrival_step=n_clusters))
        for u in range(n_dups):
            reqs.append(dict(id=f"c{c}u{u}", prompt=cores[c],
                             arrival_step=n_clusters + 1 + u))
    for r in reqs:
        r["max_new_tokens"] = 8
    return reqs, n_clusters * (n_dups + 2)


def test_cluster_skew_cow_matches_unshared(dense):
    _, _, cfg, params = dense
    reqs, slots = _cluster_skew(cfg)
    kw = dict(num_slots=slots, cache_len=CACHE_LEN, paged=True,
              block_size=8, pool_blocks=18)
    base, eng_b = _run(cfg, params, reqs, share_prefixes=False, **kw)
    shared, eng_s = _run(cfg, params, reqs, share_prefixes=True, **kw)
    assert shared == base
    m = eng_s.metrics
    assert m.cow_copies >= 1 and m.full_prompt_hits >= 1
    assert m.prefill_tokens < eng_b.metrics.prefill_tokens
    eng_s.pool.assert_partition()
    assert eng_s.pool.blocks_in_use == 0


def test_cow_event_is_one_block_copy_of_every_leaf(dense, monkeypatch):
    """Each copy-on-write event is one ``ops.block_copy_leaves`` call over
    every leaf of the pool (on the card, one kernel launch), and the shared
    run still matches the unshared one."""
    _, _, cfg, params = dense
    reqs, slots = _cluster_skew(cfg)
    kw = dict(num_slots=slots, cache_len=CACHE_LEN, paged=True,
              block_size=8, pool_blocks=18)
    calls = []
    real = ops.block_copy_leaves

    def counted(leaves, src, dst):
        leaves = list(leaves)
        calls.append((len(leaves), src, dst))
        return real(leaves, src, dst)

    monkeypatch.setattr("repro_torch.kernels.ops.block_copy_leaves", counted)
    shared, eng = _run(cfg, params, reqs, share_prefixes=True, **kw)
    monkeypatch.undo()
    base, _ = _run(cfg, params, reqs, share_prefixes=False, **kw)
    assert shared == base
    assert len(calls) == eng.metrics.cow_copies >= 1
    assert all(n == len(eng.pool.cache) and s != d for n, s, d in calls)
    eng.pool.assert_partition()


def test_failed_cow_copy_raises_without_leaking(dense, monkeypatch):
    """A block copy that fails (a kernel that does not build or launch) is
    not taken for pool exhaustion: the engine re-raises, and the block
    allocated for the copy goes back to the free list."""
    _, _, cfg, params = dense
    reqs, slots = _cluster_skew(cfg)

    def broken_copy(leaves, src, dst):
        raise RuntimeError("block copy kernel launch failed (code 98)")

    monkeypatch.setattr("repro_torch.kernels.ops.block_copy_leaves",
                        broken_copy)
    eng = ForecastEngine(cfg, params, device="cpu", num_slots=slots,
                         cache_len=CACHE_LEN, paged=True, block_size=8,
                         pool_blocks=18)
    for r in reqs:
        eng.submit(Request(**r))
    with pytest.raises(RuntimeError, match="code 98"):
        eng.run(max_steps=500)
    assert eng.metrics.cow_copies == 0 and eng.metrics.parked_events == 0
    eng.pool.assert_partition()


def test_failed_prefill_raises(dense, monkeypatch):
    """An error in prefill propagates at once; it is not requeued as if the
    pool had raced below the admission price."""
    _, _, cfg, params = dense
    eng = ForecastEngine(cfg, params, device="cpu", num_slots=2,
                         cache_len=CACHE_LEN)

    def broken_prefill(tokens, true_len):
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(eng, "_prefill", broken_prefill)
    eng.submit(Request(id="r", prompt=np.arange(6, dtype=np.int32),
                       max_new_tokens=3))
    with pytest.raises(RuntimeError, match="illegal memory access"):
        eng.run(max_steps=500)
    assert eng.step_count == 0


def test_unported_engine_options_raise(dense, tmp_path):
    """Every engine option is taken: the swap tier (refused, as in the
    reference, without a paged pool), the fault-tolerance options and
    request SLOs (a non-positive SLO is a caller error, as in the
    reference)."""
    _, _, cfg, params = dense
    assert ForecastEngine(cfg, params, device="cpu", swap_tier=True).swap_tier
    with pytest.raises(ValueError, match="paged"):
        ForecastEngine(cfg, params, device="cpu", paged=False, swap_tier=True)
    for kw in (dict(journal=str(tmp_path / "j.log")), dict(max_queue=4),
               dict(default_deadline_s=1.0), dict(default_ttft_slo_s=0.5)):
        eng = ForecastEngine(cfg, params, device="cpu", **kw)
        if eng.journal is not None:
            eng.journal.close()
    assert Request(id="x", prompt=[1, 2], max_new_tokens=2,
                   deadline_s=1.0).deadline_s == 1.0
    with pytest.raises(ValueError):
        Request(id="x", prompt=[1, 2], max_new_tokens=2, ttft_slo_s=0.0)


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

V = 16
_jax_sample_vec = jax.jit(lambda keys, lg, t, k, p: jax_sample_vec(
    keys, lg, temperature=t, top_k=k, top_p=p))
MASK_CASES = [(5, 0.0), (0, 0.6), (10, 0.8), (40, 1.0)]


@pytest.mark.parametrize("top_k,top_p", MASK_CASES)
def test_masks_equal_jax(top_k, top_p):
    """The support the port keeps equals the set of tokens JAX's
    ``sample_vec`` draws in 2000 tries (every kept token has probability
    >= 1.5%, so each is drawn with probability > 1 - 1e-13)."""
    logits = np.linspace(-1.0, 1.0, V).astype(np.float32)
    np.random.default_rng(3).shuffle(logits)
    n = 2000
    keys = jax.random.split(jax.random.PRNGKey(0), n)
    row = np.full((n,), 1.0, np.float32)
    toks = _jax_sample_vec(keys, jnp.asarray(np.tile(logits, (n, 1))),
                           row, np.full((n,), top_k, np.int32),
                           np.full((n,), top_p, np.float32))
    jax_support = set(np.asarray(toks).tolist())
    lg = masked_logits(torch.from_numpy(logits[None]), temperature=[1.0],
                       top_k=[top_k], top_p=[top_p])
    keep = lg[0] > torch.finfo(torch.float32).min
    assert set(torch.nonzero(keep).flatten().tolist()) == jax_support


def test_temperature_zero_is_argmax():
    logits = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (5, V)).astype(np.float32))
    gens = [row_generator(0, t, "cpu") for t in range(5)]
    toks = sample_vec(logits, temperature=[0.0] * 5, top_k=[3] * 5,
                      top_p=[0.5] * 5, generators=gens)
    assert toks.tolist() == logits.argmax(-1).tolist()


@pytest.mark.parametrize("top_k,top_p", [(0, 0.0), (6, 0.9)])
def test_sampled_frequencies_match_softmax(top_k, top_p):
    """Chi-square goodness of fit of 2000 draws (one generator per draw)
    against the softmax of the masked logits; the bound is the 0.999
    quantile of chi-square with (kept - 1) degrees of freedom
    (Wilson-Hilferty, within 2% for 3+ degrees), so a correct sampler fails
    one seed in a thousand (the seeds here are fixed)."""
    logits = np.linspace(-1.5, 1.5, V).astype(np.float32)
    temp, n = 0.7, 2000
    lt = torch.from_numpy(np.tile(logits, (n, 1)))
    gens = [row_generator(s, 0, "cpu") for s in range(n)]
    toks = sample_vec(lt, temperature=[temp] * n, top_k=[top_k] * n,
                      top_p=[top_p] * n, generators=gens).numpy()
    lg = masked_logits(torch.from_numpy(logits[None]), temperature=[temp],
                       top_k=[top_k], top_p=[top_p])[0]
    p = torch.softmax(lg, -1).numpy()
    kept = p > 0
    assert set(np.unique(toks)) <= set(np.nonzero(kept)[0])
    counts = np.bincount(toks, minlength=V)[kept]
    expected = n * p[kept]
    stat = ((counts - expected) ** 2 / expected).sum()
    df = kept.sum() - 1
    z999 = 3.0902                            # standard normal 0.999 quantile
    bound = df * (1 - 2 / (9 * df) + z999 * np.sqrt(2 / (9 * df))) ** 3
    assert df >= 3 and stat < bound, (stat, bound)


def test_engine_sampling_is_reproducible(dense):
    """A sampled request draws from its own (seed, t) streams: the same
    tokens alone and next to other traffic."""
    _, _, cfg, params = dense
    rng = np.random.default_rng(11)
    sp = SamplingParams(temperature=0.9, top_k=20, top_p=0.9, seed=5)
    prompt = rng.integers(0, cfg.vocab_size, 9).astype(np.int32)
    alone, _ = _run(cfg, params, [dict(id="s", prompt=prompt,
                                       max_new_tokens=6, sampling=sp)],
                    num_slots=2, cache_len=CACHE_LEN)
    other = rng.integers(0, cfg.vocab_size, 7).astype(np.int32)
    mixed, _ = _run(cfg, params, [dict(id="o", prompt=other,
                                       max_new_tokens=6),
                                  dict(id="s", prompt=prompt,
                                       max_new_tokens=6, sampling=sp,
                                       arrival_step=2)],
                    num_slots=2, cache_len=CACHE_LEN)
    assert mixed["s"] == alone["s"]


@pytest.mark.parametrize("mode", [[], ["--engine", "--trace", "3"]],
                         ids=["fixed", "engine"])
def test_launcher_cli_on_cpu(mode, monkeypatch, capsys):
    from repro_torch.launch import serve
    monkeypatch.setattr("sys.argv", ["serve", "--device", "cpu", "--gen", "3",
                                     "--prompt-len", "8", *mode])
    serve.main()
    out = capsys.readouterr().out
    if mode:
        assert "engine: 3 requests" in out and "[paged (" in out
    else:
        assert "decode:" in out
