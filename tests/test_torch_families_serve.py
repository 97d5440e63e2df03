"""Serving the rest of the dense family and the MoE family, and the repairs
that came with them, against the JAX package:

  * the engine's greedy tokens equal the JAX engine's on the launcher's
    smoke trace for qwen3-1.7b, gemma2-27b (contiguous lanes, chosen by
    itself), smollm-360m (G = 3), mixtral-8x7b and qwen2-moe-a2.7b (paged);
    the fixed-batch launcher runs each; a gemma2 engine replays its request
    journal into a fresh engine, tokens equal to an uninterrupted run;
  * the engine's ``paged`` default follows the reference: paged where the
    family has one ring geometry and ``REPRO_PAGED_KV`` is not "0", never
    for gemma2, whose forced ``paged=True`` raises; a gemma2 request past
    ``cache_len`` raises at submit, since its global rings would wrap;
  * gemma2-27b's real embedding multiplier in bf16 through both packages'
    ``embed_tokens``, equal bit for bit;
  * the layer-at-a-time weight draw keeps each leaf's shape, dtype and
    scale, and draws at most one layer slice in f32 at a time;
  * bridge round trips of gemma2's pair tree and an MoE tree (bf16), bit
    for bit;
  * the flash-decode shape rule takes (G, D) = (3, 64), (4, 128) and
    zamba2-2.7b's (1, 80) and still refuses an uninstantiated pair (fake
    CUDA tensors);
  * ``FAMILY_TARGETS["moe"]`` adds the router, whose adapters take the
    reference's shapes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models.registry import get_model as jax_get_model
from repro.serve import ForecastEngine as JaxEngine
from repro.serve import Request as JaxRequest
from repro_torch import bridge
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch.serve import make_trace, run_fixed_batch
from repro_torch.serve.engine import ForecastEngine
from repro_torch.serve.request import Request

CACHE_LEN = 48
ARCHS = ["qwen3-1.7b", "gemma2-27b", "smollm-360m", "mixtral-8x7b",
         "qwen2-moe-a2.7b"]


@pytest.fixture(autouse=True, scope="module")
def _torch_one_thread():
    """The shapes here are tiny: one intra-op thread, so that parallel test
    workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=ARCHS)
def served(request):
    jcfg = jax_smoke_config(request.param)
    cfg = get_smoke_config(request.param)
    jparams = jax_get_model(jcfg).init(jcfg, jax.random.PRNGKey(0))
    params = bridge.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                    device="cpu")
    return jcfg, jparams, cfg, params


def _trace(cfg):
    return make_trace(cfg, 6, gen=6, max_prompt=16, rate=0.5, seed=0)


def _run(cfg, params, reqs, **kw):
    eng = ForecastEngine(cfg, params, device="cpu", **kw)
    for r in reqs:
        eng.submit(Request(**r))
    done = eng.run(max_steps=500)
    return {k: v.tokens.tolist() for k, v in done.items()}, eng


def test_engine_greedy_matches_jax_engine(served):
    """Both engines at their defaults: paged with prefix sharing for the
    uniform rings, contiguous lanes for gemma2."""
    jcfg, jparams, cfg, params = served
    trace = _trace(cfg)
    jeng = JaxEngine(jcfg, jparams, num_slots=4, cache_len=CACHE_LEN)
    for r in trace:
        jeng.submit(JaxRequest(id=r["id"], prompt=r["prompt"],
                               max_new_tokens=r["max_new_tokens"],
                               arrival_step=r["arrival_step"]))
    want = {k: v.tokens.tolist() for k, v in jeng.run(max_steps=500).items()}
    got, eng = _run(cfg, params, [dict(r) for r in trace], num_slots=4,
                    cache_len=CACHE_LEN)
    assert got == want
    assert eng.paged == jeng.paged == (not cfg.local_global_alternating)


def test_fixed_batch_launcher(served):
    """One prefill and 5 synchronous steps over the contiguous ring(s):
    the tokens are the argmax chain of the reference's prefill and decode
    steps fed the same prompts."""
    jcfg, jparams, cfg, params = served
    res = run_fixed_batch(cfg, params, batch=2, prompt_len=8, gen=5,
                          device="cpu", quiet=True)
    assert res["finite"] and res["tokens"].shape == (2, 6)
    japi = jax_get_model(jcfg)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (2, 8))
    cache, lg = japi.prefill(jparams, jcfg, {"tokens": jnp.asarray(tokens)},
                             cache_len=13)
    tok = jnp.argmax(lg[:, -1], -1).astype(jnp.int32)[:, None]
    want = [np.asarray(tok)]
    for i in range(5):
        lg, cache = japi.decode_step(jparams, jcfg, cache,
                                     {"token": tok, "pos": jnp.int32(8 + i)})
        tok = jnp.argmax(lg[:, -1], -1).astype(jnp.int32)[:, None]
        want.append(np.asarray(tok))
    assert np.array_equal(res["tokens"], np.concatenate(want, 1))


def test_gemma2_journal_replay_on_contiguous_lanes(tmp_path):
    """A gemma2 engine dropped after 4 ticks with its journal open; a fresh
    engine replays the journal (prefill into a lane, then the journaled
    tokens re-decoded through both trees) and finishes every request with
    the tokens of an uninterrupted run."""
    from repro_torch.models.registry import get_model
    from repro_torch.serve.journal import replay_journal
    cfg = get_smoke_config("gemma2-27b")
    params = get_model(cfg).init(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
    trace = _trace(cfg)
    want, _ = _run(cfg, params, [dict(r) for r in trace], num_slots=3,
                   cache_len=CACHE_LEN)
    path = str(tmp_path / "gemma.jrnl")
    kw = dict(device="cpu", num_slots=3, cache_len=CACHE_LEN, journal=path)
    eng = ForecastEngine(cfg, params, **kw)
    assert not eng.paged
    for r in trace:
        eng.submit(Request(**r))
    for _ in range(4):
        eng.step()
    assert eng.active_requests > 0
    eng.journal.close()
    del eng                                  # dropped mid-trace
    st = replay_journal(path)
    assert st.unfinished_ids
    fresh = ForecastEngine(cfg, params, **kw)
    for r in st.unfinished_requests():
        assert fresh.submit(r).ok
    done = fresh.run(max_steps=500)
    got = {r: list(map(int, st.tokens[r])) for r in st.finished}
    got.update({k: v.tokens.tolist() for k, v in done.items()})
    assert got == want


def test_engine_paged_default_follows_reference(monkeypatch):
    cfg = get_smoke_config("gemma2-27b")
    from repro_torch.models.registry import get_model
    params = get_model(cfg).init(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
    eng = ForecastEngine(cfg, params, device="cpu", cache_len=32)
    assert not eng.paged and not eng.share_prefixes and not eng.swap_tier
    assert set(eng.pool.cache) == {"local", "global"}
    with pytest.raises(ValueError, match="uniform ring geometry"):
        ForecastEngine(cfg, params, device="cpu", cache_len=32, paged=True)
    for arch in ("qwen3-1.7b", "mixtral-8x7b"):
        c = get_smoke_config(arch)
        p = get_model(c).init(c, torch.Generator().manual_seed(0),
                              device="cpu")
        assert ForecastEngine(c, p, device="cpu", cache_len=32).paged
        monkeypatch.setenv("REPRO_PAGED_KV", "0")
        assert not ForecastEngine(c, p, device="cpu", cache_len=32).paged
        monkeypatch.delenv("REPRO_PAGED_KV")


def test_alternating_request_past_cache_len_raises():
    """gemma2's global rings are ``cache_len`` slots long whatever its
    window, so a request whose prompt plus horizon exceeds ``cache_len``
    raises at submit (the reference admits it, and its global layers then
    attend only the last ``cache_len`` positions); one that fits is
    admitted."""
    from repro_torch.models.registry import get_model
    cfg = get_smoke_config("gemma2-27b")
    assert 0 < cfg.sliding_window < 96
    params = get_model(cfg).init(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
    eng = ForecastEngine(cfg, params, device="cpu", cache_len=96)
    prompt = np.arange(80) % cfg.vocab_size
    with pytest.raises(ValueError, match="exceeds cache_len"):
        eng.submit(Request(id="long", prompt=prompt, max_new_tokens=17))
    assert eng.submit(Request(id="fits", prompt=prompt,
                              max_new_tokens=16)).ok


def test_launcher_no_paged_flag(monkeypatch, capsys):
    from repro_torch.launch import serve
    for flag, pool in (("--no-paged", "contiguous lanes"),
                       ("--paged", "[paged (")):
        monkeypatch.setattr("sys.argv", [
            "serve", "--device", "cpu", "--gen", "3", "--prompt-len", "8",
            "--engine", "--trace", "2", flag])
        serve.main()
        assert pool in capsys.readouterr().out


def test_embedding_multiplier_bf16_bit_exact():
    """gemma2-27b's multiplier sqrt(4608) is 68.0 in bf16: 4096 bf16
    embeddings times it equal the reference's bit for bit."""
    import ml_dtypes
    from repro.models import transformer as jtf
    from repro_torch.models import transformer as ttf
    jcfg, cfg = jax_get_config("gemma2-27b"), get_config("gemma2-27b")
    assert cfg.compute_dtype == "bfloat16"
    rng = np.random.default_rng(0)
    table = rng.standard_normal((64, 64)).astype(ml_dtypes.bfloat16)
    tokens = rng.integers(0, 64, (1, 64))
    want = np.asarray(jtf.embed_tokens({"embed": {"table": jnp.asarray(
        table)}}, jcfg, jnp.asarray(tokens)))
    got = ttf.embed_tokens({"embed": bridge.tree_to_torch(
        {"table": table}, device="cpu")}, cfg, torch.as_tensor(tokens))
    assert got.dtype == torch.bfloat16 and got.shape == (1, 64, 64)
    assert np.array_equal(bridge.params_to_numpy({"x": got})["x"].view(
        np.uint16), want.view(np.uint16))


def test_layer_draw_keeps_shape_dtype_scale(monkeypatch):
    """``draw_normal`` fills a stacked leaf one layer at a time: every f32
    draw is one slice, and the leaf keeps its shape, dtype and scale (mean
    within 0.01 of 0 and std within 2% of the scale over 49,152 values a
    layer)."""
    from repro_torch.models.layers import linear
    from repro_torch.models.layers.moe import init_moe
    draws = []
    real = torch.randn

    def spy(*shape, **kw):
        draws.append(tuple(shape[0] if len(shape) == 1 else shape))
        return real(*shape, **kw)

    monkeypatch.setattr(torch, "randn", spy)
    g = torch.Generator().manual_seed(0)
    w = linear.init_dense(g, 256, 192, layers=3, dtype=torch.bfloat16)["w"]
    assert w.shape == (3, 256, 192) and w.dtype == torch.bfloat16
    assert draws == [(256, 192)] * 3
    for i in range(3):
        x = w[i].float()
        assert abs(float(x.mean())) < 0.01
        assert abs(float(x.std()) / 256 ** -0.5 - 1) < 0.02
    draws.clear()
    cfg = get_smoke_config("mixtral-8x7b")
    p = init_moe(g, cfg, layers=2, dtype=torch.bfloat16)
    assert p["gate_proj"].shape == (2, 4, 256, 256)
    assert p["router"]["w"].dtype == torch.float32
    assert max(np.prod(d) for d in draws) == 4 * 256 * 256
    assert abs(float(p["down_proj"].float().std()) * 256 ** 0.5 - 1) < 0.02


def _bits(tree):
    return {k: _bits(v) if isinstance(v, dict) else v.view(np.uint8)
            for k, v in tree.items()}


@pytest.mark.parametrize("arch", ["gemma2-27b", "qwen2-moe-a2.7b"])
def test_bridge_round_trip_pair_and_moe_trees(arch):
    """JAX tree -> port -> numpy is bit-exact in bf16; a wrong layer count
    is refused."""
    jcfg = jax_smoke_config(arch).replace(param_dtype="bfloat16")
    cfg = get_smoke_config(arch).replace(param_dtype="bfloat16")
    tree = jax.tree.map(np.asarray,
                        jax_get_model(jcfg).init(jcfg, jax.random.PRNGKey(1)))
    params = bridge.params_from_jax(tree, cfg, device="cpu")
    if arch == "gemma2-27b":
        assert params["layers"]["local"]["post_mlp_norm"]["scale"].shape == \
            (1, cfg.d_model)
    else:
        assert params["layers"]["moe"]["gate_proj"].dtype == torch.bfloat16
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(
        bridge.params_to_numpy(params)))
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        b = flat_b[path]
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), path
    with pytest.raises(ValueError, match="layers"):
        bridge.params_from_jax(tree, cfg.replace(num_layers=4), device="cpu")


@pytest.mark.parametrize("G,D,built", [(3, 64, True), (4, 128, True),
                                       (1, 80, True), (1, 64, True),
                                       (3, 128, False), (4, 64, False),
                                       (2, 80, False), (1, 96, False)])
@pytest.mark.parametrize("paged", [False, True], ids=["ring", "paged"])
def test_head_geometries_on_fake_cuda_tensors(G, D, built, paged):
    """The shape rule (the kernel's own argument checks) takes the new
    instances and still refuses a pair that is not built."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.kernels import flash_decode as fd
    Hk = 2
    with FakeTensorMode(allow_non_fake_inputs=True):
        def t(*shape, dt=torch.bfloat16):
            return torch.empty(shape, dtype=dt, device="cuda")
        q = t(3, 1, Hk * G, D)
        kw = {}
        if paged:
            k, v, kvp = t(8, 16, Hk, D), t(8, 16, Hk, D), t(
                8, 16, dt=torch.int32)
            kw["block_tables"] = t(3, 4, dt=torch.int32)
        else:
            k, v, kvp = t(3, 64, Hk, D), t(3, 64, Hk, D), t(
                3, 64, dt=torch.int32)
        pos = t(3, dt=torch.int32)
        if built:
            out = fd.flash_decode_shape(q, k, v, kvp, pos, **kw)
            assert out.shape == q.shape
        else:
            with pytest.raises(ValueError, match="must be one of"):
                fd.flash_decode_shape(q, k, v, kvp, pos, **kw)


def test_moe_lora_targets_router():
    from repro.core.lora import FAMILY_TARGETS as JT
    from repro.core.lora import attach_lora as jattach
    from repro_torch.core.lora import FAMILY_TARGETS, attach_lora, lora_tree
    from repro_torch.models.registry import get_model
    assert FAMILY_TARGETS["moe"] == JT["moe"]
    cfg = get_smoke_config("mixtral-8x7b")
    params = get_model(cfg).init(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
    ad = lora_tree(attach_lora(params, torch.Generator().manual_seed(1),
                               rank=4, alpha=8.0,
                               targets=FAMILY_TARGETS["moe"]))
    jcfg = jax_smoke_config("mixtral-8x7b")
    jp = jattach(jax_get_model(jcfg).init(jcfg, jax.random.PRNGKey(0)),
                 jax.random.PRNGKey(1), rank=4, alpha=8.0,
                 targets=JT["moe"])
    assert ad["layers"]["moe"]["router"]["lora_a"].shape == \
        jp["layers"]["moe"]["router"]["lora_a"].shape == (2, 256, 4)
