"""xlstm-350m (family ``ssm``) against the JAX package: the mLSTM and sLSTM
blocks, the model's forward, prefill, decode and loss, the contiguous-lane
engine and its freeze of inactive lanes, on the smoke config in f32 (2
layers: one mLSTM and one sLSTM block, d_model 256, 2 heads, chunk 32),
with the reference's weights carried over by the bridge and the same numpy
inputs fed to both.

Tolerances, and why:
  * blocks, hidden states, logits and every cache leaf: within 1e-5 of
    each tensor's largest magnitude (f32; the chunk products and the
    state sums run in another order; read: up to 4e-6 of it);
  * the loss within 1e-6 relative; each gradient leaf within 1e-4 of its
    largest magnitude: the mLSTM leaves' gradients are ill-conditioned in
    f32 on both sides (read against an f64 run of the port: the reference
    up to 6.4e-5 of the leaf's largest off it, the port 8.9e-5), and the
    two sides are up to 2.5e-5 apart (the reference's own jitted and eager
    gradients 4.4e-6 apart);
  * greedy tokens, the batch axes and the frozen lane: exact.

A prompt that is not a chunk multiple (S = 40 at chunk 32) is padded to
one, and the state returned is the state after the padded steps, in the
reference as in the port (``test_padded_state_is_the_references``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import xlstm_model as jxm
from repro.models.layers import xlstm as jxl
from repro.models.registry import get_model as jax_get_model
from repro_torch import bridge
from repro_torch import tree as tree_util
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch.serve import make_trace, run_fixed_batch
from repro_torch.launch.steps import make_serve_step
from repro_torch.models import xlstm_model as txm
from repro_torch.models.layers import xlstm as txl
from repro_torch.models.registry import get_model
from repro_torch.serve.cache_pool import (CachePool, cache_batch_axes,
                                          freeze_inactive)
from repro_torch.serve.engine import ForecastEngine
from repro_torch.serve.request import Request

ARCH = "xlstm-350m"
TOL = 1e-5
GRAD_TOL = 1e-4
B = 2
CACHE_LEN = 64


@pytest.fixture(autouse=True, scope="module")
def _torch_one_thread():
    """Small shapes: one intra-op thread, so that parallel test workers do
    not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    jcfg, cfg = jax_smoke_config(ARCH), get_smoke_config(ARCH)
    jp = jax_get_model(jcfg).init(jcfg, jax.random.PRNGKey(0))
    p = bridge.params_from_jax(jax.tree.map(np.asarray, jp), cfg,
                               device="cpu")
    return jcfg, jp, cfg, p


def _close(got, want, tol=TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    top = float(np.abs(want).max()) or 1.0
    err = float(np.abs(got - want).max())
    assert err <= tol * top, (err, top)


def _close_trees(got, want, tol=TOL):
    jl = jax.tree.leaves(want)
    tl = tree_util.leaves(got)
    assert len(jl) == len(tl)
    for g, w in zip(tl, jl):
        _close(g, w, tol)


def _x(S, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, S, 256)).astype(np.float32)


def _tokens(cfg, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))


def _mlstm(jp, p):
    return (jax.tree.map(lambda a: a[0, 0], jp["mlstm"]["block"]),
            txm.layer(txm.layer(p["mlstm"]["block"], 0), 0))


def _slstm(jp, p):
    return (jax.tree.map(lambda a: a[0], jp["slstm"]["block"]),
            txm.layer(p["slstm"]["block"], 0))


def _state(st):
    return {k: torch.from_numpy(np.array(v)) for k, v in st.items()}


# ---------------------------------------------------------------------------
# config, init, bridge
# ---------------------------------------------------------------------------

def test_config_and_init_shapes_match_reference(model):
    """Full width and smoke: the port's config is the reference's, and
    ``init`` at full width (fakes: no memory) has the reference's leaves,
    shapes and dtypes, each stacked leaf drawn a layer slice at a time."""
    from repro.configs import get_config as jax_get_config
    from repro_torch.launch.specs import param_shapes
    jcfg = jax_get_config(ARCH)
    assert dataclasses.asdict(get_config(ARCH)) == dataclasses.asdict(jcfg)
    want = jax.eval_shape(lambda: jax_get_model(jcfg).init(
        jcfg, jax.random.PRNGKey(0)))
    got = param_shapes(get_config(ARCH))
    wl, gl = jax.tree.leaves(want), tree_util.leaves(got)
    assert [tuple(w.shape) for w in wl] == [tuple(g.shape) for g in gl]
    assert [w.dtype.name for w in wl] == \
        [str(g.dtype).replace("torch.", "") for g in gl]
    # smoke: the port's own draw has the reference's shapes and scales
    _, jp, cfg, _ = model
    p = get_model(cfg).init(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    for g, w in zip(tree_util.leaves(p), jax.tree.leaves(jp)):
        assert tuple(g.shape) == w.shape
        w = np.asarray(w)
        if not np.array_equal(g.numpy(), w):       # a draw, not a constant
            assert abs(float(g.std()) / float(w.std()) - 1) < 0.1


def test_bridge_checks_the_xlstm_tree(model):
    jcfg, jp, cfg, p = model
    back = bridge.params_to_numpy(p)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        assert np.array_equal(a, np.asarray(b))
    other = cfg.replace(d_model=128)
    with pytest.raises(ValueError):
        bridge.params_from_jax(jax.tree.map(np.asarray, jp), other,
                               device="cpu")


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [40, 64], ids=["padded", "two_chunks"])
def test_mlstm_block_forward_matches_reference(model, S):
    """The chunked, max-stabilised mLSTM with its returned state and conv
    buffer; at S = 40 the prompt is padded to 64."""
    jcfg, jp, cfg, p = model
    jb, tb = _mlstm(jp, p)
    x = _x(S)
    jy, jst = jxl.mlstm_block_forward(jb, jcfg, jnp.asarray(x),
                                      return_cache=True)
    ty, tst = txl.mlstm_block_forward(tb, cfg, torch.from_numpy(x),
                                      return_cache=True)
    _close(ty, jy)
    assert set(tst) == set(jst)
    for k in jst:
        _close(tst[k], jst[k])


def test_mlstm_block_forward_threads_a_state(model):
    """A second prompt from the first one's state."""
    jcfg, jp, cfg, p = model
    jb, tb = _mlstm(jp, p)
    x1, x2 = _x(32, 1), _x(48, 2)
    _, jst = jxl.mlstm_block_forward(jb, jcfg, jnp.asarray(x1))
    jy, jst2 = jxl.mlstm_block_forward(jb, jcfg, jnp.asarray(x2), state=jst)
    _, tst = txl.mlstm_block_forward(tb, cfg, torch.from_numpy(x1))
    ty, tst2 = txl.mlstm_block_forward(tb, cfg, torch.from_numpy(x2),
                                       state=tst)
    _close(ty, jy)
    for k in jst2:
        _close(tst2[k], jst2[k])


def test_slstm_block_forward_matches_reference(model):
    jcfg, jp, cfg, p = model
    jb, tb = _slstm(jp, p)
    x = _x(24, 3)
    jy, jst = jxl.slstm_block_forward(jb, jcfg, jnp.asarray(x))
    ty, tst = txl.slstm_block_forward(tb, cfg, torch.from_numpy(x))
    _close(ty, jy)
    for k in jst:
        _close(tst[k], jst[k])


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_decode_matches_reference(model, kind):
    """3 recurrent steps from a prefilled state."""
    jcfg, jp, cfg, p = model
    if kind == "mlstm":
        jb, tb = _mlstm(jp, p)
        _, jc = jxl.mlstm_block_forward(jb, jcfg, jnp.asarray(_x(40, 4)),
                                        return_cache=True)
        jstep, tstep = jxl.mlstm_block_decode, txl.mlstm_block_decode
    else:
        jb, tb = _slstm(jp, p)
        _, jc = jxl.slstm_block_forward(jb, jcfg, jnp.asarray(_x(12, 4)))
        jstep, tstep = jxl.slstm_block_decode, txl.slstm_block_decode
    tc = _state(jc)
    xs = _x(3, 5)
    for t in range(3):
        jy, jc = jstep(jb, jcfg, jnp.asarray(xs[:, t:t + 1]), jc)
        ty, tc = tstep(tb, cfg, torch.from_numpy(xs[:, t:t + 1]), tc)
        _close(ty, jy)
        for k in jc:
            _close(tc[k], jc[k])


def test_slstm_cache_starts_n_at_1e6(model):
    _, _, cfg, _ = model
    c = txl.init_slstm_cache(cfg, 3, device="cpu")
    assert torch.equal(c["n"], torch.full((3, cfg.d_model), 1e-6))
    assert all(float(c[k].abs().max()) == 0 for k in ("c", "m", "h"))
    assert len({v.data_ptr() for v in c.values()}) == 4     # no aliases


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("remat", [True, False])
def test_forward_matches_reference(model, remat):
    jcfg, jp, cfg, p = model
    toks = _tokens(cfg, 40)
    want = jxm.forward(jp, jcfg, jnp.asarray(toks), remat=remat)
    with torch.enable_grad():
        got = txm.forward(p, cfg, torch.as_tensor(toks), remat=remat)
    _close(got, want)


@pytest.mark.parametrize("S", [40, 64], ids=["padded", "two_chunks"])
def test_prefill_and_decode_match_reference(model, S):
    """Prefill (last logits and every cache leaf), then 3 decode steps."""
    jcfg, jp, cfg, p = model
    japi, api = jax_get_model(jcfg), get_model(cfg)
    toks = _tokens(cfg, S, 6)
    jc, jl = japi.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)})
    tc, tl = api.prefill(p, cfg, {"tokens": torch.as_tensor(toks)})
    _close(tl, jl)
    _close_trees(tc, jc)
    step = np.random.default_rng(7).integers(0, cfg.vocab_size, (3, B, 1))
    for t in range(3):
        jl, jc = japi.decode_step(jp, jcfg, jc, {
            "token": jnp.asarray(step[t]), "pos": jnp.int32(S + t)})
        tl, tc = api.decode_step(p, cfg, tc, {
            "token": torch.as_tensor(step[t]), "pos": S + t})
        _close(tl, jl)
        _close_trees(tc, jc)


def test_prefill_then_decode_equals_a_longer_prefill(model):
    """At a chunk-multiple prompt (64), prefill + k decode steps give the
    logits of a prefill of the prompt and those k tokens (whose own pad
    lies after the last position read)."""
    _, _, cfg, p = model
    api = get_model(cfg)
    toks = _tokens(cfg, 67, 8)
    cache, lg = api.prefill(p, cfg, {"tokens": torch.as_tensor(toks[:, :64])})
    for t in range(3):
        lg, cache = api.decode_step(p, cfg, cache, {
            "token": torch.as_tensor(toks[:, 64 + t:65 + t]), "pos": 64 + t})
    _, want = api.prefill(p, cfg, {"tokens": torch.as_tensor(toks)})
    _close(lg, want.numpy())


def test_padded_state_is_the_references(model):
    """The reference's trap, kept for parity: a 40-token prompt's state is
    the state after 64 steps, the last 24 on a zero block input, so it
    differs from 32 chunked steps and 8 recurrent ones, by far more than
    the tolerance."""
    jcfg, jp, cfg, p = model
    jb, tb = _mlstm(jp, p)
    x = torch.from_numpy(_x(40, 9))
    _, padded = txl.mlstm_block_forward(tb, cfg, x, return_cache=True)
    _, st = txl.mlstm_block_forward(tb, cfg, x[:, :32], return_cache=True)
    for t in range(32, 40):
        _, st = txl.mlstm_block_decode(tb, cfg, x[:, t:t + 1], st)
    gap = float((padded["C"] - st["C"]).abs().max())
    assert gap > 100 * TOL * float(st["C"].abs().max()), gap
    _, jst = jxl.mlstm_block_forward(jb, jcfg, jnp.asarray(x.numpy()))
    _close(padded["C"], jst["C"])


def test_loss_and_gradient_match_reference(model):
    jcfg, jp, cfg, p = model
    toks, labels = _tokens(cfg, 40, 10), _tokens(cfg, 40, 11)
    labels[0, :7] = -1
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    jloss, jgrads = jax.value_and_grad(
        lambda q: jax_get_model(jcfg).loss(q, jcfg, jb))(jp)
    api = get_model(cfg)
    leaves = [x.clone().requires_grad_(True) for x in tree_util.leaves(p)]
    batch = {"tokens": torch.as_tensor(toks),
             "labels": torch.as_tensor(labels)}
    loss = api.loss(tree_util.unflatten(p, leaves), cfg, batch)
    grads = torch.autograd.grad(loss, leaves)
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-6 * float(jloss)
    for g, w in zip(grads, jax.tree.leaves(jgrads)):
        _close(g, w, GRAD_TOL)
    tot, count, stats = api.loss_parts(p, cfg, batch)
    assert stats is None and int(count) == B * 40 - 7
    assert abs(float(tot / count) - float(jloss)) <= 1e-6 * float(jloss)


def test_prefill_refuses_true_len(model):
    _, _, cfg, p = model
    with pytest.raises(ValueError):
        get_model(cfg).prefill(p, cfg, {"tokens": torch.zeros(
            (1, 8), dtype=torch.int64)}, true_len=[4])


# ---------------------------------------------------------------------------
# serving: batch axes, the pool, the freeze, the engines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", [ARCH, "qwen3-0.6b", "gemma2-27b"])
def test_cache_batch_axes_match_reference(arch):
    """Probed on the meta device: no cache is drawn anywhere."""
    from repro.serve.cache_pool import cache_batch_axes as jaxes
    jcfg, cfg = jax_smoke_config(arch), get_smoke_config(arch)
    got = cache_batch_axes(get_model(cfg), cfg)
    want = jaxes(jax_get_model(jcfg), jcfg)
    assert tree_util.leaves(got) == jax.tree.leaves(want)
    if arch == ARCH:
        assert got["mlstm"]["C"] == 2 and got["slstm"]["h"] == 1


def test_pool_insert_writes_each_leaf_at_its_batch_axis(model):
    jcfg, jp, cfg, p = model
    pool = CachePool(cfg, 3, CACHE_LEN, device="cpu")
    c1, _ = get_model(cfg).prefill(p, cfg, {"tokens": torch.as_tensor(
        _tokens(cfg, 40, 12)[:1])})
    fresh = CachePool(cfg, 3, CACHE_LEN, device="cpu").cache
    pool.insert(c1, 1)
    for got, req, init, ax in zip(tree_util.leaves(pool.cache),
                                  tree_util.leaves(c1),
                                  tree_util.leaves(fresh),
                                  tree_util.leaves(pool.batch_axes)):
        assert torch.equal(got.select(ax, 1), req.select(ax, 0))
        for lane in (0, 2):
            assert torch.equal(got.select(ax, lane), init.select(ax, lane))


def test_freeze_inactive_keeps_a_retired_lane(model):
    """The ragged serve step on 3 contiguous lanes, lane 1 inactive: its
    state is bit for bit what it was, the others' are the reference's
    frozen step's."""
    from repro.launch.steps import make_serve_step as jmake
    jcfg, jp, cfg, p = model
    api = get_model(cfg)
    c, _ = api.prefill(p, cfg, {"tokens": torch.as_tensor(
        np.random.default_rng(13).integers(0, cfg.vocab_size, (3, 40)))})
    jc = jax.tree.map(lambda t: jnp.asarray(np.array(t.numpy())), c)
    before = tree_util.map_(torch.clone, c)
    pos = np.asarray([40, -1, 40], np.int32)
    tok = np.asarray([[5], [6], [7]], np.int32)
    ttok, tc = make_serve_step(cfg)(p, c, {"token": torch.as_tensor(tok),
                                           "pos": torch.as_tensor(pos)})
    assert tc is c                                   # written in place
    axes = cache_batch_axes(api, cfg)
    for new, old, ax in zip(tree_util.leaves(tc), tree_util.leaves(before),
                            tree_util.leaves(axes)):
        assert torch.equal(new.select(ax, 1), old.select(ax, 1))
        assert not torch.equal(new.select(ax, 0), old.select(ax, 0))
    jtok, jnew = jmake(jcfg)(jp, jc, {"token": jnp.asarray(tok),
                                      "pos": jnp.asarray(pos)})
    assert np.array_equal(ttok.numpy(), np.asarray(jtok))
    _close_trees(tc, jnew)
    # freeze_inactive alone, all lanes active: a plain copy
    fresh = tree_util.map_(torch.zeros_like, before)
    assert freeze_inactive(fresh, before, None, axes) is fresh
    assert all(torch.equal(a, b) for a, b in zip(tree_util.leaves(fresh),
                                                 tree_util.leaves(before)))


def _trace(cfg):
    # prompts of 12-48 tokens: under, over and at the 32-token chunk
    return make_trace(cfg, 6, gen=6, max_prompt=48, rate=0.5, seed=0)


def test_engine_refusals(model):
    _, _, cfg, p = model
    with pytest.raises(ValueError, match="prefill_bucket"):
        ForecastEngine(cfg, p, prefill_bucket=16, device="cpu")
    with pytest.raises(ValueError, match="paged"):
        ForecastEngine(cfg, p, paged=True, device="cpu")
    enc = get_smoke_config("qwen3-0.6b").replace(family="encdec")
    with pytest.raises(ValueError, match="not servable"):
        ForecastEngine(enc, p, device="cpu")
    eng = ForecastEngine(cfg, p, num_slots=2, cache_len=8, device="cpu")
    assert not eng.paged
    # O(1) state: a request past cache_len is admitted
    assert eng.submit(Request(id="long", prompt=np.arange(20) % 50,
                              max_new_tokens=4)).ok


def test_fixed_batch_launcher(model):
    """One prefill and 5 synchronous steps: the argmax chain of the
    reference's prefill and decode steps on the same prompts."""
    jcfg, jp, cfg, p = model
    res = run_fixed_batch(cfg, p, batch=2, prompt_len=40, gen=5,
                          device="cpu", quiet=True)
    assert res["finite"] and res["tokens"].shape == (2, 6)
    japi = jax_get_model(jcfg)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 40))
    cache, lg = japi.prefill(jp, jcfg, {"tokens": jnp.asarray(tokens)})
    tok = jnp.argmax(lg[:, -1], -1).astype(jnp.int32)[:, None]
    want = [np.asarray(tok)]
    for i in range(5):
        lg, cache = japi.decode_step(jp, jcfg, cache,
                                     {"token": tok, "pos": jnp.int32(40 + i)})
        tok = jnp.argmax(lg[:, -1], -1).astype(jnp.int32)[:, None]
        want.append(np.asarray(tok))
    assert np.array_equal(res["tokens"], np.concatenate(want, 1))


def test_engine_greedy_matches_jax_engine(model):
    """Both engines at their defaults (contiguous lanes), ragged arrivals,
    prompts padded and not; and each request's tokens are the fixed-batch
    path's on its own prompt."""
    from repro.serve import ForecastEngine as JaxEngine
    from repro.serve import Request as JaxRequest
    jcfg, jp, cfg, p = model
    trace = _trace(cfg)
    jeng = JaxEngine(jcfg, jp, num_slots=3, cache_len=CACHE_LEN)
    for r in trace:
        jeng.submit(JaxRequest(id=r["id"], prompt=r["prompt"],
                               max_new_tokens=r["max_new_tokens"],
                               arrival_step=r["arrival_step"]))
    want = {k: v.tokens.tolist() for k, v in jeng.run(max_steps=500).items()}
    eng = ForecastEngine(cfg, p, num_slots=3, cache_len=CACHE_LEN,
                         device="cpu")
    for r in trace:
        eng.submit(Request(**r))
    got = {k: v.tokens.tolist() for k, v in eng.run(max_steps=500).items()}
    assert got == want and not eng.paged and not jeng.paged
    api = get_model(cfg)
    r = max(trace, key=lambda r: len(r["prompt"]))
    cache, lg = api.prefill(p, cfg, {"tokens": torch.as_tensor(
        [r["prompt"]])})
    tok, chain = lg[:, -1].argmax(-1)[:, None], []
    for i in range(r["max_new_tokens"]):
        chain.append(int(tok))
        lg, cache = api.decode_step(p, cfg, cache, {"token": tok, "pos": 0})
        tok = lg[:, -1].argmax(-1)[:, None]
    assert got[r["id"]] == chain


def test_launcher_serves_xlstm_on_the_cpu(capsys, monkeypatch):
    from repro_torch.launch import serve
    for extra in ([], ["--engine", "--trace", "3", "--slots", "2"]):
        monkeypatch.setattr("sys.argv", [
            "serve", "--arch", ARCH, "--device", "cpu", "--prompt-len",
            "20", "--gen", "3", *extra])
        serve.main()
    out = capsys.readouterr().out
    assert "xlstm-350m-smoke on cpu" in out and "engine:" in out
