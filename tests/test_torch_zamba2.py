"""zamba2-2.7b (family ``hybrid``: Mamba2 layers and weight-shared
attention) against the JAX package: the Mamba2 layer (chunked forward with
its returned state and conv tail, the one-step decode), the model's
forward, prefill, decode and loss with its gradients, greedy tokens, the
contiguous-lane engine and its freeze of inactive lanes, on the smoke
config in f32 (4 Mamba2 layers in 2 groups, one shared-block application
each, round-robin over 2 blocks; d_model 256, 4 heads of 64, SSM heads of
32, state 16, chunk 32), with the reference's weights carried over by the
bridge and the same numpy inputs fed to both.

Tolerances, and why:
  * the Mamba2 layer, hidden states, logits and every cache leaf: within
    1e-5 of each tensor's largest magnitude (f32; the chunk products, the
    state sums and the attention run in another order; read: up to 7.3e-6
    of it, at the padded prompt's decode steps, 3.3e-6 elsewhere);
  * the loss within 1e-6 relative; each gradient leaf within 1e-4 of its
    largest magnitude, the bound ``test_torch_xlstm.py`` needed (read: up
    to 5.8e-6 of it);
  * greedy tokens, the batch axes, the frozen lane and the rings: exact.

A prompt that is not a chunk multiple (S = 40 at chunk 32) is padded to
one: the state returned is the state after the padded steps, the conv tail
the unpadded positions', in the reference as in the port
(``test_padded_state_is_the_references``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import zamba2 as jz
from repro.models.layers import attention as jattn
from repro.models.layers import mamba2 as jm
from repro.models.registry import get_model as jax_get_model
from repro_torch import bridge
from repro_torch import tree as tree_util
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch.serve import make_trace, run_fixed_batch
from repro_torch.launch.steps import make_serve_step
from repro_torch.models import zamba2 as tz
from repro_torch.models.layers import attention as tattn
from repro_torch.models.layers import mamba2 as tm
from repro_torch.models.registry import get_model
from repro_torch.serve.cache_pool import CachePool, cache_batch_axes
from repro_torch.serve.engine import ForecastEngine
from repro_torch.serve.request import Request

ARCH = "zamba2-2.7b"
TOL = 1e-5
GRAD_TOL = 1e-4
B = 2
CACHE_LEN = 72


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


@pytest.fixture(scope="module")
def jax_steps(model):
    """The reference's prefill and decode step, each jitted once for the
    module."""
    jcfg, *_ = model
    api = jax_get_model(jcfg)
    prefill = jax.jit(lambda p, t: api.prefill(p, jcfg, {"tokens": t},
                                               cache_len=CACHE_LEN))
    decode = jax.jit(lambda p, c, t, pos: api.decode_step(
        p, jcfg, c, {"token": t, "pos": pos}))
    return prefill, decode


def _close(got, want, tol=TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
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
    return np.random.default_rng(seed).standard_normal(
        (B, S, 256)).astype(np.float32)


def _tokens(cfg, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))


def _layer(jp, p, g=0, j=0):
    """Mamba2 layer (g, j)'s block, both sides."""
    return (jax.tree.map(lambda a: a[g, j], jp["mamba"]["block"]),
            tz.layer(tz.layer(p["mamba"]["block"], g), j))


def _state(st):
    return {k: torch.from_numpy(np.array(v)) for k, v in st.items()}


# ---------------------------------------------------------------------------
# config, init, bridge, the attention's widths, LoRA targets
# ---------------------------------------------------------------------------

def test_config_and_init_shapes_match_reference(model):
    """Full width and smoke: the port's config is the reference's, and
    ``init`` at full width (fakes: no memory) has the reference's leaves,
    shapes and dtypes; the port's own smoke draw has its scales."""
    from repro_torch.launch.specs import param_shapes
    jcfg = jax_config(ARCH)
    for get, jget in ((get_config, jax_config),
                      (get_smoke_config, jax_smoke_config)):
        assert dataclasses.asdict(get(ARCH)) == dataclasses.asdict(jget(ARCH))
    want = jax.eval_shape(lambda: jax_get_model(jcfg).init(
        jcfg, jax.random.PRNGKey(0)))
    got = param_shapes(get_config(ARCH))
    wl, gl = jax.tree.leaves(want), tree_util.leaves(got)
    assert [tuple(w.shape) for w in wl] == [tuple(g.shape) for g in gl]
    assert [w.dtype.name for w in wl] == \
        [str(g.dtype).replace("torch.", "") for g in gl]
    n = sum(int(np.prod(w.shape)) for w in wl)
    assert 2.66e9 < n < 2.68e9                     # 2.670 B parameters
    _, jp, cfg, _ = model
    p = get_model(cfg).init(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    for g, w in zip(tree_util.leaves(p), jax.tree.leaves(jp)):
        assert tuple(g.shape) == w.shape and str(g.dtype)[6:] == \
            w.dtype.name
        w = np.asarray(w)
        if not np.allclose(g.numpy(), w, rtol=1e-6, atol=0):   # a draw
            assert abs(float(g.std()) / float(w.std()) - 1) < 0.1


def test_bridge_checks_the_hybrid_tree(model):
    jcfg, jp, cfg, p = model
    back = bridge.params_to_numpy(p)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        assert np.array_equal(a, np.asarray(b))
    for other in (cfg.replace(d_model=128), cfg.replace(num_layers=6)):
        with pytest.raises(ValueError):
            bridge.params_from_jax(jax.tree.map(np.asarray, jp), other,
                                   device="cpu")


@pytest.mark.parametrize("widths", [{}, dict(q_in=512, kv_in=512,
                                             out_dim=256),
                                    dict(q_in=512, out_dim=128)],
                         ids=["default", "zamba2_shared", "kv_in_default"])
def test_init_attention_widths_match_reference(model, widths):
    """``q_in`` / ``kv_in`` / ``out_dim`` give the reference's shapes."""
    jcfg, _, cfg, _ = model
    want = jax.eval_shape(lambda: jattn.init_attention(
        jax.random.PRNGKey(0), jcfg, **widths))
    got = tattn.init_attention(torch.Generator().manual_seed(0), cfg,
                               **widths)
    assert {k: tuple(v["w"].shape) for k, v in got.items()} == \
        {k: tuple(v["w"].shape) for k, v in want.items()}


def test_lora_targets_hybrid(model):
    """``FAMILY_TARGETS["hybrid"]`` is the reference's; its adapters sit
    on the shared attention and every Mamba2 layer's projections, with the
    reference's shapes."""
    from repro.core.lora import FAMILY_TARGETS as JT
    from repro.core.lora import attach_lora as jattach
    from repro_torch.core.lora import FAMILY_TARGETS, attach_lora, lora_tree
    assert FAMILY_TARGETS["hybrid"] == JT["hybrid"] == (
        "wq", "wk", "wv", "wo", "in_proj", "out_proj")
    jcfg, jp, cfg, p = model
    want = jattach(jp, jax.random.PRNGKey(1), rank=4, alpha=8.0,
                   targets=JT["hybrid"])
    got = lora_tree(attach_lora(p, torch.Generator().manual_seed(1),
                                rank=4, alpha=8.0,
                                targets=FAMILY_TARGETS["hybrid"]))
    from repro.core.lora import lora_tree as jlora_tree
    jl = jlora_tree(want)
    assert [tuple(x.shape) for x in tree_util.leaves(got)] == \
        [x.shape for x in jax.tree.leaves(jl)]
    assert got["mamba"]["block"]["in_proj"]["lora_a"].shape == (2, 2, 256, 4)
    assert got["shared"]["attn"]["wq"]["lora_a"].shape == (2, 512, 4)


# ---------------------------------------------------------------------------
# the Mamba2 layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [40, 64], ids=["padded", "two_chunks"])
def test_mamba2_forward_matches_reference(model, S):
    """The chunked SSD form, its output and final state, and with
    ``return_cache`` the state and conv tail; at S = 40 the input is padded
    to 64."""
    jcfg, jp, cfg, p = model
    jb, tb = _layer(jp, p, 1, 0)
    x = _x(S)
    jy, jh = jm.mamba2_forward(jb, jcfg, jnp.asarray(x))
    ty, th = tm.mamba2_forward(tb, cfg, torch.from_numpy(x))
    _close(ty, jy)
    _close(th, jh)
    _, jst = jm.mamba2_forward(jb, jcfg, jnp.asarray(x), return_cache=True)
    _, tst = tm.mamba2_forward(tb, cfg, torch.from_numpy(x),
                               return_cache=True)
    assert set(tst) == set(jst) == {"ssm_state", "conv_buf"}
    for k in jst:
        _close(tst[k], jst[k])


def test_mamba2_forward_threads_a_state(model):
    """A second input from the first one's final state."""
    jcfg, jp, cfg, p = model
    jb, tb = _layer(jp, p)
    x1, x2 = _x(32, 1), _x(64, 2)
    _, jh = jm.mamba2_forward(jb, jcfg, jnp.asarray(x1))
    jy, jh2 = jm.mamba2_forward(jb, jcfg, jnp.asarray(x2), initial_state=jh)
    _, th = tm.mamba2_forward(tb, cfg, torch.from_numpy(x1))
    ty, th2 = tm.mamba2_forward(tb, cfg, torch.from_numpy(x2),
                                initial_state=th)
    _close(ty, jy)
    _close(th2, jh2)


def test_mamba2_decode_matches_reference(model):
    """4 recurrent steps from a prefilled cache (a padded prompt), then from
    an empty one: outputs, states and conv buffers."""
    jcfg, jp, cfg, p = model
    jb, tb = _layer(jp, p, 0, 1)
    _, jc = jm.mamba2_forward(jb, jcfg, jnp.asarray(_x(40, 4)),
                              return_cache=True)
    starts = [(jc, _state(jc)),
              (jm.init_mamba2_cache(jcfg, B, jnp.float32),
               tm.init_mamba2_cache(cfg, B, torch.float32, device="cpu"))]
    xs = _x(4, 5)
    for jc, tc in starts:
        for t in range(4):
            jy, jc = jm.mamba2_decode(jb, jcfg, jnp.asarray(xs[:, t:t + 1]),
                                      jc)
            ty, tc = tm.mamba2_decode(tb, cfg,
                                      torch.from_numpy(xs[:, t:t + 1]), tc)
            _close(ty, jy)
            for k in jc:
                _close(tc[k], jc[k])


def test_padded_state_is_the_references(model):
    """The reference's trap, kept for parity: a 40-token input's state is
    the state after 64 steps, the last 24 on a zero layer input, so it
    differs from 32 chunked steps and 8 recurrent ones by far more than
    the tolerance; the conv tail is the unpadded positions', equal to the
    recurrent one's."""
    jcfg, jp, cfg, p = model
    jb, tb = _layer(jp, p)
    x = torch.from_numpy(_x(40, 9))
    _, padded = tm.mamba2_forward(tb, cfg, x, return_cache=True)
    _, st = tm.mamba2_forward(tb, cfg, x[:, :32], return_cache=True)
    for t in range(32, 40):
        _, st = tm.mamba2_decode(tb, cfg, x[:, t:t + 1], st)
    gap = float((padded["ssm_state"] - st["ssm_state"]).abs().max())
    assert gap > 100 * TOL * float(st["ssm_state"].abs().max()), gap
    _close(padded["conv_buf"], st["conv_buf"].numpy())
    _, jst = jm.mamba2_forward(jb, jcfg, jnp.asarray(x.numpy()),
                               return_cache=True)
    _close(padded["ssm_state"], jst["ssm_state"])


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("remat", [True, False])
def test_forward_matches_reference(model, remat):
    jcfg, jp, cfg, p = model
    toks = _tokens(cfg, 40)
    want = jz.forward(jp, jcfg, jnp.asarray(toks), remat=remat)
    with torch.enable_grad():
        got = tz.forward(p, cfg, torch.as_tensor(toks), remat=remat)
    _close(got, want)


@pytest.mark.parametrize("S", [40, 64], ids=["padded", "two_chunks"])
def test_prefill_and_decode_match_reference(model, jax_steps, S):
    """Prefill into rings of CACHE_LEN slots (last logits and every cache
    leaf), then 4 decode steps; greedy tokens of every step equal."""
    jcfg, jp, cfg, p = model
    jprefill, jdecode = jax_steps
    api = get_model(cfg)
    toks = _tokens(cfg, S, 6)
    jc, jl = jprefill(jp, jnp.asarray(toks))
    tc, tl = api.prefill(p, cfg, {"tokens": torch.as_tensor(toks)},
                         cache_len=CACHE_LEN)
    _close(tl, jl)
    _close_trees(tc, jc)
    assert tc["attn"]["k"].shape == (2, B, CACHE_LEN, 4, 64)
    step = np.random.default_rng(7).integers(0, cfg.vocab_size, (4, B, 1))
    for t in range(4):
        jl, jc = jdecode(jp, jc, jnp.asarray(step[t], jnp.int32),
                         jnp.int32(S + t))
        tl, tc = api.decode_step(p, cfg, tc, {
            "token": torch.as_tensor(step[t]), "pos": S + t})
        _close(tl, jl)
        _close_trees(tc, jc)
        assert np.array_equal(tl[:, -1].argmax(-1).numpy(),
                              np.asarray(jnp.argmax(jl[:, -1], -1)))


def test_prefill_then_decode_equals_a_longer_prefill(model):
    """At a chunk-multiple prompt (64), prefill + 3 decode steps give the
    logits of a prefill of the prompt and those 3 tokens (whose pad lies
    after the last position read)."""
    _, _, cfg, p = model
    api = get_model(cfg)
    toks = _tokens(cfg, 67, 8)
    cache, lg = api.prefill(p, cfg, {"tokens": torch.as_tensor(
        toks[:, :64])}, cache_len=67)
    for t in range(3):
        lg, cache = api.decode_step(p, cfg, cache, {
            "token": torch.as_tensor(toks[:, 64 + t:65 + t]), "pos": 64 + t})
    _, want = api.prefill(p, cfg, {"tokens": torch.as_tensor(toks)})
    _close(lg, want.numpy())


def test_loss_and_gradient_match_reference(model):
    jcfg, jp, cfg, p = model
    toks, labels = _tokens(cfg, 40, 10), _tokens(cfg, 40, 11)
    labels[0, :7] = -1
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda q: jax_get_model(jcfg).loss(q, jcfg, jb)))(jp)
    api = get_model(cfg)
    leaves = [x.clone().requires_grad_(True) for x in tree_util.leaves(p)]
    batch = {"tokens": torch.as_tensor(toks),
             "labels": torch.as_tensor(labels)}
    loss = api.loss(tree_util.unflatten(p, leaves), cfg, batch)
    grads = torch.autograd.grad(loss, leaves)
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-6 * float(jloss)
    jl = jax.tree.leaves(jgrads)
    assert len(jl) == len(grads)
    for g, w in zip(grads, jl):
        _close(g, w, GRAD_TOL)
    tot, count, stats = api.loss_parts(p, cfg, batch)
    assert stats is None and int(count) == B * 40 - 7
    assert abs(float(tot / count) - float(jloss)) <= 1e-6 * float(jloss)


def test_prefill_refuses_true_len(model):
    _, _, cfg, p = model
    with pytest.raises(ValueError, match="true_len"):
        get_model(cfg).prefill(p, cfg, {"tokens": torch.zeros(
            (1, 8), dtype=torch.int64)}, true_len=[4])


# ---------------------------------------------------------------------------
# serving: batch axes, the freeze, the engine
# ---------------------------------------------------------------------------

def test_cache_batch_axes_match_reference(model):
    """Probed on the meta device: no cache is drawn anywhere."""
    from repro.serve.cache_pool import cache_batch_axes as jaxes
    jcfg, _, cfg, _ = model
    got = cache_batch_axes(get_model(cfg), cfg)
    want = jaxes(jax_get_model(jcfg), jcfg)
    assert tree_util.leaves(got) == jax.tree.leaves(want)
    assert got["mamba"]["ssm_state"] == 2 and got["attn"]["k"] == 1


def test_freeze_inactive_keeps_a_retired_lane(model):
    """The ragged serve step on 3 contiguous lanes, lane 1 inactive: every
    leaf of its lane (states, conv buffers, rings) is bit for bit what it
    was; the rings are written in place, the Mamba2 states into the pool's
    tensors; tokens equal the reference's frozen step's, and its cache."""
    from repro.launch.steps import make_serve_step as jmake
    jcfg, jp, cfg, p = model
    api = get_model(cfg)
    c, _ = api.prefill(p, cfg, {"tokens": torch.as_tensor(
        np.random.default_rng(13).integers(0, cfg.vocab_size, (3, 40)))},
        cache_len=48)
    jc = jax.tree.map(lambda t: jnp.asarray(np.array(t.numpy())), c)
    before = tree_util.map_(torch.clone, c)
    ptrs = [t.data_ptr() for t in tree_util.leaves(c)]
    pos = np.asarray([40, -1, 40], np.int32)
    tok = np.asarray([[5], [6], [7]], np.int32)
    ttok, tc = make_serve_step(cfg)(p, c, {"token": torch.as_tensor(tok),
                                           "pos": torch.as_tensor(pos)})
    assert tc is c and [t.data_ptr() for t in tree_util.leaves(tc)] == ptrs
    axes = cache_batch_axes(api, cfg)
    for new, old, ax in zip(tree_util.leaves(tc), tree_util.leaves(before),
                            tree_util.leaves(axes)):
        assert torch.equal(new.select(ax, 1), old.select(ax, 1))
        assert not torch.equal(new.select(ax, 0), old.select(ax, 0))
    jtok, jnew = jmake(jcfg)(jp, jc, {"token": jnp.asarray(tok),
                                      "pos": jnp.asarray(pos)})
    assert np.array_equal(ttok.numpy(), np.asarray(jtok))
    _close_trees(tc, jnew)


def test_engine_refusals_and_the_global_rings(model):
    """No bucketing and no paged pool (a recurrent prefill, as the
    reference's); the shared attention's rings are global, so a request
    past ``cache_len`` raises at submit, as in the reference."""
    _, _, cfg, p = model
    with pytest.raises(ValueError, match="prefill_bucket"):
        ForecastEngine(cfg, p, prefill_bucket=16, device="cpu")
    with pytest.raises(ValueError, match="paged"):
        ForecastEngine(cfg, p, paged=True, device="cpu")
    eng = ForecastEngine(cfg, p, num_slots=2, cache_len=24, device="cpu")
    assert not eng.paged and set(eng.pool.cache) == {"mamba", "attn"}
    assert eng.submit(Request(id="fits", prompt=np.arange(20) % 50,
                              max_new_tokens=4)).ok
    with pytest.raises(ValueError, match="cache_len"):
        eng.submit(Request(id="long", prompt=np.arange(21) % 50,
                           max_new_tokens=4))


def test_fixed_batch_launcher(model, jax_steps):
    """One prefill and 5 synchronous steps: the argmax chain of the
    reference's prefill and decode steps on the same prompts."""
    jcfg, jp, cfg, p = model
    jprefill, jdecode = jax_steps
    res = run_fixed_batch(cfg, p, batch=2, prompt_len=40, gen=5,
                          device="cpu", quiet=True)
    assert res["finite"] and res["tokens"].shape == (2, 6)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 40))
    cache, lg = jprefill(jp, jnp.asarray(tokens))
    tok = jnp.argmax(lg[:, -1], -1).astype(jnp.int32)[:, None]
    want = [np.asarray(tok)]
    for i in range(5):
        lg, cache = jdecode(jp, cache, tok, jnp.int32(40 + i))
        tok = jnp.argmax(lg[:, -1], -1).astype(jnp.int32)[:, None]
        want.append(np.asarray(tok))
    assert np.array_equal(res["tokens"], np.concatenate(want, 1))


def test_engine_tokens_equal_the_lanes_path(model):
    """The engine on contiguous lanes, ragged arrivals, prompts padded
    and not: each request's greedy tokens are those of the fixed-batch
    path fed the same prompts, each prefilled alone into its lane of a
    pool and every lane decoded together."""
    _, _, cfg, p = model
    trace = make_trace(cfg, 5, gen=6, max_prompt=48, rate=0.5, seed=0)
    eng = ForecastEngine(cfg, p, num_slots=3, cache_len=CACHE_LEN,
                         device="cpu")
    for r in trace:
        eng.submit(Request(**r))
    got = {k: v.tokens.tolist() for k, v in eng.run(max_steps=500).items()}
    assert not eng.paged and len(got) == len(trace)
    api = get_model(cfg)
    pool = CachePool(cfg, len(trace), CACHE_LEN, device="cpu")
    first = torch.zeros((len(trace), 1), dtype=torch.int64)
    for i, r in enumerate(trace):
        c1, lg = api.prefill(p, cfg, {"tokens": torch.as_tensor(
            [r["prompt"]])}, cache_len=CACHE_LEN)
        pool.insert(c1, i)
        first[i, 0] = lg[0, -1].argmax()
    pos = torch.as_tensor([len(r["prompt"]) for r in trace])
    tok, out = first, [first]
    for t in range(5):
        lg, new = api.decode_step(p, cfg, pool.cache,
                                  {"token": tok, "pos": pos + t})
        pool.cache = new
        tok = lg[:, -1].argmax(dim=-1)[:, None]
        out.append(tok)
    toks = torch.cat(out, 1).numpy()
    assert got == {r["id"]: toks[i].tolist() for i, r in enumerate(trace)}


def test_launcher_serves_zamba2_on_the_cpu(capsys, monkeypatch):
    from repro_torch.launch import serve
    for extra in ([], ["--engine", "--trace", "3", "--slots", "2"]):
        monkeypatch.setattr("sys.argv", [
            "serve", "--arch", ARCH, "--device", "cpu", "--prompt-len",
            "20", "--gen", "3", *extra])
        serve.main()
    out = capsys.readouterr().out
    assert "zamba2-2.7b-smoke on cpu" in out and "engine:" in out
