"""seamless-m4t-medium (family ``encdec``: a bidirectional encoder over
stub frame embeddings, a decoder with self- and cross-attention) against
the JAX package: the attention layer's cross form (``kv_x``, no RoPE), the
cross decode over a memory with empty slots and an empty lane, the
encoder (naive and blockwise), the model's forward, prefill, decode, loss
and gradients, greedy tokens of the fixed-batch launcher and the serve
step, on the smoke config in f32 (2 encoder and 2 decoder layers, d_model
256, 4/4 heads of 64, d_ff 512, vocab 512, 128 source slots), with the
reference's weights carried over by the bridge and the same numpy inputs
fed to both.

Tolerances, and why:
  * hidden states, the memory, logits, attention outputs and every cache
    leaf: within 1e-5 of each tensor's largest magnitude (f32; the
    products and the softmax run in another order);
  * the loss within 1e-6 relative; each gradient leaf within 1e-4 of its
    largest magnitude, the bound ``test_torch_zamba2.py`` holds;
  * greedy tokens, positions and the empty lane's output (exactly 0):
    exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import encdec as je
from repro.models.layers import attention as jattn
from repro.models.registry import get_model as jax_get_model
from repro_torch import bridge
from repro_torch import tree as tree_util
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch.serve import run_fixed_batch
from repro_torch.launch.steps import make_serve_step
from repro_torch.models import encdec as te
from repro_torch.models import transformer
from repro_torch.models.layers import attention as tattn
from repro_torch.models.registry import get_model, train_batch_shapes

ARCH = "seamless-m4t-medium"
TOL = 1e-5
GRAD_TOL = 1e-4
B = 2
F = 24                       # source frames (of the smoke config's 128)
CACHE_LEN = 48


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
    prefill = jax.jit(lambda p, f, t: api.prefill(
        p, jcfg, {"frames": f, "tokens": t}, cache_len=CACHE_LEN))
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


def _frames(n=F, seed=0, rows=B):
    return np.random.default_rng(seed).standard_normal(
        (rows, n, 256)).astype(np.float32)


def _tokens(cfg, S, seed=0, rows=B):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (rows, S))


def _both(fr, tk):
    """The batch for each side: (reference's, port's)."""
    return ({"frames": jnp.asarray(fr), "tokens": jnp.asarray(tk)},
            {"frames": torch.as_tensor(fr), "tokens": torch.as_tensor(tk)})


# ---------------------------------------------------------------------------
# config, init, bridge, LoRA targets, batch shapes
# ---------------------------------------------------------------------------

def test_config_and_init_shapes_match_reference(model):
    """Full width and smoke: the port's config is the reference's, and
    ``init`` at full width (fakes: no memory) has the reference's leaves,
    shapes and dtypes (0.616 B parameters, 1.23 GB in bf16); the port's
    own smoke draw has its scales."""
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
    assert 0.61e9 < n < 0.62e9                     # 0.616 B parameters
    _, jp, cfg, _ = model
    p = get_model(cfg).init(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    for g, w in zip(tree_util.leaves(p), jax.tree.leaves(jp)):
        assert tuple(g.shape) == w.shape and str(g.dtype)[6:] == \
            w.dtype.name
        w = np.asarray(w)
        if not np.allclose(g.numpy(), w, rtol=1e-6, atol=0):   # a draw
            assert abs(float(g.std()) / float(w.std()) - 1) < 0.1


def test_bridge_checks_the_encdec_tree(model):
    jcfg, jp, cfg, p = model
    back = bridge.params_to_numpy(p)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        assert np.array_equal(a, np.asarray(b))
    assert set(p) == {"frame_proj", "embed", "encoder", "enc_norm",
                      "decoder", "final_norm"}
    assert "cross" in p["decoder"] and "cross" not in p["encoder"]
    tree = jax.tree.map(np.asarray, jp)
    for other in (cfg.replace(d_model=128), cfg.replace(num_layers=3),
                  cfg.replace(encdec=dataclasses.replace(
                      cfg.encdec, encoder_layers=4))):
        with pytest.raises(ValueError):
            bridge.params_from_jax(tree, other, device="cpu")
    no_cross = dict(tree, decoder={k: v for k, v in tree["decoder"].items()
                                   if k != "cross"})
    with pytest.raises(ValueError, match="cross"):
        bridge.params_from_jax(no_cross, cfg, device="cpu")


def test_lora_targets_encdec(model):
    """``FAMILY_TARGETS["encdec"]`` is the reference's; its adapters sit on
    the encoder's and both decoder attentions' projections, with the
    reference's shapes; ``frame_proj`` stays unquantized."""
    from repro.core.lora import FAMILY_TARGETS as JT
    from repro.core.lora import attach_lora as jattach
    from repro.core.lora import lora_tree as jlora_tree
    from repro_torch.core.lora import (FAMILY_TARGETS, NO_QUANT, attach_lora,
                                       lora_tree, quantize_base)
    assert FAMILY_TARGETS["encdec"] == JT["encdec"] == ("wq", "wk", "wv",
                                                        "wo")
    jcfg, jp, cfg, p = model
    want = jlora_tree(jattach(jp, jax.random.PRNGKey(1), rank=4, alpha=8.0,
                              targets=JT["encdec"]))
    got = lora_tree(attach_lora(p, torch.Generator().manual_seed(1),
                                rank=4, alpha=8.0,
                                targets=FAMILY_TARGETS["encdec"]))
    assert [tuple(x.shape) for x in tree_util.leaves(got)] == \
        [x.shape for x in jax.tree.leaves(want)]
    assert got["decoder"]["cross"]["wk"]["lora_a"].shape == (2, 256, 4)
    assert got["encoder"]["attn"]["wo"]["lora_b"].shape == (2, 4, 256)
    assert "frame_proj" in NO_QUANT
    q = quantize_base(p, qblock=64, targets=FAMILY_TARGETS["encdec"])
    assert "w" in q["frame_proj"] and "w_nf4" in q["decoder"]["cross"]["wq"]


def test_batch_shapes_carry_the_frames():
    """``frames`` of ``min(seq, max_source_len)`` bf16 embeddings a row, at
    full width and smoke size, as the reference's."""
    from repro.models import registry as jregistry
    for get, jget, seq in ((get_config, jax_config, 8192),
                           (get_smoke_config, jax_smoke_config, 40),
                           (get_smoke_config, jax_smoke_config, 200)):
        got = train_batch_shapes(get(ARCH), 3, seq)
        want = jregistry.train_batch_shapes(jget(ARCH), 3, seq)
        assert {k: s for k, (s, _) in got.items()} == \
            {k: s for k, (s, _) in want.items()}
        assert got["frames"][1] == torch.bfloat16
    assert train_batch_shapes(get_config(ARCH), 2, 8192)["frames"][0] == \
        (2, 4096, 1024)


# ---------------------------------------------------------------------------
# the attention layer: cross attention and its decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["full", "causal"])
def test_attention_with_kv_x_matches_reference(model, kind):
    """``attention`` with ``kv_x`` (a memory of another length), its
    positions and ``use_rope=False``: the output and the returned memory
    K/V; a self call with ``use_rope`` off too."""
    jcfg, jp, cfg, p = model
    jl = jax.tree.map(lambda a: a[0], jp["decoder"]["cross"])
    tl = transformer.layer(p["decoder"]["cross"], 0)
    x, mem = _frames(12, 1), _frames(F, 2)
    qp, mp = np.arange(12, dtype=np.int32), np.arange(F, dtype=np.int32)
    jy, (jk, jv) = jattn.attention(
        jl, jcfg, jnp.asarray(x), positions=jnp.asarray(qp), kind=kind,
        kv_x=jnp.asarray(mem), kv_positions=jnp.asarray(mp), use_rope=False,
        return_kv=True)
    ty, (tk, tv) = tattn.attention(
        tl, cfg, torch.as_tensor(x), positions=torch.as_tensor(qp),
        kind=kind, kv_x=torch.as_tensor(mem),
        kv_positions=torch.as_tensor(mp), use_rope=False, return_kv=True)
    _close(ty, jy)
    _close(tk, jk)
    _close(tv, jv)
    jy = jattn.attention(jl, jcfg, jnp.asarray(x), positions=jnp.asarray(qp),
                         kind=kind, use_rope=False)
    ty = tattn.attention(tl, cfg, torch.as_tensor(x),
                         positions=torch.as_tensor(qp), kind=kind,
                         use_rope=False)
    _close(ty, jy)


def test_cross_attention_skips_the_arange_shortcut(model, monkeypatch):
    """A cross call (Sq != Skv) never reads its skip table off the shapes:
    ``sdpa`` gets ``arange=False`` for it and ``True`` for a self call."""
    _, _, cfg, p = model
    seen = []
    real = tattn.sdpa

    def spy(*a, **k):
        seen.append(k["arange"])
        return real(*a, **k)

    monkeypatch.setattr(tattn, "sdpa", spy)
    tl = transformer.layer(p["decoder"]["cross"], 0)
    x, mem = torch.as_tensor(_frames(12, 1)), torch.as_tensor(_frames(F, 2))
    pos = torch.arange(12, dtype=torch.int32)
    tattn.attention(tl, cfg, x, positions=pos, kind="full", kv_x=mem,
                    kv_positions=torch.arange(F, dtype=torch.int32),
                    use_rope=False)
    tattn.attention(tl, cfg, x, positions=pos, kind="causal")
    assert seen == [False, True]


def test_attn_cross_decode_matches_reference(model):
    """The cross decode through the plain version (tensors on the CPU) over
    a memory whose row 0 has empty (-1) slots in its middle and tail and
    whose row 2 has none valid: within TOL of the reference's; the empty
    lane exactly 0; the memory unchanged."""
    jcfg, jp, cfg, p = model
    jl = jax.tree.map(lambda a: a[1], jp["decoder"]["cross"])
    tl = transformer.layer(p["decoder"]["cross"], 1)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 1, 256)).astype(np.float32)
    mk = rng.standard_normal((3, 32, 4, 64)).astype(np.float32)
    mv = rng.standard_normal((3, 32, 4, 64)).astype(np.float32)
    mpos = np.tile(np.arange(32, dtype=np.int32), (3, 1))
    mpos[0, 10:14] = -1
    mpos[0, 28:] = -1
    mpos[2] = -1
    want = jattn.attn_cross_decode(jl, jcfg, jnp.asarray(x), jnp.asarray(mk),
                                   jnp.asarray(mv), jnp.asarray(mpos))
    tk, tv = torch.as_tensor(mk), torch.as_tensor(mv)
    got = tattn.attn_cross_decode(tl, cfg, torch.as_tensor(x), tk, tv,
                                  torch.as_tensor(mpos))
    _close(got[:2], np.asarray(want)[:2])
    assert torch.count_nonzero(got[2]) == 0
    assert np.array_equal(tk.numpy(), mk) and np.array_equal(tv.numpy(), mv)
    # an empty slot adds nothing: its K/V may be anything
    mk2 = mk.copy()
    mk2[0, 10:14] = 1e3
    again = tattn.attn_cross_decode(tl, cfg, torch.as_tensor(x),
                                    torch.as_tensor(mk2), tv,
                                    torch.as_tensor(mpos))
    assert torch.equal(again, got)


# ---------------------------------------------------------------------------
# the encoder and the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("remat", [True, False])
def test_encode_and_forward_match_reference(model, remat):
    """The memory and the decoder's final hidden states, with remat on and
    off (under gradients on the port's side, so the recompute runs)."""
    jcfg, jp, cfg, p = model
    fr, tk = _frames(), _tokens(cfg, 20)
    jmem = je.encode(jp, jcfg, jnp.asarray(fr), remat=remat)
    jh = je.forward(jp, jcfg, jnp.asarray(fr), jnp.asarray(tk), remat=remat)
    with torch.enable_grad():
        tmem = te.encode(p, cfg, torch.as_tensor(fr), remat=remat)
        th = te.forward(p, cfg, torch.as_tensor(fr), torch.as_tensor(tk),
                        remat=remat)
    _close(tmem, jmem)
    _close(th, jh)


def test_encoder_blockwise_path_matches_reference(model, monkeypatch):
    """With ``BLOCKWISE_THRESHOLD`` lowered on both sides, a 40-frame
    source takes the blockwise path (Q blocks of 16, KV blocks of 16, a
    ragged tail; full attention, so no skip table): the memory within TOL
    of the reference's blockwise memory and of the port's own naive one,
    and the blockwise path really runs."""
    jcfg, jp, cfg, p = model
    fr = _frames(40, 3)
    naive = te.encode(p, cfg, torch.as_tensor(fr), remat=False)
    for mod in (je, transformer):
        monkeypatch.setattr(mod, "BLOCKWISE_THRESHOLD", 32)
        monkeypatch.setattr(mod, "BLOCK_Q", 16)
        monkeypatch.setattr(mod, "BLOCK_KV", 16)
    calls = []
    real = tattn._sdpa_blockwise

    def spy(*a, **k):
        calls.append(a[5])                   # kind
        return real(*a, **k)

    monkeypatch.setattr(tattn, "_sdpa_blockwise", spy)
    want = je.encode(jp, jcfg, jnp.asarray(fr), remat=False)
    got = te.encode(p, cfg, torch.as_tensor(fr), remat=False)
    assert calls == ["full"] * cfg.encdec.encoder_layers
    _close(got, want)
    _close(got, naive.numpy())


@pytest.mark.parametrize("S", [20, 37], ids=["short", "odd"])
def test_prefill_and_decode_match_reference(model, jax_steps, S):
    """Prefill (last logits and every cache leaf: the self rings of
    CACHE_LEN slots, the memory K/V and its positions), then 4 decode
    steps; greedy tokens of every step equal; the memory left as it was."""
    jcfg, jp, cfg, p = model
    jprefill, jdecode = jax_steps
    api = get_model(cfg)
    fr, tk = _frames(seed=4), _tokens(cfg, S, 6)
    jc, jl = jprefill(jp, jnp.asarray(fr), jnp.asarray(tk))
    tc, tl = api.prefill(p, cfg, _both(fr, tk)[1], cache_len=CACHE_LEN)
    _close(tl, jl)
    _close_trees(tc, jc)
    assert tc["self"]["k"].shape == (2, B, CACHE_LEN, 4, 64)
    assert tc["mem_k"].shape == (2, B, F, 4, 64)
    assert torch.equal(tc["mem_pos"], torch.arange(F).expand(B, F).int())
    mem = [tc[k].clone() for k in ("mem_k", "mem_v", "mem_pos")]
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
    assert all(torch.equal(tc[k], m) for k, m in
               zip(("mem_k", "mem_v", "mem_pos"), mem))


def test_prefill_then_decode_equals_a_longer_prefill(model):
    """Prefill + 3 decode steps give the logits of a prefill of the prompt
    and those 3 tokens over the same frames."""
    _, _, cfg, p = model
    api = get_model(cfg)
    fr = torch.as_tensor(_frames(seed=8))
    toks = _tokens(cfg, 23, 8)
    cache, lg = api.prefill(p, cfg, {"frames": fr, "tokens": torch.as_tensor(
        toks[:, :20])}, cache_len=23)
    for t in range(3):
        lg, cache = api.decode_step(p, cfg, cache, {
            "token": torch.as_tensor(toks[:, 20 + t:21 + t]), "pos": 20 + t})
    _, want = api.prefill(p, cfg, {"frames": fr,
                                   "tokens": torch.as_tensor(toks)})
    _close(lg, want.numpy())


def test_init_cache_matches_reference(model):
    """Empty self rings of the prompt's length and a memory of
    ``max_source_len`` slots at -1, as the reference's."""
    jcfg, _, cfg, _ = model
    want = jax_get_model(jcfg).init_cache(jcfg, B, 40, dtype=jnp.float32)
    got = get_model(cfg).init_cache(cfg, B, 40, dtype=torch.float32,
                                    device="cpu")
    for g, w in zip(tree_util.leaves(got), jax.tree.leaves(want)):
        assert tuple(g.shape) == w.shape
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_loss_and_gradient_match_reference(model):
    jcfg, jp, cfg, p = model
    fr, toks, labels = _frames(seed=9), _tokens(cfg, 20, 10), \
        _tokens(cfg, 20, 11)
    labels[0, :5] = -1
    jb = {"frames": jnp.asarray(fr), "tokens": jnp.asarray(toks),
          "labels": jnp.asarray(labels)}
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda q: jax_get_model(jcfg).loss(q, jcfg, jb)))(jp)
    api = get_model(cfg)
    leaves = [x.clone().requires_grad_(True) for x in tree_util.leaves(p)]
    batch = {"frames": torch.as_tensor(fr), "tokens": torch.as_tensor(toks),
             "labels": torch.as_tensor(labels)}
    loss = api.loss(tree_util.unflatten(p, leaves), cfg, batch)
    grads = torch.autograd.grad(loss, leaves)
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-6 * float(jloss)
    jl = jax.tree.leaves(jgrads)
    assert len(jl) == len(grads)
    for g, w in zip(grads, jl):
        _close(g, w, GRAD_TOL)
    tot, count, stats = api.loss_parts(p, cfg, batch)
    assert stats is None and int(count) == B * 20 - 5
    assert abs(float(tot / count) - float(jloss)) <= 1e-6 * float(jloss)


def test_prefill_refuses_true_len(model):
    _, _, cfg, p = model
    with pytest.raises(ValueError, match="true_len"):
        get_model(cfg).prefill(p, cfg, {
            "frames": torch.zeros((1, 4, 256)),
            "tokens": torch.zeros((1, 8), dtype=torch.int64)}, true_len=[4])


def test_vlm_still_refused():
    from repro_torch.models import registry
    vlm = get_smoke_config("qwen3-0.6b").replace(family="vlm")
    for fn, args in ((registry.get_model, ()),
                     (registry.train_batch_shapes, (2, 8))):
        with pytest.raises(NotImplementedError):
            fn(vlm, *args)


# ---------------------------------------------------------------------------
# serving: the serve step and the fixed-batch launcher
# ---------------------------------------------------------------------------

def test_serve_step_matches_reference(model):
    """The ragged serve step (lane 1 inactive): tokens and the cache equal
    the reference's; the rings are written in place, the inactive lane's
    ring slot untouched and its token passed through."""
    from repro.launch.steps import make_serve_step as jmake
    jcfg, jp, cfg, p = model
    api = get_model(cfg)
    fr, tk = _frames(seed=12, rows=3), _tokens(cfg, 20, 13, rows=3)
    c, _ = api.prefill(p, cfg, {"frames": torch.as_tensor(fr),
                                "tokens": torch.as_tensor(tk)}, cache_len=28)
    jc = jax.tree.map(lambda t: jnp.asarray(np.array(t.numpy())), c)
    before = c["self"]["k"][:, 1].clone()
    ptrs = [t.data_ptr() for t in tree_util.leaves(c)]
    pos = np.asarray([20, -1, 20], np.int32)
    tok = np.asarray([[5], [6], [7]], np.int32)
    ttok, tc = make_serve_step(cfg)(p, c, {"token": torch.as_tensor(tok),
                                           "pos": torch.as_tensor(pos)})
    assert [t.data_ptr() for t in tree_util.leaves(tc)] == ptrs
    assert torch.equal(tc["self"]["k"][:, 1], before) and ttok[1, 0] == 6
    jtok, jnew = jmake(jcfg)(jp, jc, {"token": jnp.asarray(tok),
                                      "pos": jnp.asarray(pos)})
    assert np.array_equal(ttok.numpy(), np.asarray(jtok))
    _close_trees(tc, jnew)


def test_fixed_batch_launcher(model, jax_steps):
    """One prefill over zero frames (the reference launcher's non-token
    inputs) and 5 synchronous steps: the argmax chain of the reference's
    prefill and decode steps on the same prompts; seeded frames through
    ``inputs`` change the tokens."""
    jcfg, jp, cfg, p = model
    res = run_fixed_batch(cfg, p, batch=2, prompt_len=40, gen=5,
                          device="cpu", quiet=True)
    assert res["finite"] and res["tokens"].shape == (2, 6)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 40))
    prefill = jax.jit(lambda q, f, t: jax_get_model(jcfg).prefill(
        q, jcfg, {"frames": f, "tokens": t}, cache_len=45))
    _, jdecode = jax_steps
    cache, lg = prefill(jp, jnp.zeros((2, 40, 256), jnp.bfloat16),
                        jnp.asarray(tokens))
    tok = jnp.argmax(lg[:, -1], -1).astype(jnp.int32)[:, None]
    want = [np.asarray(tok)]
    for i in range(5):
        lg, cache = jdecode(jp, cache, tok, jnp.int32(40 + i))
        tok = jnp.argmax(lg[:, -1], -1).astype(jnp.int32)[:, None]
        want.append(np.asarray(tok))
    assert np.array_equal(res["tokens"], np.concatenate(want, 1))
    seeded = run_fixed_batch(cfg, p, batch=2, prompt_len=40, gen=5,
                             device="cpu", quiet=True, inputs={
                                 "frames": torch.as_tensor(_frames(40, 3))})
    assert seeded["finite"] and not np.array_equal(seeded["tokens"],
                                                   res["tokens"])


def test_launcher_serves_seamless_on_the_cpu(capsys, monkeypatch):
    from repro_torch.launch import serve
    monkeypatch.setattr("sys.argv", [
        "serve", "--arch", ARCH, "--device", "cpu", "--prompt-len", "20",
        "--gen", "3"])
    serve.main()
    out = capsys.readouterr().out
    assert "seamless-m4t-medium-smoke on cpu" in out and "decode:" in out


def test_train_launcher_fills_the_frames(monkeypatch):
    """``launch.train``'s synthetic batch carries zero frames beside the
    Markov tokens; two steps run and their losses are finite."""
    from repro_torch.launch import train as launch_train
    cfg = get_smoke_config(ARCH)
    from repro_torch.data.tokens import lm_batches, markov_tokens
    it = lm_batches(markov_tokens(4096, cfg.vocab_size, seed=0), 2, 16)
    b = launch_train.synth_batch(cfg, 2, 16, it, device="cpu")
    assert b["frames"].shape == (2, 16, 256) and not b["frames"].any()
    run = launch_train.run(launch_train.parse_args(
        ["--arch", ARCH, "--steps", "2", "--batch", "2", "--seq", "16",
         "--device", "cpu"]))
    assert len(run.losses) == 2 and all(np.isfinite(run.losses))


# ---------------------------------------------------------------------------
# flash-decode's (1, 64) instance: its shape and cost rules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["self_ring", "cross_memory", "pool"])
def test_flash_decode_rules_at_1_64(case):
    """On fake CUDA tensors at phase 12d's shapes (16/16 heads of 64): the
    shape rule takes the (1, 64) instance and gives q's shape and type;
    the cost rule counts 4 H D FLOPs a slot and each input read once (K,
    V and kv_pos at every slot walked, q, the table, q_pos) and the output
    written once, in closed form."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.kernels import flash_decode as fd
    B, H, D = 4, 16, 64
    S = {"self_ring": 576, "cross_memory": 512, "pool": 128}[case]
    with FakeTensorMode(allow_non_fake_inputs=True):
        def t(*shape, dt=torch.bfloat16):
            return torch.empty(shape, dtype=dt, device="cuda")
        q, kw = t(B, 1, H, D), {}
        if case == "pool":
            n, bs = 96, 16
            k, v, kvp = t(n, bs, H, D), t(n, bs, H, D), t(n, bs,
                                                          dt=torch.int32)
            kw["block_tables"] = t(B, S // bs, dt=torch.int32)
            qp = t(B, dt=torch.int32)
        else:
            k, v, kvp = t(B, S, H, D), t(B, S, H, D), t(B, S,
                                                        dt=torch.int32)
            qp = t(B, dt=torch.int32)
            if case == "cross_memory":
                kw["kind"], qp = "full", 0
        out = fd.flash_decode_shape(q, k, v, kvp, qp, **kw)
        flops, nbytes = fd.flash_decode_cost(q, k, v, kvp, qp, **kw)
    assert out.shape == q.shape and out.dtype == q.dtype
    slots = B * S
    assert flops == 4 * H * D * slots
    want = (2 * slots * H * D * 2 + slots * 4 + 2 * B * H * D * 2
            + (B * 4 if case != "cross_memory" else 0)
            + (B * (S // 16) * 4 if case == "pool" else 0))
    assert nbytes == want
