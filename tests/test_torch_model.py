"""The port's dense model against the JAX package, on the smoke configs of
both served architectures in f32 with the reference's weights carried over
by the bridge: qwen3-0.6b (GQA, G = 2, D 64) and fedtime-llama2-7b (MHA,
G = 1, D 32), each a case of every model test.

Compared within atol 1e-4: prefill logits and the prefilled ring, and 8
teacher-forced decode steps for each cache layout (scalar position,
ragged positions with an inactive -1 lane, paged pool with an ungranted
table entry).  The JAX side runs on the CPU through its XLA decode path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models.registry import get_model as jax_get_model
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.models.registry import get_model

ATOL = 1e-4
S, CACHE_LEN, STEPS = 10, 24, 8
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
def models(request):
    jcfg = jax_smoke_config(request.param)
    cfg = get_smoke_config(request.param)
    japi = jax_get_model(jcfg)
    jparams = japi.init(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    params = bridge.params_from_jax(tree, cfg, device="cpu")
    # one compiled JAX decode step per cache layout (eager dispatch is slow)
    japi.decode_step = jax.jit(
        lambda p, _cfg, c, b, _d=japi.decode_step: _d(p, jcfg, c, b),
        static_argnums=(1,))
    return jcfg, japi, jparams, cfg, get_model(cfg), params


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0)


def _prefill(models, tokens, true_len=None):
    jcfg, japi, jparams, cfg, api, params = models
    jcache, jlg = japi.prefill(jparams, jcfg, {"tokens": jnp.asarray(tokens)},
                               cache_len=CACHE_LEN,
                               true_len=None if true_len is None
                               else jnp.asarray(true_len))
    cache, lg = api.prefill(params, cfg, {"tokens": torch.as_tensor(tokens)},
                            cache_len=CACHE_LEN, true_len=true_len)
    return jcache, jlg, cache, lg


def _teacher(vocab, B, seed):
    return np.random.default_rng(seed).integers(0, vocab, (STEPS, B, 1))


def test_prefill_logits_and_ring(models):
    cfg = models[3]
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, S))
    jcache, jlg, cache, lg = _prefill(models, tokens)
    assert lg.shape == (2, 1, cfg.vocab_size)
    _close(lg, jlg)
    for name in ("k", "v"):
        _close(cache[name], jcache[name])
    assert np.array_equal(cache["kv_pos"].numpy(), np.asarray(jcache["kv_pos"]))


def test_forward_hidden(models):
    """The full-sequence trunk (no cache) matches the reference's."""
    from repro.models import transformer as jtf
    from repro_torch.models import transformer as ttf
    jcfg, _, jparams, cfg, _, params = models
    tokens = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, S))
    want = jtf.forward(jparams, jcfg, jnp.asarray(tokens), remat=False)
    x = ttf.embed_tokens(params, cfg, torch.as_tensor(tokens))
    got = ttf.forward_hidden(params, cfg, x,
                             positions=torch.arange(S, dtype=torch.int32))
    _close(got, want)


def test_decode_scalar_pos(models):
    jcfg, japi, jparams, cfg, api, params = models
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, S))
    jcache, _, cache, _ = _prefill(models, tokens)
    for i, tok in enumerate(_teacher(cfg.vocab_size, 2, 2)):
        jlg, jcache = japi.decode_step(
            jparams, jcfg, jcache,
            {"token": jnp.asarray(tok, jnp.int32),
             "pos": jnp.asarray(S + i, jnp.int32)})
        lg, cache = api.decode_step(params, cfg, cache,
                                    {"token": torch.as_tensor(tok),
                                     "pos": S + i})
        _close(lg, jlg)


def test_decode_ragged_with_inactive_lane(models):
    """Right-padded prompts (true_len) then per-row positions; lane 1 stays
    inactive (-1) and must leave its ring untouched."""
    jcfg, japi, jparams, cfg, api, params = models
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (3, S))
    true_len = np.array([10, 7, 9], np.int32)
    jcache, jlg, cache, lg = _prefill(models, tokens, true_len)
    _close(lg, jlg)
    ring_before = cache["k"][:, 1].clone()
    for i, tok in enumerate(_teacher(cfg.vocab_size, 3, 4)):
        pos = np.where(np.arange(3) == 1, -1, true_len + i).astype(np.int32)
        jlg, jcache = japi.decode_step(
            jparams, jcfg, jcache, {"token": jnp.asarray(tok, jnp.int32),
                                    "pos": jnp.asarray(pos)})
        lg, cache = api.decode_step(params, cfg, cache,
                                    {"token": torch.as_tensor(tok),
                                     "pos": torch.as_tensor(pos)})
        _close(lg, jlg)
    assert torch.equal(cache["k"][:, 1], ring_before)
    _close(cache["k"], jcache["k"])
    assert np.array_equal(cache["kv_pos"].numpy(), np.asarray(jcache["kv_pos"]))


def _to_pool(ring, table, n_blocks, bs):
    """(L, B, ring, ...) ring leaf -> (L, n_blocks, bs, ...) pool under
    ``table`` (blocks no table row cites stay zero / -1)."""
    ring = np.asarray(ring)
    L, B = ring.shape[:2]
    fill = -1 if ring.dtype == np.int32 else 0
    pool = np.full((L, n_blocks, bs) + ring.shape[3:], fill, ring.dtype)
    for b in range(B):
        for j, pb in enumerate(table[b]):
            if pb >= 0:
                pool[:, pb] = ring[:, b, j * bs:(j + 1) * bs]
    return pool


def test_decode_paged(models):
    """The prefilled rings scattered into a shuffled block pool; lane 2 has
    an ungranted third block, lane 1 is inactive."""
    jcfg, japi, jparams, cfg, api, params = models
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, (3, S))
    true_len = np.array([10, 6, 5], np.int32)
    jcache, _, cache, _ = _prefill(models, tokens, true_len)
    bs, n_blocks = 8, 11
    table = np.array([[4, 9, 1], [0, 7, 3], [10, 2, -1]], np.int32)
    jpool = {n: jnp.asarray(_to_pool(jcache[n], table, n_blocks, bs))
             for n in jcache}
    pool = {n: torch.from_numpy(_to_pool(cache[n].numpy(), table, n_blocks,
                                         bs)) for n in cache}
    for i, tok in enumerate(_teacher(cfg.vocab_size, 3, 6)):
        pos = np.where(np.arange(3) == 1, -1, true_len + i).astype(np.int32)
        jlg, jpool = japi.decode_step(
            jparams, jcfg, jpool,
            {"token": jnp.asarray(tok, jnp.int32), "pos": jnp.asarray(pos),
             "block_tbl": jnp.asarray(table),
             "ring_len": jnp.asarray(CACHE_LEN, jnp.int32)})
        lg, pool = api.decode_step(
            params, cfg, pool,
            {"token": torch.as_tensor(tok), "pos": torch.as_tensor(pos),
             "block_tbl": torch.from_numpy(table), "ring_len": CACHE_LEN})
        _close(lg, jlg)
    _close(pool["k"], jpool["k"])
    assert np.array_equal(pool["kv_pos"].numpy(), np.asarray(jpool["kv_pos"]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_round_trip(dtype):
    """JAX tree -> port -> numpy is bit-exact, layout kept: stacked layer
    axis, (in, out) weights, tied embedding table."""
    jcfg = jax_smoke_config("qwen3-0.6b").replace(param_dtype=dtype)
    cfg = get_smoke_config("qwen3-0.6b").replace(param_dtype=dtype)
    tree = jax.tree.map(np.asarray,
                        jax_get_model(jcfg).init(jcfg, jax.random.PRNGKey(1)))
    params = bridge.params_from_jax(tree, cfg, device="cpu")
    wq = params["layers"]["attn"]["wq"]["w"]
    assert wq.shape == (cfg.num_layers, cfg.d_model, cfg.q_dim)
    assert wq.dtype == getattr(torch, dtype)
    assert "lm_head" not in params
    back = bridge.params_to_numpy(params)
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        b = flat_b[path]
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), path


def test_bridge_rejects_another_model(models):
    tree = jax.tree.map(np.asarray, models[2])
    other = models[3].replace(num_layers=3)
    with pytest.raises(ValueError, match="layers"):
        bridge.params_from_jax(tree, other, device="cpu")
