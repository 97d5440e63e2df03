"""The rest of the dense family and the MoE family against the JAX package:
qwen3-1.7b (G = 2, D 64 at smoke size), gemma2-27b (local/global
alternating layers, post-block norms, both logit softcaps, an embedding
multiplier), smollm-360m (G = 3), mixtral-8x7b (top-2 experts, a sliding
window) and qwen2-moe-a2.7b (top-2 of 4 routed experts plus a shared one),
each a case of every model test, on its smoke config in f32 with the
reference's weights carried over by ``bridge.params_from_jax``.

Compared within atol 1e-4 (the f32 sum-order noise of two backends, as
``tests/test_torch_model.py``): prefill logits and every cache leaf (both
trees of gemma2's cache), the trunk's hidden states (and the MoE aux loss),
8 teacher-forced decode steps with a scalar position, with ragged positions
and an inactive lane, and through a paged pool (gemma2: the paged pool
raises on both sides), the registry's loss (with the aux loss; within
1e-5), and, for the windowed configs cut to an 8-slot window, a prompt
that wraps the ring.  ``kv_pos`` is held exactly everywhere.  The MoE
block alone is held at a capacity that drops tokens, with and without
``REPRO_MOE_SLABS``, and its token-count assertion on both sides.
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
from repro_torch.models.layers.moe import router_aux
from repro_torch.models.registry import get_model

ATOL = 1e-4
LOSS_ATOL = 1e-5
S, CACHE_LEN, STEPS = 10, 24, 8
ARCHS = ["qwen3-1.7b", "gemma2-27b", "smollm-360m", "mixtral-8x7b",
         "qwen2-moe-a2.7b"]
WINDOWED = ["gemma2-27b", "mixtral-8x7b"]


@pytest.fixture(autouse=True, scope="module")
def _torch_one_thread():
    """The shapes here are tiny: one intra-op thread, so that parallel test
    workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(arch, **over):
    jcfg = jax_smoke_config(arch).replace(**over)
    cfg = get_smoke_config(arch).replace(**over)
    japi = jax_get_model(jcfg)
    jparams = japi.init(jcfg, jax.random.PRNGKey(0))
    params = bridge.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                    device="cpu")
    # one compiled JAX decode step per cache layout (eager dispatch is slow)
    japi.decode_step = jax.jit(
        lambda p, _cfg, c, b, _d=japi.decode_step: _d(p, jcfg, c, b),
        static_argnums=(1,))
    return jcfg, japi, jparams, cfg, get_model(cfg), params


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    return _pair(request.param)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0)


def _leaves(tree, path=""):
    """{path: leaf} of a cache tree (one ring tree or gemma2's pair)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{path}/{k}"))
        return out
    return {path: tree}


def _same_cache(cache, jcache):
    got, want = _leaves(cache), _leaves(jcache)
    assert sorted(got) == sorted(want)
    for path, leaf in got.items():
        if path.endswith("kv_pos"):
            assert np.array_equal(leaf.numpy(), np.asarray(want[path])), path
        else:
            _close(leaf, want[path])


def _prefill(models, tokens, true_len=None, cache_len=CACHE_LEN):
    jcfg, japi, jparams, cfg, api, params = models
    jcache, jlg = japi.prefill(jparams, jcfg, {"tokens": jnp.asarray(tokens)},
                               cache_len=cache_len,
                               true_len=None if true_len is None
                               else jnp.asarray(true_len))
    cache, lg = api.prefill(params, cfg, {"tokens": torch.as_tensor(tokens)},
                            cache_len=cache_len, true_len=true_len)
    return jcache, jlg, cache, lg


def _teacher(vocab, B, seed):
    return np.random.default_rng(seed).integers(0, vocab, (STEPS, B, 1))


def _decode_scalar(models, jcache, cache, start, B, seed):
    jcfg, japi, jparams, cfg, api, params = models
    for i, tok in enumerate(_teacher(cfg.vocab_size, B, seed)):
        jlg, jcache = japi.decode_step(
            jparams, jcfg, jcache,
            {"token": jnp.asarray(tok, jnp.int32),
             "pos": jnp.asarray(start + i, jnp.int32)})
        lg, cache = api.decode_step(params, cfg, cache,
                                    {"token": torch.as_tensor(tok),
                                     "pos": start + i})
        _close(lg, jlg)
    return jcache, cache


def test_prefill_logits_and_caches(models):
    cfg = models[3]
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, S))
    jcache, jlg, cache, lg = _prefill(models, tokens)
    assert lg.shape == (2, 1, cfg.vocab_size)
    _close(lg, jlg)
    _same_cache(cache, jcache)
    if cfg.local_global_alternating:
        n = cfg.num_layers // 2
        assert cache["local"]["k"].shape[0] == cache["global"]["k"].shape[0] \
            == n


def test_forward_hidden(models):
    """The full-sequence trunk (no cache) matches the reference's; an MoE
    trunk's summed aux loss too."""
    jcfg, _, jparams, cfg, _, params = models
    tokens = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, S))
    if cfg.family == "moe":
        from repro.models import moe_transformer as jmt
        from repro_torch.models import transformer as ttf
        want, jaux = jmt.forward(jparams, jcfg, jnp.asarray(tokens),
                                 remat=False)
        got, stats = ttf.forward_aux(params, cfg, torch.as_tensor(tokens),
                                     remat=False)
        aux = router_aux(cfg, stats, tokens.size)
        _close(aux, jaux, LOSS_ATOL)
        assert float(aux) > 0
    else:
        from repro.models import transformer as jtf
        from repro_torch.models import transformer as ttf
        want = jtf.forward(jparams, jcfg, jnp.asarray(tokens), remat=False)
        x = ttf.embed_tokens(params, cfg, torch.as_tensor(tokens))
        got = ttf.forward_hidden(params, cfg, x,
                                 positions=torch.arange(S, dtype=torch.int32))
    _close(got, want)


def test_decode_scalar_pos(models):
    cfg = models[3]
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, S))
    jcache, _, cache, _ = _prefill(models, tokens)
    jcache, cache = _decode_scalar(models, jcache, cache, S, 2, 2)
    _same_cache(cache, jcache)


def test_decode_ragged_with_inactive_lane(models):
    """Right-padded prompts (true_len) then per-row positions; lane 1 stays
    inactive (-1) and must leave every ring untouched."""
    jcfg, japi, jparams, cfg, api, params = models
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (3, S))
    true_len = np.array([10, 7, 9], np.int32)
    jcache, jlg, cache, lg = _prefill(models, tokens, true_len)
    _close(lg, jlg)
    before = {p: v[:, 1].clone() for p, v in _leaves(cache).items()}
    for i, tok in enumerate(_teacher(cfg.vocab_size, 3, 4)):
        pos = np.where(np.arange(3) == 1, -1, true_len + i).astype(np.int32)
        jlg, jcache = japi.decode_step(
            jparams, jcfg, jcache, {"token": jnp.asarray(tok, jnp.int32),
                                    "pos": jnp.asarray(pos)})
        lg, cache = api.decode_step(params, cfg, cache,
                                    {"token": torch.as_tensor(tok),
                                     "pos": torch.as_tensor(pos)})
        _close(lg, jlg)
    for p, v in _leaves(cache).items():
        assert torch.equal(v[:, 1], before[p]), p
    _same_cache(cache, jcache)


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
    an ungranted third block, lane 1 is inactive.  gemma2's local and
    global rings differ in length: a table raises on both sides."""
    jcfg, japi, jparams, cfg, api, params = models
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, (3, S))
    true_len = np.array([10, 6, 5], np.int32)
    jcache, _, cache, _ = _prefill(models, tokens, true_len)
    bs, n_blocks = 8, 11
    table = np.array([[4, 9, 1], [0, 7, 3], [10, 2, -1]], np.int32)
    tok0 = _teacher(cfg.vocab_size, 3, 6)[0]
    pos0 = np.where(np.arange(3) == 1, -1, true_len).astype(np.int32)
    if cfg.local_global_alternating:
        with pytest.raises(ValueError, match="contiguous lanes"):
            japi.decode_step(jparams, jcfg, jcache, {
                "token": jnp.asarray(tok0, jnp.int32),
                "pos": jnp.asarray(pos0), "block_tbl": jnp.asarray(table),
                "ring_len": jnp.asarray(CACHE_LEN, jnp.int32)})
        with pytest.raises(ValueError, match="contiguous lanes"):
            api.decode_step(params, cfg, cache, {
                "token": torch.as_tensor(tok0), "pos": torch.as_tensor(pos0),
                "block_tbl": torch.from_numpy(table),
                "ring_len": CACHE_LEN})
        return
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
    _same_cache(pool, jpool)


def test_loss_with_aux(models):
    """The registry's training loss (cross-entropy over labels with -1
    entries; an MoE model's plus its aux loss), and ``loss_parts``'
    summed loss over its count plus ``router_aux`` of its router
    statistics equal to it."""
    jcfg, japi, jparams, cfg, api, params = models
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, cfg.vocab_size, (2, 16))
    labels = rng.integers(0, cfg.vocab_size, (2, 16))
    labels[0, :5] = -1
    want = japi.loss(jparams, jcfg, {"tokens": jnp.asarray(tokens),
                                     "labels": jnp.asarray(labels)})
    batch = {"tokens": torch.as_tensor(tokens),
             "labels": torch.as_tensor(labels)}
    got = api.loss(params, cfg, batch)
    _close(got, want, LOSS_ATOL)
    tot, count, stats = api.loss_parts(params, cfg, batch)
    assert int(count) == 27
    if cfg.family == "moe":
        assert tuple(stats.shape) == (cfg.num_layers, 2,
                                      cfg.moe.num_experts)
        assert torch.equal(stats[:, 0].sum(-1),
                           torch.full((cfg.num_layers,), 32.0))
        tot = tot + router_aux(cfg, stats, tokens.size) * count
    else:
        assert stats is None
    _close(tot / count, want, LOSS_ATOL)


@pytest.mark.parametrize("arch", WINDOWED)
def test_prompt_wraps_the_window(arch):
    """The windowed configs cut to an 8-slot window: a 12-token prompt
    wraps the (local) ring, so the window drops slots in prefill and
    decode; gemma2's global rings keep the whole sequence."""
    models = _pair(arch, sliding_window=8)
    cfg = models[3]
    tokens = np.random.default_rng(9).integers(0, cfg.vocab_size, (2, 12))
    jcache, jlg, cache, lg = _prefill(models, tokens)
    _close(lg, jlg)
    local = cache["local"] if cfg.local_global_alternating else cache
    assert local["k"].shape[2] == 8
    assert sorted(local["kv_pos"][0, 0].tolist()) == list(range(4, 12))
    if cfg.local_global_alternating:
        assert cache["global"]["k"].shape[2] == CACHE_LEN
    _same_cache(cache, jcache)
    jcache, cache = _decode_scalar(models, jcache, cache, 12, 2, 10)
    _same_cache(cache, jcache)


# ---------------------------------------------------------------------------
# the MoE block alone
# ---------------------------------------------------------------------------

def _moe_pair(capacity_factor):
    from repro.configs.base import MoEConfig as JMoE
    from repro.models.layers.moe import init_moe as jinit_moe
    from repro_torch.configs.base import MoEConfig
    over = dict(num_experts=4, top_k=2, num_shared_experts=1,
                expert_d_ff=64, capacity_factor=capacity_factor)
    jcfg = jax_smoke_config("qwen2-moe-a2.7b").replace(moe=JMoE(**over))
    cfg = get_smoke_config("qwen2-moe-a2.7b").replace(moe=MoEConfig(**over))
    jp = jinit_moe(jax.random.PRNGKey(3), jcfg)
    p = bridge.tree_to_torch(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, cfg, p


@pytest.mark.parametrize("slabs", ["1", "2"])
def test_moe_block_drops_tokens(slabs, monkeypatch):
    """Capacity factor 0.25 over 4 groups of 32 tokens: C = 8 slots an
    expert for 16 assignments an expert on average, so about half the
    assignments are dropped; outputs within 1e-4, aux within 1e-6, with
    the expert compute in one slab or two (``REPRO_MOE_SLABS``, set on
    both sides)."""
    from repro.models.layers.moe import _capacity as jcap
    from repro.models.layers.moe import moe_block as jmoe
    from repro_torch.models.layers.moe import _capacity, moe_block
    monkeypatch.setenv("REPRO_MOE_SLABS", slabs)
    jcfg, jp, cfg, p = _moe_pair(0.25)
    assert _capacity(32, 2, 4, 0.25) == jcap(32, 2, 4, 0.25) == 8
    x = np.random.default_rng(4).standard_normal(
        (4, 32, cfg.d_model)).astype(np.float32)
    jy, jaux = jmoe(jp, jcfg, jnp.asarray(x), group_size=32)
    y, stats = moe_block(p, cfg, torch.from_numpy(x), group_size=32)
    _close(y, jy)
    _close(router_aux(cfg, stats, x.shape[0] * x.shape[1]), jaux, 1e-6)
    # the drops are real: without the shared expert, some token gets no
    # routed output at all
    del p["shared"]
    y0, _ = moe_block(p, cfg, torch.from_numpy(x), group_size=32)
    assert int((y0.abs().sum(-1) == 0).sum()) > 0


def test_moe_token_count_must_fill_groups():
    """A prefill of more than 512 tokens that is not a multiple of 512
    fails on both sides."""
    from repro.models.layers.moe import moe_block as jmoe
    from repro_torch.models.layers.moe import moe_block
    jcfg, jp, cfg, p = _moe_pair(1.25)
    x = np.zeros((1, 600, cfg.d_model), np.float32)
    with pytest.raises(AssertionError):
        jmoe(jp, jcfg, jnp.asarray(x))
    with pytest.raises(AssertionError, match="600, 512"):
        moe_block(p, cfg, torch.from_numpy(x))
