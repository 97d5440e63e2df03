"""The port's blockwise (online-softmax) ``sdpa`` against the JAX
package's, in f32 on the CPU, and a prefill over the blockwise threshold
against the reference's.

Tolerance: 2e-5 absolute and relative, the reference's own for blockwise
against naive (``tests/test_attention.py``): the two sides sum the same f32
products in another order.  A fully masked row must come out exactly 0 on
the port's blockwise path, as on both naive paths.  The reference's
blockwise path gives such a row the mean of V over the masked slots (its
online softmax takes exp(0) where a whole KV block is masked), so that row
is held against the reference's naive path.

The prefill case lowers ``BLOCKWISE_THRESHOLD`` (and the block sizes) on
both sides with ``monkeypatch``, so a smoke-sized prompt takes the
blockwise path: logits and caches within 1e-4 absolute of the
reference's, the tolerance ``tests/test_torch_model.py`` holds prefills
to, and cache positions equal.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import transformer as jtransformer
from repro.models.layers.attention import sdpa as jax_sdpa
from repro.models.registry import get_model as jax_get_model
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.models import transformer
from repro_torch.models.layers.attention import sdpa
from repro_torch.models.registry import get_model

TOL = 2e-5
MODEL_ATOL = 1e-4


def _qkv(B, Sq, Skv, H, Hk, D, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, D)).astype(np.float32),
            rng.standard_normal((B, Skv, Hk, D)).astype(np.float32),
            rng.standard_normal((B, Skv, Hk, D)).astype(np.float32))


def _both(q, k, v, **kw):
    """(reference, port) outputs of the same call as numpy arrays."""
    want = np.asarray(jax_sdpa(q, k, v, **kw))
    t = {n: (torch.from_numpy(np.asarray(a)) if isinstance(a, np.ndarray)
             else a) for n, a in kw.items()}
    got = sdpa(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
               **t).numpy()
    return want, got


S = 96
CASES = {
    "causal": dict(kind="causal"),
    "prefix": dict(kind="prefix", prefix_len=np.asarray([20, 40],
                                                        np.int32)),
    "window": dict(kind="causal", window=24),
    "softcap": dict(kind="causal", softcap=5.0),
    "full": dict(kind="full"),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("blocks", [(32, 32), (16, 48), (0, 40)],
                         ids=["32x32", "16x48", "q-whole"])
def test_blockwise_equals_reference(case, blocks):
    q, k, v = _qkv(2, S, S, 4, 2, 16)
    pos = np.arange(S, dtype=np.int32)
    kw = dict(q_pos=pos, kv_pos=pos, block_q=blocks[0], block_kv=blocks[1],
              **CASES[case])
    want, got = _both(q, k, v, **kw)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    # and the port's own naive path
    naive, _ = _both(q, k, v, **{**kw, "block_q": 0, "block_kv": 0})
    np.testing.assert_allclose(got, naive, rtol=TOL, atol=TOL)


def test_blockwise_ragged_sq_and_skv():
    """A chunk of 37 queries at positions 64-100 over 101 KV slots: both
    tails padded (Q blocks of 16, KV blocks of 32)."""
    q, k, v = _qkv(2, 37, 101, 6, 3, 8, seed=1)
    want, got = _both(q, k, v, q_pos=np.arange(64, 101, dtype=np.int32),
                      kv_pos=np.arange(101, dtype=np.int32), kind="causal",
                      block_q=16, block_kv=32)
    assert got.shape == (2, 37, 6, 8)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_blockwise_int8_scales():
    """int8 K/V with (B, Skv, Hk, 1) scales, dequantized a KV block at a
    time on both sides."""
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 70, 4, 16)).astype(np.float32)
    k = rng.integers(-127, 128, (2, 70, 2, 16)).astype(np.int8)
    v = rng.integers(-127, 128, (2, 70, 2, 16)).astype(np.int8)
    ks = rng.uniform(0.001, 0.02, (2, 70, 2, 1)).astype(np.float32)
    vs = rng.uniform(0.001, 0.02, (2, 70, 2, 1)).astype(np.float32)
    pos = np.arange(70, dtype=np.int32)
    kw = dict(q_pos=pos, kv_pos=pos, kind="causal", k_scale=ks, v_scale=vs)
    want, got = _both(q, k, v, block_q=16, block_kv=32, **kw)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    naive_want, naive_got = _both(q, k, v, **kw)
    np.testing.assert_allclose(naive_got, naive_want, rtol=TOL, atol=TOL)


def test_blockwise_fully_masked_row_is_zero():
    """Row 1's cache is empty (every kv_pos -1) and row 0's first query
    sees only a masked slot: those rows are exactly 0 on the port's
    blockwise path, as on the reference's naive one; the others equal the
    reference's blockwise path."""
    q, k, v = _qkv(2, S, S, 4, 2, 16, seed=3)
    qp = np.arange(S, dtype=np.int32)
    kvp = np.tile(qp, (2, 1))
    kvp[1] = -1
    kvp[0, 0] = -1
    kw = dict(q_pos=qp, kv_pos=kvp, kind="causal")
    want_blk, got = _both(q, k, v, block_q=32, block_kv=32, **kw)
    want_naive, _ = _both(q, k, v, **kw)
    assert not got[1].any() and not got[0, 0].any()
    assert not want_naive[1].any() and not want_naive[0, 0].any()
    np.testing.assert_allclose(got[0, 1:], want_blk[0, 1:], rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("blocks,window,steps", [
    ((32, 32), 0, 6), ((16, 48), 0, 9), ((24, 47), 24, 8)],
    ids=["32x32", "16x48", "ragged-window"])
def test_causal_skips_masked_kv_blocks_bit_identical(blocks, window, steps,
                                                     monkeypatch):
    """Under the causal mask the blockwise path skips the KV blocks that
    lie wholly after a Q block's last query (a KV block of 47 starts at
    the second Q block's last position: kept): it computes only ``steps``
    (Q block, KV block) scores, and its output equals bit for bit the
    same mask run as ``prefix`` with prefix_len 0, which visits every
    block; and the reference's within TOL."""
    from repro_torch.models.layers import attention
    q, k, v = _qkv(2, S, S, 4, 2, 16, seed=5)
    pos = np.arange(S, dtype=np.int32)
    kw = dict(q_pos=pos, kv_pos=pos, block_q=blocks[0], block_kv=blocks[1],
              window=window)
    real, calls = attention._scores, []

    def counted(*a):
        calls.append(1)
        return real(*a)

    monkeypatch.setattr(attention, "_scores", counted)
    want, got = _both(q, k, v, kind="causal", **kw)
    assert len(calls) == steps
    calls.clear()
    t = {n: torch.from_numpy(a) if isinstance(a, np.ndarray) else a
         for n, a in kw.items()}
    every = sdpa(torch.from_numpy(q), torch.from_numpy(k),
                 torch.from_numpy(v), kind="prefix",
                 prefix_len=torch.zeros(2, dtype=torch.int32), **t).numpy()
    nq, nkv = -(-S // blocks[0]), -(-S // blocks[1])
    assert len(calls) == nq * nkv > steps
    np.testing.assert_array_equal(got, every)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "fedtime-llama2-7b"])
def test_prefill_over_threshold_matches_reference(arch, monkeypatch):
    """A 40-token prefill with the threshold lowered to 32 and blocks of 16
    (a ragged tail on both axes) on both sides."""
    for mod in (jtransformer, transformer):
        monkeypatch.setattr(mod, "BLOCKWISE_THRESHOLD", 32)
        monkeypatch.setattr(mod, "BLOCK_Q", 16)
        monkeypatch.setattr(mod, "BLOCK_KV", 16)
    jcfg, cfg = jax_smoke_config(arch), get_smoke_config(arch)
    jparams = jax_get_model(jcfg).init(jcfg, jax.random.PRNGKey(0))
    params = bridge.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                    device="cpu")
    tokens = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 40))
    jcache, jlogits = jax_get_model(jcfg).prefill(
        jparams, jcfg, {"tokens": tokens.astype(np.int32)}, cache_len=48)
    cache, logits = get_model(cfg).prefill(
        params, cfg, {"tokens": torch.from_numpy(tokens)}, cache_len=48)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=0, atol=MODEL_ATOL)
    np.testing.assert_array_equal(cache["kv_pos"].numpy(),
                                  np.asarray(jcache["kv_pos"]))
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.asarray(jcache[name]), rtol=0,
                                   atol=MODEL_ATOL)
    # the same prompt on the port's naive path
    monkeypatch.setattr(transformer, "BLOCKWISE_THRESHOLD", 4096)
    _, naive = get_model(cfg).prefill(
        params, cfg, {"tokens": torch.from_numpy(tokens)}, cache_len=48)
    np.testing.assert_allclose(logits.numpy(), naive.numpy(), rtol=0,
                               atol=MODEL_ATOL)
