"""The port's plain flash-decode and block copy against the JAX package.

Inputs are drawn with numpy and handed to both packages.  The JAX side runs
its Pallas kernel in interpret mode and its ``flash_decode_ref`` oracle;
the port's side is its plain PyTorch version, which the CUDA kernel is
held to on the card (tests/test_torch_gpu_kernels.py, chip_smoke.py).

Tolerances: f32 caches 1e-5 (atol and rtol; the sums run in another order);
bf16 and int8 caches 2e-2 (the output is rounded to bf16 and the int8
scales are bf16).  Rows with no valid slot must be exactly 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_decode import flash_decode as jax_flash_decode
from repro_torch.kernels import flash_decode as tfd
from repro_torch.kernels import ops as tops


@pytest.fixture(autouse=True, scope="module")
def _torch_one_thread():
    """The shapes here are tiny: one intra-op thread, so that parallel test
    workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _quant(x):
    """The reference's int8 absmax quantizer, in numpy."""
    amax = np.abs(x).max(-1, keepdims=True)
    scale = np.maximum(amax, 1e-6) / 127.0
    scale = np.array(jnp.asarray(scale, jnp.bfloat16).astype(jnp.float32))
    q = np.clip(np.round(x / scale), -127, 127).astype(np.int8)
    return q, scale


def _case(*, B=3, S=72, Hk=2, G=2, D=32, wrap=False, int8=False, seed=0,
          empty_row=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, 1, Hk * G, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hk, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hk, D)).astype(np.float32)
    if wrap:
        pos = np.array([S + S // 2 + 3 + b for b in range(B)])
    else:
        pos = np.array([S - 1 - 5 * b for b in range(B)])
    kv_pos = np.full((B, S), -1, np.int32)
    for b in range(B):
        for p in range(max(0, pos[b] - S + 1), pos[b] + 1):
            kv_pos[b, p % S] = p
    if empty_row is not None:
        kv_pos[empty_row] = -1
    scales = {}
    if int8:
        k, ks = _quant(k)
        v, vs = _quant(v)
        scales = {"k_scale": ks, "v_scale": vs}
    return q, k, v, kv_pos, pos.astype(np.int32), scales


def _jax(arrs, scales, dtype):
    q, k, v, kv_pos, pos = arrs
    jq = jnp.asarray(q, dtype)
    if k.dtype == np.int8:
        jk, jv = jnp.asarray(k), jnp.asarray(v)
    else:
        jk, jv = jnp.asarray(k, dtype), jnp.asarray(v, dtype)
    js = {n: jnp.asarray(s, jnp.bfloat16) for n, s in scales.items()}
    return jq, jk, jv, jnp.asarray(kv_pos), jnp.asarray(pos), js


def _torch(arrs, scales, dtype):
    q, k, v, kv_pos, pos = arrs
    tq = torch.from_numpy(q).to(dtype)
    if k.dtype == np.int8:
        tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    else:
        tk, tv = torch.from_numpy(k).to(dtype), torch.from_numpy(v).to(dtype)
    ts = {n: torch.from_numpy(s).to(torch.bfloat16)
          for n, s in scales.items()}
    return tq, tk, tv, torch.from_numpy(kv_pos), torch.from_numpy(pos), ts


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _check(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


CONTIG = [
    # (name, case kwargs, call kwargs)
    ("causal-G1", dict(G=1), {}),
    ("causal-G2", dict(G=2), {}),
    ("causal-G4", dict(G=4, seed=1), {}),
    ("wrap-window", dict(wrap=True, seed=2), dict(window=40)),
    ("prefix", dict(seed=3), dict(kind="prefix", prefix_len=50)),
    ("full", dict(seed=4), dict(kind="full")),
    ("softcap", dict(seed=5), dict(softcap=2.0)),
    ("empty-row", dict(seed=6, empty_row=1), {}),
]


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("name,case,kw", CONTIG, ids=[c[0] for c in CONTIG])
def test_contiguous_matches_jax(name, case, kw, int8):
    q, k, v, kv_pos, pos, scales = _case(int8=int8, **case)
    arrs = (q, k, v, kv_pos, pos)
    jq, jk, jv, jkp, jpos, js = _jax(arrs, scales, jnp.float32)
    want_ref = jref.flash_decode_ref(jq, jk, jv, jkp, jpos, **js, **kw)
    want_pallas = jax_flash_decode(jq, jk, jv, jkp, jpos, **js, block_kv=128,
                                   n_splits=1, interpret=True, **kw)
    tq, tk, tv, tkp, tpos, ts = _torch(arrs, scales, torch.float32)
    got = tops.flash_decode(tq, tk, tv, tkp, tpos, **ts, **kw)
    tol = 2e-2 if int8 else 1e-5
    _check(got, want_ref, tol)
    _check(got, want_pallas, tol)
    if case.get("empty_row") is not None:
        assert torch.count_nonzero(got[case["empty_row"]]) == 0


def test_bf16_cache_matches_jax():
    q, k, v, kv_pos, pos, _ = _case(seed=7)
    arrs = (q, k, v, kv_pos, pos)
    jq, jk, jv, jkp, jpos, _ = _jax(arrs, {}, jnp.bfloat16)
    want = jref.flash_decode_ref(jq, jk, jv, jkp, jpos)
    tq, tk, tv, tkp, tpos, _ = _torch(arrs, {}, torch.bfloat16)
    got = tops.flash_decode(tq, tk, tv, tkp, tpos)
    assert got.dtype == torch.bfloat16
    _check(got, want, 2e-2)


def test_return_partials_match_jax():
    """(m, l, acc) of the plain version equal the JAX kernel's combined
    partials, and recombine to the output; an empty row gives m = -1e30,
    l = 0, acc = 0."""
    q, k, v, kv_pos, pos, _ = _case(seed=8, empty_row=2, wrap=True)
    arrs = (q, k, v, kv_pos, pos)
    jq, jk, jv, jkp, jpos, _ = _jax(arrs, {}, jnp.float32)
    jm, jl, jacc = jax_flash_decode(jq, jk, jv, jkp, jpos, block_kv=128,
                                    n_splits=1, interpret=True,
                                    return_partials=True)
    tq, tk, tv, tkp, tpos, _ = _torch(arrs, {}, torch.float32)
    m, l, acc = tops.flash_decode(tq, tk, tv, tkp, tpos,
                                  return_partials=True)
    assert m.shape == (3, 2, 2, 1) and acc.shape == (3, 2, 2, 32)
    _check(m, jm, 1e-5)
    _check(l, jl, 1e-5)
    _check(acc, jacc, 1e-5)
    assert torch.all(m[2] == -1e30) and torch.all(l[2] == 0)
    out = tfd._combine(m[:, :, None], l[:, :, None], acc[:, :, None], axis=2)
    _check(out.reshape(3, 1, 4, 32), tops.flash_decode(tq, tk, tv, tkp, tpos),
           1e-6)


def _paged_case(*, int8=False, seed=9):
    """Rows 0/1/2 share physical blocks 7 and 2 (a common prefix); tails
    diverge (blocks 5, 8, ungranted)."""
    nb, bs, Hk, G, D, B, T = 10, 8, 2, 2, 32, 3, 3
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, 1, Hk * G, D)).astype(np.float32)
    k = rng.standard_normal((nb, bs, Hk, D)).astype(np.float32)
    v = rng.standard_normal((nb, bs, Hk, D)).astype(np.float32)
    tbl = np.array([[7, 2, 5], [7, 2, 8], [7, 2, -1]], np.int32)
    q_pos = np.array([3 * bs - 1, 2 * bs + 3, 2 * bs - 2], np.int32)
    kv_pos = np.full((nb, bs), -1, np.int32)
    for b in range(B):
        for j in range(T):
            pb = tbl[b, j]
            if pb < 0:
                continue
            for o in range(bs):
                if j * bs + o <= q_pos[b]:
                    kv_pos[pb, o] = max(kv_pos[pb, o], j * bs + o)
    kv_pos[0] = np.arange(bs)          # a stale block no table cites
    scales = {}
    if int8:
        k, ks = _quant(k)
        v, vs = _quant(v)
        scales = {"k_scale": ks, "v_scale": vs}
    return q, k, v, kv_pos, q_pos, tbl, scales


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
def test_paged_matches_jax(int8):
    q, k, v, kv_pos, q_pos, tbl, scales = _paged_case(int8=int8)
    arrs = (q, k, v, kv_pos, q_pos)
    jq, jk, jv, jkp, jpos, js = _jax(arrs, scales, jnp.float32)
    jt = jnp.asarray(tbl)
    want_ref = jref.flash_decode_ref(jq, jk, jv, jkp, jpos, block_tables=jt,
                                     **js)
    want_pallas = jax_flash_decode(jq, jk, jv, jkp, jpos, block_tables=jt,
                                   n_splits=1, interpret=True, **js)
    tq, tk, tv, tkp, tpos, ts = _torch(arrs, scales, torch.float32)
    got = tops.flash_decode(tq, tk, tv, tkp, tpos,
                            block_tables=torch.from_numpy(tbl), **ts)
    tol = 2e-2 if int8 else 1e-5
    _check(got, want_ref, tol)
    _check(got, want_pallas, tol)


def test_paged_gather_equals_ring():
    """A paged pool read through its table equals the ring it replaces,
    bit for bit; ungranted blocks come back masked (-1)."""
    q, k, v, kv_pos, q_pos, tbl, _ = _paged_case()
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    gk, gv, gpos, _, _ = tfd.paged_gather(tk, tv, torch.from_numpy(kv_pos),
                                          None, None, torch.from_numpy(tbl))
    bs = k.shape[1]
    for b in range(3):
        for j in range(3):
            sl = slice(j * bs, (j + 1) * bs)
            if tbl[b, j] < 0:
                assert torch.all(gpos[b, sl] == -1)
            else:
                assert torch.equal(gk[b, sl], tk[tbl[b, j]])
                assert torch.equal(gv[b, sl], tv[tbl[b, j]])


@pytest.mark.parametrize("dtype", ["bfloat16", "int8", "int32"])
def test_block_copy_bit_exact(dtype):
    rng = np.random.default_rng(5)
    base = rng.integers(-100, 100, (3, 6, 8, 2, 4))
    if dtype == "bfloat16":
        base = rng.standard_normal((3, 6, 8, 2, 4))
    jleaf = jnp.asarray(base, getattr(jnp, dtype))
    want = jops.block_copy(jleaf, 4, 1)
    tleaf = torch.from_numpy(np.asarray(jleaf.astype(jnp.float32)))
    tleaf = tleaf.to(getattr(torch, dtype))
    got = tops.block_copy(tleaf, 4, 1)
    assert got is tleaf                    # in place
    assert np.array_equal(got.float().numpy(),
                          np.asarray(want.astype(jnp.float32)))
    # per-slot scalar leaves (kv_pos) take the same path
    flat = rng.integers(-5, 50, (3, 6, 8)).astype(np.int32)
    want2 = jops.block_copy(jnp.asarray(flat), 2, 5)
    got2 = tops.block_copy(torch.from_numpy(flat.copy()), 2, 5)
    assert np.array_equal(got2.numpy(), np.asarray(want2))


def test_block_copy_leaves_equals_per_leaf_copies():
    """One ``block_copy_leaves`` call over an event's leaves (bf16, f32,
    int8, int32 and an odd tail, as a pool's K, V, scales and kv_pos) in
    place equals ``paged_block_copy_ref`` of each leaf and the reference's
    ``block_copy`` of each, bit for bit; the other blocks are untouched."""
    rng = np.random.default_rng(11)
    L, nb = 3, 7
    tails = {"bfloat16": (4, 2, 8), "float32": (4, 2, 8), "int8": (4, 2, 8),
             "int32": (4,), "odd": (3, 5)}
    leaves, wants, jwants = [], [], []
    for name, tail in tails.items():
        base = rng.standard_normal((L, nb) + tail) * 50
        dtype = {"odd": "int8"}.get(name, name)
        jleaf = jnp.asarray(base).astype(getattr(jnp, dtype))
        jwants.append(np.asarray(jops.block_copy(jleaf, 5, 2).astype(
            jnp.float32)))
        leaf = torch.from_numpy(np.array(jleaf.astype(jnp.float32)))
        leaf = leaf.to(getattr(torch, dtype))
        want = leaf.clone()
        tfd.paged_block_copy_ref(want, 5, 2)
        leaves.append(leaf)
        wants.append(want)
    before = [leaf.clone() for leaf in leaves]
    got = tops.block_copy_leaves(iter(leaves), 5, 2)
    assert len(got) == len(leaves)
    for g, leaf, want, jwant, old in zip(got, leaves, wants, jwants, before):
        assert g is leaf                       # in place
        assert torch.equal(leaf, want)
        assert np.array_equal(leaf.float().numpy(), jwant)
        assert torch.equal(leaf[:, 5], old[:, 5])
        keep = [b for b in range(nb) if b != 2]
        assert torch.equal(leaf[:, keep], old[:, keep])


def test_policy_matches_reference():
    """The paged kernel cuts a row's table into runs of whole entries, as
    the reference's Pallas kernel does: wherever the reference's split
    count (``_pick_splits``, a divisor of T) is one a cluster holds, the
    port given that count cuts the table at the reference's bounds."""
    from repro.kernels import flash_decode as jfd
    for T in range(1, 70):
        for req in (0, 1, 3, 8):
            jn = jfd._pick_splits(T, req)
            want = [(i * (T // jn), (i + 1) * (T // jn)) for i in range(jn)]
            n, longest = tfd._paged_splits(4, 8, T, 16, 132, jn)
            assert n == jn
            got = [(i * T // n, (i + 1) * T // n) for i in range(n)]
            assert got == want and longest == T // jn


def test_cuda_wrapper_refuses_cpu_tensors():
    """The kernel wrappers take CUDA tensors only; nothing falls back."""
    q, k, v, kv_pos, pos, _ = _case()
    tq, tk, tv, tkp, tpos, _ = _torch((q, k, v, kv_pos, pos), {},
                                      torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        tfd.flash_decode_cuda(tq, tk, tv, tkp, tpos)
    with pytest.raises(ValueError, match="CUDA"):
        tfd.paged_block_copy_cuda(torch.zeros(2, 3, 4), 0, 1)
    with pytest.raises(ValueError, match="CUDA"):
        tfd.paged_block_copy_leaves_cuda([torch.zeros(2, 3, 4)], 0, 1)
