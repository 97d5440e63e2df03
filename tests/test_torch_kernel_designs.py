"""The arithmetic and the work split of the port's redesigned CUDA kernels,
held on the CPU before any card run.

* The ring flash-decode kernel's split policy (``_ring_splits``): for a
  grid of (B, Hk, S, SM count) every slot lies in exactly one split, no
  split is empty, there are at most 8 splits (one thread-block cluster
  carries them), a requested count is honoured, and given the card's
  resident clusters of each size, every (row, head)'s cluster fits at
  once.  The kernel cuts split i of n at ``floor(i * S / n)``
  (``csrc/flash_decode.cu``); the bounds here are that formula.
* The paged flash-decode's split policy (``_paged_splits``): every table
  entry in exactly one split of whole entries (split i of n holds entries
  ``floor(i * T / n)`` .. ``floor((i + 1) * T / n)``), requests honoured
  and refused above 8, every cluster resident; and its cluster merge,
  emulated: each split's (m, l, acc) from the plain version over its own
  entries, merged in split order as block 0 does, matches
  ``flash_decode_ref(block_tables=...)`` within 1e-6, idle lanes exactly 0.
* The f32 flash-attention kernel's arithmetic (3xTF32): each operand split
  into a TF32 ``hi`` (cvt.rna's rounding) and a truncated TF32 ``lo``, the
  products ``lo hi + hi lo + hi hi`` in f32, an f32 online softmax over
  32-key tiles; held to the plain version and the JAX package's oracle
  within the card's unchanged f32 limit (atol 2e-5, rtol 2e-5).  One TF32
  product alone misses it.
* The bf16 flash-attention kernel's arithmetic, emulated in plain torch:
  bf16 inputs, f32 scores of exact products, an f32 online softmax over
  64-key tiles, p split as ``p_hi + p_lo`` (two bf16 values) for P . V,
  f32 sums, one rounding to bf16 at the end.  It is held to the plain
  version (``flash_attention_ref``) and to the JAX package's oracle
  (``repro.kernels.ref.flash_attention_ref``), both run in f32 on the same
  bf16-valued inputs, within the limit the card holds the kernel to:
  ``2e-5 + 2**-8 |want|`` (half a bf16 step over the f32 limit).  The
  emulation's f32 output before its rounding must be within the f32 limit
  2e-5 on its own, which is what leaves the rounding its half step.  The
  same arithmetic with p in one bf16 value (no ``p_lo``) misses the limit
  (by ~1e-3 at these shapes): the split is what keeps it.
* The bf16 qlora_matmul kernel's arithmetic (``csrc/qlora_matmul.cu``,
  ``qlora_mma_kernel``), emulated in plain torch: x in bf16 (exact), the
  dequantized weight ``w = code[q] * absmax`` (f32) split into ``w_hi =
  bf16(w)`` and ``w_lo = bf16(w - w_hi)``, f32 sums of exact products taken
  one 16-deep MMA slice at a time in the kernel's order (``x·w_hi +
  x·w_lo``), the LoRA bypass ``x·A`` from A split exactly into three bf16
  parts (every product exact: the f32 product), each MMA modelled as the
  tensor cores add (the exact products and the accumulator summed, then
  truncated to f32), each slice's MMAs into zeroed partials added into
  f32 sums rounded to nearest, and the f32 epilogue ``acc + s·(x·A)·B``,
  rounded once to bf16.  One chain of MMAs over all of K stays inside the
  limit at K = 4096 and misses it at K = 11,008 (fedtime-llama2-7b's
  ``w_down``), as the card's kernel did before its partials; the LoRA
  chain alone flushed, or the main one alone, still misses it there.  It is held to the
  plain version (``qlora_matmul_ref``) and to the JAX package's oracle
  (``repro.kernels.ref.qlora_matmul_ref``) on the same numpy-drawn inputs,
  within the card's unchanged limit: ``atol 1e-4``, ``rtol 1e-4 + 2**-7``.
  Its f32 output before the rounding is within 1e-4 of the plain version's
  on its own.  The same arithmetic with w in one bf16 value (``w_hi``
  alone) misses the limit: at K = 4096 its error, about 2**-9 of each
  product, breaks ``atol 1e-4`` on outputs near 0.
* The f32 qlora_matmul kernel's arithmetic (``qlora_tf32_kernel``,
  3xTF32), emulated in plain torch: x, the dequantized weight ``w =
  code[q] * absmax`` and A each split into TF32 halves as the kernel
  splits them (``_split_tf32``), one 32-deep K step at a time ``x_lo·w_hi +
  x_hi·w_lo + x_hi·w_hi`` summed in f32 into one accumulator, the LoRA
  bypass ``x·A`` as 3xTF32 on the same x halves, and the f32 epilogue
  ``acc + s·(x·A)·B``.  It is held to the plain version and to the JAX
  package's oracle within the reference's f32 limit (atol 1e-4, rtol
  1e-4).  At K >= 1024 one TF32 product, ``x_hi·(w_hi + w_lo)`` and
  ``(x_hi + x_lo)·w_hi`` each miss it: the kernel needs all three.  Each
  MMA is modelled as the tensor cores add (the exact products and the
  accumulator summed, then truncated): at K = 4096 one chain of MMAs
  over all of K misses the limit, so the kernel runs each 32-deep step
  into zeroed partials and adds them into f32 sums rounded to nearest.
* The rmsnorm kernel's layout (``rmsnorm_layout``): pinned at the three
  shapes ``chip_smoke.py`` phase 2b drives (the fit's (504, 4096) bf16,
  the benchmark's (64, 4096) f32, the ragged (4, 37, 512) f32), at rows
  below the SM count (still one block a row: a cluster measured slower),
  at many short rows and at a row only a cluster covers; over a grid of
  shapes every 16-byte chunk of a row is owned by exactly one thread, a
  block holds at most 512 threads and at least a warp a row.  The kernel's
  sum of squares in its order (a thread's chunks, the warp's butterfly,
  the row's warps, the cluster's blocks in rank order), emulated in f32, is
  held to the plain version and the JAX package's oracle within the f32
  limit 2e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.core.quant import nf4_dequant, nf4_quantize
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import qlora_matmul as qm
from repro_torch.kernels import rmsnorm as rn

H100_SMS = 132


@pytest.fixture(autouse=True, scope="module")
def _torch_one_thread():
    """The shapes here are small: one intra-op thread, so that parallel test
    workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# The ring's split policy
# ---------------------------------------------------------------------------

def _bounds(S: int, n: int):
    """The kernel's splits of a ring of S slots: split i of n covers
    [floor(i S / n), floor((i + 1) S / n))."""
    return [(i * S // n, (i + 1) * S // n) for i in range(n)]


def _check_splits(S: int, n: int, split_len: int):
    bounds = _bounds(S, n)
    slots = [t for lo, hi in bounds for t in range(lo, hi)]
    assert slots == list(range(S)), (S, n)          # each slot exactly once
    assert all(hi > lo for lo, hi in bounds), (S, n)    # none empty
    assert 1 <= n <= fd.MAX_SPLITS
    assert split_len == max(hi - lo for lo, hi in bounds)


@pytest.mark.parametrize("sm_count", [8, 114, H100_SMS])
@pytest.mark.parametrize("B", [1, 3, 4, 12, 64])
def test_ring_splits_cover_every_slot_once(B, sm_count):
    for Hk in (1, 2, 8, 32):
        for S in (1, 2, 31, 32, 33, 63, 100, 576, 577, 1024, 4096, 40000):
            n, split_len = fd._ring_splits(B, Hk, S, sm_count)
            _check_splits(S, n, split_len)
            # splits of at least 32 slots, unless the ring is shorter
            assert n == 1 or S // n >= 32
            # no more splits than about two blocks an SM need
            assert n == 1 or (n - 1) * B * Hk < 2 * sm_count


def test_ring_splits_fill_the_card_at_the_fixed_batch():
    """The fixed batch's ring (B=4, Hk=8, 576 slots) on 132 SMs: 8 splits,
    256 blocks of 72 slots, about two an SM."""
    n, split_len = fd._ring_splits(4, 8, 576, H100_SMS)
    assert (n, split_len, n * 4 * 8) == (8, 72, 256)


def test_ring_splits_fill_the_card_at_the_fixed_batch_g1():
    """fedtime-llama2-7b's fixed batch (B=4, Hk=32 heads of G = 1, 576
    slots) on 132 SMs: 3 splits, 384 blocks of 192 slots, three an SM or
    fewer; 3 still when the card holds 128 clusters of 3 at once, 2 when it
    holds fewer."""
    n, split_len = fd._ring_splits(4, 32, 576, H100_SMS)
    assert (n, split_len, n * 4 * 32) == (3, 192, 384)
    _check_splits(576, n, split_len)
    fits = (528, 264, 128, 96, 80, 64, 56, 48)
    assert fd._ring_splits(4, 32, 576, H100_SMS, max_clusters=fits)[0] == 3
    short = (528, 264, 127, 96, 80, 64, 56, 48)
    assert fd._ring_splits(4, 32, 576, H100_SMS, max_clusters=short)[0] == 2


@pytest.mark.parametrize("requested", [1, 2, 3, 5, 8])
def test_ring_splits_honour_a_request(requested):
    for S in (1, 2, 3, 7, 8, 100, 577):
        for sm_count in (8, H100_SMS):
            n, split_len = fd._ring_splits(4, 8, S, sm_count, requested)
            assert n == min(requested, S)
            _check_splits(S, n, split_len)


@pytest.mark.parametrize("requested", [-1, 9, 16])
def test_ring_splits_refuse_more_than_a_cluster(requested):
    with pytest.raises(ValueError, match="n_splits"):
        fd._ring_splits(4, 8, 576, H100_SMS, requested)


@pytest.mark.parametrize("B,Hk,resident,want", [
    (4, 8, (264,) * 8, 8),                            # every cluster fits
    (4, 8, (264, 132, 88, 64, 48, 40, 32, 28), 7),   # 32 clusters of 8 do not
    (4, 8, (264, 132, 88, 40, 24, 20, 16, 14), 4),
    (64, 8, (264,) * 8, 1),                           # one block a pair fills
    (4, 32, (264,) * 8, 3),                           # G = 1: 128 pairs
    (4, 32, (264, 132, 88, 64, 48, 40, 32, 28), 2),  # 128 clusters of 3 do not
    (1, 32, (264, 132, 88, 40, 24, 20, 16, 14), 4)])
def test_ring_splits_keep_every_cluster_resident(B, Hk, resident, want):
    """Given the card's resident clusters of each size, the policy takes the
    most splits (up to its own choice) whose B * Hk clusters all fit at
    once."""
    n, split_len = fd._ring_splits(B, Hk, 4096, H100_SMS,
                                   max_clusters=resident)
    assert n == want
    assert n == 1 or resident[n - 1] >= B * Hk
    _check_splits(4096, n, split_len)
    # a request is honoured whatever fits
    assert fd._ring_splits(B, Hk, 4096, H100_SMS, 8, resident)[0] == 8


# ---------------------------------------------------------------------------
# The paged pool's split policy and cluster merge
# ---------------------------------------------------------------------------

def _entry_bounds(T: int, n: int):
    """The kernel's splits of a table row of T entries: split i of n holds
    entries [floor(i T / n), floor((i + 1) T / n))."""
    return [(i * T // n, (i + 1) * T // n) for i in range(n)]


def _check_paged_splits(T: int, n: int, split_entries: int):
    bounds = _entry_bounds(T, n)
    entries = [e for lo, hi in bounds for e in range(lo, hi)]
    assert entries == list(range(T)), (T, n)        # each entry exactly once
    assert all(hi > lo for lo, hi in bounds), (T, n)    # none empty
    assert 1 <= n <= fd.MAX_SPLITS
    assert split_entries == max(hi - lo for lo, hi in bounds)


@pytest.mark.parametrize("sm_count", [8, 114, H100_SMS])
@pytest.mark.parametrize("B", [1, 3, 4, 12, 64])
def test_paged_splits_cover_every_entry_once(B, sm_count):
    """Every table entry in exactly one split of whole entries, for the
    engine's T = 8 and ragged T; splits of at least 32 slots; no more
    splits than about two blocks an SM need."""
    for Hk in (1, 2, 8, 32):
        for T in (1, 2, 3, 7, 8, 9, 20, 23, 64, 100, 257):
            for bs in (8, 16):
                n, entries = fd._paged_splits(B, Hk, T, bs, sm_count)
                _check_paged_splits(T, n, entries)
                assert n == 1 or (T // n) * bs >= 32
                assert n == 1 or (n - 1) * B * Hk < 2 * sm_count


def test_paged_splits_fill_the_card_at_the_engine_pool():
    """The engine's pool (12 lanes, T = 8 entries of 16 slots) on 132 SMs:
    qwen3-0.6b (Hk = 8) takes 3 splits, 288 blocks; fedtime-llama2-7b (Hk =
    32) 1, 384 blocks; so also given the occupancy a bf16 instance read on
    the card in PR 17 (clusters of 1..8 resident at once)."""
    fits = (396, 198, 124, 92, 69, 62, 47, 45)
    for resident in (None, fits):
        n, entries = fd._paged_splits(12, 8, 8, 16, H100_SMS,
                                      max_clusters=resident)
        assert (n, entries, n * 12 * 8) == (3, 3, 288)
        n, entries = fd._paged_splits(12, 32, 8, 16, H100_SMS,
                                      max_clusters=resident)
        assert (n, entries, n * 12 * 32) == (1, 8, 384)


@pytest.mark.parametrize("requested", [1, 2, 3, 5, 8])
def test_paged_splits_honour_a_request(requested):
    for T in (1, 2, 3, 7, 8, 23, 100):
        for sm_count in (8, H100_SMS):
            n, entries = fd._paged_splits(12, 8, T, 16, sm_count, requested)
            assert n == min(requested, T)
            _check_paged_splits(T, n, entries)


@pytest.mark.parametrize("requested", [-1, 9, 16])
def test_paged_splits_refuse_more_than_a_cluster(requested):
    with pytest.raises(ValueError, match="n_splits"):
        fd._paged_splits(12, 8, 8, 16, H100_SMS, requested)


@pytest.mark.parametrize("B,Hk,T,resident,want", [
    (4, 8, 256, (264,) * 8, 8),                       # every cluster fits
    (4, 8, 256, (264, 132, 88, 64, 48, 40, 32, 28), 7),  # 32 of 8 do not
    (4, 8, 256, (264, 132, 88, 40, 24, 20, 16, 14), 4),
    (12, 8, 8, (264, 132, 88, 64, 48, 40, 32, 28), 2),   # 96 of 3 do not
    (12, 8, 8, (264, 132, 96, 64, 48, 40, 32, 28), 3),
    (64, 8, 256, (264,) * 8, 1),                      # one block a pair fills
    (4, 32, 256, (264, 132, 88, 64, 48, 40, 32, 28), 2),
    (1, 32, 256, (264, 132, 88, 40, 24, 20, 16, 14), 4)])
def test_paged_splits_keep_every_cluster_resident(B, Hk, T, resident, want):
    """Given the card's resident clusters of each size, the policy takes the
    most splits (up to its own choice) whose B * Hk clusters all fit at
    once; a request is honoured whatever fits."""
    n, entries = fd._paged_splits(B, Hk, T, 16, H100_SMS,
                                  max_clusters=resident)
    assert n == want
    assert n == 1 or resident[n - 1] >= B * Hk
    _check_paged_splits(T, n, entries)
    assert fd._paged_splits(B, Hk, T, 16, H100_SMS, 8, resident)[0] == 8


@pytest.mark.parametrize("d", [1, 2, 3, 7, 8, 13, 16, 20, 24, 100, 128, 1000,
                               4096, 65537, 2 ** 30 + 3])
def test_paged_block_index_is_exact(d):
    """The kernel's slot-to-block index, ``umulhi(n, mul) >> shr`` with the
    wrapper's magic, equals n // d for slots 0 .. 2**31 - 1: every block
    size a pool can have (``auto_block_size`` picks divisors near 16, not
    only powers of two)."""
    mul, shr = fd._fast_divisor(d)
    assert 0 <= mul < 2 ** 32 and 0 <= shr < 32
    rng = np.random.default_rng(d)
    top = (2 ** 31 - 1) // d * d                  # the last multiple of d
    n = np.concatenate([np.arange(min(4 * d + 8, 4096)),
                        rng.integers(0, 2 ** 31, 20000),
                        [d - 1, d, d + 1, top - 1, top, 2 ** 31 - 1]
                        ]).astype(np.uint64)
    n = n[n < 2 ** 31]
    got = n if mul == 0 else ((n * np.uint64(mul)) >> np.uint64(32)) >> \
        np.uint64(shr)
    assert np.array_equal(got, n // np.uint64(d))


def _pool_case(*, B, T, Hk, G, D, bs, int8, idle, seed):
    """A pool read through a (B, T) table, drawn with numpy: a 2-block
    prefix shared by the active rows, -1 entries past each row's
    position, a stale block, and idle lanes with no granted entry."""
    rng = np.random.default_rng(seed)
    nb = B * T + 4
    q = rng.standard_normal((B, 1, Hk * G, D)).astype(np.float32)
    k = rng.standard_normal((nb, bs, Hk, D)).astype(np.float32)
    v = rng.standard_normal((nb, bs, Hk, D)).astype(np.float32)
    n = T * bs
    q_pos = np.array([(n - 1, n // 3, 5, n * 2 // 3 + 1)[b % 4]
                      for b in range(B)], np.int32)
    q_pos[list(idle)] = -1
    perm = rng.permutation(nb)
    tbl = np.full((B, T), -1, np.int32)
    kv_pos = np.full((nb, bs), -1, np.int32)
    nxt = 2
    for b in range(B):
        for j in range(q_pos[b] // bs + 1 if q_pos[b] >= 0 else 0):
            tbl[b, j] = perm[j] if j < 2 else perm[nxt]
            nxt += j >= 2
            ar = np.arange(j * bs, (j + 1) * bs)
            kv_pos[tbl[b, j]] = np.maximum(kv_pos[tbl[b, j]],
                                           np.where(ar <= q_pos[b], ar, -1))
    kv_pos[perm[-1]] = np.arange(bs)               # stale, cited by no table
    kw = {}
    if int8:
        ks = (np.abs(k).max(-1, keepdims=True) / 127.0).astype(np.float32)
        vs = (np.abs(v).max(-1, keepdims=True) / 127.0).astype(np.float32)
        ks = torch.from_numpy(ks).to(torch.bfloat16)
        vs = torch.from_numpy(vs).to(torch.bfloat16)
        k = np.clip(np.round(k / ks.float().numpy()), -127, 127).astype(
            np.int8)
        v = np.clip(np.round(v / vs.float().numpy()), -127, 127).astype(
            np.int8)
        kw = {"k_scale": ks, "v_scale": vs}
    args = tuple(torch.from_numpy(x) for x in (q, k, v, kv_pos, q_pos))
    return args, dict(block_tables=torch.from_numpy(tbl), **kw)


def _cluster_merge(args, kw, n):
    """The kernel's result from its splits: each split's (m, l, acc) over
    its own table entries (the plain version on that slice of the table),
    then block 0's merge in split order: M = max_r m_r, L = sum_r e^(m_r -
    M) l_r, A = sum_r e^(m_r - M) acc_r, out = A / max(L, 1e-30)."""
    tbl = kw["block_tables"]
    T = tbl.shape[1]
    parts = [fd.flash_decode_ref(*args, return_partials=True,
                                 **{**kw, "block_tables": tbl[:, lo:hi]})
             for lo, hi in _entry_bounds(T, n)]
    M = parts[0][0]
    for m, _, _ in parts[1:]:
        M = torch.maximum(M, m)
    L = torch.zeros_like(parts[0][1])
    A = torch.zeros_like(parts[0][2])
    for m, l, acc in parts:                        # in split order
        w = torch.exp(m - M)
        L = L + l * w
        A = A + acc * w
    q = args[0]
    B, _, H, D = q.shape
    return (A / torch.clamp(L, min=1e-30)).reshape(B, 1, H, D), (M, L, A)


@pytest.mark.parametrize("n_splits", [1, 3, 8])
@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("G,D", [(2, 64), (1, 32)], ids=["G2-D64",
                                                         "G1-D32"])
def test_paged_cluster_merge_matches_plain(G, D, int8, n_splits):
    """The cluster merge over whole-entry splits of a T = 23 table (uneven
    splits; at 8 splits some hold only ungranted entries) matches
    ``flash_decode_ref(block_tables=...)`` within 1e-6; an idle lane, whose
    every split is empty, is exactly 0, as are its merged m = -1e30, l and
    acc."""
    args, kw = _pool_case(B=6, T=23, Hk=2, G=G, D=D, bs=8, int8=int8,
                          idle=(1, 5), seed=D + n_splits)
    got, (M, L, A) = _cluster_merge(args, kw, n_splits)
    want = fd.flash_decode_ref(*args, **kw)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    # the merged sums, to 1e-6 of l (the scale they are divided by)
    wm, wl, wacc = fd.flash_decode_ref(*args, return_partials=True, **kw)
    torch.testing.assert_close(M, wm, rtol=1e-6, atol=1e-6)
    assert torch.all((L - wl).abs() <= 1e-6 * wl)
    assert torch.all((A - wacc).abs() <= 1e-6 * wl)
    for b in (1, 5):
        assert torch.count_nonzero(got[b]) == 0
        assert torch.all(M[b] == -1e30) and torch.count_nonzero(L[b]) == 0
        assert torch.count_nonzero(A[b]) == 0
    # row 2 (position 5) has one entry: its later splits hold none granted
    tbl = kw["block_tables"]
    assert n_splits == 1 or all(
        torch.all(tbl[2, lo:hi] < 0)
        for lo, hi in _entry_bounds(23, n_splits)[1:])


# ---------------------------------------------------------------------------
# The bf16 flash-attention kernel's arithmetic
# ---------------------------------------------------------------------------

TILE = 64


def _mma_arithmetic(q, k, v, causal: bool, split_p: bool = True):
    """The bf16 kernel's arithmetic on bf16 q, k, v (B, H, S, D): returns
    (the f32 output before its cast, the bf16 output)."""
    B, H, S, D = q.shape
    qf, kf, vf = q.float(), k.float(), v.float()
    fill = torch.finfo(torch.float32).min
    out = torch.empty((B, H, S, D), dtype=torch.float32)
    for q0 in range(0, S, TILE):
        rows = torch.arange(q0, min(q0 + TILE, S))
        m = torch.full((B, H, len(rows)), fill)
        l = torch.zeros((B, H, len(rows)))
        acc = torch.zeros((B, H, len(rows), D))
        kv_end = min(S, q0 + TILE) if causal else S
        for k0 in range(0, kv_end, TILE):          # tiles above the diagonal
            keys = torch.arange(k0, min(k0 + TILE, S))      # are skipped
            # bf16 x bf16 products are exact in f32; f32 sums
            s = torch.einsum("bhqd,bhkd->bhqk", qf[:, :, rows],
                             kf[:, :, keys]) * D ** -0.5
            if causal:
                s = s.masked_fill(keys[None, :] > rows[:, None], fill)
            m_new = torch.maximum(m, s.amax(-1))
            corr = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * corr + p.sum(-1)
            hi = p.to(torch.bfloat16).float()
            pv = torch.einsum("bhqk,bhkd->bhqd", hi, vf[:, :, keys])
            if split_p:
                lo = (p - hi).to(torch.bfloat16).float()
                pv = pv + torch.einsum("bhqk,bhkd->bhqd", lo, vf[:, :, keys])
            acc = acc * corr[..., None] + pv
            m = m_new
        out[:, :, rows] = acc / torch.clamp(l, min=1e-30)[..., None]
    return out, out.to(torch.bfloat16)


def _within(got, want, atol, rtol):
    err = (got.float() - want.float()).abs()
    return float((err - atol - rtol * want.float().abs()).max())


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("shape", [(8, 4, 63, 128), (2, 3, 100, 64),
                                   (1, 2, 130, 128)],
                         ids=["fit-4-heads", "ragged-d64", "three-tiles"])
def test_bf16_attention_arithmetic_keeps_the_limit(shape, causal):
    """The fit's shape (8 series x 63 patch tokens, D 128) cut to 4 heads,
    and ragged shapes over two and three key tiles."""
    rng = np.random.default_rng(sum(shape))
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(torch.bfloat16) for _ in range(3))
    got32, got = _mma_arithmetic(q, k, v, causal)
    want = fa.flash_attention_ref(q.float(), k.float(), v.float(), causal)
    jwant = np.asarray(jref.flash_attention_ref(
        *(jnp.asarray(t.float().numpy()) for t in (q, k, v)), causal=causal))
    assert _within(got32, want, 2e-5, 0.0) <= 0.0
    assert _within(got, want, 2e-5, 2.0 ** -8) <= 0.0
    assert _within(got, torch.from_numpy(jwant.copy()), 2e-5, 2.0 ** -8) <= 0.0
    assert torch.isfinite(got32).all()
    # p in one bf16 value (p_hi alone) misses the limit: the split is needed
    _, hi_only = _mma_arithmetic(q, k, v, causal, split_p=False)
    assert _within(hi_only, want, 2e-5, 2.0 ** -8) > 0.0


# ---------------------------------------------------------------------------
# The f32 flash-attention kernel's arithmetic: 3xTF32 on the tensor cores
# ---------------------------------------------------------------------------

F32_KV_TILE = 32                              # the f32 kernel's key tile


def _tf32(x):
    """``cvt.rna.tf32.f32``: x rounded to 10 mantissa bits, to nearest
    with ties away from zero (on the sign-magnitude bits: add half of the
    13 dropped bits, then clear them)."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def _split_tf32(x):
    """x as a_hi + a_lo, both TF32, as the kernel splits it: a_hi = tf32(x)
    (cvt.rna's rounding), a_lo = x - a_hi (exact in f32) truncated to 10
    mantissa bits."""
    hi = _tf32(x)
    lo = (x - hi).contiguous().view(torch.int32) & ~0x1FFF
    return hi, lo.view(torch.float32)


def _tf32_product(a, b, three: bool):
    """a . b on the tensor cores: TF32 operands, exact products, f32 sums;
    with ``three`` the 3xTF32 sum a_lo b_hi + a_hi b_lo + a_hi b_hi,
    else the one TF32 product a_hi b_hi."""
    a_hi, a_lo = _split_tf32(a)
    b_hi, b_lo = _split_tf32(b)
    if not three:
        return a_hi @ b_hi
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def _tf32x3_arithmetic(q, k, v, causal: bool, three: bool = True):
    """The f32 kernel's arithmetic on f32 q, k, v (B, H, S, D): S = Q . K^T
    and O += P . V each as three TF32 products, an f32 online softmax over
    32-key tiles, the finite finfo(f32).min fill, key tiles above a query
    row skipped (rows are independent, so the kernel's query tile does
    not enter); returns the f32 output."""
    B, H, S, D = q.shape
    fill = torch.finfo(torch.float32).min
    rows = torch.arange(S)
    m = torch.full((B, H, S), fill)
    l = torch.zeros((B, H, S))
    acc = torch.zeros((B, H, S, D))
    for k0 in range(0, S, F32_KV_TILE):
        keys = torch.arange(k0, min(k0 + F32_KV_TILE, S))
        s = _tf32_product(q, k[:, :, keys].transpose(-1, -2), three) * (
            D ** -0.5)
        if causal:
            s = s.masked_fill(keys[None, :] > rows[:, None], fill)
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + _tf32_product(p, v[:, :, keys], three)
        m = m_new
    return acc / torch.clamp(l, min=1e-30)[..., None]


def test_tf32_rounds_to_nearest_ties_away():
    """The emulated cvt.rna: 10 mantissa bits kept, a half-way value of
    either sign rounded away from zero; the split's halves are TF32 and sum
    to within 2**-21 of the value."""
    one_ulp = 2.0 ** -10                            # TF32's step at 1.0
    x = torch.tensor([1.0 + one_ulp / 2, -(1.0 + one_ulp / 2),
                      1.0 + one_ulp / 2 - 2.0 ** -23, 3.0, -0.0])
    want = torch.tensor([1.0 + one_ulp, -(1.0 + one_ulp), 1.0, 3.0, -0.0])
    assert torch.equal(_tf32(x), want)
    rng = np.random.default_rng(0)
    y = torch.from_numpy(rng.standard_normal(4096).astype(np.float32))
    hi, lo = _split_tf32(y)
    assert torch.all(hi.view(torch.int32) & 0x1FFF == 0)
    assert torch.all(lo.view(torch.int32) & 0x1FFF == 0)
    # hi + lo keeps 22 of f32's 24 bits: within 2**-21 of y, relative
    assert torch.all((hi + lo - y).abs() <= 2.0 ** -21 * y.abs())


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("shape", [(1, 1, 256, 128), (1, 2, 100, 128),
                                   (1, 2, 100, 64)],
                         ids=["benchmark-1-head-S256", "ragged", "d64"])
def test_f32_attention_arithmetic_keeps_the_limit(shape, causal):
    """The reference benchmark's shape (4, 8, 1024, 128) cut to one head
    and S 256, the ragged shape (2, 4, 100, 128) cut to one row and two
    heads, and D 64: 3xTF32 held to the plain version and to the JAX
    package's oracle within the card's unchanged f32 limit (atol 2e-5,
    rtol 2e-5); the one TF32 product alone misses it."""
    rng = np.random.default_rng(sum(shape))
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)) for _ in range(3))
    got = _tf32x3_arithmetic(q, k, v, causal)
    want = fa.flash_attention_ref(q, k, v, causal)
    jwant = torch.from_numpy(np.asarray(jref.flash_attention_ref(
        *(jnp.asarray(t.numpy()) for t in (q, k, v)), causal=causal)).copy())
    assert torch.isfinite(got).all()
    assert _within(got, want, 2e-5, 2e-5) <= 0.0
    assert _within(got, jwant, 2e-5, 2e-5) <= 0.0
    one = _tf32x3_arithmetic(q, k, v, causal, three=False)
    assert _within(one, want, 2e-5, 2e-5) > 0.0


# ---------------------------------------------------------------------------
# The bf16 qlora_matmul kernel's arithmetic
# ---------------------------------------------------------------------------

K_TILE = 32                                   # the kernel's K step
MMA_K = 16                                    # an m16n8k16 MMA's depth


def _bf16(t):
    return t.to(torch.bfloat16).float()


def _split3(a):
    """a (f32) as three bf16 values whose sum is a, exactly."""
    hi = _bf16(a)
    mid = _bf16(a - hi)
    return hi, mid, _bf16(a - hi - mid)


def _qlora_mma_arithmetic(x, wq, am, a, b, s, split_w: bool = True,
                          flush=("w", "a")):
    """The bf16 kernel's arithmetic on bf16 x (M, K): returns (the f32
    output before its cast, the bf16 output).  Each m16n8k16 MMA is
    modelled as the tensor cores add: the exact products and the
    accumulator summed, then truncated to f32 (``_rz``).  ``flush`` names
    the chains (x . w: "w", x . A: "a") whose slice MMAs run into zeroed
    partials added into f32 sums rounded to nearest, as the kernel does;
    a chain not named accumulates over all of K in one."""
    M, K = x.shape
    w = nf4_dequant(wq, am.reshape(-1))               # code * absmax, f32
    w_hi = _bf16(w)
    w_lo = _bf16(w - w_hi)
    a_parts = _split3(a)
    assert torch.equal(a_parts[0] + a_parts[1] + a_parts[2], a)
    xd = x.double()
    w_parts = [t.double() for t in ((w_hi, w_lo) if split_w else (w_hi,))]
    a_parts = [t.double() for t in a_parts]
    acc = torch.zeros((M, w.shape[1]))
    xa = torch.zeros((M, a.shape[1]))
    for k0 in range(0, K, MMA_K):                # one 16-deep slice a time
        xt = xd[:, k0:k0 + MMA_K]
        pa = torch.zeros_like(acc) if "w" in flush else acc
        px = torch.zeros_like(xa) if "a" in flush else xa
        for part in w_parts:
            pa = _rz(pa.double() + xt @ part[k0:k0 + MMA_K])
        for part in a_parts:
            px = _rz(px.double() + xt @ part[k0:k0 + MMA_K])
        acc = acc + pa if "w" in flush else pa
        xa = xa + px if "a" in flush else px
    out = acc + s * (xa @ b)
    return out, out.to(torch.bfloat16)


def _qlora_inputs(M, K, N, r, qb, seed, dtype=torch.bfloat16):
    """The card's qlora case (``chip_smoke._ops_cases``) drawn with numpy:
    w ~ 0.02 N(0, 1) quantized to NF4, x ~ N(0, 1) in ``dtype``, A and B ~
    0.1 N(0, 1), s = 2."""
    rng = np.random.default_rng(seed)
    f = lambda *shape: torch.from_numpy(              # noqa: E731
        rng.standard_normal(shape).astype(np.float32))
    wq, am = nf4_quantize(f(K, N) * 0.02, qb)
    x = f(M, K).to(dtype)
    return x, wq, am.reshape(K, N // qb), f(K, r) * 0.1, f(r, N) * 0.1, 2.0


QLORA_ATOL, QLORA_RTOL = 1e-4, 1e-4 + 2.0 ** -7     # the card's bf16 limit


@pytest.mark.parametrize("M,K,N,r,qb", [
    (504, 4096, 256, 8, 64),      # the fit's site (M 504, K 4096), N cut
    (37, 200, 192, 8, 64),        # ragged: M, K past a tile, N past 128
    (70, 96, 136, 64, 8)],        # the largest rank, qblock 8
    ids=["fit-K4096-N256", "ragged", "rank64"])
def test_bf16_qlora_arithmetic_keeps_the_limit(M, K, N, r, qb):
    x, wq, am, a, b, s = _qlora_inputs(M, K, N, r, qb, seed=M + K + N)
    got32, got = _qlora_mma_arithmetic(x, wq, am, a, b, s)
    want = qm.qlora_matmul_ref(x, wq, am, a, b, s)
    want32 = qm.qlora_matmul_ref(x.float(), wq, am, a, b, s)
    jwant = torch.from_numpy(np.asarray(jref.qlora_matmul_ref(
        jnp.asarray(x.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(wq.numpy()), jnp.asarray(am.numpy()),
        jnp.asarray(a.numpy()), jnp.asarray(b.numpy()), s)).astype(
            np.float32))
    assert torch.isfinite(got32).all()
    assert _within(got32, want32, QLORA_ATOL, 0.0) <= 0.0
    assert _within(got, want, QLORA_ATOL, QLORA_RTOL) <= 0.0
    assert _within(got, jwant, QLORA_ATOL, QLORA_RTOL) <= 0.0
    if K >= 4096:
        # w in one bf16 value (w_hi alone) misses the limit
        _, hi_only = _qlora_mma_arithmetic(x, wq, am, a, b, s,
                                           split_w=False)
        assert _within(hi_only, want, QLORA_ATOL, QLORA_RTOL) > 0.0


# ---------------------------------------------------------------------------
# The f32 qlora_matmul kernel's arithmetic (3xTF32)
# ---------------------------------------------------------------------------

# The TF32 products of x . w the f32 kernel sums (``qlora_tf32_kernel``), in
# its order, and the variants with fewer products.
QLORA_3XTF32 = ("lo_hi", "hi_lo", "hi_hi")
QLORA_VARIANTS = {"1xTF32": ("hi_hi",),
                  "x_hi.(w_hi + w_lo)": ("hi_lo", "hi_hi"),
                  "(x_hi + x_lo).w_hi": ("lo_hi", "hi_hi")}


def _rz(v):
    """f64 -> f32, rounded toward zero."""
    f = v.float()
    return torch.where(f.double().abs() > v.abs(),
                       torch.nextafter(f, torch.zeros_like(f)), f)


def _qlora_tf32_arithmetic(x, wq, am, a, b, s, products=QLORA_3XTF32,
                           flush: bool = True):
    """The f32 kernel's arithmetic on f32 x (M, K): the dequantized weight
    ``w = code[q] * absmax`` (f32), x, w and A each split into TF32 halves
    (``_split_tf32``); for each 8-deep slice an MMA of each product named in
    ``products`` (and of the LoRA bypass x . A's three), modelled as the
    tensor cores add: the exact products and the accumulator summed, then
    truncated to f32.  With ``flush`` a 32-deep K step's MMAs run into
    zeroed partials that are added into the f32 accumulators rounded to
    nearest, as the kernel does; without it every MMA adds into one chain.
    Then the f32 epilogue ``acc + s . (x . A) . B``."""
    M, K = x.shape
    w = nf4_dequant(wq, am.reshape(-1))
    halves = {"x": _split_tf32(x), "w": _split_tf32(w), "a": _split_tf32(a)}
    halves = {k: tuple(t.double() for t in v) for k, v in halves.items()}
    pick = {"hi": 0, "lo": 1}
    acc = torch.zeros((M, w.shape[1]))
    xa = torch.zeros((M, a.shape[1]))
    for k0 in range(0, K, K_TILE):               # one K step at a time
        pa = torch.zeros_like(acc) if flush else acc
        px = torch.zeros_like(xa) if flush else xa
        for k8 in range(k0, min(k0 + K_TILE, K), 8):
            ks = slice(k8, k8 + 8)

            def term(name, rhs):
                xp, rp = name.split("_")
                return (halves["x"][pick[xp]][:, ks]
                        @ halves[rhs][pick[rp]][ks])

            for name in products:
                pa = _rz(pa.double() + term(name, "w"))
            for name in QLORA_3XTF32:
                px = _rz(px.double() + term(name, "a"))
        acc, xa = (acc + pa, xa + px) if flush else (pa, px)
    return acc + s * (xa @ b)


@pytest.mark.parametrize("M,K,N,r,qb", [
    (512, 1024, 256, 8, 64),      # the benchmark's --full, N cut
    (37, 200, 192, 8, 64),        # ragged: M, K and N past a 64 tile
    (70, 96, 136, 64, 8)],        # the largest rank, qblock 8
    ids=["benchmark-N256", "ragged", "rank64"])
def test_f32_qlora_arithmetic_keeps_the_limit(M, K, N, r, qb):
    """3xTF32 held to the plain version and to the JAX package's oracle
    within the reference's f32 limit (atol 1e-4, rtol 1e-4); at K >= 1024
    one TF32 product and both two-product variants miss it."""
    x, wq, am, a, b, s = _qlora_inputs(M, K, N, r, qb, seed=M + K + N,
                                       dtype=torch.float32)
    got = _qlora_tf32_arithmetic(x, wq, am, a, b, s)
    want = qm.qlora_matmul_ref(x, wq, am, a, b, s)
    jwant = torch.from_numpy(np.asarray(jref.qlora_matmul_ref(
        *(jnp.asarray(t.numpy()) for t in (x, wq, am, a, b)), s)).copy())
    assert torch.isfinite(got).all()
    assert _within(got, want, 1e-4, 1e-4) <= 0.0
    assert _within(got, jwant, 1e-4, 1e-4) <= 0.0
    if K >= 1024:
        for label, products in QLORA_VARIANTS.items():
            fewer = _qlora_tf32_arithmetic(x, wq, am, a, b, s, products)
            assert _within(fewer, want, 1e-4, 1e-4) > 0.0, label


def test_bf16_qlora_accumulation_flushes_each_slice():
    """At K = 11,008 (fedtime-llama2-7b's ``w_down``; M and N cut to a 64 x
    128 tile) one chain of MMAs over all of K misses the bf16 limit, as
    does flushing only x . w or only x . A; the kernel's partials, both
    chains flushed each 16-deep slice, keep it.  At K = 4096 even one
    chain kept it, which is why the fit's ``wq`` shape never showed the
    drift."""
    x, wq, am, a, b, s = _qlora_inputs(64, 11_008, 128, 8, 64, seed=3)
    want = qm.qlora_matmul_ref(x, wq, am, a, b, s)

    def over(flush):
        got = _qlora_mma_arithmetic(x, wq, am, a, b, s, flush=flush)[1]
        return _within(got, want, QLORA_ATOL, QLORA_RTOL)
    assert over(("w", "a")) <= 0.0
    for flush in ((), ("w",), ("a",)):
        assert over(flush) > 0.0, flush
    x, wq, am, a, b, s = _qlora_inputs(64, 4096, 128, 8, 64, seed=3)
    got = _qlora_mma_arithmetic(x, wq, am, a, b, s, flush=())[1]
    assert _within(got, qm.qlora_matmul_ref(x, wq, am, a, b, s),
                   QLORA_ATOL, QLORA_RTOL) <= 0.0


def test_f32_qlora_accumulation_flushes_each_step():
    """The tensor cores truncate as they accumulate: at K = 4096 (the fit's
    site, M and N cut to one 64 x 64 tile) one chain of MMAs over all of K
    misses the f32 limit, and the kernel's partials flushed into f32 sums
    each 32-deep step keep it."""
    x, wq, am, a, b, s = _qlora_inputs(64, 4096, 64, 8, 64, seed=1,
                                       dtype=torch.float32)
    want = qm.qlora_matmul_ref(x, wq, am, a, b, s)
    got = _qlora_tf32_arithmetic(x, wq, am, a, b, s)
    assert _within(got, want, 1e-4, 1e-4) <= 0.0
    chain = _qlora_tf32_arithmetic(x, wq, am, a, b, s, flush=False)
    assert _within(chain, want, 1e-4, 1e-4) > 0.0


# ---------------------------------------------------------------------------
# rmsnorm: the layout and the order of the sum of squares
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows,d,itemsize,want", [
    (504, 4096, 2, (256, 1, 1, 2)),     # the fit's shape, bf16: 504 blocks
    (64, 4096, 4, (256, 1, 1, 4)),      # benchmark f32: 64 rows < 132 SMs
    (148, 512, 4, (64, 1, 1, 2)),       # ragged (4, 37, 512) f32
    (8, 4096, 4, (256, 1, 1, 4)),       # few rows: still a block a row
    (2, 2000, 2, (128, 1, 1, 2)),       # d not a multiple of 16 bytes' 2
    (100000, 64, 4, (32, 8, 1, 1)),     # many short rows: 8 to a block
    (3, 16384, 4, (512, 1, 2, 4))])     # 4096 chunks: a cluster of 2
def test_rmsnorm_layout_pinned(rows, d, itemsize, want):
    assert tuple(rn.rmsnorm_layout(rows, d, itemsize, H100_SMS)) == want


def _rmsnorm_chunks(lay, d, itemsize):
    """The 16-byte chunks each (cluster rank, thread) of a row owns."""
    W = 16 // itemsize
    own = {}
    for rank in range(lay.cl):
        for t in range(lay.tpr):
            g = rank * lay.tpr + t
            own[(rank, t)] = [c for j in range(lay.nv)
                              for c in [j * lay.tpr * lay.cl + g]
                              if c * W < d]
    return own


@pytest.mark.parametrize("sms", [8, 114, H100_SMS])
@pytest.mark.parametrize("rows", [1, 3, 64, 131, 132, 148, 504, 100000])
@pytest.mark.parametrize("d,itemsize", [(37, 4), (512, 4), (1030, 4),
                                        (4096, 4), (9000, 4), (16384, 4),
                                        (4096, 2), (2000, 2), (32768, 2)])
def test_rmsnorm_layout_covers_each_chunk_once(rows, d, itemsize, sms):
    lay = rn.rmsnorm_layout(rows, d, itemsize, sms)
    assert lay.tpr % 32 == 0 and 32 <= lay.tpr
    assert lay.tpr * lay.rpb <= 512 and lay.cl in (1, 2, 4)
    assert lay.nv in (1, 2, 4)
    chunks = -(-d * itemsize // 16)
    owned = sorted(c for cs in _rmsnorm_chunks(lay, d, itemsize).values()
                   for c in cs)
    assert owned == list(range(chunks))
    assert lay.nv == 1 or (lay.nv // 2) * lay.tpr * lay.cl < chunks
    if lay.cl > 1:                      # only a row too long for a block
        assert chunks > 512 * 4


def _rmsnorm_kernel_order(x, scale, lay, eps=1e-6):
    """The kernel's arithmetic on the CPU in f32, sum of squares in its
    order: each thread over its chunks (fma, in element order), a warp's
    xor butterfly, the row's warps in order, the cluster's blocks in rank
    order; y = x * (1 / sqrt(ss / d + eps)) * scale."""
    rows, d = x.shape
    W = 16 // x.element_size()
    xf = x.float()
    own = _rmsnorm_chunks(lay, d, x.element_size())
    ss = torch.zeros((rows, lay.cl, lay.tpr), dtype=torch.float32)
    for (rank, t), cs in own.items():
        acc = torch.zeros(rows, dtype=torch.float32)
        for c in cs:
            for i in range(W):
                if c * W + i < d:
                    v = xf[:, c * W + i]
                    acc = (v.double() * v.double() + acc.double()).float()
        ss[:, rank, t] = acc
    warps = ss.reshape(rows, lay.cl, lay.tpr // 32, 32)
    for o in (16, 8, 4, 2, 1):
        lane = torch.arange(32)
        warps = warps + warps[..., lane ^ o]
    per_block = torch.zeros((rows, lay.cl), dtype=torch.float32)
    for w in range(lay.tpr // 32):
        per_block = per_block + warps[..., w, 0]
    total = torch.zeros(rows, dtype=torch.float32)
    for r in range(lay.cl):
        total = total + per_block[:, r]
    inv = 1.0 / torch.sqrt(total / d + eps)
    return (xf * inv[:, None] * scale.float()).to(x.dtype)


@pytest.mark.parametrize("rows,d,dtype", [
    (148, 512, torch.float32), (64, 4096, torch.float32),
    (24, 4096, torch.bfloat16), (5, 1030, torch.float32)])
def test_rmsnorm_kernel_order_keeps_the_limit(rows, d, dtype):
    rng = np.random.default_rng(rows + d)
    x = torch.from_numpy(rng.standard_normal((rows, d),
                                             dtype=np.float32)).to(dtype)
    scale = torch.from_numpy(rng.standard_normal(d, dtype=np.float32))
    lay = rn.rmsnorm_layout(rows, d, x.element_size(), H100_SMS)
    got = _rmsnorm_kernel_order(x, scale, lay)
    want = rn.rmsnorm_ref(x, scale)
    jwant = torch.from_numpy(np.asarray(jref.rmsnorm_ref(
        jnp.asarray(x.float().numpy()), jnp.asarray(scale.numpy())),
        np.float32).copy()).to(dtype)
    bf16 = 2.0 ** -7 if dtype == torch.bfloat16 else 0.0
    for ref in (want, jwant):
        torch.testing.assert_close(got.float(), ref.float(), atol=2e-5,
                                   rtol=2e-5 + bf16)
