"""The arithmetic and the work split of the port's redesigned CUDA kernels,
held on the CPU before any card run.

* The ring flash-decode kernel's split policy (``_ring_splits``): for a
  grid of (B, Hk, S, SM count) every slot lies in exactly one split, no
  split is empty, there are at most 8 splits (one thread-block cluster
  carries them), a requested count is honoured, and given the card's
  resident clusters of each size, every (row, head)'s cluster fits at
  once.  The kernel cuts split i of n at ``floor(i * S / n)``
  (``csrc/flash_decode.cu``); the bounds here are that formula.
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
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd

H100_SMS = 132


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
    assert 1 <= n <= fd.MAX_RING_SPLITS
    assert split_len == max(hi - lo for lo, hi in bounds)


@pytest.mark.parametrize("sm_count", [8, 114, H100_SMS])
@pytest.mark.parametrize("B", [1, 3, 4, 12, 64])
def test_ring_splits_cover_every_slot_once(B, sm_count):
    for Hk in (1, 2, 8):
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
    (64, 8, (264,) * 8, 1)])                          # one block a pair fills
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
