"""The port's secure aggregation (``repro_torch.core.secure_agg``) against
the JAX package's, on the CPU.

Tolerances, and why:
  * integer domain (pairwise uint32 mask streams, masked codes, recovery
    residues, unmasked code sums, shared-grid EF encode and decode): equal
    bit for bit.  Both sides draw the masks from numpy's SeedSequence and
    do the same numpy arithmetic.
  * float domain: the reference draws its masks from ``jax.random``, which
    torch cannot reproduce, so the port's masks are not the reference's.
    What the masks are for is held instead: they hide each update, cancel
    in the cohort sum, and a dropped client's masks re-cancel through the
    recovery mask, within 1e-5 of the unmasked aggregate (masks of scale
    1e-2, summed over a few pairs in f32).
"""

import itertools

import jax
import numpy as np
import pytest
import torch

from repro.core import secure_agg as jsa
from repro_torch import bridge
from repro_torch import tree as tree_util
from repro_torch.core import secure_agg as sa

CLIENTS = [3, 7, 11, 20]


@pytest.fixture(autouse=True)
def _no_step_env(monkeypatch):
    monkeypatch.delenv("REPRO_SECAGG_STEP", raising=False)


@pytest.mark.parametrize("pair", [(0, 1), (7, 3), (11, 20)])
@pytest.mark.parametrize("n", [1, 33, 4097])
def test_pair_mask_stream_equals_reference(pair, n):
    got = sa.pair_mask_u32(5, *pair, n)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, jsa.pair_mask_u32(5, *pair, n))
    np.testing.assert_array_equal(got, sa.pair_mask_u32(5, *pair[::-1], n))


def _codes(n=65, seed=0):
    rng = np.random.default_rng(seed)
    return {p: rng.integers(-127, 128, size=n).astype(np.int32)
            for p in CLIENTS}


def test_masked_codes_equal_reference():
    codes = _codes()
    for p in CLIENTS:
        got = sa.mask_codes(codes[p], client_id=p, participants=CLIENTS,
                            round_idx=4)
        want = jsa.mask_codes(codes[p], client_id=p, participants=CLIENTS,
                              round_idx=4)
        assert got.dtype == np.uint32
        np.testing.assert_array_equal(got, want)
        assert not np.array_equal(got, codes[p].astype(np.uint32))


@pytest.mark.parametrize("survivors", [
    s for k in range(1, len(CLIENTS) + 1)
    for s in itertools.combinations(CLIENTS, k)])
def test_unmask_every_surviving_subset_bit_exact(survivors):
    """For every surviving subset of 4 clients: the recovery residue equals
    the reference's, and the unmasked sum equals the plain sum of the
    survivors' codes and the reference's unmasked sum."""
    codes = _codes()
    masked = {p: sa.mask_codes(codes[p], client_id=p, participants=CLIENTS,
                               round_idx=2) for p in CLIENTS}
    survivors = list(survivors)
    dropped = [p for p in CLIENTS if p not in survivors]
    np.testing.assert_array_equal(
        sa.recovery_mask(survivors, dropped, round_idx=2, n=65),
        jsa.recovery_mask(survivors, dropped, round_idx=2, n=65))
    got = sa.unmask_sum([masked[s] for s in survivors], survivors,
                        participants=CLIENTS, round_idx=2)
    want = jsa.unmask_sum([masked[s] for s in survivors], survivors,
                          participants=CLIENTS, round_idx=2)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, sum(codes[s] for s in survivors))


def test_unmask_refuses_bad_cohorts():
    with pytest.raises(ValueError):
        sa.unmask_sum([], [], participants=CLIENTS, round_idx=0)
    with pytest.raises(ValueError):
        sa.unmask_sum([np.zeros(3, np.uint32)], [3, 7],
                      participants=CLIENTS, round_idx=0)


@pytest.mark.parametrize("step", [None, 2.0 ** -8])
def test_secure_encode_with_error_feedback_equals_reference(step,
                                                            monkeypatch):
    """Two rounds of shared-grid encode with the residual carried, clipping
    included (a few values beyond 127 steps), then the decode of the code
    sum: equal bit for bit.  ``None`` reads ``REPRO_SECAGG_STEP``."""
    monkeypatch.setenv("REPRO_SECAGG_STEP", str(2.0 ** -9))
    assert sa.default_step() == jsa.default_step() == 2.0 ** -9
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(257) * 0.02).astype(np.float32)
    x[:3] = [0.9, -0.7, 0.3]
    res, jres, total = None, None, 0
    for _ in range(2):
        codes, res = sa.secure_encode(x, res, step=step)
        jcodes, jres = jsa.secure_encode(x, jres, step=step)
        assert codes.dtype == np.int32 and res.dtype == np.float32
        np.testing.assert_array_equal(codes, jcodes)
        np.testing.assert_array_equal(res, jres)
        total = total + codes
    got = sa.secure_decode_sum(total, step=step)
    np.testing.assert_array_equal(got, jsa.secure_decode_sum(total,
                                                             step=step))
    # the carried error makes two rounds converge on the true sum
    np.testing.assert_allclose(got + res, 2 * x, atol=1e-6)


def _updates(seed=3):
    rng = np.random.default_rng(seed)
    return {p: {"a": rng.normal(size=(8,)).astype(np.float32) * 1e-2,
                "b": {"c": rng.normal(size=(2, 3)).astype(np.float32)}}
            for p in CLIENTS}


def test_float_masks_cancel_and_hide():
    ups = _updates()
    masked = [sa.mask_update(bridge.tree_to_torch(ups[p], "cpu"),
                             client_id=p, participants=CLIENTS, round_idx=3)
              for p in CLIENTS]
    assert not np.allclose(masked[0]["a"].numpy(), ups[CLIENTS[0]]["a"],
                           atol=1e-4)
    agg = sa.aggregate_masked(masked)
    for path in (("a",), ("b", "c")):
        want = np.mean([_get(ups[p], path) for p in CLIENTS], axis=0)
        np.testing.assert_allclose(_get(agg, path).numpy(), want,
                                   atol=1e-5, rtol=0)
    jmasked = [jsa.mask_update(jax.tree.map(np.asarray, ups[p]),
                               client_id=p, participants=CLIENTS,
                               round_idx=3) for p in CLIENTS]
    jagg = jsa.aggregate_masked(jmasked)
    np.testing.assert_allclose(agg["a"].numpy(), np.asarray(jagg["a"]),
                               atol=1e-5, rtol=0)
    summed = sa.aggregate_masked(masked, weights=np.ones(4))
    np.testing.assert_allclose(summed["a"].numpy(),
                               sum(ups[p]["a"] for p in CLIENTS),
                               atol=1e-5, rtol=0)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("dropped", [[7], [3, 20]])
def test_float_recovery_after_dropout(dropped):
    """Masks committed against all four clients, some of which never
    upload: the survivors' sum minus the recovery mask is the unmasked
    survivors' sum within 1e-5; without the recovery it is not."""
    ups = _updates()
    survivors = [p for p in CLIENTS if p not in dropped]
    masked = [sa.mask_update(bridge.tree_to_torch(ups[p], "cpu"),
                             client_id=p, participants=CLIENTS, round_idx=1,
                             seed=9) for p in survivors]
    total = masked[0]
    for m in masked[1:]:
        total = tree_util.map_(lambda x, y: x + y, total, m)
    rec = sa.float_recovery_mask(survivors, dropped, round_idx=1,
                                 like=total, seed=9)
    got = tree_util.map_(lambda x, m: x - m, total, rec)
    want = sum(ups[p]["a"] for p in survivors)
    np.testing.assert_allclose(got["a"].numpy(), want, atol=1e-5, rtol=0)
    assert np.abs(total["a"].numpy() - want).max() > 1e-4
    # another seed draws other masks, which then fail to cancel
    other = sa.float_recovery_mask(survivors, dropped, round_idx=1,
                                   like=total, seed=10)
    assert np.abs((total["a"] - other["a"]).numpy() - want).max() > 1e-4
