"""Secure aggregation (SecAgg-lite): pairwise additive masking, with
dropout recovery over an integer (int8-range, EF-quantized) wire.

Every client pair (i, j) derives a shared mask m_ij from a common seed;
client i adds +m_ij, client j adds -m_ij, so the masks cancel in the
cluster sum and the server only ever sees the aggregate (Bonawitz et al.
2017).

Two wire domains:

  * **integer domain** (``secure_encode`` / ``mask_codes`` /
    ``unmask_sum`` / ``recovery_mask``), the fault-tolerant path.  Each
    client quantizes its delta onto a *shared* step grid (int8-range codes,
    error-feedback residual carried per client), then masks the codes with
    pairwise uint32 streams; all arithmetic is mod 2**32, where pairwise
    cancellation and dropout recovery are exact for every surviving subset.
    The streams are numpy's (``SeedSequence(entropy=round, spawn_key=(a,
    b))``), drawn on the host as the reference draws them, so masks, codes,
    code sums and decoded floats equal the reference's bit for bit.
  * **float domain** (``mask_update`` / ``aggregate_masked`` /
    ``float_recovery_mask``): Gaussian masks added to f32 trees;
    cancellation and recovery hold up to f32 rounding.  The reference draws
    these masks from ``jax.random``, which torch cannot reproduce: the port
    draws them from a ``torch.Generator`` on the tree's device, seeded from
    (seed, round, pair).  They are not the reference's masks; they cancel
    as its do.

Dropout recovery: when clients commit masks against a participant set P but
only S, a subset of P, upload, the survivor sum carries the uncancelled
masks +-m_ij for i in S, j in P - S.  ``recovery_mask`` regenerates exactly
that residue (the real protocol reveals the pairwise seeds through secret
sharing; this simulation regenerates them) and ``unmask_sum`` subtracts it.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import tree as tree_util

__all__ = ["mask_update", "aggregate_masked", "float_recovery_mask",
           "default_step", "secure_encode", "secure_decode_sum",
           "mask_codes", "recovery_mask", "unmask_sum", "pair_mask_u32"]


# ---------------------------------------------------------------------------
# Float domain
# ---------------------------------------------------------------------------

def _pair_generator(seed: int, round_idx: int, i: int, j: int,
                    device) -> torch.Generator:
    """The (order-independent) generator of pair (i, j)'s float masks."""
    a, b = (i, j) if i < j else (j, i)
    state = np.random.SeedSequence(entropy=(seed, round_idx),
                                   spawn_key=(a, b)).generate_state(
                                       1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(state[0]))


@torch.no_grad()
def _mask_tree(tree, gen: torch.Generator, sign: float, scale: float):
    """``tree`` plus sign * scale * N(0, 1) a leaf, the leaves drawn in
    sorted key order from ``gen``."""
    leaves = tree_util.leaves(tree)
    masked = [l + (sign * scale * torch.randn(
        l.shape, generator=gen, device=l.device, dtype=torch.float32)
    ).to(l.dtype) for l in leaves]
    return tree_util.unflatten(tree, masked)


def mask_update(update, *, client_id: int, participants: Sequence[int],
                round_idx: int, scale: float = 1e-2, seed: int = 0):
    """Client-side: add pairwise masks against every other participant."""
    out = update
    device = tree_util.leaves(update)[0].device
    for other in participants:
        if other == client_id:
            continue
        sign = 1.0 if client_id < other else -1.0
        out = _mask_tree(out, _pair_generator(seed, round_idx, client_id,
                                              other, device), sign, scale)
    return out


def aggregate_masked(masked_updates: List, weights=None):
    """Server-side: plain sum, masks cancel pairwise.  Without weights the
    sum is divided by the cohort size; with weights the clients are
    expected to have pre-scaled their updates before masking, so the sum
    is returned as it is."""
    n = len(masked_updates)
    total = masked_updates[0]
    for u in masked_updates[1:]:
        total = tree_util.map_(lambda a, b: a + b, total, u)
    if weights is None:
        return tree_util.map_(lambda a: a / n, total)
    return total


def float_recovery_mask(survivors: Sequence[int], dropped: Sequence[int],
                        *, round_idx: int, like, scale: float = 1e-2,
                        seed: int = 0):
    """The sum over (i in survivors, j in dropped) of the uncancelled mask
    survivor i added for dropped partner j: subtract it from the survivor
    sum to recover the unmasked aggregate (up to f32 rounding)."""
    total = tree_util.map_(lambda l: torch.zeros(
        l.shape, dtype=torch.float32, device=l.device), like)
    device = tree_util.leaves(like)[0].device
    for i in survivors:
        for j in dropped:
            sign = 1.0 if i < j else -1.0
            total = _mask_tree(total, _pair_generator(seed, round_idx, i, j,
                                                      device), sign, scale)
    return total


# ---------------------------------------------------------------------------
# Integer domain: shared-grid EF quantization, masks mod 2**32
# ---------------------------------------------------------------------------

def default_step() -> float:
    """Shared quantization step of the secure integer wire
    (``REPRO_SECAGG_STEP``, read on every call).  2**-10 covers adapter
    deltas to +-0.124 at int8 range; clipping error lands in the
    per-client EF residual."""
    return float(os.environ.get("REPRO_SECAGG_STEP", str(2.0 ** -10)))


def secure_encode(flat: np.ndarray, residual: Optional[np.ndarray] = None,
                  *, step: Optional[float] = None
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Quantize a flat f32 payload onto the shared grid with error
    feedback: ``t = flat + residual``; codes = clip(rint(t / step), +-127);
    new residual = t - codes * step.  Returns ``(codes int32, new_residual
    f32)``.  Host arithmetic in numpy f32, as the reference's."""
    step = step or default_step()
    flat = np.asarray(flat, np.float32)
    t = flat + (np.zeros_like(flat) if residual is None
                else np.asarray(residual, np.float32))
    codes = np.clip(np.rint(t / step), -127, 127).astype(np.int32)
    new_res = t - codes.astype(np.float32) * np.float32(step)
    return codes, new_res


def secure_decode_sum(code_sum: np.ndarray, *,
                      step: Optional[float] = None) -> np.ndarray:
    """Dequantize an exact integer code sum: one f32 multiply an element,
    so equal code sums give bit-identical floats."""
    step = step or default_step()
    return code_sum.astype(np.float32) * np.float32(step)


def pair_mask_u32(round_idx: int, i: int, j: int, n: int) -> np.ndarray:
    """The (order-independent) pairwise mask stream of clients (i, j) in
    round ``round_idx``: ``n`` uint32 values.  Both endpoints generate the
    identical stream."""
    a, b = (i, j) if i < j else (j, i)
    rng = np.random.default_rng(
        np.random.SeedSequence(entropy=round_idx, spawn_key=(a, b)))
    return rng.integers(0, 2 ** 32, size=n, dtype=np.uint32)


def mask_codes(codes: np.ndarray, *, client_id: int,
               participants: Sequence[int],
               round_idx: int) -> np.ndarray:
    """Client-side: codes + sum of +-m_ij mod 2**32.  The lower-id endpoint
    adds, the higher-id one subtracts."""
    out = codes.astype(np.int64).astype(np.uint32)   # two's complement
    for other in participants:
        if other == client_id:
            continue
        m = pair_mask_u32(round_idx, client_id, other, codes.size)
        out = (out + m) if client_id < other else (out - m)
    return out


def recovery_mask(survivors: Sequence[int], dropped: Sequence[int], *,
                  round_idx: int, n: int) -> np.ndarray:
    """The mod-2**32 residue the dropped clients leave in the survivor sum:
    the sum over (i in survivors, j in dropped) of +-m_ij with i's sign."""
    total = np.zeros(n, np.uint32)
    for i in survivors:
        for j in dropped:
            m = pair_mask_u32(round_idx, i, j, n)
            total = (total + m) if i < j else (total - m)
    return total


def unmask_sum(masked: Sequence[np.ndarray], survivors: Sequence[int],
               *, participants: Sequence[int],
               round_idx: int) -> np.ndarray:
    """Server-side: sum the survivors' masked codes, subtract the recovery
    residue of every dropped participant, and centre back to signed
    integers.  Exact for every surviving subset: the result equals the sum
    of the survivors' unmasked codes while that sum fits in int32."""
    if not masked:
        raise ValueError("unmask_sum needs at least one survivor upload")
    if len(masked) != len(survivors):
        raise ValueError(f"{len(masked)} uploads for {len(survivors)} "
                         "survivors")
    dropped = [p for p in participants if p not in set(survivors)]
    total = np.zeros(masked[0].size, np.uint32)
    for u in masked:
        total = total + np.asarray(u, np.uint32)
    total = total - recovery_mask(survivors, dropped,
                                  round_idx=round_idx, n=total.size)
    return total.astype(np.int32)                    # exact recentring
