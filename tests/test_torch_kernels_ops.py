"""The port's ``kernels.ops`` entries ``qlora_matmul``, ``flash_attention``
and ``rmsnorm`` against the JAX package's, on the CPU.

A CPU tensor takes each kernel's plain version, so these hold the plain
versions (what the card's CUDA kernels are held to) to

  * the reference's oracles in ``repro.kernels.ref``, and
  * the reference's Pallas kernels run with ``interpret=True``, as
    ``tests/test_kernels.py`` runs them, at that file's shapes and dtypes.

Inputs are drawn with numpy from a seed and handed to both sides; the NF4
codes are the port's, which equal the reference's bit for bit
(``tests/test_torch_fedtime.py``).
Tolerances are the reference's own in f32 (``tests/test_kernels.py``: 1e-4
for qlora, 2e-5 for attention and rmsnorm).  In bf16, qlora and rmsnorm
round at the same places on both sides (f32 inside, one cast at the end),
so they may differ by one bf16 step where the f32 values straddle a
rounding boundary: a relative 2**-7 over the f32 limit.  Attention does
not: the oracle's p . v is a bf16 product whose sums XLA and PyTorch round
differently (a few steps of a small output), and the Pallas kernel keeps p
in f32; there the reference's 5e-2 holds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.flash_attention import flash_attention as jflash_attention
from repro.kernels.qlora_matmul import qlora_matmul as jqlora_matmul
from repro.kernels.rmsnorm import rmsnorm as jrmsnorm
from repro_torch.core.lora import _best_block
from repro_torch.core.quant import nf4_quantize
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import qlora_matmul as qm
from repro_torch.kernels import rmsnorm as rn

BF16_STEP = 2.0 ** -7
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture(autouse=True)
def _no_forced_kernels(monkeypatch):
    """The reference reads REPRO_FORCE_KERNELS on every call; a process
    shared with other test files must not carry it in."""
    monkeypatch.delenv("REPRO_FORCE_KERNELS", raising=False)


def _pair(a: np.ndarray, dtype: str):
    """The same values as a torch tensor and a jax array of ``dtype``."""
    tdt, jdt = DTYPES[dtype]
    return torch.from_numpy(a).to(tdt), jnp.asarray(a).astype(jdt)


def _np(y) -> np.ndarray:
    if isinstance(y, torch.Tensor):
        return y.float().numpy()
    return np.asarray(y, np.float32)


def _close(got, want, tol: float, dtype: str):
    rtol = tol + (BF16_STEP if dtype == "bf16" else 0.0)
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=tol)


def _close_attention(got, want, dtype: str):
    tol = 2e-5 if dtype == "f32" else 5e-2
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _qlora_inputs(M, K, N, r=8, qb=64, seed=0):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((K, N)) * 0.05).astype(np.float32)
    x = (rng.standard_normal((M, K)) * 0.5).astype(np.float32)
    a = (rng.standard_normal((K, r)) * 0.1).astype(np.float32)
    b = (rng.standard_normal((r, N)) * 0.1).astype(np.float32)
    wq, am = nf4_quantize(torch.from_numpy(w), qb)
    return x, wq, am.reshape(K, N // qb), a, b


# ---------------------------------------------------------------------------
# rmsnorm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(16, 256), (4, 37, 512), (2, 3, 5, 128)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rmsnorm_matches_oracle_and_pallas(shape, dtype):
    rng = np.random.default_rng(len(shape))
    x = rng.standard_normal(shape).astype(np.float32)
    s = rng.standard_normal(shape[-1]).astype(np.float32)
    tx, jx = _pair(x, dtype)
    got = ops.rmsnorm(tx, torch.from_numpy(s))
    assert got.dtype == tx.dtype and got.shape == tx.shape
    _close(got, ref.rmsnorm_ref(jx, jnp.asarray(s)), 2e-5, dtype)
    _close(got, jrmsnorm(jx, jnp.asarray(s), interpret=True), 2e-5, dtype)


# ---------------------------------------------------------------------------
# qlora_matmul
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("M,K,N", [(64, 128, 128), (128, 256, 256),
                                   (256, 128, 512)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_qlora_matmul_matches_oracle_and_pallas(M, K, N, dtype):
    x, wq, am, a, b = _qlora_inputs(M, K, N, seed=M + K + N)
    tx, jx = _pair(x, dtype)
    got = ops.qlora_matmul(tx, wq, am, torch.from_numpy(a),
                           torch.from_numpy(b), 2.0)
    assert got.dtype == tx.dtype and got.shape == (M, N)
    jargs = (jnp.asarray(wq.numpy()), jnp.asarray(am.numpy()),
             jnp.asarray(a), jnp.asarray(b), 2.0)
    _close(got, ref.qlora_matmul_ref(jx, *jargs), 1e-4, dtype)
    _close(got, jqlora_matmul(jx, *jargs, qblock=64, bm=64, bn=128, bk=128,
                              interpret=True), 1e-4, dtype)


def test_qlora_plain_version_matches_dense_layer():
    """The port's counterpart of the reference's
    test_qlora_matmul_matches_dense_layer: ops.qlora_matmul equals the
    port's ``dense`` on a quantized LoRA site."""
    from repro_torch.models.layers.linear import dense
    K, N, r, qb = 256, 256, 4, 64
    rng = np.random.default_rng(5)
    w = torch.from_numpy((rng.standard_normal((K, N)) * 0.05
                          ).astype(np.float32))
    wq, am = nf4_quantize(w, qb)
    p = {"w_nf4": wq, "absmax": am,
         "lora_a": torch.from_numpy((rng.standard_normal((K, r)) * 0.1
                                     ).astype(np.float32)),
         "lora_b": torch.from_numpy((rng.standard_normal((r, N)) * 0.1
                                     ).astype(np.float32)),
         "lora_scale": torch.tensor(2.0)}
    x = torch.from_numpy(rng.standard_normal((32, K)).astype(np.float32))
    got = ops.qlora_matmul(x, wq, am.reshape(K, N // qb), p["lora_a"],
                           p["lora_b"], p["lora_scale"])
    np.testing.assert_allclose(got.numpy(), dense(p, x).numpy(), rtol=1e-4,
                               atol=1e-4)


def test_qlora_matmul_refuses_cross_row_blocks():
    """``quantize_base`` picks ``_best_block`` when qblock does not divide
    in * out; that block may cross rows, and absmax then has no (K,
    N/qblock) view.  The entry refuses it on every device."""
    K, N = 3, 32
    qb = _best_block(K * N, 64)
    assert qb == 48 and N % qb                    # the blocks cross rows
    rng = np.random.default_rng(1)
    wq, am = nf4_quantize(torch.from_numpy(
        rng.standard_normal((K, N)).astype(np.float32)), qb)
    x = torch.ones((4, K))
    a, b = torch.ones((K, 2)), torch.ones((2, N))
    for absmax in (am, am.reshape(-1, 1), am.reshape(1, -1)):
        with pytest.raises(ValueError, match="absmax"):
            ops.qlora_matmul(x, wq, absmax, a, b, 1.0)


# ---------------------------------------------------------------------------
# flash_attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,H,S,D,causal,dtype", [
    (1, 2, 128, 64, True, "f32"), (1, 2, 128, 64, False, "f32"),
    (2, 3, 256, 64, True, "f32"), (2, 3, 256, 64, False, "f32"),
    (1, 1, 256, 128, True, "f32"), (1, 1, 256, 128, False, "f32"),
    (2, 2, 128, 64, True, "bf16")])
def test_flash_attention_matches_oracle_and_pallas(B, H, S, D, causal,
                                                   dtype):
    rng = np.random.default_rng(B * H + S)
    qkv = [_pair(rng.standard_normal((B, H, S, D)).astype(np.float32), dtype)
           for _ in range(3)]
    t, j = [p[0] for p in qkv], [p[1] for p in qkv]
    got = ops.flash_attention(*t, causal=causal)
    assert got.dtype == t[0].dtype and got.shape == (B, H, S, D)
    _close_attention(got, ref.flash_attention_ref(*j, causal=causal), dtype)
    _close_attention(got, jflash_attention(*j, causal=causal, bq=128, bk=128,
                                           interpret=True), dtype)


# ---------------------------------------------------------------------------
# ragged shapes (the Pallas kernels assert divisibility; the port masks)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["qlora M37 K200 N192", "attention S100",
                                  "attention S100 full"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_ragged_shapes_match_oracle(case, dtype):
    if case.startswith("qlora"):
        x, wq, am, a, b = _qlora_inputs(37, 200, 192, seed=3)
        tx, jx = _pair(x, dtype)
        got = ops.qlora_matmul(tx, wq, am, torch.from_numpy(a),
                               torch.from_numpy(b), 2.0)
        want = ref.qlora_matmul_ref(
            jx, jnp.asarray(wq.numpy()), jnp.asarray(am.numpy()),
            jnp.asarray(a), jnp.asarray(b), 2.0)
        _close(got, want, 1e-4, dtype)
        return
    causal = not case.endswith("full")
    rng = np.random.default_rng(100)
    qkv = [_pair(rng.standard_normal((2, 3, 100, 64)).astype(np.float32),
                 dtype) for _ in range(3)]
    got = ops.flash_attention(*[p[0] for p in qkv], causal=causal)
    want = ref.flash_attention_ref(*[p[1] for p in qkv], causal=causal)
    _close_attention(got, want, dtype)


# ---------------------------------------------------------------------------
# the CUDA wrappers
# ---------------------------------------------------------------------------

def _cpu_calls():
    x, wq, am, a, b = _qlora_inputs(8, 64, 64)
    q = torch.zeros((1, 1, 16, 64))
    return {
        "rmsnorm": (rn, lambda f: f(torch.ones((2, 8)), torch.ones(8))),
        "qlora_matmul": (qm, lambda f: f(torch.from_numpy(x), wq, am,
                                         torch.from_numpy(a),
                                         torch.from_numpy(b), 2.0)),
        "flash_attention": (fa, lambda f: f(q, q, q, causal=True))}


@pytest.mark.parametrize("name", ["rmsnorm", "qlora_matmul",
                                  "flash_attention"])
def test_cuda_wrapper_refuses_cpu_tensors_and_counts_nothing(name):
    mod, call = _cpu_calls()[name]
    mod.reset_launches()
    with pytest.raises(ValueError, match="CUDA"):
        call(getattr(mod, f"{name}_cuda"))
    call(getattr(ops, name))                     # the plain version
    assert mod.LAUNCHES == {name: 0}
