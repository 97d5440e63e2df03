"""The port's fused wire hop and host-loop upload against the JAX package's.

The plain hop (``repro_torch.kernels.wire_hop.fused_hop_ref``, what a CPU
tensor runs and what the card's kernel is held to) must equal, bit for bit:

  * the reference's oracle ``_hop_jnp`` run op by op, as its host-loop
    upload (``fedcomm.quantize_update``) runs it: acc, codes, scales and
    residual, on both wires, in both forms;
  * ``_hop_pallas`` called directly (interpreted off the TPU), on the bf16
    wire, and on the int8 wire wherever XLA's CPU compiler leaves the
    kernel's arithmetic as written.  It does not everywhere, and that is a
    difference on the JAX side: XLA contracts ``acc + codes*scales`` and
    ``t - q*s`` into one FMA each (one rounding where the kernel body
    rounds twice) and turns ``max|t| / 127`` into ``max|t| * (1/127)``.
    There the codes stay exact, the scales agree within 1 ulp, acc within
    the rounding of the product that the FMA skips plus one ulp of the sum
    (2**-23 (|codes*scales| + |acc|)), and the residual within 2**-22 of
    its row's max |t| (the same skipped rounding, plus 127 x a 1-ulp scale
    difference).

Inputs are drawn with numpy and cover a ragged number of rows, all-zero
rows (the 1e-30 scale floor), ties at x.5 (half to even) and rows whose
scale is a power of two.  ``REPRO_FORCE_KERNELS`` is cleared with
``monkeypatch`` so the reference's upload takes its oracle.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.dist import fedcomm as jfedcomm
from repro.kernels.ring_allreduce import _hop_jnp, _hop_pallas
from repro_torch.dist import fedcomm
from repro_torch.kernels import wire_hop


@pytest.fixture(autouse=True)
def _reference_oracle(monkeypatch):
    """The reference's ``fused_hop`` takes its Pallas launch when
    ``REPRO_FORCE_KERNELS=1``; these tests hold the port to the oracle."""
    monkeypatch.delenv("REPRO_FORCE_KERNELS", raising=False)


def _rows(rng, R, Q, *, zero_rows=(1,), tie_row=2, pow2_row=3):
    """(R*Q,) f32 acc and res with the special rows."""
    acc = (rng.normal(size=(R, Q)) *
           rng.uniform(0.01, 10.0, (R, 1))).astype(np.float32)
    res = (rng.normal(size=(R, Q)) * 1e-3).astype(np.float32)
    for r in zero_rows:
        acc[r] = 0.0
        res[r] = 0.0
    # ties: max |t| = 127 gives a scale of exactly 1, so t / s = k + 0.5
    acc[tie_row] = np.round(rng.uniform(-120, 120, Q)) + 0.5
    acc[tie_row, 0] = 127.0
    res[tie_row] = 0.0
    # a scale of 0.5: t / s lands on integers and half-integers
    acc[pow2_row] = (np.arange(Q) - Q // 2) * 0.25
    acc[pow2_row, 0] = 63.5
    res[pow2_row] = 0.0
    return acc.reshape(-1), res.reshape(-1)


def _received(rng, wire, n, R):
    if wire == "int8":
        codes = rng.integers(-127, 128, n).astype(np.int8)
        scales = rng.uniform(1e-4, 1e-1, R).astype(np.float32)
        return codes, scales
    return rng.normal(size=n).astype(ml_dtypes.bfloat16), None


def _t(a):
    if a is None:
        return None
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _np(t):
    if t is None:
        return None
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _bits(a):
    a = np.asarray(a)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.itemsize])


def _zero_like_codes(acc, wire, R):
    if wire == "int8":
        return np.zeros(acc.shape, np.int8), np.zeros(R, np.float32)
    return np.zeros(acc.shape, ml_dtypes.bfloat16), None


CASES = [(wire, form, Q, R) for wire in ("int8", "bf16")
         for form in ("full", "quantize_only")
         for Q, R in ((32, 13), (128, 21))]


def _case(wire, form, Q, R, seed=0):
    rng = np.random.default_rng(seed)
    acc, res = _rows(rng, R, Q)
    codes = scales = None
    if form == "full":
        codes, scales = _received(rng, wire, acc.size, R)
    return acc, codes, scales, res


def _port(acc, codes, scales, res, wire, Q):
    out = wire_hop.fused_hop(_t(acc), _t(codes), _t(scales), _t(res),
                             wire=wire, qblock=Q)
    return [_np(o) for o in out]


def _reference(fn, acc, codes, scales, res, wire, Q):
    if codes is None:             # the reference's quantize-only form
        codes, scales = _zero_like_codes(acc, wire, acc.size // Q)
    out = fn(jnp.asarray(acc), jnp.asarray(codes),
             None if scales is None else jnp.asarray(scales),
             jnp.asarray(res), wire=wire, qblock=Q)
    return [None if o is None else np.asarray(o) for o in out]


@pytest.mark.parametrize("wire,form,Q,R", CASES)
def test_plain_hop_equals_reference_oracle_bit_for_bit(wire, form, Q, R):
    args = _case(wire, form, Q, R)
    got = _port(*args, wire, Q)
    want = _reference(_hop_jnp, *args, wire, Q)
    for name, g, w in zip(("acc", "codes", "scales", "res"), got, want):
        if w is None:
            assert g is None, name
            continue
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=name)


@pytest.mark.parametrize("wire,form,Q,R", CASES)
def test_plain_hop_against_pallas_hop(wire, form, Q, R):
    args = _case(wire, form, Q, R)
    _, codes_in, scales_in, _ = args
    got = _port(*args, wire, Q)
    want = _reference(_hop_pallas, *args, wire, Q)
    g_acc, g_codes, g_scales, g_res = got
    w_acc, w_codes, w_scales, w_res = want
    np.testing.assert_array_equal(_bits(g_codes), _bits(w_codes))
    if wire == "bf16":                   # no product: exact everywhere
        np.testing.assert_array_equal(_bits(g_acc), _bits(w_acc))
        np.testing.assert_array_equal(_bits(g_res), _bits(w_res))
        return
    if form == "quantize_only":          # acc + 0*0: no product to fuse
        np.testing.assert_array_equal(_bits(g_acc), _bits(w_acc))
    else:
        prod = (codes_in.reshape(R, Q).astype(np.float32) *
                scales_in[:, None]).reshape(-1)
        bound = 2.0 ** -23 * (np.abs(prod) + np.abs(g_acc)) + 1e-45
        assert np.all(np.abs(g_acc - w_acc) <= bound)
    ulps = np.abs(g_scales.view(np.int32).astype(np.int64) -
                  w_scales.view(np.int32).astype(np.int64))
    assert ulps.max() <= 1, ulps
    t = (g_acc + args[3]).reshape(R, Q)
    row_max = np.abs(t).max(axis=1, keepdims=True)
    bound = (2.0 ** -22 * row_max + 1e-45).repeat(Q, 1).reshape(-1)
    assert np.all(np.abs(g_res - w_res) <= bound)


def test_ties_round_half_to_even_and_zero_rows_floor_the_scale():
    """What the traps would break: roundf (half away from zero) moves the
    codes of the tie row, and a zero row must keep its 1e-30 scale and
    all-zero codes and residual."""
    acc, _, _, res = _case("int8", "quantize_only", 32, 13)
    _, codes, scales, new_res = _port(acc, None, None, res, "int8", 32)
    t = (acc + res).reshape(13, 32)
    assert scales[2] == 1.0 and scales[3] == 0.5
    np.testing.assert_array_equal(codes.reshape(13, 32)[2],
                                  np.round(t[2]).astype(np.int8))
    assert np.any(np.abs(t[2] - np.trunc(t[2])) == 0.5)
    assert not np.array_equal(np.round(t[2]),
                              np.trunc(t[2] + np.sign(t[2]) * 0.5))
    assert scales[1] == np.float32(1e-30)
    assert not codes.reshape(13, 32)[1].any()
    assert not new_res.reshape(13, 32)[1].any()


def _adapter_tree(rng):
    """An adapter-shaped tree whose total (492) is not a multiple of the
    qblock, so the last row is padded."""
    shapes = {"wq": ((2, 16, 4), (2, 4, 16)), "wo": ((2, 16, 4), (2, 4, 9)),
              "wk": ((1, 5, 3), (1, 3, 7))}
    tree = {}
    for name, (sa, sb) in shapes.items():
        tree[name] = {"lora_b": rng.normal(size=sb).astype(np.float32),
                      "lora_a": rng.normal(size=sa).astype(np.float32)}
    return {"layers": {"attn": tree}}


def _map(tree, fn):
    return {k: _map(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


@pytest.mark.parametrize("wire", ["int8", "bf16"])
@pytest.mark.parametrize("qblock", [32, 128])
def test_quantize_update_equals_reference_with_and_without_residual(
        wire, qblock):
    rng = np.random.default_rng(3)
    jres = pres = None
    for step in range(3):                 # the first upload has no residual
        tree = _adapter_tree(rng)
        jdq, jres = jfedcomm.quantize_update(
            _map(tree, jnp.asarray), jres, wire=wire, qblock=qblock)
        pdq, pres = fedcomm.quantize_update(
            _map(tree, torch.from_numpy), pres, wire=wire, qblock=qblock)
        assert pres.shape == (-(-492 // qblock) * qblock,)
        np.testing.assert_array_equal(_bits(pres.numpy()),
                                      _bits(np.asarray(jres)), err_msg=step)
        for (ka, a), (kb, b) in zip(
                sorted(_flat(jdq).items()), sorted(_flat(pdq).items())):
            assert ka == kb
            np.testing.assert_array_equal(_bits(b.numpy()),
                                          _bits(np.asarray(a)),
                                          err_msg=f"{ka} step {step}")


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def test_quantize_update_f32_is_identity_and_wire_reads_env(monkeypatch):
    tree = {"a": torch.ones(3)}
    same, res = fedcomm.quantize_update(tree, None, wire="f32")
    assert same is tree and res is None
    monkeypatch.setenv("REPRO_FED_WIRE", "bf16")
    monkeypatch.setenv("REPRO_FED_QBLOCK", "32")
    dq, res = fedcomm.quantize_update({"a": torch.full((40,), 1.0 / 3)})
    assert res.shape == (64,)
    assert dq["a"][0] == torch.tensor(1.0 / 3).to(torch.bfloat16).float()


def test_cuda_wrapper_refuses_cpu_tensors_and_counts_nothing():
    wire_hop.reset_launches()
    acc = torch.zeros(128)
    with pytest.raises(ValueError, match="CUDA"):
        wire_hop.fused_hop_cuda(acc, None, None, acc, wire="int8",
                                qblock=128)
    wire_hop.fused_hop(acc, None, None, acc, wire="int8", qblock=128)
    assert wire_hop.LAUNCHES == {"wire_hop_int8": 0, "wire_hop_bf16": 0}
