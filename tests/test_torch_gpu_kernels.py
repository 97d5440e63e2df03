"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU with sm_90a and nvcc; without one it
skips.  This file imports neither jax nor the JAX package (the card's
machine has no jax), so on that machine it runs without the repository's
conftest:

  PYTHONPATH=src python -m pytest -q --noconftest -m gpu \
      tests/test_torch_gpu_kernels.py

Tolerances: the f32 output before its cast to q's dtype (acc / l of the
partials) within 1e-5 for every cache type, since both sides see the same
inputs and differ only in the order of their sums; a bf16 output within
what rounding those f32 outputs allows: |got - want| <= 2**-8 (|got| +
|want|) + 1e-5 (each side rounds by at most half a bf16 step, 2**-8 of its
value).  Block copies
and empty rows are exact.  The kernel is built for G = 2 and D in {64, 128}
(the ported configurations' head geometries) and refuses the rest.  The
ring kernel is held at the card's split policy and at explicit split
counts, at ring lengths that no split count divides, with idle lanes
(q_pos -1) and empty rings, through ``return_partials`` (its merged f32
sums), and must be one kernel launch a call (counted with
``torch.profiler``).

The wire-hop kernel (int8 and bf16 wires, full and quantize-only forms)
must equal its plain version bit for bit: acc, codes, scales and residual.

The ``kernels.ops`` kernels (rmsnorm, qlora_matmul, flash_attention) are
held at ragged shapes, the reference benchmark's ``--full`` shapes and the
shapes fedtime-llama2-7b's local step would give them.  Limits: in f32 the
reference's own (``tests/test_kernels.py``: 2e-5 for rmsnorm and
attention, 1e-4 for qlora, as ``assert_allclose``'s rtol and atol), since
both sides compute in f32 and differ in the order of their sums.  In bf16
rmsnorm and qlora round once, at the end, on both sides: they may differ by
one bf16 step (a relative 2**-7) over the f32 limit.  The plain attention
casts p to bf16 before p . v and the kernel does not, so a bf16 attention
output is held instead to the plain version run on the same inputs in f32:
within its own rounding, half a bf16 step (a relative 2**-8), over the f32
limit.  The bf16 kernel runs on the tensor cores with p split into two bf16
values, which keeps it inside that limit
(``tests/test_torch_kernel_designs.py`` emulates its arithmetic on the CPU).
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import ops

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA not available)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _quant(x):
    amax = x.abs().amax(-1, keepdim=True)
    scale = (torch.clamp(amax, min=1e-6) / 127.0).to(torch.bfloat16)
    q = torch.clamp(torch.round(x / scale.float()), -127, 127)
    return q.to(torch.int8), scale


def _ring(dev, *, B, S, Hk, G, D, dtype, wrap=False, empty_row=None,
          seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn((B, 1, Hk * G, D), generator=g)
    k = torch.randn((B, S, Hk, D), generator=g)
    v = torch.randn((B, S, Hk, D), generator=g)
    pos = np.array([(S + S // 3 + b) if wrap else (S - 1 - 7 * b)
                    for b in range(B)])
    kv_pos = np.full((B, S), -1, np.int32)
    for b in range(B):
        lo = max(0, pos[b] - S + 1)
        p = np.arange(lo, pos[b] + 1)
        kv_pos[b, p % S] = p
    if empty_row is not None:
        kv_pos[empty_row] = -1
    kw = {}
    if dtype == torch.int8:
        k, ks = _quant(k)
        v, vs = _quant(v)
        kw = {"k_scale": ks.to(dev), "v_scale": vs.to(dev)}
        q = q.to(torch.bfloat16)
    else:
        q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    return (q.to(dev), k.to(dev), v.to(dev),
            torch.from_numpy(kv_pos).to(dev),
            torch.from_numpy(pos.astype(np.int32)).to(dev), kw)


TOL_F32 = 1e-5


def _close(got, want, tol):
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def _f32_out(fn, *args, **kw):
    m, l, acc = fn(*args, return_partials=True, **kw)
    return acc / torch.clamp(l, min=1e-30)


def _assert_matches_plain(args, kw):
    """Kernel (through ops) against the plain version on the same inputs;
    returns the kernel's output."""
    _close(_f32_out(ops.flash_decode, *args, **kw),
           _f32_out(fd.flash_decode_ref, *args, **kw), TOL_F32)
    got = ops.flash_decode(*args, **kw)
    want = fd.flash_decode_ref(*args, **kw)
    if got.dtype == torch.bfloat16:
        g, w = got.float(), want.float()
        err = (g - w).abs()
        assert torch.all(err <= 2 ** -8 * (g.abs() + w.abs()) + TOL_F32), \
            err.max()
    else:
        _close(got, want, TOL_F32)
    return got


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.int8],
                         ids=["bf16", "f32", "int8"])
@pytest.mark.parametrize("D", [64, 128])
def test_contiguous_kernel_matches_plain(cuda, dtype, D):
    q, k, v, kv_pos, pos, kw = _ring(cuda, B=3, S=1000, Hk=2, G=2, D=D,
                                     dtype=dtype, empty_row=1, seed=D)
    got = _assert_matches_plain((q, k, v, kv_pos, pos), kw)
    assert torch.count_nonzero(got[1]) == 0          # empty row: exactly 0


@pytest.mark.parametrize("G,D", [(1, 128), (4, 128), (2, 96)])
def test_kernel_refuses_other_head_geometries(cuda, G, D):
    q, k, v, kv_pos, pos, _ = _ring(cuda, B=1, S=256, Hk=2, G=G, D=D,
                                    dtype=torch.bfloat16)
    n = dict(fd.LAUNCHES)
    with pytest.raises(ValueError, match="must be"):
        ops.flash_decode(q, k, v, kv_pos, pos)
    assert fd.LAUNCHES == n


@pytest.mark.parametrize("kw", [dict(window=300), dict(kind="prefix",
                                                        prefix_len=100),
                                dict(kind="full"), dict(softcap=5.0)],
                         ids=["window", "prefix", "full", "softcap"])
def test_contiguous_kernel_masks(cuda, kw):
    q, k, v, kv_pos, pos, _ = _ring(cuda, B=2, S=640, Hk=2, G=2, D=128,
                                    dtype=torch.float32, wrap=True, seed=3)
    _assert_matches_plain((q, k, v, kv_pos, pos), kw)


def test_return_partials(cuda):
    q, k, v, kv_pos, pos, _ = _ring(cuda, B=2, S=4096, Hk=2, G=2, D=128,
                                    dtype=torch.float32, empty_row=0, seed=4)
    got = ops.flash_decode(q, k, v, kv_pos, pos, return_partials=True)
    want = fd.flash_decode_ref(q, k, v, kv_pos, pos, return_partials=True)
    for a, b in zip(got, want):
        _close(a, b, 1e-4)
    assert torch.all(got[0][0] == -1e30) and torch.all(got[1][0] == 0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.int8],
                         ids=["bf16", "f32", "int8"])
def test_paged_kernel_matches_plain(cuda, dtype):
    """Shared prefix blocks in several tables, -1 entries, a stale block."""
    B, bs, T, Hk, G, D = 4, 16, 20, 8, 2, 128
    nb = 64
    g = torch.Generator(device="cpu").manual_seed(7)
    q = torch.randn((B, 1, Hk * G, D), generator=g)
    k = torch.randn((nb, bs, Hk, D), generator=g)
    v = torch.randn((nb, bs, Hk, D), generator=g)
    perm = torch.randperm(nb, generator=g).tolist()
    tbl = np.full((B, T), -1, np.int32)
    q_pos = np.array([T * bs - 1, 150, 37, 200], np.int32)
    shared = perm[:3]                          # a 3-block common prefix
    nxt = 3
    for b in range(B):
        need = q_pos[b] // bs + 1
        for j in range(need):
            if j < 3:
                tbl[b, j] = shared[j]
            else:
                tbl[b, j] = perm[nxt]
                nxt += 1
    kv_pos = np.full((nb, bs), -1, np.int32)
    for b in range(B):
        for j in range(T):
            if tbl[b, j] >= 0:
                for o in range(bs):
                    if j * bs + o <= q_pos[b]:
                        kv_pos[tbl[b, j], o] = max(kv_pos[tbl[b, j], o],
                                                   j * bs + o)
    kv_pos[perm[-1]] = np.arange(bs)           # stale, cited by no table
    kw = {}
    if dtype == torch.int8:
        k, ks = _quant(k)
        v, vs = _quant(v)
        kw = {"k_scale": ks.to(cuda), "v_scale": vs.to(cuda)}
        q = q.to(torch.bfloat16)
    else:
        q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    args = (q.to(cuda), k.to(cuda), v.to(cuda),
            torch.from_numpy(kv_pos).to(cuda),
            torch.from_numpy(q_pos).to(cuda))
    t = torch.from_numpy(tbl).to(cuda)
    _assert_matches_plain(args, dict(block_tables=t, **kw))


@pytest.mark.parametrize("n_splits", [0, 1, 3, 8],
                         ids=["card", "1", "3", "8"])
@pytest.mark.parametrize("S", [577, 100, 1])
def test_ring_kernel_splits(cuda, S, n_splits):
    """The card's split policy (0) and explicit counts, at ring lengths no
    count divides and at one slot; lane 1 idle (q_pos -1) and row 2's ring
    empty, both exactly 0; the merged f32 partials through the same
    kernel."""
    q, k, v, kv_pos, pos, _ = _ring(cuda, B=4, S=S, Hk=8, G=2, D=128,
                                    dtype=torch.bfloat16, empty_row=2,
                                    seed=S)
    pos[1] = -1
    args, kw = (q, k, v, kv_pos, pos), dict(n_splits=n_splits)
    got = _assert_matches_plain(args, kw)
    assert torch.count_nonzero(got[1]) == 0
    assert torch.count_nonzero(got[2]) == 0
    got_p = ops.flash_decode(*args, return_partials=True, **kw)
    want_p = fd.flash_decode_ref(*args, return_partials=True, **kw)
    for a, b in zip(got_p, want_p):
        _close(a, b, 1e-4)
    assert torch.all(got_p[0][1:3] == -1e30)
    assert torch.count_nonzero(got_p[1][1:3]) == 0
    assert torch.count_nonzero(got_p[2][1:3]) == 0


@pytest.mark.parametrize("kw", [{}, dict(window=300),
                                dict(kind="prefix", prefix_len=100),
                                dict(kind="full"), dict(softcap=5.0)],
                         ids=["causal", "window", "prefix", "full",
                              "softcap"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.int8],
                         ids=["bf16", "f32", "int8"])
def test_ring_kernel_kinds_and_types_d64(cuda, dtype, kw):
    q, k, v, kv_pos, pos, skw = _ring(cuda, B=3, S=640, Hk=2, G=2, D=64,
                                      dtype=dtype, wrap=True, seed=5)
    _assert_matches_plain((q, k, v, kv_pos, pos), {**kw, **skw})


@pytest.mark.parametrize("q_pos_form", ["int", "0-d"])
def test_ring_kernel_scalar_positions(cuda, q_pos_form):
    """q_pos as a Python int or a 0-d tensor (read with stride 0), one (S,)
    kv_pos row for every request, prefix_len as a (B,) tensor."""
    B, S, Hk, D = 3, 300, 2, 128
    g = torch.Generator(device="cpu").manual_seed(9)
    q = torch.randn((B, 1, 2 * Hk, D), generator=g).to(cuda)
    k, v = (torch.randn((B, S, Hk, D), generator=g).to(cuda)
            for _ in range(2))
    kv_pos = torch.arange(S, dtype=torch.int32, device=cuda)
    q_pos = 250 if q_pos_form == "int" else torch.tensor(
        250, dtype=torch.int32, device=cuda)
    plen = torch.tensor([0, 270, 299], dtype=torch.int32, device=cuda)
    for kw in ({}, dict(kind="prefix", prefix_len=plen)):
        _assert_matches_plain((q, k, v, kv_pos, q_pos), kw)


def test_ring_wrapper_is_one_kernel_launch(cuda):
    """A ring call, output or partials, is one kernel and no other device
    work (no copy, fill or combine)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    q, k, v, kv_pos, pos, _ = _ring(cuda, B=4, S=576, Hk=8, G=2, D=128,
                                    dtype=torch.bfloat16)
    calls = (lambda: ops.flash_decode(q, k, v, kv_pos, pos),
             lambda: ops.flash_decode(q, k, v, kv_pos, 575),
             lambda: ops.flash_decode(q, k, v, kv_pos, pos,
                                      return_partials=True))
    for call in calls:
        call()
    torch.cuda.synchronize()
    n0 = fd.LAUNCHES["flash_decode"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(4):
            for call in calls:
                call()
        torch.cuda.synchronize()
    dev_ops = [(e.key, e.count) for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    assert sum(n for _, n in dev_ops) == 12, dev_ops
    assert fd.LAUNCHES["flash_decode"] - n0 == 12


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.int8,
                                   torch.int32])
@pytest.mark.parametrize("tail", [(16, 8, 128), (16,), (3, 5)],
                         ids=["kv", "kv_pos", "odd"])
def test_block_copy_bit_exact(cuda, dtype, tail):
    g = torch.Generator(device="cpu").manual_seed(1)
    base = torch.randint(-100, 100, (4, 10) + tail, generator=g)
    leaf = base.to(dtype).to(cuda)
    want = leaf.clone()
    fd.paged_block_copy_ref(want, 7, 2)
    got = ops.block_copy(leaf, 7, 2)
    assert got is leaf
    assert torch.equal(got, want)


def test_launch_counters(cuda):
    fd.reset_launches()
    q, k, v, kv_pos, pos, _ = _ring(cuda, B=1, S=256, Hk=1, G=2, D=64,
                                    dtype=torch.float32)
    ops.flash_decode(q, k, v, kv_pos, pos)
    fd.flash_decode_ref(q, k, v, kv_pos, pos)      # plain: not counted
    ops.block_copy(torch.zeros((2, 3, 4), device=cuda), 0, 1)
    assert fd.LAUNCHES == {"flash_decode": 1, "flash_decode_paged": 0,
                           "paged_block_copy": 1}


def test_smoke_model_on_card_matches_cpu(cuda):
    """The smoke config in f32: prefill + 4 decode steps on the card (the
    kernels) against the CPU (the plain versions), same weights."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.registry import get_model
    cfg = get_smoke_config("qwen3-0.6b")
    api = get_model(cfg)
    params = api.init(cfg, torch.Generator(device="cpu").manual_seed(0),
                      device="cpu")
    params_gpu = _to(params, cuda)
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 12), generator=g)
    teacher = torch.randint(0, cfg.vocab_size, (4, 2, 1), generator=g)
    outs = []
    for dev, p in (("cpu", params), (cuda, params_gpu)):
        cache, lg = api.prefill(p, cfg, {"tokens": toks.to(dev)},
                                cache_len=32)
        steps = [lg]
        for i in range(4):
            lg, cache = api.decode_step(p, cfg, cache,
                                        {"token": teacher[i].to(dev),
                                         "pos": 12 + i})
            steps.append(lg)
        outs.append(torch.cat([s.cpu() for s in steps], 1))
    _close(outs[1], outs[0], 1e-3)


def _to(tree, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# The wire hop
# ---------------------------------------------------------------------------

def _hop_inputs(dev, rows, qblock, wire, full, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    n = rows * qblock
    acc = torch.randn(n, generator=g) * 3
    res = torch.randn(n, generator=g) * 1e-3
    acc[:qblock] = 0.0                              # an all-zero row
    res[:qblock] = 0.0
    acc[qblock:2 * qblock] = torch.arange(qblock) - qblock / 2 + 0.5
    acc[qblock] = 127.0                             # scale 1: ties at x.5
    res[qblock:2 * qblock] = 0.0
    codes = scales = None
    if full:
        if wire == "int8":
            codes = torch.randint(-127, 128, (n,), generator=g).to(
                torch.int8).to(dev)
            scales = (torch.rand(rows, generator=g) * 0.1).to(dev)
        else:
            codes = torch.randn(n, generator=g).to(torch.bfloat16).to(dev)
    return acc.to(dev), codes, scales, res.to(dev)


def _same_bits(a, b):
    if a is None or b is None:
        return a is None and b is None
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    return torch.equal(a.contiguous().view(torch.uint8),
                       b.contiguous().view(torch.uint8))


@pytest.mark.parametrize("wire", ["int8", "bf16"])
@pytest.mark.parametrize("full", [True, False])
@pytest.mark.parametrize("rows,qblock", [
    (65536, 128),          # the main path: LLaMA-2-7B-width adapters
    (1001, 128), (77, 64), (13, 32), (5, 1024)])
def test_wire_hop_kernel_bit_exact(cuda, wire, full, rows, qblock):
    from repro_torch.kernels import wire_hop as wh
    args = _hop_inputs(cuda, rows, qblock, wire, full)
    got = wh.fused_hop_cuda(*args, wire=wire, qblock=qblock)
    want = wh.fused_hop_ref(*args, wire=wire, qblock=qblock)
    torch.cuda.synchronize()
    for name, a, b in zip(("acc", "codes", "scales", "res"), got, want):
        assert _same_bits(a, b), name


def test_wire_hop_kernel_refuses_what_it_does_not_take(cuda):
    from repro_torch.kernels import wire_hop as wh
    acc = torch.zeros(96 * 4, device=cuda)
    with pytest.raises(ValueError, match="qblock"):
        wh.fused_hop_cuda(acc, None, None, acc, wire="int8", qblock=96)
    with pytest.raises(ValueError, match="wire"):
        wh.fused_hop_cuda(acc, None, None, acc, wire="f32", qblock=128)
    with pytest.raises(ValueError, match="aligned"):
        wh.fused_hop_cuda(acc[1:257], None, None, acc[:256], wire="bf16",
                          qblock=128)


def test_quantize_update_on_card_equals_cpu(cuda):
    from repro_torch.dist import fedcomm
    g = torch.Generator(device="cpu").manual_seed(3)
    tree = {"b": {"lora_a": torch.randn(2, 64, 8, generator=g)},
            "a": {"lora_b": torch.randn(2, 8, 37, generator=g)}}
    for wire in ("int8", "bf16"):
        res_c = res_g = None
        for _ in range(3):
            dq_c, res_c = fedcomm.quantize_update(tree, res_c, wire=wire,
                                                  qblock=128)
            dq_g, res_g = fedcomm.quantize_update(_to(tree, cuda), res_g,
                                                  wire=wire, qblock=128)
            assert _same_bits(res_g.cpu(), res_c)
            for k in ("a", "b"):
                for leaf, t in dq_c[k].items():
                    assert _same_bits(dq_g[k][leaf].cpu(), t)


# ---------------------------------------------------------------------------
# The kernels.ops kernels: rmsnorm, qlora_matmul, flash_attention
# ---------------------------------------------------------------------------

def _allclose(got, want, tol, bf16_rel=0.0):
    torch.testing.assert_close(got.float(), want.float(), rtol=tol + bf16_rel,
                               atol=tol)


@pytest.mark.parametrize("shape", [(4, 37, 512), (504, 4096), (64, 4096),
                                   (3, 37), (5, 1030), (2, 2000)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernel_matches_plain(cuda, shape, dtype):
    from repro_torch.kernels import rmsnorm as rn
    g = torch.Generator(device="cpu").manual_seed(shape[-1])
    x = torch.randn(shape, generator=g).to(dtype).to(cuda)
    for scale_dtype in (torch.float32, torch.bfloat16):
        s = torch.randn(shape[-1], generator=g).to(scale_dtype).to(cuda)
        got = rn.rmsnorm_cuda(x, s)
        assert got.dtype == dtype and got.shape == x.shape
        _allclose(got, rn.rmsnorm_ref(x, s), 2e-5,
                  2.0 ** -7 if dtype == torch.bfloat16 else 0.0)


def _qlora_case(dev, M, K, N, r, qb, dtype, seed=0):
    from repro_torch.core.quant import nf4_quantize
    g = torch.Generator(device="cpu").manual_seed(seed)
    w = torch.randn((K, N), generator=g) * 0.02
    wq, am = nf4_quantize(w, qb)
    x = torch.randn((M, K), generator=g).to(dtype)
    a = torch.randn((K, r), generator=g) * 0.1
    b = torch.randn((r, N), generator=g) * 0.1
    return tuple(t.to(dev) for t in (x, wq, am.reshape(K, N // qb), a, b))


@pytest.mark.parametrize("M,K,N,r,qb", [
    (37, 200, 192, 8, 64),        # ragged M, K, N
    (504, 4096, 4096, 8, 64),     # fedtime-llama2-7b's wq at full width
    (512, 1024, 1024, 8, 64),     # the reference benchmark's --full
    (5, 37, 36, 3, 12),           # no vector loads of x or of the codes
    (70, 96, 128, 64, 32)])       # the largest rank
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_qlora_kernel_matches_plain(cuda, M, K, N, r, qb, dtype):
    from repro_torch.kernels import qlora_matmul as qm
    args = _qlora_case(cuda, M, K, N, r, qb, dtype)
    got = qm.qlora_matmul_cuda(*args, 2.0)
    assert got.dtype == dtype and got.shape == (M, N)
    _allclose(got, qm.qlora_matmul_ref(*args, 2.0), 1e-4,
              2.0 ** -7 if dtype == torch.bfloat16 else 0.0)


@pytest.mark.parametrize("B,H,S,D", [(8, 32, 63, 128), (4, 8, 1024, 128),
                                     (2, 3, 100, 64), (1, 2, 1, 64),
                                     (1, 1, 130, 128)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(cuda, B, H, S, D, causal,
                                              dtype):
    from repro_torch.kernels import flash_attention as fa
    g = torch.Generator(device="cpu").manual_seed(S + D)
    q, k, v = (torch.randn((B, H, S, D), generator=g).to(dtype).to(cuda)
               for _ in range(3))
    got = fa.flash_attention_cuda(q, k, v, causal)
    assert got.dtype == dtype and got.shape == q.shape
    want = fa.flash_attention_ref(q.float(), k.float(), v.float(), causal)
    _allclose(got, want, 2e-5, 2.0 ** -8 if dtype == torch.bfloat16 else 0.0)


@pytest.mark.parametrize("S", [1, 63, 64, 65, 100])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_attention_kernel_tile_edges(cuda, S, D, causal, dtype):
    """S on both sides of one 64-row / 64-key tile and at one row."""
    from repro_torch.kernels import flash_attention as fa
    g = torch.Generator(device="cpu").manual_seed(S * D)
    q, k, v = (torch.randn((2, 3, S, D), generator=g).to(dtype).to(cuda)
               for _ in range(3))
    got = fa.flash_attention_cuda(q, k, v, causal)
    assert got.dtype == dtype and got.shape == q.shape
    want = fa.flash_attention_ref(q.float(), k.float(), v.float(), causal)
    _allclose(got, want, 2e-5, 2.0 ** -8 if dtype == torch.bfloat16 else 0.0)


def test_ops_kernels_refuse_what_they_do_not_take(cuda):
    from repro_torch.core.quant import nf4_quantize
    q = torch.zeros((1, 2, 8, 96), device=cuda)
    with pytest.raises(ValueError, match="D must be"):
        ops.flash_attention(q, q, q)
    x = torch.zeros((4, 8), dtype=torch.float16, device=cuda)
    with pytest.raises(ValueError, match="f32 or bf16"):
        ops.rmsnorm(x, torch.ones(8, device=cuda))
    args = _qlora_case(cuda, 4, 64, 64, 8, 64, torch.float32)
    with pytest.raises(ValueError, match="lora_a"):
        ops.qlora_matmul(*args[:3], torch.zeros((64, 65), device=cuda),
                         args[4], 1.0)
    wq, am = nf4_quantize(torch.randn((3, 32)), 48)   # blocks cross rows
    with pytest.raises(ValueError, match="absmax"):
        ops.qlora_matmul(torch.ones((4, 3), device=cuda), wq.to(cuda),
                         am.to(cuda), torch.ones((3, 2), device=cuda),
                         torch.ones((2, 32), device=cuda), 1.0)


def test_ops_launch_counters(cuda):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import qlora_matmul as qm
    from repro_torch.kernels import rmsnorm as rn
    for mod in (fa, qm, rn):
        mod.reset_launches()
    x = torch.randn((4, 64), device=cuda)
    ops.rmsnorm(x, torch.ones(64, device=cuda))
    args = _qlora_case(cuda, 4, 64, 64, 8, 64, torch.float32)
    ops.qlora_matmul(*args, 2.0)
    qm.qlora_matmul_ref(*args, 2.0)                # plain: not counted
    q = torch.randn((1, 2, 8, 64), device=cuda)
    ops.flash_attention(q, q, q, causal=False)
    assert (rn.LAUNCHES, qm.LAUNCHES, fa.LAUNCHES) == (
        {"rmsnorm": 1}, {"qlora_matmul": 1}, {"flash_attention": 1})
