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
and empty rows are exact.  Both flash-decode kernels are built for the
ported configurations' head geometries, (G, D) in {(2, 64), (2, 128), (1,
32), (1, 128), (3, 64), (4, 128), (1, 80), (1, 64)}, and refuse the
rest; at D 80
a row is not a power of two of 16-byte vectors, so part of each lane
group idles.  Ring
and paged are held at the card's split policy and at explicit split
counts, at lengths (slots or table entries) that no split count divides,
with idle lanes (q_pos -1) and empty rings or tables, through
``return_partials`` (their merged f32 sums), and each must be one kernel
launch a call (counted with ``torch.profiler``); a paged call captured in
a CUDA graph replays to the eager result.  A copy-on-write event's block
copy over all of a pool's leaves (bf16 and int8 pools) is one launch.

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
values, and the f32 kernel as three TF32 products for each f32 one, which
keeps each inside its limit (``tests/test_torch_kernel_designs.py``
emulates both arithmetics on the CPU).  qlora_matmul's f32 kernel runs as
3xTF32 too, held to the same 1e-4 as before; its shapes include one past
its 64 x 64 tile and 32-deep K step in M, K and N.
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


HEADS = [(2, 64), (2, 128), (1, 32), (1, 128), (3, 64), (4, 128),
         (1, 80), (1, 64)]                                         # built
HEAD_IDS = [f"G{g}-D{d}" for g, d in HEADS]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.int8],
                         ids=["bf16", "f32", "int8"])
@pytest.mark.parametrize("G,D", HEADS, ids=HEAD_IDS)
def test_contiguous_kernel_matches_plain(cuda, dtype, G, D):
    q, k, v, kv_pos, pos, kw = _ring(cuda, B=3, S=1000, Hk=2, G=G, D=D,
                                     dtype=dtype, empty_row=1, seed=D)
    got = _assert_matches_plain((q, k, v, kv_pos, pos), kw)
    assert torch.count_nonzero(got[1]) == 0          # empty row: exactly 0


@pytest.mark.parametrize("G,D", [(4, 64), (3, 128), (2, 96), (1, 96),
                                 (2, 32)])
def test_kernel_refuses_other_head_geometries(cuda, G, D):
    """Ring and paged alike refuse a geometry they are not built for, and
    count no launch."""
    q, k, v, kv_pos, pos, _ = _ring(cuda, B=1, S=256, Hk=2, G=G, D=D,
                                    dtype=torch.bfloat16)
    n = dict(fd.LAUNCHES)
    with pytest.raises(ValueError, match="must be"):
        ops.flash_decode(q, k, v, kv_pos, pos)
    pool_pos = torch.arange(256, dtype=torch.int32, device=cuda).reshape(
        16, 16)
    tbl = torch.arange(16, dtype=torch.int32, device=cuda)[None]
    with pytest.raises(ValueError, match="must be"):
        ops.flash_decode(q, k[0].reshape(16, 16, 2, D),
                         v[0].reshape(16, 16, 2, D), pool_pos, pos,
                         block_tables=tbl)
    assert fd.LAUNCHES == n


@pytest.mark.parametrize("kw", [dict(window=300), dict(kind="prefix",
                                                        prefix_len=100),
                                dict(kind="full"), dict(softcap=5.0)],
                         ids=["window", "prefix", "full", "softcap"])
@pytest.mark.parametrize("G,D", [(2, 128), (1, 128), (1, 32), (3, 64),
                                 (4, 128), (1, 80), (1, 64)],
                         ids=["G2-D128", "G1-D128", "G1-D32", "G3-D64",
                              "G4-D128", "G1-D80", "G1-D64"])
def test_contiguous_kernel_masks(cuda, kw, G, D):
    q, k, v, kv_pos, pos, _ = _ring(cuda, B=2, S=640, Hk=2, G=G, D=D,
                                    dtype=torch.float32, wrap=True, seed=3)
    _assert_matches_plain((q, k, v, kv_pos, pos), kw)


@pytest.mark.parametrize("G,D", [(2, 128), (1, 128), (1, 32), (3, 64),
                                 (4, 128), (1, 80), (1, 64)],
                         ids=["G2-D128", "G1-D128", "G1-D32", "G3-D64",
                              "G4-D128", "G1-D80", "G1-D64"])
def test_return_partials(cuda, G, D):
    q, k, v, kv_pos, pos, _ = _ring(cuda, B=2, S=4096, Hk=2, G=G, D=D,
                                    dtype=torch.float32, empty_row=0, seed=4)
    got = ops.flash_decode(q, k, v, kv_pos, pos, return_partials=True)
    want = fd.flash_decode_ref(q, k, v, kv_pos, pos, return_partials=True)
    for a, b in zip(got, want):
        _close(a, b, 1e-4)
    assert torch.all(got[0][0] == -1e30) and torch.all(got[1][0] == 0)


def _paged(dev, *, B, T, Hk, G, D, dtype, bs=16, nb=64, idle=(), seed=7):
    """A pool of ``nb`` blocks read through a (B, T) table: a 3-block
    prefix shared by every row, -1 entries past each row's position, a
    stale block no table cites, and the lanes in ``idle`` with no granted
    entry at all (q_pos -1).  Returns (args, kw)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn((B, 1, Hk * G, D), generator=g)
    k = torch.randn((nb, bs, Hk, D), generator=g)
    v = torch.randn((nb, bs, Hk, D), generator=g)
    perm = torch.randperm(nb, generator=g).tolist()
    tbl = np.full((B, T), -1, np.int32)
    n = T * bs
    q_pos = np.array([(n - 1, n * 5 // 8, n // 4 + 5, n * 3 // 4)[b % 4]
                      for b in range(B)], np.int32)
    q_pos[list(idle)] = -1
    shared = perm[:3]                          # a 3-block common prefix
    nxt = 3
    for b in range(B):
        need = q_pos[b] // bs + 1 if q_pos[b] >= 0 else 0
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
        kw = {"k_scale": ks.to(dev), "v_scale": vs.to(dev)}
        q = q.to(torch.bfloat16)
    else:
        q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    args = (q.to(dev), k.to(dev), v.to(dev),
            torch.from_numpy(kv_pos).to(dev),
            torch.from_numpy(q_pos).to(dev))
    return args, dict(block_tables=torch.from_numpy(tbl).to(dev), **kw)


@pytest.mark.parametrize("n_splits", [0, 1, 3, 8],
                         ids=["card", "1", "3", "8"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.int8],
                         ids=["bf16", "f32", "int8"])
@pytest.mark.parametrize("G,D", HEADS, ids=HEAD_IDS)
def test_paged_kernel_matches_plain(cuda, dtype, G, D, n_splits):
    """Shared prefix blocks in several tables, -1 entries, a stale block, an
    idle lane; the card's split count and explicit ones over T = 23 table
    entries, which no split count but 1 divides (so a split may hold an
    ungranted entry only, and the last split is uneven)."""
    args, kw = _paged(cuda, B=5, T=23, Hk=8, G=G, D=D, dtype=dtype,
                      idle=(4,))
    got = _assert_matches_plain(args, dict(n_splits=n_splits, **kw))
    assert torch.count_nonzero(got[4]) == 0          # idle lane: exactly 0


@pytest.mark.parametrize("n_splits", [0, 1, 3, 8],
                         ids=["card", "1", "3", "8"])
@pytest.mark.parametrize("G,D", [(2, 128), (1, 128), (1, 32), (3, 64),
                                 (4, 128), (1, 80), (1, 64)],
                         ids=["G2-D128", "G1-D128", "G1-D32", "G3-D64",
                              "G4-D128", "G1-D80", "G1-D64"])
def test_paged_return_partials(cuda, G, D, n_splits):
    """The paged kernel's merged f32 partials (m, l, acc) against the plain
    version's; an idle lane (no granted entry) gives m = -1e30, l = 0,
    acc = 0 exactly."""
    args, kw = _paged(cuda, B=4, T=23, Hk=2, G=G, D=D, dtype=torch.float32,
                      idle=(2,), seed=11)
    kw["n_splits"] = n_splits
    got = ops.flash_decode(*args, return_partials=True, **kw)
    want = fd.flash_decode_ref(*args, return_partials=True, **kw)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        _close(a, b, 1e-4)
    assert torch.all(got[0][2] == -1e30)
    assert torch.count_nonzero(got[1][2]) == 0
    assert torch.count_nonzero(got[2][2]) == 0


@pytest.mark.parametrize("kw", [dict(window=100),
                                dict(kind="prefix", prefix_len=60),
                                dict(kind="full"), dict(softcap=5.0)],
                         ids=["window", "prefix", "full", "softcap"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8],
                         ids=["bf16", "int8"])
def test_paged_kernel_masks(cuda, dtype, kw):
    args, skw = _paged(cuda, B=4, T=20, Hk=2, G=2, D=64, dtype=dtype,
                       seed=13)
    _assert_matches_plain(args, {**kw, **skw})


@pytest.mark.parametrize("n_splits", [0, 1, 3, 8],
                         ids=["card", "1", "3", "8"])
@pytest.mark.parametrize("S", [577, 100, 1])
@pytest.mark.parametrize("Hk,G,D", [(8, 2, 128), (32, 1, 128), (4, 1, 32),
                                    (32, 1, 80), (16, 1, 64)],
                         ids=["qwen3", "fedtime", "fedtime-smoke", "zamba2",
                              "seamless"])
def test_ring_kernel_splits(cuda, S, n_splits, Hk, G, D):
    """The card's split policy (0) and explicit counts, at ring lengths no
    count divides and at one slot, at the served configs' heads; lane 1
    idle (q_pos -1) and row 2's ring empty, both exactly 0; the merged f32
    partials through the same kernel."""
    q, k, v, kv_pos, pos, _ = _ring(cuda, B=4, S=S, Hk=Hk, G=G, D=D,
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


@pytest.mark.parametrize("Hk,G", [(8, 2), (32, 1)], ids=["G2", "G1"])
def test_ring_wrapper_is_one_kernel_launch(cuda, Hk, G):
    """A ring call, output or partials, is one kernel and no other device
    work (no copy, fill or combine), at the fixed batch of each served
    config."""
    q, k, v, kv_pos, pos, _ = _ring(cuda, B=4, S=576, Hk=Hk, G=G, D=128,
                                    dtype=torch.bfloat16)
    calls = (lambda: ops.flash_decode(q, k, v, kv_pos, pos),
             lambda: ops.flash_decode(q, k, v, kv_pos, 575),
             lambda: ops.flash_decode(q, k, v, kv_pos, pos,
                                      return_partials=True))
    n0 = fd.LAUNCHES["flash_decode"]
    dev_ops = _device_ops(calls)
    assert sum(n for _, n in dev_ops) == 12, dev_ops
    assert fd.LAUNCHES["flash_decode"] - n0 == 15       # the warm round too


def _device_ops(calls, reps: int = 4):
    """[(kernel name, count)] of the device work ``reps`` rounds of
    ``calls`` put on the device (torch.profiler), after a warm round."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for call in calls:
        call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            for call in calls:
                call()
        torch.cuda.synchronize()
    return [(e.key, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]


@pytest.mark.parametrize("Hk,G", [(8, 2), (32, 1)], ids=["G2", "G1"])
def test_paged_wrapper_is_one_kernel_launch(cuda, Hk, G):
    """A paged call, output or partials, is one kernel and no other device
    work (no fill of q_pos, no combine), at the engine's pool of each
    served config (12 lanes, 8 entries of 16 slots, idle lanes)."""
    args, kw = _paged(cuda, B=12, T=8, Hk=Hk, G=G, D=128,
                      dtype=torch.bfloat16, nb=100, idle=(2, 5, 9))
    calls = (lambda: ops.flash_decode(*args, **kw),
             lambda: ops.flash_decode(*args[:4], 100, **kw),
             lambda: ops.flash_decode(*args, return_partials=True, **kw))
    n0 = fd.LAUNCHES["flash_decode_paged"]
    dev_ops = _device_ops(calls)
    assert sum(n for _, n in dev_ops) == 12, dev_ops
    assert fd.LAUNCHES["flash_decode_paged"] - n0 == 15  # the warm round too


@pytest.mark.parametrize("G", [2, 1], ids=["G2", "G1"])
def test_paged_call_replays_in_a_cuda_graph(cuda, G):
    """A paged call captured in a CUDA graph and replayed after its inputs
    changed in place equals the eager call on the new inputs."""
    args, kw = _paged(cuda, B=12, T=8, Hk=4, G=G, D=128,
                      dtype=torch.bfloat16, nb=100, idle=(3,))
    q, k, v, kv_pos, q_pos = args
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ops.flash_decode(*args, **kw)                # warm: build, queries
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ops.flash_decode(*args, **kw)
    g = torch.Generator(device="cpu").manual_seed(5)
    q.copy_(torch.randn(q.shape, generator=g).to(q.dtype))
    q_pos[0] -= 9                                    # a shorter row 0
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, ops.flash_decode(*args, **kw))
    _assert_matches_plain(args, kw)


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


def _pool_leaves(dev, int8: bool, L=4, nb=24, bs=16, Hk=8, D=128):
    """A paged pool's leaves as the engine holds them: K and V (bf16, or
    int8 with bf16 scales a slot and head) and int32 kv_pos."""
    g = torch.Generator(device="cpu").manual_seed(3)
    kv = (L, nb, bs, Hk, D)
    rnd = lambda shape, dtype: torch.randint(  # noqa: E731
        -100, 100, shape, generator=g).to(dtype).to(dev)
    if int8:
        leaves = [rnd(kv, torch.int8), rnd(kv, torch.int8),
                  rnd(kv[:4], torch.bfloat16), rnd(kv[:4], torch.bfloat16)]
    else:
        leaves = [rnd(kv, torch.bfloat16), rnd(kv, torch.bfloat16)]
    return leaves + [rnd((L, nb, bs), torch.int32)]


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_block_copy_leaves_is_one_launch(cuda, int8):
    """One ``block_copy_leaves`` call, a whole copy-on-write event over a
    pool's leaves, is one kernel launch and one device operation, and
    equals the plain copy of each leaf bit for bit."""
    leaves = _pool_leaves(cuda, int8)
    wants = [leaf.clone() for leaf in leaves]
    fd.paged_block_copy_leaves_ref(wants, 19, 4)
    n0 = fd.LAUNCHES["paged_block_copy"]
    got = ops.block_copy_leaves(leaves, 19, 4)
    torch.cuda.synchronize()
    assert fd.LAUNCHES["paged_block_copy"] - n0 == 1
    assert all(g is leaf for g, leaf in zip(got, leaves))
    for leaf, want in zip(leaves, wants):
        assert torch.equal(leaf, want)
    dev_ops = _device_ops((lambda: ops.block_copy_leaves(leaves, 7, 11),))
    assert sum(n for _, n in dev_ops) == 4, dev_ops


def test_launch_counters(cuda):
    fd.reset_launches()
    q, k, v, kv_pos, pos, _ = _ring(cuda, B=1, S=256, Hk=1, G=2, D=64,
                                    dtype=torch.float32)
    ops.flash_decode(q, k, v, kv_pos, pos)
    fd.flash_decode_ref(q, k, v, kv_pos, pos)      # plain: not counted
    ops.block_copy(torch.zeros((2, 3, 4), device=cuda), 0, 1)
    leaves = _pool_leaves(cuda, int8=True, L=2, nb=4)
    ops.block_copy_leaves(leaves, 0, 3)             # five leaves, one launch
    fd.paged_block_copy_leaves_ref(leaves, 3, 0)    # plain: not counted
    assert fd.LAUNCHES == {"flash_decode": 1, "flash_decode_paged": 0,
                           "paged_block_copy": 2}


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "fedtime-llama2-7b",
                                  "qwen3-1.7b", "gemma2-27b", "smollm-360m",
                                  "mixtral-8x7b", "qwen2-moe-a2.7b",
                                  "seamless-m4t-medium"])
def test_smoke_model_on_card_matches_cpu(cuda, arch):
    """The smoke config in f32 (qwen3-0.6b, qwen3-1.7b, gemma2-27b's local
    and global rings, mixtral-8x7b: G = 2, D 64; fedtime-llama2-7b: G = 1,
    D 32; smollm-360m: G = 3, D 64; qwen2-moe-a2.7b and
    seamless-m4t-medium's self and cross attention: G = 1, D 64): prefill
    + 4 decode steps on the card (the kernels) against the CPU (the plain
    versions), same weights; an encoder-decoder's frames drawn beside its
    tokens."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.registry import get_model
    cfg = get_smoke_config(arch)
    api = get_model(cfg)
    params = api.init(cfg, torch.Generator(device="cpu").manual_seed(0),
                      device="cpu")
    params_gpu = _to(params, cuda)
    g = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 12),
                                     generator=g)}
    if cfg.family == "encdec":
        batch["frames"] = torch.randn((2, 24, cfg.d_model), generator=g)
    teacher = torch.randint(0, cfg.vocab_size, (4, 2, 1), generator=g)
    outs = []
    for dev, p in (("cpu", params), (cuda, params_gpu)):
        cache, lg = api.prefill(p, cfg, {k: x.to(dev)
                                         for k, x in batch.items()},
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


@pytest.mark.parametrize("shape,dtype,layout", [
    ((4, 37, 512), torch.float32, (32, 4, 2, 2)),
    ((4, 37, 512), torch.float32, (64, 2, 4, 1)),
    ((4, 37, 512), torch.bfloat16, (32, 1, 1, 2)),
    ((64, 4096), torch.float32, (64, 1, 4, 4)),
    ((64, 4096), torch.float32, (256, 2, 1, 4)),
    ((64, 4096), torch.float32, (128, 4, 2, 4)),
    ((3, 16384), torch.float32, (512, 1, 2, 4)),
    ((504, 4096), torch.bfloat16, (512, 1, 1, 1)),
    ((504, 4096), torch.bfloat16, (64, 8, 2, 4)),
    ((5, 1030), torch.float32, (32, 1, 4, 4)),
    ((5, 1030), torch.float32, (64, 2, 2, 4)),
    ((2, 2000), torch.bfloat16, (128, 4, 2, 1))])
def test_rmsnorm_kernel_layouts(cuda, shape, dtype, layout):
    """Layouts other than the one the launcher picks (clusters of 2 and 4,
    several rows a block, rows masked in a block or cluster), with f32 and
    bf16 scales, aligned and at an address not aligned to its vector."""
    from repro_torch.kernels import rmsnorm as rn
    g = torch.Generator(device="cpu").manual_seed(shape[-1] + 1)
    x = torch.randn(shape, generator=g).to(dtype).to(cuda)
    lay = rn.Layout(*layout)
    for scale_dtype in (torch.float32, torch.bfloat16):
        full = torch.randn(shape[-1] + 1, generator=g).to(scale_dtype)
        for s in (full[:-1].to(cuda), full.to(cuda)[1:]):
            launch, got = rn.rmsnorm_launcher(x, s, layout=lay)
            launch()
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
    (70, 96, 128, 64, 32),        # the largest rank
    (65, 33, 66, 8, 33)])         # one past the f32 tile in M, K and N
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


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("B,H,S,D", [(4, 8, 1024, 128), (2, 4, 100, 128),
                                     (2, 4, 1024, 64), (1, 3, 77, 64)],
                         ids=["benchmark", "ragged", "d64", "ragged-d64"])
def test_f32_attention_kernel_matches_plain(cuda, B, H, S, D, causal):
    """The f32 kernel (3xTF32 on the tensor cores) at the reference
    benchmark's shape, the ragged shape and D 64, through the bare launch
    and through ops, within the f32 limit of the plain version (2e-5)."""
    from repro_torch.kernels import flash_attention as fa
    g = torch.Generator(device="cpu").manual_seed(S * D + H)
    q, k, v = (torch.randn((B, H, S, D), generator=g).to(cuda)
               for _ in range(3))
    want = fa.flash_attention_ref(q, k, v, causal)
    launch, o = fa.flash_attention_launcher(q, k, v, causal)
    launch()
    _allclose(o, want, 2e-5)
    _allclose(ops.flash_attention(q, k, v, causal=causal), want, 2e-5)


@pytest.mark.parametrize("M", [504, 37], ids=["fit", "ragged"])
def test_bf16_qlora_kernel_at_the_longest_k(cuda, M):
    """bf16 qlora_matmul at fedtime-llama2-7b's ``w_down`` (K = 11,008, the
    longest K a ported model gives it), held to its plain version at the
    bf16 limit above: one K loop of 344 32-deep steps on the tensor
    cores."""
    from repro_torch.kernels import qlora_matmul as qm
    args = _qlora_case(cuda, M, 11_008, 4096, 8, 64, torch.bfloat16)
    got = ops.qlora_matmul(*args, 2.0)
    assert got.dtype == torch.bfloat16 and got.shape == (M, 4096)
    _allclose(got, qm.qlora_matmul_ref(*args, 2.0), 1e-4, 2.0 ** -7)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_f32_attention_kernel_at_4096(cuda, causal):
    """f32 flash attention (3xTF32) at S = 4096, the blockwise prefill's
    threshold, held to its plain version at the f32 limit (2e-5): one
    chain of 64 key tiles a row block."""
    from repro_torch.kernels import flash_attention as fa
    g = torch.Generator(device="cpu").manual_seed(4096)
    q, k, v = (torch.randn((1, 8, 4096, 128), generator=g).to(cuda)
               for _ in range(3))
    got = ops.flash_attention(q, k, v, causal=causal)
    assert got.dtype == torch.float32 and got.shape == q.shape
    _allclose(got, fa.flash_attention_ref(q, k, v, causal), 2e-5)


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


# ---------------------------------------------------------------------------
# The fault-tolerant engine's guarded decode step
# ---------------------------------------------------------------------------

def test_guarded_decode_tick_copies_to_host_once(cuda):
    """A decode tick of the engine brings the tokens and the guard's
    per-lane screen back in one device-to-host copy, a poisoned tick too,
    and the poisoned lane is quarantined alone (qwen3-0.6b's smoke config
    on the card)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_smoke_config
    from repro_torch.models.registry import get_model
    from repro_torch.serve.engine import ForecastEngine
    from repro_torch.serve.request import Request
    cfg = get_smoke_config("qwen3-0.6b")
    params = get_model(cfg).init(
        cfg, torch.Generator(device=cuda).manual_seed(0), device=cuda)
    eng = ForecastEngine(cfg, params, num_slots=4, cache_len=48,
                         device=cuda)
    rng = np.random.default_rng(0)
    for i in range(3):
        eng.submit(Request(id=f"r{i}", max_new_tokens=12,
                           prompt=rng.integers(0, cfg.vocab_size, 9 + i)))
    eng.step()                                  # admissions: their copies
    copies = []
    for poison in (None, "r1"):
        if poison:
            eng.poison(poison)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            eng.step()
            torch.cuda.synchronize()
        copies.append(sum(e.count for e in prof.key_averages()
                          if e.device_type == DeviceType.CUDA
                          and "DtoH" in e.key))
    assert copies == [1, 1], copies
    assert set(eng.quarantined) == {"r1"}
    assert eng.active_requests == 2
    done = eng.run(max_steps=100)
    assert set(done) == {"r0", "r2"}
    eng.pool.assert_partition()
