"""The port's step cost model (``repro_torch.obs.cost``,
``repro_torch.launch.hlo_cost``, ``repro_torch.obs.devmem.scope_costs``)
against the reference's (``repro.launch.hlo_cost``, ``repro.obs.devmem``),
and each kernel's shape and cost rules, on the CPU.

The reference's cases, ported: the 8-step ``tanh(h @ w)`` loop's gradient
(the reference counts its scan's trip count through HLO, the port counts
the products autograd dispatches), a single rank's collectives, a named
scope and rmsnorm's dispatch under ``obs.rmsnorm``.  Then each kernel
entry of ``repro_torch.kernels.ops`` (and the wire hop) on fake ``cuda``
tensors, which a CPU build of PyTorch makes but cannot index: the shape
rule gives the plain version's output shapes and types and refuses what
the kernel refuses; the counter files each call at its cost rule, equal on
fakes and on real CPU tensors; the counter's live bytes follow storages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.kernels import ops as jops
from repro.launch import hlo_cost as jhlo_cost
from repro.obs import devmem as jdevmem
from repro_torch.core.quant import nf4_quantize
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import ops
from repro_torch.kernels import qlora_matmul as qm
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels import wire_hop as wh
from repro_torch.launch.hlo_cost import analyze, count
from repro_torch.obs import cost, devmem
from repro_torch.obs.cost import CostCounter

LOOP_PRODUCT = 2 * 128 * 256 * 256


def _tanh_loop(x, w):
    h = x
    for _ in range(8):
        h = torch.tanh(h @ w)
    return h.sum()


@pytest.mark.parametrize("wrt", ["x_and_w", "w"])
def test_cost_counts_every_product_of_a_loop_gradient(wrt):
    """The reference's trip-count case: forward 8 products, backward 8
    input and 8 weight gradients, 24 in all, as the reference's HLO count
    of its scan (its scan body computes the first step's input gradient
    too).  Autograd computes only what is asked: with the gradient of w
    alone it skips the first step's input gradient, 23."""
    rng = np.random.default_rng(0)
    xn = rng.standard_normal((128, 256), dtype=np.float32)
    wn = rng.standard_normal((256, 256), dtype=np.float32) * 0.05

    def f(x, w):
        def body(h, _):
            return jnp.tanh(h @ w), None
        h, _ = jax.lax.scan(body, x, None, length=8)
        return h.sum()

    txt = jax.jit(jax.grad(f, argnums=1)).lower(
        jax.ShapeDtypeStruct(xn.shape, jnp.float32),
        jax.ShapeDtypeStruct(wn.shape, jnp.float32)).compile().as_text()
    want = jhlo_cost.analyze(txt)["flops_per_device"]
    assert abs(want - 24 * LOOP_PRODUCT) / (24 * LOOP_PRODUCT) < 0.01

    x = torch.from_numpy(xn).requires_grad_(wrt == "x_and_w")
    w = torch.from_numpy(wn).requires_grad_(True)
    with CostCounter() as c:
        loss = _tanh_loop(x, w)
        torch.autograd.grad(loss, [t for t in (x, w) if t.requires_grad])
    got = analyze(c)["flops_per_device"]
    assert got == (24 if wrt == "x_and_w" else 23) * LOOP_PRODUCT


def test_single_rank_sends_no_collective_bytes():
    """The reference's second case: a loop of 5 doublings on one device
    moves bytes and no collective."""
    def f(x):
        def body(c, _):
            return c * 2.0, None
        c, _ = jax.lax.scan(body, x, None, length=5)
        return c

    r = jhlo_cost.analyze(jax.jit(f).lower(jax.ShapeDtypeStruct(
        (64,), jnp.float32)).compile().as_text())
    assert r["collective_total_bytes"] == 0 and r["bytes_per_device"] > 0

    def g(x):
        for _ in range(5):
            x = x * 2.0
        return x

    _, c = count(g, torch.ones(64))
    got = analyze(c)
    assert got["collective_total_bytes"] == 0
    assert set(got["collective_bytes"]) == set(jhlo_cost._COLLECTIVES)
    # 5 multiplies, each reading and writing 64 f32
    assert got["bytes_per_device"] == 5 * 2 * 64 * 4
    assert got["flops_per_device"] == 0


def test_scope_costs_attribute_named_scopes():
    """The reference's named-scope case: the product's 2 M K N FLOPs land
    in ``obs.proj`` and dominate; the unscoped epilogue has none."""
    def jf(x, w):
        with jax.named_scope("obs.proj"):
            y = x @ w
        return y + 1.0

    compiled = jax.jit(jf).lower(jnp.ones((16, 32)),
                                 jnp.ones((32, 8))).compile()
    jcosts = jdevmem.compiled_scope_costs(compiled)
    assert jcosts["obs.proj"]["flops"] >= 2 * 16 * 32 * 8

    def f(x, w):
        with cost.scope("obs.proj"):
            y = x @ w
        return y + 1.0

    costs = devmem.compiled_scope_costs(f, torch.ones(16, 32),
                                        torch.ones(32, 8))
    assert costs["obs.proj"]["flops"] == 2 * 16 * 32 * 8
    assert costs["obs.proj"]["bytes"] == (16 * 32 + 32 * 8 + 16 * 8) * 4
    assert costs[cost.UNSCOPED]["flops"] == 0
    assert costs[cost.UNSCOPED]["bytes"] > 0
    other = sum(v["flops"] for k, v in costs.items() if k != "obs.proj")
    assert other < costs["obs.proj"]["flops"]


def test_scope_costs_on_dispatch_kernel():
    """rmsnorm's dispatch shows under ``obs.rmsnorm``, one op at its cost
    rule (x and scale read, y written; no products), as the reference's
    shows under its scope."""
    jcosts = jdevmem.compiled_scope_costs(jax.jit(
        lambda a, b: jops.rmsnorm(a, b)).lower(
            jnp.ones((4, 64)), jnp.ones((64,))).compile())
    assert jcosts and jcosts["obs.rmsnorm"]["ops"] >= 1
    costs = devmem.compiled_scope_costs(
        lambda a, b: ops.rmsnorm(a, b), torch.ones(4, 64), torch.ones(64))
    assert costs["obs.rmsnorm"] == {"flops": 0.0, "bytes": float(
        (2 * 4 * 64 + 64) * 4), "ops": 1.0}
    assert set(costs) == {"obs.rmsnorm"}        # the plain ops not counted


def test_scope_is_free_without_a_counter():
    """No counter: ``scope`` hands back one shared no-op context and opens
    nothing; under a counter it stacks and unstacks its name."""
    assert cost.COUNTER is None
    assert cost.scope("obs.a") is cost.scope("obs.b")
    with cost.scope("obs.a"):
        assert cost.SCOPES == []
    with CostCounter() as c:
        assert cost.COUNTER is c
        with cost.scope("obs.a"):
            with cost.scope("obs.b"):
                assert cost.SCOPES == ["obs.a", "obs.b"]
        assert cost.SCOPES == []
    assert cost.COUNTER is None


def test_live_bytes_follow_storages():
    """A storage counts from its birth until it is freed; views, in-place
    results and detached aliases are not new storages."""
    with CostCounter() as c:
        a = torch.ones(1000)                   # 4000 B
        v = a[:10]
        a.add_(1.0)
        d = a.detach()
        assert c.live_bytes == 4000
        b = a * 2                              # +4000
        assert c.peak_bytes == 8000
        del b
        assert c.live_bytes == 4000
        del a, v, d
        assert c.live_bytes == 0
        e = torch.empty(250)                   # +1000
    assert c.peak_bytes == 8000 and c.live_bytes == 1000
    del e


# ---------------------------------------------------------------------------
# Kernel shape and cost rules
# ---------------------------------------------------------------------------

def _decode_inputs(device, *, B=2, S=48, Hk=2, G=2, D=64, paged=False,
                   int8=False, seed=0):
    rng = np.random.default_rng(seed)

    def t(shape, dt=torch.float32):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dt)

    if paged:
        nb, bs = 6, 16
        kshape, kvp = (nb, bs, Hk, D), torch.arange(
            nb * bs, dtype=torch.int32).reshape(nb, bs)
        kw = {"block_tables": torch.tensor([[0, 1, 2], [3, -1, 5]],
                                           dtype=torch.int32)}
    else:
        kshape, kvp = (B, S, Hk, D), torch.arange(
            S, dtype=torch.int32).expand(B, S).contiguous()
        kw = {}
    k, v = t(kshape, torch.bfloat16), t(kshape, torch.bfloat16)
    if int8:
        k, v = k.to(torch.int8), v.to(torch.int8)
        kw["k_scale"] = t(kshape[:3] + (1,), torch.bfloat16)
        kw["v_scale"] = t(kshape[:3] + (1,), torch.bfloat16)
    args = [t((B, 1, Hk * G, D), torch.bfloat16), k, v, kvp,
            torch.tensor([40, 7], dtype=torch.int32)]
    return args, kw


def _cases():
    """(name, entry, args, kwargs) of every kernel entry at a small shape,
    on real CPU tensors."""
    rng = np.random.default_rng(1)
    w = torch.from_numpy(rng.standard_normal((64, 128)).astype(np.float32))
    codes, absmax = nf4_quantize(w, 64)
    fx = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32))
    out = []
    for label, kw in (("ring", {}), ("ring int8", {"int8": True}),
                      ("paged", {"paged": True})):
        args, extra = _decode_inputs("cpu", **kw)
        out.append((f"flash_decode {label}", ops.flash_decode, args, extra))
        out.append((f"flash_decode {label} partials", ops.flash_decode,
                    args, {**extra, "return_partials": True}))
    out += [
        ("block_copy_leaves", ops.block_copy_leaves,
         [[fx(2, 6, 16, 2, 8).to(torch.bfloat16),
           torch.zeros((2, 6, 16), dtype=torch.int32)], 1, 4], {}),
        ("qlora_matmul", ops.qlora_matmul,
         [fx(5, 64).to(torch.bfloat16), codes, absmax.reshape(64, -1),
          fx(64, 4), fx(4, 128), 2.0], {}),
        ("flash_attention", ops.flash_attention,
         [fx(1, 2, 40, 64), fx(1, 2, 40, 64), fx(1, 2, 40, 64)],
         {"causal": True}),
        ("rmsnorm", ops.rmsnorm, [fx(3, 5, 96).to(torch.bfloat16), fx(96)],
         {}),
        ("wire_hop", wh.fused_hop, [fx(512), None, None, fx(512)],
         {"wire": "int8", "qblock": 128}),
        ("wire_hop recv", wh.fused_hop,
         [fx(256), fx(256).to(torch.bfloat16), None, fx(256)],
         {"wire": "bf16", "qblock": 128}),
    ]
    return out


CASES = _cases()


def _fake(mode, x, device):
    if isinstance(x, torch.Tensor):
        with mode:
            return torch.empty_strided(x.shape, x.stride(), dtype=x.dtype,
                                       device=device)
    if isinstance(x, list):
        return [_fake(mode, y, device) for y in x]
    return x


def _sig(x):
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.dtype)
    if isinstance(x, (list, tuple)):
        return [_sig(y) for y in x]
    return x


@pytest.mark.parametrize("name,entry,args,kw", CASES,
                         ids=[c[0] for c in CASES])
def test_shape_rule_on_fake_cuda_tensors(name, entry, args, kw):
    """On fake ``cuda`` tensors an entry takes its kernel's shape rule,
    which needs no card and gives the plain version's output shapes and
    types; the counter files the call at the kernel's cost rule, the same
    on fakes and on real CPU tensors, and counts none of the plain
    version's ops."""
    want = _sig(entry(*args, **kw))
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    fargs = _fake(mode, list(args), "cuda")
    fkw = {k: _fake(mode, x, "cuda") for k, x in kw.items()}
    with mode:
        got = entry(*fargs, **fkw)
    assert _sig(got) == want
    assert all(t.device.type == "cuda" for t in cost.tensors_in(got))
    with mode:
        _, c_fake = count(entry, *fargs, **fkw)
    _, c_real = count(entry, *args, **kw)
    assert c_fake.scopes == c_real.scopes
    assert sum(b["ops"] for b in c_real.scopes.values()) == 1
    assert c_fake.peak_bytes == c_real.peak_bytes == \
        (0 if name.startswith("block_copy") else cost.tensor_bytes(got))


def test_shape_rule_refuses_what_the_kernel_refuses():
    """Heads of 15 / 5 (G = 3) at D 128 have no flash-decode instance
    (smollm-360m's D 64 has one): the shape rule raises the kernel's own
    message, where the plain version would run.  A cross-row NF4 block is
    refused by qlora's."""
    args, kw = _decode_inputs("cpu", Hk=5, G=3, D=128)
    ops.flash_decode(*args, **kw)                     # the plain version
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    fargs = _fake(mode, args, "cuda")
    with mode, pytest.raises(ValueError, match=r"flash_decode kernel: "
                             r"\(G, D\) = \(H/Hk, D\) must be one of .* "
                             r"got H/Hk = 15/5, D = 128"):
        ops.flash_decode(*fargs, **{k: _fake(mode, x, "cuda")
                                    for k, x in kw.items()})
    x = torch.ones(4, 6, dtype=torch.bfloat16)
    codes, absmax = nf4_quantize(torch.ones(6, 10), 4)   # crosses rows
    qargs = [x, codes, absmax.reshape(1, -1), torch.ones(6, 2),
             torch.ones(2, 10), 1.0]
    with mode, pytest.raises(ValueError, match="absmax must be"):
        ops.qlora_matmul(*_fake(mode, qargs, "cuda"))


def test_cost_rules_from_shapes():
    """The cost rules' closed forms: flash-decode 4 B H D slots FLOPs over
    the slots the kernel walks (S a row, or T entries of bs), each input
    read once; qlora's three products; flash attention over S (S + 1) / 2
    causal pairs; a block copy reads and writes each layer's block."""
    args, kw = _decode_inputs("cpu", B=2, S=48, Hk=2, G=2, D=64)
    q, k, v, kvp, qp = args
    flops, nbytes = fd.flash_decode_cost(*args, **kw)
    assert flops == 4 * 2 * 4 * 64 * 48
    assert nbytes == (2 * q.numel() * 2 + 2 * k.numel() * 2 + kvp.numel() * 4
                      + qp.numel() * 4)
    args, kw = _decode_inputs("cpu", paged=True)
    flops, _ = fd.flash_decode_cost(*args, **kw)
    assert flops == 4 * 4 * 64 * (2 * 3 * 16)
    x = torch.ones(5, 64)
    codes, absmax = nf4_quantize(torch.ones(64, 128), 64)
    f, b = qm.qlora_matmul_cost(x, codes, absmax.reshape(64, -1),
                                torch.ones(64, 4), torch.ones(4, 128), 1.0)
    assert f == 2 * 5 * 64 * 128 + 2 * 5 * 64 * 4 + 2 * 5 * 4 * 128
    assert b == (5 * 64 * 4 + codes.numel() + absmax.numel() * 4
                 + 64 * 4 * 4 + 4 * 128 * 4 + 5 * 128 * 4)
    qq = torch.ones(1, 2, 40, 64)
    assert fa.flash_attention_cost(qq, qq, qq, True)[0] == \
        4 * 2 * 64 * (40 * 41 // 2)
    assert fa.flash_attention_cost(qq, qq, qq, False)[0] == \
        4 * 2 * 64 * 40 * 40
    leaf = torch.zeros((3, 6, 16, 2, 8), dtype=torch.bfloat16)
    assert fd.paged_block_copy_cost([leaf]) == (0, 2 * 3 * 16 * 2 * 8 * 2)
    assert rn.rmsnorm_cost(torch.ones(3, 96), torch.ones(96)) == \
        (0, (2 * 3 * 96 + 96) * 4)
