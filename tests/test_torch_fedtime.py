"""The port's FedTime model, QLoRA plumbing and optimizers against the JAX
package, on the fedtime-llama2-7b smoke config in f32 with the reference's
weights carried over by the bridge.

Tolerances, and why:
  * NF4 codes and absmax scales: exact (the same f32 quotients and the same
    first-minimum tie-break), including the cross-row block that
    ``quantize_base`` picks when ``qblock`` does not divide in*out.
  * ``dense``, RevIN, patching: within 1e-6 of the output's largest
    magnitude (one or two f32 products or sums).
  * ``fedtime.forward`` (both phases) and ``loss``: within 1e-5 of the
    output's largest magnitude, both sides f32 with sums in another order
    (each side is within 1e-6 of the port's own f64 forward here).
  * adapter gradients: within 1e-5 of the largest gradient, the same sums
    run backwards (each side within 1.3e-6 of the f64 gradient).  B is
    drawn at 0.01, where the adapters' share of each projection is
    comparable to the base weight's, as after training; at 0.1 they
    outweigh it fivefold and both sides' f32 gradients drift 1e-4 from
    the f64 one.
  * ``adamw_update``: within 1e-6 (elementwise f32).
  * ``local_update`` over 3 steps: the mean loss within 1e-5, the adapters
    within 1e-5.  AdamW divides each moment by its own root, so a gradient
    that differs in its last bits moves its weight by a normalized step;
    the first step's A gradients are exactly 0 on both sides (B starts at
    0), and the later ones are far from 0 at these inputs.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import fedtime as jfedtime
from repro.core import lora as jlora
from repro.core import patching as jpatching
from repro.core import revin as jrevin
from repro.core.client import local_update as jlocal_update
from repro.core.quant import nf4_dequant as jnf4_dequant
from repro.core.quant import nf4_quantize as jnf4_quantize
from repro.models.layers.linear import dense as jdense
from repro.optim.adamw import adamw_init as jadamw_init
from repro.optim.adamw import adamw_update as jadamw_update
from repro_torch import bridge
from repro_torch import tree as tree_util
from repro_torch.configs import get_smoke_config
from repro_torch.core import fedtime, lora, patching, revin
from repro_torch.core.client import local_update
from repro_torch.core.quant import nf4_dequant, nf4_quantize
from repro_torch.models.layers.linear import dense
from repro_torch.optim.adamw import adamw_init, adamw_update

B, M = 3, 2


@pytest.fixture(autouse=True, scope="module")
def _torch_one_thread():
    """The shapes here are tiny: one intra-op thread, so that parallel test
    workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _close(got, want, tol):
    """|got - want| <= tol x max(max |want|, 1)."""
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got.detach().float()), want,
                               atol=tol * max(float(np.abs(want).max()), 1.0),
                               rtol=0)


@pytest.fixture(scope="module")
def model():
    """The reference's QLoRA'd FedTime tree with nonzero B (so the adapters
    act), and the port's copy of it."""
    jcfg = jax_smoke_config("fedtime-llama2-7b")
    cfg = get_smoke_config("fedtime-llama2-7b")
    ft = jcfg.fedtime
    k0, k1, k2 = jax.random.split(jax.random.PRNGKey(0), 3)
    base = jfedtime.init(jcfg, k0, num_channels=M)
    jp = jlora.attach_lora(base, k1, rank=ft.lora_rank, alpha=ft.lora_alpha)
    jp = jlora.quantize_base(jp, qblock=ft.qlora_block)
    rng = np.random.default_rng(1)
    attn = jp["layers"]["attn"]
    for site in ("wq", "wk", "wv", "wo"):
        attn[site]["lora_b"] = jnp.asarray(
            rng.normal(size=attn[site]["lora_b"].shape).astype(np.float32)
            * 0.01)
    params = bridge.params_from_jax(_np_tree(jp), cfg, device="cpu")
    x = rng.normal(size=(B, ft.lookback, M)).astype(np.float32) * 2 + 1
    y = rng.normal(size=(B, ft.horizon, M)).astype(np.float32)
    return jcfg, cfg, jp, params, x, y


# ---------------------------------------------------------------------------
# NF4, dense, RevIN, patching
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,qblock", [((2, 64, 96), 64), ((48, 32), 16)])
def test_nf4_codes_and_scales_exact(shape, qblock):
    w = np.random.default_rng(2).normal(size=shape).astype(np.float32)
    w[..., 0, :8] = 0.0                    # a block that touches 0 codes
    jq, ja = jnf4_quantize(jnp.asarray(w), qblock)
    q, a = nf4_quantize(torch.from_numpy(w), qblock)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(a.numpy().view(np.uint32),
                                  np.asarray(ja).view(np.uint32))
    np.testing.assert_array_equal(
        nf4_dequant(q, a).numpy().view(np.uint32),
        np.asarray(jnf4_dequant(jq, ja)).view(np.uint32))


def test_quantize_base_cross_row_block_exact():
    """in*out = 6*10 = 60 is not a multiple of 64: both pick a 60-element
    block that spans six rows."""
    w = np.random.default_rng(3).normal(size=(2, 6, 10)).astype(np.float32)
    tree = {"attn": {"wq": {"w": w}}}
    jq = jlora.quantize_base(jax.tree.map(jnp.asarray, tree), qblock=64)
    q = lora.quantize_base(bridge.tree_to_torch(tree, "cpu"), qblock=64)
    assert q["attn"]["wq"]["absmax"].shape == (2, 1)
    for leaf in ("w_nf4", "absmax"):
        np.testing.assert_array_equal(
            q["attn"]["wq"][leaf].numpy(),
            np.asarray(jq["attn"]["wq"][leaf]))
    assert "w" not in q["attn"]["wq"]


@pytest.mark.parametrize("form", ["lora", "qlora"])
def test_dense_lora_and_qlora(form):
    rng = np.random.default_rng(4)
    p = {"w": (rng.normal(size=(32, 48)) * 0.2).astype(np.float32)}
    jp = jlora.attach_lora({"wq": jax.tree.map(jnp.asarray, p)},
                           jax.random.PRNGKey(5), rank=4, alpha=8.0)
    jp["wq"]["lora_b"] = jnp.asarray(
        rng.normal(size=(4, 48)).astype(np.float32))
    if form == "qlora":
        jp = jlora.quantize_base(jp, qblock=64)
    x = rng.normal(size=(5, 32)).astype(np.float32)
    want = jdense(jp["wq"], jnp.asarray(x))
    tp = bridge.tree_to_torch(_np_tree(jp), "cpu")
    _close(dense(tp["wq"], torch.from_numpy(x)), want, 1e-6)


def test_revin_and_patching():
    rng = np.random.default_rng(6)
    x = (rng.normal(size=(B, 24, M)) * 3 + 2).astype(np.float32)
    prm = {"gamma": rng.uniform(0.5, 2, M).astype(np.float32),
           "beta": rng.normal(size=M).astype(np.float32)}
    jxn, jst = jrevin.revin_norm(jax.tree.map(jnp.asarray, prm),
                                 jnp.asarray(x))
    tprm = bridge.tree_to_torch(prm, "cpu")
    xn, st = revin.revin_norm(tprm, torch.from_numpy(x))
    _close(xn, jxn, 1e-6)
    y = rng.normal(size=(B, 7, M)).astype(np.float32)
    _close(revin.revin_denorm(tprm, torch.from_numpy(y), st),
           jrevin.revin_denorm(jax.tree.map(jnp.asarray, prm),
                               jnp.asarray(y), jst), 1e-5)
    _close(revin.instance_norm(torch.from_numpy(x))[0],
           jrevin.instance_norm(jnp.asarray(x))[0], 1e-6)
    u = patching.channel_split(torch.from_numpy(x))
    np.testing.assert_array_equal(
        u.numpy(), np.asarray(jpatching.channel_split(jnp.asarray(x))))
    np.testing.assert_array_equal(
        patching.make_patches(u, 8, 4).numpy(),
        np.asarray(jpatching.make_patches(jnp.asarray(u.numpy()), 8, 4)))
    np.testing.assert_array_equal(
        patching.channel_merge(u, B, M).numpy(),
        np.asarray(jpatching.channel_merge(jnp.asarray(u.numpy()), B, M)))
    with pytest.raises(ValueError):
        patching.num_patches(24, 8, 5)


# ---------------------------------------------------------------------------
# The model, its gradients, the optimizers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("phase", ["sft", "forecast"])
def test_forward_and_loss(model, phase):
    jcfg, cfg, jp, params, x, y = model
    want = jfedtime.forward(jp, jcfg, jnp.asarray(x), phase=phase)
    got = fedtime.forward(params, cfg, torch.from_numpy(x), phase=phase)
    assert got.shape == (B, cfg.fedtime.horizon, M)
    _close(got, want, 1e-5)
    jl = jfedtime.loss(jp, jcfg, {"x": jnp.asarray(x), "y": jnp.asarray(y)},
                       phase=phase)
    tl = fedtime.loss(params, cfg, {"x": torch.from_numpy(x),
                                    "y": torch.from_numpy(y)}, phase=phase)
    _close(tl, jl, 1e-5)


def test_lora_gradients_match_jax_grad(model):
    jcfg, cfg, jp, params, x, y = model
    jbatch = {"x": jnp.asarray(x), "y": jnp.asarray(y)}
    jg = jax.grad(lambda ad: jfedtime.loss(jlora.merge_lora(jp, ad), jcfg,
                                           jbatch))(jlora.lora_tree(jp))
    ad = tree_util.map_(lambda a: a.detach().requires_grad_(True),
                        lora.lora_tree(params))
    loss = fedtime.loss(lora.merge_lora(params, ad), cfg,
                        {"x": torch.from_numpy(x), "y": torch.from_numpy(y)})
    grads = torch.autograd.grad(loss, tree_util.leaves(ad))
    want = jax.tree.leaves(jg)
    assert len(grads) == len(want) == 8
    top = max(float(np.abs(np.asarray(w)).max()) for w in want)
    assert top > 1e-3                       # the adapters really act
    for g, w in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5 * top)


def test_adamw_update():
    rng = np.random.default_rng(7)
    p = {"a": rng.normal(size=(4, 3)).astype(np.float32),
         "b": {"c": rng.normal(size=(5,)).astype(np.float32)}}
    jp, tp = jax.tree.map(jnp.asarray, p), bridge.tree_to_torch(p, "cpu")
    js, ts = jadamw_init(jp), adamw_init(tp)
    for step in (1, 2, 3):
        g = jax.tree.map(lambda a: rng.normal(size=a.shape)
                         .astype(np.float32), p)
        jp, js = jadamw_update(jp, jax.tree.map(jnp.asarray, g), js, step,
                               lr=1e-2, weight_decay=0.01)
        tp, ts = adamw_update(tp, bridge.tree_to_torch(g, "cpu"), ts, step,
                              lr=1e-2, weight_decay=0.01)
        for got, want in zip(tree_util.leaves(tp) + tree_util.leaves(ts),
                             jax.tree.leaves(jp) + jax.tree.leaves(js)):
            _close(got, want, 1e-6)


def test_local_update_three_steps(model):
    jcfg, cfg, jp, params, x, y = model
    rng = np.random.default_rng(8)
    xs = np.stack([x + rng.normal(size=x.shape).astype(np.float32)
                   for _ in range(3)])
    ys = np.stack([y] * 3)

    def jloss(p, batch):
        return jfedtime.loss(p, jcfg, batch)

    jad, jl = jlocal_update(jloss, jp, jlora.lora_tree(jp),
                            {"x": jnp.asarray(xs), "y": jnp.asarray(ys)},
                            steps=3)
    ad, tl = local_update(lambda p, b: fedtime.loss(p, cfg, b), params,
                          lora.lora_tree(params),
                          {"x": torch.from_numpy(xs),
                           "y": torch.from_numpy(ys)}, steps=3)
    _close(tl, jl, 1e-5)
    for got, want in zip(tree_util.leaves(ad), jax.tree.leaves(jad)):
        _close(got, want, 1e-5)
    for got, before in zip(tree_util.leaves(ad),
                           tree_util.leaves(lora.lora_tree(params))):
        assert not torch.equal(got, before)            # every leaf moved
    assert all(not t.requires_grad for t in tree_util.leaves(ad))


def test_lora_tree_helpers_match_reference(model):
    jcfg, cfg, jp, params, x, y = model
    assert lora.count_params(params) == jlora.count_params(jp)
    assert lora.tree_nbytes(params) == jlora.tree_nbytes(jp)
    assert lora.trainable_fraction(params) == pytest.approx(
        jlora.trainable_fraction(jp), rel=1e-12)
    assert _flat(lora.lora_mask(params)) == {
        k: bool(v) for k, v in _flat(jlora.lora_mask(jp)).items()}
    ad = lora.lora_tree(params)
    assert sorted(_flat(ad)) == sorted(_flat(jlora.lora_tree(jp)))
    doubled = tree_util.map_(lambda a: a * 2, ad)
    merged = lora.merge_lora(params, doubled)
    assert merged["layers"]["attn"]["wq"]["lora_a"] is \
        doubled["layers"]["attn"]["wq"]["lora_a"]
    assert merged["head"]["w"] is params["head"]["w"]


# ---------------------------------------------------------------------------
# The bridge
# ---------------------------------------------------------------------------

def test_bridge_round_trip_fedtime_tree_bit_exact(model):
    """JAX tree -> port -> numpy: equal bits for f32, bf16 and uint8
    leaves; a tree that does not match the config is refused."""
    jcfg, cfg, jp, params, x, y = model
    tree = _np_tree(jp)
    tree["head"]["w"] = tree["head"]["w"].astype(ml_dtypes.bfloat16)
    back = bridge.params_to_numpy(bridge.params_from_jax(tree, cfg, "cpu"))
    dtypes = set()
    flat, flat_back = _flat(tree), _flat(back)
    assert sorted(flat) == sorted(flat_back)
    for key, a in flat.items():
        b = flat_back[key]
        assert a.dtype == b.dtype and a.shape == b.shape, key
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
        dtypes.add(a.dtype.name)
    assert {"float32", "bfloat16", "uint8"} <= dtypes
    bad = _np_tree(jp)
    bad["head"]["w"] = bad["head"]["w"][:, :5]
    with pytest.raises(ValueError, match="head"):
        bridge.params_from_jax(bad, cfg, "cpu")
    plain = _np_tree(jfedtime.init(jcfg, jax.random.PRNGKey(9),
                                   num_channels=M))
    assert "w" in bridge.params_from_jax(plain, cfg,
                                         "cpu")["layers"]["attn"]["wq"]
