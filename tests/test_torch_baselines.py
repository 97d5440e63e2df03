"""The paper's comparison models in the port (DLinear, PatchTST, FSLSTM)
against the JAX package's, with the reference's weights carried over by
the bridge; and the port's trees with lists (FSLSTM's stack of layers).

Tolerances, and why:
  * tree leaves, fedavg of two FSLSTM trees: the same order exactly;
    fedavg within 1e-6 (one f32 weighted sum of two terms).
  * forward and loss: within 1e-5 of the output's largest magnitude.
    Both sides are f32 with sums in another order; FSLSTM's recurrence
    carries such a difference through 32 steps and two layers.
  * gradients, leaf by leaf: within 1e-5 of the leaf's largest gradient
    (the same sums run backwards).
  * 3 ``fit`` steps: losses within 1e-5 relative, parameters within 1e-5
    of their largest magnitude (AdamW's normalised steps, as in
    ``test_torch_trainer.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.baselines import dlinear as jdlinear
from repro.baselines import fslstm as jfslstm
from repro.baselines import patchtst as jpatchtst
from repro.optim.fedadam import fedavg as jfedavg
from repro.train.trainer import fit as jfit
from repro_torch import bridge
from repro_torch import tree as tree_util
from repro_torch.baselines import dlinear, fslstm, patchtst
from repro_torch.optim.fedadam import fedavg
from repro_torch.train.trainer import fit

B, L, T, M = 4, 32, 8, 3
FIT_STEPS = 3


@pytest.fixture(autouse=True, scope="module")
def _torch_one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, tol):
    """|got - want| <= tol x max(max |want|, 1)."""
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got.detach().float()), want,
                               atol=tol * max(float(np.abs(want).max()), 1.0),
                               rtol=0)


def _data(seed=0, n=1):
    rng = np.random.default_rng(seed)
    return [{"x": rng.normal(size=(B, L, M)).astype(np.float32) * 2 + 1,
             "y": rng.normal(size=(B, T, M)).astype(np.float32)}
            for _ in range(n)]


_PCFG = dict(lookback=L, horizon=T, d_model=16, num_layers=2, num_heads=4,
             d_ff=32, patch_len=8, stride=4)


def _models():
    """name -> (reference params, reference loss, port loss, port forward,
    reference forward)."""
    jcfg = jpatchtst.make_config(**_PCFG)
    cfg = patchtst.make_config(**_PCFG)
    key = jax.random.PRNGKey(0)
    return {
        "dlinear": (jdlinear.init(key, L, T), jdlinear.loss, dlinear.loss,
                    dlinear.forward, jdlinear.forward),
        "patchtst": (jpatchtst.init(jcfg, key, num_channels=M),
                     lambda p, b: jpatchtst.loss(p, jcfg, b),
                     lambda p, b: patchtst.loss(p, cfg, b),
                     lambda p, x: patchtst.forward(p, cfg, x),
                     lambda p, x: jpatchtst.forward(p, jcfg, x)),
        "fslstm": (jfslstm.init(key, channels=M, horizon=T, d_hidden=8),
                   jfslstm.loss, fslstm.loss, fslstm.forward,
                   jfslstm.forward),
    }


MODELS = ("dlinear", "patchtst", "fslstm")


@pytest.fixture(scope="module")
def models():
    return _models()


# ---------------------------------------------------------------------------
# trees with lists
# ---------------------------------------------------------------------------

def test_tree_leaves_order_on_dicts_and_lists():
    rng = np.random.default_rng(1)
    arr = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    tree = {"z": [arr(2), {"b": arr(3), "a": arr(1)}, (arr(4), arr(5))],
            "a": {"y": [arr(6)], "x": arr(7)}, "m": arr(8)}
    want = [np.asarray(x) for x in jax.tree.leaves(tree)]
    port = bridge.tree_to_torch(tree, "cpu")
    got = tree_util.leaves(port)
    assert [g.numel() for g in got] == [w.size for w in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    assert isinstance(port["z"], list) and isinstance(port["z"][2], tuple)
    # unflatten is leaves' inverse and keeps the containers
    back = tree_util.unflatten(port, [g * 2 for g in got])
    assert isinstance(back["z"], list) and isinstance(back["z"][2], tuple)
    for a, b in zip(tree_util.leaves(back), got):
        assert torch.equal(a, b * 2)
    flat = tree_util.ravel(port)
    np.testing.assert_array_equal(flat.numpy(), np.concatenate(
        [w.ravel() for w in want]))
    again = tree_util.unravel(port, flat)
    for a, b in zip(tree_util.leaves(again), got):
        assert torch.equal(a, b)
    np_back = bridge.params_to_numpy(port)
    assert isinstance(np_back["z"], list)
    for a, b in zip(jax.tree.leaves(np_back), want):
        np.testing.assert_array_equal(a, b)


def test_fedavg_of_two_fslstm_trees(models):
    j0 = models["fslstm"][0]
    j1 = jfslstm.init(jax.random.PRNGKey(1), channels=M, horizon=T,
                      d_hidden=8)
    want = jfedavg([j0, j1], np.array([3.0, 1.0]))
    got = fedavg([bridge.tree_to_torch(_np_tree(t), "cpu") for t in (j0, j1)],
                 np.array([3.0, 1.0]))
    assert isinstance(got["layers"], list) and len(got["layers"]) == 2
    for a, b in zip(tree_util.leaves(got), jax.tree.leaves(want)):
        _close(a, np.asarray(b), 1e-6)


# ---------------------------------------------------------------------------
# forward, loss, gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", MODELS)
def test_forward_loss_and_gradients(models, name):
    jp, jloss, loss, fwd, jfwd = models[name]
    batch = _data()[0]
    p = bridge.tree_to_torch(_np_tree(jp), "cpu")
    x = torch.from_numpy(batch["x"])
    want = np.asarray(jfwd(jp, jnp.asarray(batch["x"])))
    got = fwd(p, x)
    assert got.shape == (B, T, M) and got.dtype == torch.float32
    _close(got, want, 1e-5)

    jl, jg = jax.value_and_grad(jloss)(jp, batch)
    leaves = [t.requires_grad_(True) for t in tree_util.leaves(p)]
    l = loss(p, bridge.tree_to_torch(batch, "cpu"))
    grads = torch.autograd.grad(l, leaves)
    np.testing.assert_allclose(float(l.detach()), float(jl), rtol=1e-5)
    jgl = jax.tree.leaves(jg)
    assert len(grads) == len(jgl)
    for g, w in zip(grads, jgl):
        w = np.asarray(w)
        np.testing.assert_allclose(
            g.numpy(), w, rtol=0,
            atol=1e-5 * max(float(np.abs(w).max()), 1e-30))


def test_fslstm_forget_gate_bias_and_layers():
    p = fslstm.init(torch.Generator().manual_seed(0), channels=M, horizon=T,
                    d_hidden=8, device="cpu")
    jp = jfslstm.init(jax.random.PRNGKey(0), channels=M, horizon=T,
                      d_hidden=8)
    assert isinstance(p["layers"], list) and len(p["layers"]) == 2
    for lp, jlp in zip(p["layers"], jp["layers"]):
        assert set(lp) == set(jlp)
        for k in lp:
            assert tuple(lp[k].shape) == jlp[k].shape
        np.testing.assert_array_equal(lp["b"].numpy(), np.asarray(jlp["b"]))
    assert tuple(p["head"].shape) == jp["head"].shape


@pytest.mark.parametrize("name", ["dlinear", "patchtst"])
def test_port_init_matches_reference_tree(name):
    """The port's own draw has the reference's keys, shapes and dtypes."""
    g = torch.Generator().manual_seed(0)
    if name == "dlinear":
        p = dlinear.init(g, L, T, device="cpu")
        jp = jdlinear.init(jax.random.PRNGKey(0), L, T)
    else:
        p = patchtst.init(patchtst.make_config(**_PCFG), g, num_channels=M,
                          device="cpu")
        jp = jpatchtst.init(jpatchtst.make_config(**_PCFG),
                            jax.random.PRNGKey(0), num_channels=M)
    got = bridge.params_to_numpy(p)
    assert jax.tree.structure(got) == jax.tree.structure(_np_tree(jp))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jp)):
        assert a.shape == b.shape and a.dtype == b.dtype


# ---------------------------------------------------------------------------
# fit
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fits(models):
    stream = _data(seed=4, n=FIT_STEPS)
    out = {}
    for name in MODELS:
        jp, jloss, loss, _, _ = models[name]
        want = jfit(jloss, jp, iter(stream), steps=FIT_STEPS, lr=5e-3,
                    warmup=1)
        got = fit(loss, bridge.tree_to_torch(_np_tree(jp), "cpu"),
                  iter(stream), steps=FIT_STEPS, lr=5e-3, warmup=1)
        out[name] = (want, got)
    return out


@pytest.mark.parametrize("name", MODELS)
def test_fit_steps_against_reference(fits, name):
    (jparams, jlogs, _), (params, logs, _) = fits[name]
    np.testing.assert_allclose([l.loss for l in logs],
                               [l.loss for l in jlogs], rtol=1e-5, atol=0)
    got, want = tree_util.leaves(params), jax.tree.leaves(jparams)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert not a.requires_grad
        _close(a, np.asarray(b), 1e-5)
