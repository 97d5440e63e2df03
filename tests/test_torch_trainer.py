"""The port's centralized training loop and its optimizer pieces against the
JAX package: schedules, masked AdamW, SGD and ``trainer.fit``, with the
reference's weights carried over by the bridge and the same numpy batches
fed to both.

Tolerances, and why:
  * ``cosine_warmup`` / ``constant``: bit for bit.  Both compute in f32
    with the same operations; the cosine is the C library's ``cosf`` on
    both sides (XLA's CPU backend calls it).
  * masked ``adamw_update``: frozen leaves and their moments bit for bit
    (the same tensors); trained leaves within 1e-6 of the largest
    magnitude (elementwise f32, the same operations).
  * ``sgd_update``: within 1e-6 (one f32 product and difference).
  * ``fit`` on DLinear (5 steps): losses within 1e-5 relative, parameters
    within 1e-5 of their largest magnitude.  The gradients differ by f32
    sum order only; AdamW divides each moment by its own root, so such a
    difference moves a weight by a small fraction of one step.
  * ``fit`` with ``lora_mask`` on the smoke FedTime tree (3 steps): frozen
    leaves bit for bit; adapters within 1e-5, losses within 1e-5 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.baselines import dlinear as jdlinear
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import fedtime as jfedtime
from repro.core import lora as jlora
from repro.optim import schedules as jschedules
from repro.optim.adamw import adamw_init as jadamw_init
from repro.optim.adamw import adamw_update as jadamw_update
from repro.optim.adamw import sgd_update as jsgd_update
from repro.train.trainer import fit as jfit
from repro_torch import bridge
from repro_torch import tree as tree_util
from repro_torch.baselines import dlinear
from repro_torch.configs import get_smoke_config
from repro_torch.core import fedtime, lora
from repro_torch.optim import schedules
from repro_torch.optim.adamw import adamw_init, adamw_update, sgd_update
from repro_torch.train.trainer import TrainLog, fit


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


def _paths(tree, path=()):
    """(key path, leaf) of every leaf of a dict tree."""
    if not isinstance(tree, dict):
        return [(path, tree)]
    return [x for k in sorted(tree) for x in _paths(tree[k], path + (k,))]


def _same_bits(got: torch.Tensor, want) -> bool:
    want = np.asarray(want)
    got = got.detach().numpy()
    return got.shape == want.shape and got.tobytes() == want.tobytes()


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("warmup", [0, 1, 10])
@pytest.mark.parametrize("base_lr,total", [(1e-3, 40), (5e-3, 400)])
def test_cosine_warmup_bit_for_bit(warmup, base_lr, total):
    for step in range(total + 3):
        want = np.float32(jschedules.cosine_warmup(
            step, base_lr=base_lr, warmup=warmup, total=total))
        got = schedules.cosine_warmup(step, base_lr=base_lr, warmup=warmup,
                                      total=total)
        assert got.dtype == torch.float32 and got.ndim == 0
        assert _same_bits(got, want), (step, float(got), float(want))


def test_constant_bit_for_bit():
    for base_lr in (1e-3, 5e-3, 0.1):
        want = np.float32(jschedules.constant(7, base_lr=base_lr))
        assert _same_bits(schedules.constant(7, base_lr=base_lr), want)


# ---------------------------------------------------------------------------
# masked AdamW, SGD
# ---------------------------------------------------------------------------

def _opt_case():
    rng = np.random.default_rng(3)
    tree = {"a": {"lora_a": rng.normal(size=(4, 3)).astype(np.float32),
                  "lora_b": rng.normal(size=(3, 5)).astype(np.float32),
                  "w": rng.normal(size=(4, 5)).astype(np.float32)},
            "b": rng.normal(size=(6,)).astype(np.float32)}
    grads = jax.tree.map(
        lambda a: rng.normal(size=a.shape).astype(np.float32), tree)
    return tree, grads


def test_adamw_mask_freezes_leaves_bit_for_bit():
    tree, grads = _opt_case()
    mask = jlora.lora_mask(tree)
    jp = jax.tree.map(jnp.asarray, tree)
    jg = jax.tree.map(jnp.asarray, grads)
    js = jadamw_init(jp)
    p = bridge.tree_to_torch(tree, "cpu")
    g = bridge.tree_to_torch(grads, "cpu")
    s = adamw_init(p)
    pmask = lora.lora_mask(p)
    assert tree_util.leaves(pmask) == jax.tree.leaves(mask)
    for step in (1, 2, 3):
        jp, js = jadamw_update(jp, jg, js, step, lr=1e-2,
                               weight_decay=0.01, mask=mask)
        p2, s2 = adamw_update(p, g, s, step, lr=1e-2, weight_decay=0.01,
                              mask=pmask)
        for path in (("a", "w"), ("b",)):         # frozen: the same tensors
            for got, was in ((p2, p), (s2["mu"], s["mu"]),
                             (s2["nu"], s["nu"])):
                for k in path:
                    got, was = got[k], was[k]
                assert got is was, path
        for k in ("lora_a", "lora_b"):
            _close(p2["a"][k], np.asarray(jp["a"][k]), 1e-6)
            _close(s2["mu"]["a"][k], np.asarray(js["mu"]["a"][k]), 1e-6)
            _close(s2["nu"]["a"][k], np.asarray(js["nu"]["a"][k]), 1e-6)
        assert _same_bits(p2["a"]["w"], np.asarray(jp["a"]["w"]))
        assert _same_bits(p2["b"], np.asarray(jp["b"]))
        p, s = p2, s2


def test_sgd_update():
    tree, grads = _opt_case()
    want = jsgd_update(jax.tree.map(jnp.asarray, tree),
                       jax.tree.map(jnp.asarray, grads), lr=0.05)
    got = sgd_update(bridge.tree_to_torch(tree, "cpu"),
                     bridge.tree_to_torch(grads, "cpu"), lr=0.05)
    for a, b in zip(tree_util.leaves(got), jax.tree.leaves(want)):
        _close(a, np.asarray(b), 1e-6)


# ---------------------------------------------------------------------------
# fit
# ---------------------------------------------------------------------------

L_DL, T_DL, M_DL = 32, 8, 3
FIT_STEPS = 5


def _batches(n, L, T, M, B=4, seed=5):
    rng = np.random.default_rng(seed)
    return [{"x": rng.normal(size=(B, L, M)).astype(np.float32) * 2 + 1,
             "y": rng.normal(size=(B, T, M)).astype(np.float32)}
            for _ in range(n)]


@pytest.fixture(scope="module")
def dlinear_fits():
    """The reference's fit and the port's, from the same params on the
    same batch stream, each recording eval and progress calls."""
    jp = jdlinear.init(jax.random.PRNGKey(0), L_DL, T_DL)
    stream = _batches(FIT_STEPS, L_DL, T_DL, M_DL)
    held = _batches(1, L_DL, T_DL, M_DL, seed=9)[0]
    out = {}
    for side in ("ref", "port"):
        msgs, evals_at = [], []
        if side == "ref":
            p0, loss_fn, batch = jp, jdlinear.loss, held
            run = jfit
        else:
            p0 = bridge.tree_to_torch(_np_tree(jp), "cpu")
            loss_fn, batch = dlinear.loss, bridge.tree_to_torch(held, "cpu")
            run = fit

        def eval_fn(p, loss_fn=loss_fn, batch=batch, evals_at=evals_at,
                    msgs=msgs):
            evals_at.append(len(msgs))        # before this step's progress
            return float(loss_fn(p, batch))

        out[side] = run(loss_fn, p0, iter(stream), steps=FIT_STEPS, lr=5e-3,
                        warmup=2, eval_fn=eval_fn, eval_every=2,
                        progress=msgs.append) + (msgs, evals_at)
    out["p0"] = p0
    out["jp0"] = _np_tree(jp)
    return out


def test_fit_dlinear_losses_and_params(dlinear_fits):
    jparams, jlogs, jevals, _, jat = dlinear_fits["ref"]
    params, logs, evals, _, at = dlinear_fits["port"]
    np.testing.assert_allclose([l.loss for l in logs],
                               [l.loss for l in jlogs], rtol=1e-5, atol=0)
    for k in ("w_trend", "w_season"):
        _close(params[k], np.asarray(jparams[k]), 1e-5)
        assert not params[k].requires_grad and params[k].grad is None
    # the caller's tree is untouched
    for k, v in dlinear_fits["p0"].items():
        assert _same_bits(v, dlinear_fits["jp0"][k])
        assert not v.requires_grad and v.grad is None
    assert [i for i, _ in evals] == [i for i, _ in jevals] == [1, 3]
    assert at == jat == [1, 3]
    np.testing.assert_allclose([v for _, v in evals],
                               [v for _, v in jevals], rtol=1e-5)


def test_fit_logs_and_progress(dlinear_fits):
    _, jlogs, _, jmsgs, _ = dlinear_fits["ref"]
    _, logs, _, msgs, _ = dlinear_fits["port"]
    assert all(isinstance(l, TrainLog) for l in logs)
    assert [l.step for l in logs] == [l.step for l in jlogs] == \
        list(range(FIT_STEPS))
    secs = [l.seconds for l in logs]
    assert all(isinstance(s, float) for s in secs)
    assert secs == sorted(secs) and secs[0] >= 0
    assert len(msgs) == len(jmsgs) == FIT_STEPS
    for got, want in zip(msgs, jmsgs):
        head, loss = got.rsplit("loss=", 1)
        jhead, jloss = want.rsplit("loss=", 1)
        assert head == jhead
        assert abs(float(loss) - float(jloss)) <= 1e-4 * max(
            abs(float(jloss)), 1.0) + 5e-5


B_FT, M_FT = 3, 2


@pytest.fixture(scope="module")
def masked_fits():
    """A LoRA-attached, unquantized smoke FedTime tree (B nonzero so the
    adapters act), fitted 3 steps under ``lora_mask`` on both sides."""
    jcfg = jax_smoke_config("fedtime-llama2-7b")
    cfg = get_smoke_config("fedtime-llama2-7b")
    ft = jcfg.fedtime
    k0, k1 = jax.random.split(jax.random.PRNGKey(0))
    jp = jlora.attach_lora(jfedtime.init(jcfg, k0, num_channels=M_FT), k1,
                           rank=ft.lora_rank, alpha=ft.lora_alpha)
    rng = np.random.default_rng(1)
    for site in ("wq", "wk", "wv", "wo"):
        node = jp["layers"]["attn"][site]
        node["lora_b"] = jnp.asarray(
            rng.normal(size=node["lora_b"].shape).astype(np.float32) * 0.01)
    stream = _batches(3, ft.lookback, ft.horizon, M_FT, B=B_FT, seed=11)
    jout = jfit(lambda p, b: jfedtime.loss(p, jcfg, b), jp, iter(stream),
                steps=3, lr=1e-3, warmup=1, mask=jlora.lora_mask(jp))
    p0 = bridge.params_from_jax(_np_tree(jp), cfg, device="cpu")
    out = fit(lambda p, b: fedtime.loss(p, cfg, b), p0, iter(stream),
              steps=3, lr=1e-3, warmup=1, mask=lora.lora_mask(p0))
    return jout, out, p0, _np_tree(jp)


def test_fit_with_lora_mask(masked_fits):
    (jparams, jlogs, _), (params, logs, _), p0, jp0 = masked_fits
    np.testing.assert_allclose([l.loss for l in logs],
                               [l.loss for l in jlogs], rtol=1e-5, atol=0)
    trained = 0
    for path, got in _paths(params):
        want, start = jparams, jp0
        for k in path:
            want, start = want[k], start[k]
        assert not got.requires_grad
        if path[-1] in ("lora_a", "lora_b"):
            _close(got, np.asarray(want), 1e-5)
            trained += 1
        else:                                  # frozen: bit for bit
            assert _same_bits(got, start), path
            assert _same_bits(got, np.asarray(want)), path
    assert trained == 8
    # the adapters moved
    b = params["layers"]["attn"]["wq"]["lora_b"]
    assert not _same_bits(b, jp0["layers"]["attn"]["wq"]["lora_b"])
