"""The rest of the centralized path in the port against the JAX package:
Fig. 3's centralized FedTime fine-tune through ``trainer.fit``, the GELU
and GeGLU MLPs, LayerNorm, ``materialize_lora``, the NF4 accounting, the
data helpers and the byte accounting of Fig. 5.

Tolerances, and why:
  * the centralized fit (smoke FedTime, f32, every float leaf trained, 3
    steps): losses within 1e-5 relative, parameters within 1e-5 of each
    leaf's largest magnitude (f32 sums in another order, AdamW's
    normalised steps; see ``test_torch_trainer.py``).
  * ``mlp``, ``layernorm``: within 1e-6 of the output's largest magnitude
    (f32 products and sums; GELU's tanh form on both sides); a bf16
    ``layernorm`` within one bf16 step (2**-8) of it, since both round an
    f32 value that may differ in its last bits.
  * ``materialize_lora``: within 1e-6 (one f32 product chain added to w).
  * ``quant_error``: within 1e-6 relative (two f32 norms summed in another
    order); ``nbytes_nf4``: exact.
  * ``load_csv``, ``batches``, ``sample_batch``: equal arrays (numpy on
    both sides).
  * every ``comm`` count: exact integers; the modelled seconds are the same
    Python arithmetic on the same integers, so equal too.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import comm as jcomm
from repro.core import fedtime as jfedtime
from repro.core import lora as jlora
from repro.core import quant as jquant
from repro.data import timeseries as jts
from repro.data.federated import client_windows, partition_clients
from repro.models.layers import mlp as jmlp
from repro.models.layers import norms as jnorms
from repro.train.trainer import fit as jfit
from repro_torch import bridge
from repro_torch import tree as tree_util
from repro_torch.configs import get_smoke_config
from repro_torch.core import comm, fedtime, lora, quant
from repro_torch.data import timeseries
from repro_torch.models.layers import mlp, norms
from repro_torch.train.trainer import fit


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


# ---------------------------------------------------------------------------
# Fig. 3: the centralized fine-tune
# ---------------------------------------------------------------------------

M_C = 2
CEN_STEPS = 3


@pytest.fixture(scope="module")
def centralized_fits():
    """fig3_convergence's centralized arm at the smoke config: FedTime's
    backbone on the pooled client windows, every float leaf trained."""
    jcfg = jax_smoke_config("fedtime-llama2-7b")
    cfg = get_smoke_config("fedtime-llama2-7b")
    ft = jcfg.fedtime
    tr, _ = jts.train_test_split(jts.generate(jts.DATASETS["etth1"],
                                              timesteps=1200))
    cdata = client_windows(partition_clients(tr, 8, seed=0,
                                             channels_per_client=M_C),
                           ft.lookback, ft.horizon, max_windows=16)
    x_all = np.concatenate([x for x, _ in cdata])
    y_all = np.concatenate([y for _, y in cdata])
    rng = np.random.default_rng(0)
    stream = []
    for _ in range(CEN_STEPS):
        s = rng.integers(0, len(x_all), 8)
        stream.append({"x": x_all[s], "y": y_all[s]})
    jp = jfedtime.init(jcfg, jax.random.PRNGKey(0), num_channels=M_C)
    want = jfit(lambda p, b: jfedtime.loss(p, jcfg, b), jp, iter(stream),
                steps=CEN_STEPS, lr=1e-3)
    p0 = bridge.params_from_jax(_np_tree(jp), cfg, device="cpu")
    got = fit(lambda p, b: fedtime.loss(p, cfg, b), p0, iter(stream),
              steps=CEN_STEPS, lr=1e-3)
    return want, got


def test_centralized_fit_against_reference(centralized_fits):
    (jparams, jlogs, _), (params, logs, _) = centralized_fits
    np.testing.assert_allclose([l.loss for l in logs],
                               [l.loss for l in jlogs], rtol=1e-5, atol=0)
    got, want = tree_util.leaves(params), jax.tree.leaves(jparams)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert not a.requires_grad and a.grad is None
        _close(a, np.asarray(b), 1e-5)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("activation", ["gelu", "geglu", "swiglu"])
@pytest.mark.parametrize("out_dim", [None, 12])
def test_mlp_against_reference(activation, out_dim):
    jp = jmlp.init_mlp(jax.random.PRNGKey(2), 16, 40, activation,
                       out_dim=out_dim)
    p = bridge.tree_to_torch(_np_tree(jp), "cpu")
    own = mlp.init_mlp(torch.Generator().manual_seed(0), 16, 40, activation,
                       out_dim=out_dim)
    assert jax.tree.structure(bridge.params_to_numpy(own)) == \
        jax.tree.structure(_np_tree(jp))
    for a, b in zip(tree_util.leaves(own), jax.tree.leaves(jp)):
        assert tuple(a.shape) == b.shape
    x = np.random.default_rng(3).normal(size=(2, 5, 16)).astype(np.float32)
    want = np.asarray(jmlp.mlp(jp, jnp.asarray(x), activation))
    got = mlp.mlp(p, torch.from_numpy(x), activation)
    assert got.shape == want.shape
    _close(got, want, 1e-6)


def test_layernorm_against_reference():
    rng = np.random.default_rng(4)
    x = (rng.normal(size=(3, 7, 24)) * 3 + 1).astype(np.float32)
    jp = jnorms.init_layernorm(24)
    jp = {"scale": jp["scale"] + jnp.asarray(rng.normal(size=24), jnp.float32),
          "bias": jnp.asarray(rng.normal(size=24), jnp.float32)}
    p = bridge.tree_to_torch(_np_tree(jp), "cpu")
    init = norms.init_layernorm(24)
    assert torch.equal(init["scale"], torch.ones(24))
    assert torch.equal(init["bias"], torch.zeros(24))
    for dtype, jdtype, tol in ((torch.float32, jnp.float32, 1e-6),
                               (torch.bfloat16, jnp.bfloat16, 2 ** -8)):
        want = np.asarray(jnorms.layernorm(jp, jnp.asarray(x, jdtype))
                          .astype(jnp.float32))
        got = norms.layernorm(p, torch.from_numpy(x).to(dtype))
        assert got.dtype == dtype
        _close(got, want, tol)


# ---------------------------------------------------------------------------
# materialize_lora, NF4 accounting
# ---------------------------------------------------------------------------

def _lora_tree():
    """Unstacked sites as the reference's ``materialize_lora`` takes them:
    one plain with adapters, one NF4 with adapters, one plain without."""
    rng = np.random.default_rng(5)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    q, a = jquant.nf4_quantize(jnp.asarray(f(16, 8)), 64)
    return {
        "wq": {"w": f(16, 8), "lora_a": f(16, 4), "lora_b": f(4, 8),
               "lora_scale": np.float32(4.0)},
        "wk": {"w_nf4": np.asarray(q), "absmax": np.asarray(a),
               "lora_a": f(16, 4), "lora_b": f(4, 8),
               "lora_scale": np.float32(4.0)},
        "mlp": {"up": {"w": f(16, 8)}},
        "norm": {"scale": f(16)},
    }


def test_materialize_lora_against_reference():
    tree = _lora_tree()
    want = jlora.materialize_lora(jax.tree.map(jnp.asarray, tree))
    got = lora.materialize_lora(bridge.tree_to_torch(tree, "cpu"))
    assert jax.tree.structure(bridge.params_to_numpy(got)) == \
        jax.tree.structure(_np_tree(want))
    assert set(got["wq"]) == {"w"}
    assert set(got["wk"]) == set(tree["wk"])            # NF4 keeps adapters
    for a, b in zip(tree_util.leaves(got), jax.tree.leaves(want)):
        if a.dtype == torch.uint8:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        else:
            _close(a, np.asarray(b), 1e-6)


def test_materialize_lora_stacked_is_layer_by_layer():
    """A stacked site (L, in, out) with scale (L,) folds each layer as the
    reference folds that layer's unstacked site."""
    rng = np.random.default_rng(6)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    site = {"w": f(3, 16, 8), "lora_a": f(3, 16, 4), "lora_b": f(3, 4, 8),
            "lora_scale": np.array([0.5, 2.0, 4.0], np.float32)}
    got = lora.materialize_lora({"wq": bridge.tree_to_torch(site, "cpu")})
    for i in range(3):
        one = {k: jnp.asarray(v[i]) for k, v in site.items()}
        want = jlora.materialize_lora({"wq": one})["wq"]["w"]
        _close(got["wq"]["w"][i], np.asarray(want), 1e-6)


@pytest.mark.parametrize("shape,qblock", [((64, 96), 64), ((3, 48, 32), 16)])
def test_quant_error_and_nbytes(shape, qblock):
    w = np.random.default_rng(7).normal(size=shape).astype(np.float32)
    want = jquant.quant_error(jnp.asarray(w), qblock)
    got = quant.quant_error(torch.from_numpy(w), qblock)
    assert isinstance(got, float)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    for s in (shape, (4096, 4096), (11008, 4096), (7, 64)):
        assert quant.nbytes_nf4(s, qblock) == jquant.nbytes_nf4(s, qblock)


# ---------------------------------------------------------------------------
# data helpers
# ---------------------------------------------------------------------------

def test_load_csv_batches_and_sample_batch(tmp_path):
    series = jts.generate(jts.DATASETS["etth1"], timesteps=300, seed=3)
    path = tmp_path / "series.csv"
    header = ",".join(f"c{i}" for i in range(series.shape[1]))
    np.savetxt(path, series, delimiter=",", header=header, comments="",
               fmt="%.6f")
    got = timeseries.load_csv(str(path))
    want = jts.load_csv(str(path))
    assert got.dtype == np.float32 and got.shape == series.shape
    np.testing.assert_array_equal(got, want)
    x, y = jts.make_windows(got, 24, 8, stride=3)
    for bs, drop in ((8, True), (7, False), (7, True)):
        a = list(timeseries.batches(x, y, bs, seed=2, drop_last=drop))
        b = list(jts.batches(x, y, bs, seed=2, drop_last=drop))
        assert len(a) == len(b) > 0
        for (xa, ya), (xb, yb) in zip(a, b):
            np.testing.assert_array_equal(xa, xb)
            np.testing.assert_array_equal(ya, yb)
    for seed in (0, 5):
        xa, ya = timeseries.sample_batch(x, y, 11, seed=seed)
        xb, yb = jts.sample_batch(x, y, 11, seed=seed)
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)


# ---------------------------------------------------------------------------
# Fig. 5's byte accounting
# ---------------------------------------------------------------------------

WIRES = ("f32", "bf16", "int8")
NS = (1, 2, 3, 4, 8)
# ragged sizes, and sizes that are whole multiples of the 128-value qblock
# for every n of NS (2n chunks of whole blocks)
SIZES = (1, 1001, 65_537, 3 * 4096 + 5, 16 * 128 * 60, 16 * 128 * 2048)


@pytest.fixture(autouse=True)
def _no_wire_env(monkeypatch):
    """Both packages read these on every call."""
    for name in ("REPRO_FED_WIRE", "REPRO_FED_QBLOCK"):
        monkeypatch.delenv(name, raising=False)


@pytest.mark.parametrize("wire", WIRES)
def test_ring_plan_and_bytes_exact(wire):
    for elems in SIZES:
        for n in NS:
            for qblock in (None, 64):
                want = jcomm.ring_wire_plan(elems, n, wire, qblock)
                got = comm.ring_wire_plan(elems, n, wire, qblock)
                assert dataclasses.asdict(got) == dataclasses.asdict(want)
                assert got.chunk_bytes == want.chunk_bytes
                assert got.per_device_bytes == want.per_device_bytes
                assert comm.ring_wire_bytes(elems, n, wire, qblock) == \
                    jcomm.ring_wire_bytes(elems, n, wire, qblock)


def _stats(rs):
    """A round's counts, from either package's ``RoundStats``."""
    return dataclasses.asdict(rs)


def _adapter_tree(n_a: int, n_b: int, extra: int = 10):
    """A tree whose adapter leaves hold n_a + n_b values beside a base."""
    z = lambda n: np.zeros((n,), np.float32)  # noqa: E731
    return {"x": {"lora_a": z(n_a), "lora_b": z(n_b), "w": z(extra)},
            "y": {"w": z(extra)}}


@pytest.mark.parametrize("wire", WIRES + (None,))
def test_collective_and_round_bytes_exact(wire):
    for n_a, n_b in ((500, 501), (64 * 128, 64 * 128), (3, 65_534)):
        tree = _adapter_tree(n_a, n_b)
        jt = jax.tree.map(jnp.asarray, tree)
        pt = bridge.tree_to_torch(tree, "cpu")
        for n in NS:
            for shape in ({"data": n}, {"data": n, "pod": 2}, {"pod": n}):
                assert comm.collective_bytes_per_round(pt, shape, wire) == \
                    jcomm.collective_bytes_per_round(jt, shape, wire)
            kw = dict(clients_per_round=n, num_clusters=max(n // 2, 1))
            assert _stats(comm.fedtime_round(pt, wire=wire, **kw)) == \
                _stats(jcomm.fedtime_round(jt, wire=wire, **kw))
            assert _stats(comm.fed_full_round(pt, **kw)) == \
                _stats(jcomm.fed_full_round(jt, **kw))


def test_fed_full_round_counts_every_leaf_in_its_dtype():
    rng = np.random.default_rng(8)
    tree = _np_tree(jlora.attach_lora(
        {"wq": {"w": jnp.asarray(rng.normal(size=(32, 16)), jnp.bfloat16)}},
        jax.random.PRNGKey(0), rank=4, alpha=8.0))
    want = jcomm.fed_full_round(tree, clients_per_round=3, num_clusters=2)
    got = comm.fed_full_round(bridge.tree_to_torch(tree, "cpu"),
                              clients_per_round=3, num_clusters=2)
    assert _stats(got) == _stats(want)
    assert got.bytes_up == 3 * (32 * 16 * 2 + (32 * 4 + 4 * 16) * 4 + 4)


@pytest.mark.parametrize("samples,lookback,horizon,channels,clients", [
    (512, 512, 96, 2, 8), (2585, 512, 720, 7, 1), (1, 96, 24, 3, 5)])
def test_centralized_epoch_exact(samples, lookback, horizon, channels,
                                 clients):
    want = jcomm.centralized_epoch(samples, lookback, horizon, channels,
                                   num_clients=clients)
    got = comm.centralized_epoch(samples, lookback, horizon, channels,
                                 num_clients=clients)
    assert _stats(got) == _stats(want)
    assert got.bytes_up == samples * (lookback + horizon) * channels * 4
