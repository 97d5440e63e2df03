"""The port's federated fit (paper Algorithm 1, plain options) against the
JAX package's, on the fedtime-llama2-7b smoke config in f32.

Both fits start from the same base parameters and adapters (the
reference's, carried over by the bridge) and the same first K-means
centre; client sampling and local batches draw from the same numpy seeds.

Tolerances, and why:
  * data arrays, client weights, K-means assignments, the clients each
    round samples, communication bytes and messages: exact.
  * K-means features and centres: within 1e-5 (f32 means and sums in
    another order).
  * round losses: within 1e-5 of the loss.  A round's loss is the mean of
    its clients' local losses, computed from the same adapters up to f32
    differences.
  * final adapters (measured: within 6.5e-6, 6.2e-6 and 1.1e-5 of the
    largest adapter value on the f32, int8 and bf16 wires): within 1e-4 of
    it on the f32 wire: two rounds of AdamW and FedAdam, each dividing a moment by its own
    root, carry the f32 differences of the gradients into the weights.  On
    a quantized wire a delta whose two sides differ in the last bit may
    round to neighbouring wire codes: one wire step (the row's scale on the
    int8 wire, a bf16 ulp of the value on bf16) moves that element of the
    averaged delta, and FedAdam's step (lr 1e-2 over sqrt(v) + 1e-3) can
    carry it to the adapter in full.  The quantized wires are therefore held
    within 1e-4 of the largest adapter value in all but the elements a flip
    can reach, and those within 2 x lr = 2e-2.
  * test metrics: within 1e-5 of their value.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import clustering as jclustering
from repro.core import comm as jcomm
from repro.core import fedtime as jfedtime
from repro.core import lora as jlora
from repro.data import federated as jfederated
from repro.data import timeseries as jtimeseries
from repro.train import fed_trainer as jfed_trainer
from repro.train.trainer import evaluate_forecaster as jevaluate
from repro_torch import bridge
from repro_torch import tree as tree_util
from repro_torch.configs import get_smoke_config
from repro_torch.core import clustering, comm, fedtime
from repro_torch.core.lora import count_params, lora_tree
from repro_torch.data import federated, timeseries
from repro_torch.train import fed_trainer
from repro_torch.train.trainer import evaluate_forecaster

ROUNDS, BATCH = 2, 4


@pytest.fixture(autouse=True, scope="module")
def _torch_one_thread():
    """The shapes here are tiny: one intra-op thread, so that parallel test
    workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_wire_env(monkeypatch):
    """Each fit names its wire; nothing is read from a variable another
    test may have left."""
    for name in ("REPRO_FED_WIRE", "REPRO_FED_QBLOCK", "REPRO_FORCE_KERNELS"):
        monkeypatch.delenv(name, raising=False)


def _data(mod_ts, mod_fed, cfg):
    ft = cfg.fedtime
    series = mod_ts.generate(mod_ts.DATASETS["etth1"], timesteps=1000)
    train, test = mod_ts.train_test_split(series)
    clients = mod_fed.partition_clients(train, ft.num_clients, seed=0,
                                        channels_per_client=2)
    cdata = mod_fed.client_windows(clients, ft.lookback, ft.horizon,
                                   max_windows=16)
    xte, yte = mod_ts.make_windows(test, ft.lookback, ft.horizon, stride=8)
    return clients, cdata, xte[..., :2], yte[..., :2]


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_smoke_config("fedtime-llama2-7b")
    cfg = get_smoke_config("fedtime-llama2-7b")
    ft = jcfg.fedtime
    clients, cdata, xte, yte = _data(jtimeseries, jfederated, jcfg)
    k_init, k_lora, k_cl = jax.random.split(jax.random.PRNGKey(0), 3)
    jbase = jfedtime.init(jcfg, k_init, num_channels=2)
    ad0 = jlora.lora_tree(jlora.attach_lora(jbase, k_lora, rank=ft.lora_rank,
                                            alpha=ft.lora_alpha))
    first = int(jax.random.randint(k_cl, (), 0, len(cdata)))
    return dict(jcfg=jcfg, cfg=cfg, clients=clients, cdata=cdata, xte=xte,
                yte=yte, jbase=jbase, ad0=ad0, first=first)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def test_data_pipeline_equals_reference(setup):
    clients, cdata, xte, yte = _data(timeseries, federated, setup["cfg"])
    for a, b in zip(clients, setup["clients"]):
        np.testing.assert_array_equal(a, b)
    for (x, y), (jx, jy) in zip(cdata, setup["cdata"]):
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)
    np.testing.assert_array_equal(xte, setup["xte"])
    np.testing.assert_array_equal(federated.client_weights(cdata),
                                  jfederated.client_weights(setup["cdata"]))


def test_kmeans_with_the_reference_first_centre(setup):
    rng = np.random.default_rng(5)
    series = [rng.normal(size=(int(rng.integers(40, 90)), 6)).astype(
        np.float32) * rng.uniform(0.5, 3) + rng.normal() for _ in range(12)]
    jX = jclustering.client_features(series)
    X = clustering.client_features(series)
    np.testing.assert_allclose(X.numpy(), np.asarray(jX), atol=1e-5, rtol=0)
    key = jax.random.PRNGKey(1)
    first = int(jax.random.randint(key, (), 0, len(series)))
    ja, jc, ji = jclustering.kmeans(jX, 4, key=key)
    a, c, inertia = clustering.kmeans(X, 4, first=first)
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    assert len(set(a.tolist())) > 1
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(inertia), float(ji), rtol=1e-5)
    g = torch.Generator().manual_seed(0)
    a, _, _ = clustering.kmeans(X, 3, generator=g)
    assert a.shape == (12,) and set(a.tolist()) <= {0, 1, 2}


@pytest.mark.parametrize("n", [1, 127, 128, 8_388_608, 8_388_609])
def test_wire_payload_bytes_equal_reference(n):
    for wire in ("f32", "bf16", "int8"):
        for qblock in (64, 128):
            assert comm.wire_payload_bytes(n, wire, qblock) == \
                jcomm.wire_payload_bytes(n, wire, qblock)


def _fits(setup, wire):
    jcfg, cfg = setup["jcfg"], setup["cfg"]
    jres = jfed_trainer.federated_fit(
        jcfg, setup["cdata"], rounds=ROUNDS, batch_size=BATCH,
        key=jax.random.PRNGKey(0), base_params=setup["jbase"],
        init_adapters=setup["ad0"], wire=wire)
    res = fed_trainer.federated_fit(
        cfg, setup["cdata"], rounds=ROUNDS, batch_size=BATCH,
        base_params=bridge.params_from_jax(_np(setup["jbase"]), cfg, "cpu"),
        init_adapters=bridge.tree_to_torch(_np(setup["ad0"]), "cpu"),
        kmeans_first=setup["first"], wire=wire, device="cpu")
    return jres, res


@pytest.mark.parametrize("wire", ["f32", "int8", "bf16"])
def test_federated_fit_matches_reference(setup, wire):
    jres, res = _fits(setup, wire)
    np.testing.assert_array_equal(res.assignments,
                                  np.asarray(jres.assignments))
    assert res.trainable_frac == pytest.approx(jres.trainable_frac, rel=1e-9)
    assert len(res.logs) == len(jres.logs) == ROUNDS * 2
    n_elems = count_params(lora_tree(res.base_params))
    assert n_elems == jlora.count_params(jlora.lora_tree(jres.base_params))
    uploads = 0
    for log, jlog in zip(res.logs, jres.logs):
        assert (log.round, log.cluster) == (jlog.round, jlog.cluster)
        assert (log.comm.bytes_up, log.comm.bytes_down, log.comm.messages) \
            == (jlog.comm.bytes_up, jlog.comm.bytes_down,
                jlog.comm.messages)
        assert log.comm.time_s == pytest.approx(jlog.comm.time_s, rel=1e-12)
        assert log.train_loss == pytest.approx(jlog.train_loss, rel=1e-5)
        uploads += (log.comm.messages -
                    setup["cfg"].fedtime.num_clusters) // 2
    assert sum(l.comm.bytes_up for l in res.logs) == \
        comm.wire_payload_bytes(n_elems, wire) * uploads
    top = max(float(np.abs(np.asarray(x)).max())
              for x in jax.tree.leaves(jres.adapters_per_cluster))
    diffs = [np.abs(g.numpy() - np.asarray(w)) for g, w in zip(
        [t for ad in res.adapters_per_cluster
         for t in tree_util.leaves(ad)],
        [t for ad in jres.adapters_per_cluster
         for t in jax.tree.leaves(ad)])]
    assert len(diffs) == 2 * 8
    worst = max(float(d.max()) for d in diffs)
    if wire == "f32":
        assert worst <= 1e-4 * top, (worst, top)
    else:
        flipped = sum(int((d > 1e-4 * top).sum()) for d in diffs)
        total = sum(d.size for d in diffs)
        assert worst <= 2e-2, worst
        assert flipped <= total // 100, (flipped, total)


def test_evaluate_forecaster_equals_reference(setup):
    jcfg, cfg = setup["jcfg"], setup["cfg"]
    k_lora = jax.random.split(jax.random.PRNGKey(0), 3)[1]
    jp = jlora.quantize_base(jlora.attach_lora(
        setup["jbase"], k_lora, rank=4, alpha=16.0), qblock=64)
    params = bridge.params_from_jax(_np(jp), cfg, "cpu")
    want = jevaluate(lambda p, x: jfedtime.forward(p, jcfg, x), jp,
                     setup["xte"], setup["yte"], batch=8)
    got = evaluate_forecaster(lambda p, x: fedtime.forward(p, cfg, x),
                              params, setup["xte"], setup["yte"], batch=8)
    for name in ("mse", "mae"):
        assert got[name] == pytest.approx(want[name], rel=1e-5)


def test_upload_screen_matches_reference():
    """The plain path screens every upload: a non-finite delta is corrupt,
    one above 25x the cohort's median norm byzantine."""
    from repro.fault.guard import validate_deltas as jvalidate
    from repro_torch.fault.guard import validate_deltas
    rng = np.random.default_rng(9)
    deltas = [{"a": rng.normal(size=(4, 3)).astype(np.float32)}
              for _ in range(5)]
    deltas[1]["a"][0, 0] = np.nan
    deltas[3]["a"] *= 100.0
    want = jvalidate([jax.tree.map(np.asarray, d) for d in deltas])
    got = validate_deltas([bridge.tree_to_torch(d, "cpu") for d in deltas])
    assert [g[:2] for g in got] == [w[:2] for w in want]
    assert [g[1] for g in got] == [None, "corrupt", None, "byzantine", None]
    for g, w in zip(got, want):
        assert g[2] == pytest.approx(w[2], rel=1e-6, nan_ok=True)
