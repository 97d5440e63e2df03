"""The port's DPO loss (``core/dpo.py``) and two-phase fit
(``train/fed_trainer.two_phase_fit``: SFT rounds, DPO alignment, then
forecasting rounds) against the JAX package's, on the fedtime-llama2-7b
smoke config in f32 on the CPU.

The reference draws its weights, LoRA A matrices, first K-means centres
and preference pairs from ``jax.random``; the port's own draws come from a
``torch.Generator``.  So every draw is carried over: the reference's
weights and adapters by the bridge, the first centres as indices, the
pairs as numpy arrays.  The reference's ``two_phase_fit`` itself runs
beside the port's.

Tolerances, and why:
  * ``dpo_loss``: within 1e-5 of the loss; identical policy and reference
    give ln 2 within 1e-6.  Its gradient with respect to the adapters:
    within 1e-5 of the largest gradient entry (f32 sums in another order
    through two layers and the head).
  * two-phase fit: round losses within 1e-5 of the loss, assignments and
    bytes exact, final adapters within 1e-4 of the largest adapter value:
    the tolerances ``tests/test_torch_fed_fit.py`` holds a fit to on the
    f32 wire.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import dpo as jdpo
from repro.core import fedtime as jfedtime
from repro.core import lora as jlora
from repro.data import federated as jfederated
from repro.data import timeseries as jtimeseries
from repro.train import fed_trainer as jfed_trainer
from repro_torch import bridge
from repro_torch import tree as tree_util
from repro_torch.configs import get_smoke_config
from repro_torch.core import dpo
from repro_torch.core.lora import lora_tree, merge_lora
from repro_torch.train import fed_trainer


@pytest.fixture(autouse=True, scope="module")
def _torch_one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_wire_env(monkeypatch):
    """The reference reads its wire from the environment on every call."""
    for name in ("REPRO_FED_WIRE", "REPRO_FED_QBLOCK", "REPRO_FORCE_KERNELS"):
        monkeypatch.delenv(name, raising=False)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def quantized():
    """The smoke config's quantized base with LoRA attached (the fit's
    parameter tree), on both sides, and a preference batch drawn by the
    reference, as ``tests/test_optim_data.py`` draws it."""
    jcfg = jax_smoke_config("fedtime-llama2-7b")
    cfg = get_smoke_config("fedtime-llama2-7b")
    ft = jcfg.fedtime
    jp = jfedtime.init(jcfg, jax.random.PRNGKey(0), num_channels=2)
    jp = jlora.quantize_base(jlora.attach_lora(
        jp, jax.random.PRNGKey(5), rank=ft.lora_rank, alpha=ft.lora_alpha),
        qblock=ft.qlora_block)
    L, T = ft.lookback, ft.horizon
    x = jax.random.normal(jax.random.PRNGKey(1), (2, L, 2))
    y = jax.random.normal(jax.random.PRNGKey(2), (2, T, 2))
    batch = _np(jdpo.make_preference_pairs(jax.random.PRNGKey(3), x, y))
    # a policy that differs from the reference: B matrices drawn nonzero
    rng = np.random.default_rng(6)
    ad = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 0.05
                                 ).astype(np.float32),
                      _np(jlora.lora_tree(jp)))
    return dict(jcfg=jcfg, cfg=cfg, jp=jp,
                p=bridge.params_from_jax(_np(jp), cfg, "cpu"),
                batch=batch, ad=ad)


def _tbatch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def test_dpo_loss_of_identical_policy_is_ln2(quantized):
    q = quantized
    want = float(jdpo.dpo_loss(q["jp"], q["jp"], q["jcfg"], q["batch"]))
    got = float(dpo.dpo_loss(q["p"], q["p"], q["cfg"], _tbatch(q["batch"])))
    assert got == pytest.approx(np.log(2.0), abs=1e-6)
    assert want == pytest.approx(np.log(2.0), abs=1e-6)


@pytest.mark.parametrize("phase", ["sft", "forecast"])
def test_dpo_loss_and_adapter_gradient_match_reference(quantized, phase):
    q = quantized
    jcfg, cfg = q["jcfg"], q["cfg"]

    def jloss(ad):
        return jdpo.dpo_loss(jlora.merge_lora(q["jp"], ad), q["jp"], jcfg,
                             q["batch"], beta=0.1, phase=phase)

    want, jgrad = jax.value_and_grad(jloss)(q["ad"])
    ad = tree_util.map_(lambda a: a.requires_grad_(True),
                        bridge.tree_to_torch(q["ad"], "cpu"))
    got = dpo.dpo_loss(merge_lora(q["p"], ad), q["p"], cfg,
                       _tbatch(q["batch"]), beta=0.1, phase=phase)
    grads = torch.autograd.grad(got, tree_util.leaves(ad))
    got = float(got.detach())
    assert got == pytest.approx(float(want), rel=1e-5)
    assert abs(got - np.log(2.0)) > 1e-3             # the policy moved it
    jleaves = [np.asarray(g) for g in jax.tree.leaves(jgrad)]
    assert len(jleaves) == len(grads) == 8
    top = max(float(np.abs(g).max()) for g in jleaves)
    assert top > 0
    for g, w in zip(grads, jleaves):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * top)


def test_preference_pairs_perturb_by_the_series_scale():
    """y_w = y + 0.05 std(y) n_w, y_l = y + 0.5 std(y) n_l, the std over
    time without Bessel's correction (as ``jnp.std``), the noise two
    draws of the generator."""
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal((3, 16, 2)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal((3, 12, 2)).astype(np.float32)
                         * 3.0)
    out = dpo.make_preference_pairs(torch.Generator().manual_seed(2), x, y)
    g = torch.Generator().manual_seed(2)
    n_w, n_l = torch.randn(y.shape, generator=g), torch.randn(y.shape,
                                                              generator=g)
    scale = torch.from_numpy(np.std(y.numpy(), axis=1, keepdims=True)) + 1e-6
    torch.testing.assert_close(out["y_w"], y + 0.05 * scale * n_w)
    torch.testing.assert_close(out["y_l"], y + 0.5 * scale * n_l)
    assert out["x"] is x
    assert float(((out["y_w"] - y) ** 2).mean()) < \
        float(((out["y_l"] - y) ** 2).mean())


@pytest.mark.parametrize("rounds_forecast", [0, 1], ids=["dpo", "full"])
def test_two_phase_fit_matches_reference(rounds_forecast):
    """With no forecasting round the result's adapters are the DPO stage's
    output itself (8 steps at lr 1e-4 move each adapter element by up to
    ~8e-4, over the tolerance); with one, the whole pipeline's."""
    jcfg = jax_smoke_config("fedtime-llama2-7b")
    cfg = get_smoke_config("fedtime-llama2-7b")
    ft = jcfg.fedtime
    series = jtimeseries.generate(jtimeseries.DATASETS["etth1"],
                                  timesteps=1000)
    train, _ = jtimeseries.train_test_split(series)
    cdata = jfederated.client_windows(
        jfederated.partition_clients(train, ft.num_clients, seed=0,
                                     channels_per_client=2),
        ft.lookback, ft.horizon, max_windows=16)
    kw = dict(rounds_sft=1, rounds_forecast=rounds_forecast, dpo_steps=8,
              batch_size=4)
    jres = jfed_trainer.two_phase_fit(jcfg, cdata, key=jax.random.PRNGKey(0),
                                      **kw)

    # the reference's draws, carried over
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    k_init, k_lora, k_cl = jax.random.split(k1, 3)
    jbase = jfedtime.init(jcfg, k_init, num_channels=2)
    ad0 = jlora.lora_tree(jlora.attach_lora(jbase, k_lora, rank=ft.lora_rank,
                                            alpha=ft.lora_alpha))
    firsts = [int(jax.random.randint(k, (), 0, len(cdata)))
              for k in (k_cl, jax.random.split(k3, 3)[2])]
    x_all = np.concatenate([x[:8] for x, _ in cdata])[:4]
    y_all = np.concatenate([y[:8] for _, y in cdata])[:4]
    pairs = _np(jdpo.make_preference_pairs(k2, jnp.asarray(x_all),
                                           jnp.asarray(y_all)))
    res = fed_trainer.two_phase_fit(
        cfg, cdata, base_params=bridge.params_from_jax(_np(jbase), cfg,
                                                       "cpu"),
        init_adapters=bridge.tree_to_torch(_np(ad0), "cpu"),
        kmeans_first=firsts, pairs=pairs, device="cpu", **kw)

    np.testing.assert_array_equal(res.assignments,
                                  np.asarray(jres.assignments))
    assert len(res.logs) == len(jres.logs) == \
        (1 + rounds_forecast) * ft.num_clusters
    for log, jlog in zip(res.logs, jres.logs):
        assert (log.round, log.cluster) == (jlog.round, jlog.cluster)
        assert (log.comm.bytes_up, log.comm.messages) == \
            (jlog.comm.bytes_up, jlog.comm.messages)
        assert log.train_loss == pytest.approx(jlog.train_loss, rel=1e-5)
    top = max(float(np.abs(np.asarray(x)).max())
              for x in jax.tree.leaves(jres.adapters_per_cluster))
    got = [t for ad in res.adapters_per_cluster
           for t in tree_util.leaves(ad)]
    want = [np.asarray(t) for ad in jres.adapters_per_cluster
            for t in jax.tree.leaves(ad)]
    assert len(got) == len(want) == 2 * 8
    worst = max(float(np.abs(g.numpy() - w).max())
                for g, w in zip(got, want))
    assert worst <= 1e-4 * top, (worst, top)
    if not rounds_forecast:
        # every cluster starts the forecasting phase from the aligned
        # adapters, which the result's base carries too
        aligned = tree_util.leaves(lora_tree(res.base_params))
        for ad in res.adapters_per_cluster:
            for a, b in zip(tree_util.leaves(ad), aligned):
                assert torch.equal(a, b)
