"""ZeRO-1 AdamW (``repro_torch.optim.adamw.adamw_update_zero1``) against the
port's plain ``adamw_update``, on a 4-rank gloo world on the CPU.

The reference's own ZeRO-1 parity test
(``tests/test_ring_collective.py::test_zero1_scatter_parity_and_collective_term``)
does not run on the installed jax, so the scatter update is held to the
plain update, which the port's other tests hold to the reference's
(``tests/test_torch_trainer.py``).  Every rank runs three steps of both on
the same seeded gradients, on ``(data 4)`` and on ``(data 2, model 2)``:

  * qwen3-0.6b's smoke tree, every leaf trained, weight decay on;
  * FedTime's smoke tree with LoRA attached, only the adapters trained
    (``mask=``): frozen leaves and their moments are not touched;
  * parameters bit for bit on every rank; each rank's moment blocks bit for
    bit with the plain moments' blocks, and gathered whole;
  * the fallbacks: no mesh, a mesh with no live data axis ``(data 1,
    model 4)``, and ``REPRO_ZERO1_SCATTER=0``, each equal to the plain
    update with whole moments.
"""

import os

import pytest
import torch

from repro_torch.launch.mesh import spawn_local

WORLD = 4
TIMEOUT_S = 180
STEPS = 3
MESHES = {"data4": ((4,), ("data",)),
          "data2_model2": ((2, 2), ("data", "model"))}
HP = dict(lr=1e-3, weight_decay=0.01)



def _yield_cpu():
    """Lowest CPU priority for this module's processes: the suite runs its
    files in parallel workers, and some of their tests bound wall time."""
    os.nice(19)


def _trees():
    from repro_torch import configs
    from repro_torch import tree as tree_util
    from repro_torch.core import fedtime, lora
    from repro_torch.models.registry import get_model
    cfg = configs.get_smoke_config("qwen3-0.6b")
    g = torch.Generator().manual_seed(0)
    qwen = get_model(cfg).init(cfg, g, device="cpu")
    fcfg = configs.get_smoke_config("fedtime-llama2-7b")
    ft = lora.attach_lora(fedtime.init(fcfg, g, num_channels=2,
                                       device="cpu"), g, rank=4, alpha=8.0)
    mask = lora.lora_mask(ft)
    out = []
    for params, m in ((qwen, None), (ft, mask)):
        grads = [tree_util.map_(
            lambda p: torch.randn(p.shape, generator=g).to(p.dtype) * 0.01,
            params) for _ in range(STEPS)]
        out.append((params, grads, m))
    return out


def _equal(a, b) -> bool:
    from repro_torch import tree as tree_util
    la, lb = tree_util.leaves(a), tree_util.leaves(b)
    return len(la) == len(lb) and all(
        x.shape == y.shape and x.dtype == y.dtype and torch.equal(x, y)
        for x, y in zip(la, lb))


def _plain(params, grads, mask):
    from repro_torch.optim.adamw import adamw_init, adamw_update
    st = adamw_init(params)
    for step, g in enumerate(grads, 1):
        params, st = adamw_update(params, g, st, step, mask=mask, **HP)
    return params, st


def _port_ranks():
    _yield_cpu()
    os.environ.pop("REPRO_ZERO1_SCATTER", None)
    import torch.distributed as dist

    from repro_torch import tree as tree_util
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import adamw

    cases = _trees()
    plain = [_plain(*c) for c in cases]
    out = {"rank": dist.get_rank()}
    for name, (shape, names) in MESHES.items():
        mesh = make_mesh(shape, names, device_type="cpu")
        for i, ((params, grads, mask), (pp, pst)) in enumerate(
                zip(cases, plain)):
            key = f"{name}/{i}"
            st = adamw.zero1_init(params, mesh)
            p = params
            for step, g in enumerate(grads, 1):
                p, st = adamw.adamw_update_zero1(p, g, st, step, mesh=mesh,
                                                 mask=mask, **HP)
            out[key + "/params"] = _equal(p, pp)
            out[key + "/blocks"] = _equal(st, adamw.zero1_shard(pst, params,
                                                                mesh))
            out[key + "/gathered"] = _equal(
                adamw.zero1_gather(st, params, mesh), pst)
            plan = adamw._zero1_plan(params, mesh)
            out[key + "/scattered"] = sum(wi is not None for wi in plan)
            out[key + "/moment_elems"] = sum(
                x.numel() for x in tree_util.leaves(st["mu"]))
            out[key + "/frozen_kept"] = mask is None or all(
                a is b for a, b, m in zip(tree_util.leaves(p),
                                          tree_util.leaves(params),
                                          tree_util.leaves(mask))
                if m is False)
    # fallbacks: whole moments, the plain update
    params, grads, mask = cases[0]
    pp, pst = plain[0]
    mesh = make_mesh((1, 4), ("data", "model"), device_type="cpu")
    for name, m in (("no_data_axis", mesh), ("no_mesh", None)):
        p, st = params, adamw.adamw_init(params)
        for step, g in enumerate(grads, 1):
            p, st = adamw.adamw_update_zero1(p, g, st, step, mesh=m, **HP)
        out[name] = _equal(p, pp) and _equal(st, pst)
    from repro_torch.dist.sharding import _mesh_shape
    from repro_torch.launch.mesh import make_host_mesh
    out["host_meshes"] = [
        _mesh_shape(make_host_mesh(model=m, device_type="cpu"))
        for m in (1, 2, 8)]
    os.environ["REPRO_ZERO1_SCATTER"] = "0"
    mesh = make_mesh((4,), ("data",), device_type="cpu")
    p, st = params, adamw.adamw_init(params)
    for step, g in enumerate(grads, 1):
        p, st = adamw.adamw_update_zero1(p, g, st, step, mesh=mesh, **HP)
    out["env_off"] = _equal(p, pp) and _equal(st, pst)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return spawn_local(WORLD, _port_ranks, device_type="cpu",
                       timeout_s=TIMEOUT_S,
                       store_dir=str(tmp_path_factory.mktemp("zero1")))


@pytest.mark.parametrize("tree", (0, 1), ids=("qwen3", "fedtime_lora"))
@pytest.mark.parametrize("mesh", MESHES)
def test_scatter_update_equals_plain_adamw(runs, mesh, tree):
    for r in runs:
        key = f"{mesh}/{tree}"
        assert r[key + "/scattered"] > 0
        assert r[key + "/params"], (r["rank"], key)
        assert r[key + "/blocks"], (r["rank"], key)
        assert r[key + "/gathered"], (r["rank"], key)
        assert r[key + "/frozen_kept"], (r["rank"], key)


@pytest.mark.parametrize("mesh", MESHES)
def test_moments_are_scattered(runs, mesh):
    """Each rank keeps less than the whole moment state: a quarter of the
    scattered leaves on (data 4), half on (data 2, model 2)."""
    from repro_torch import tree as tree_util
    (params, _, _), _ = _trees()
    whole = sum(p.numel() for p in tree_util.leaves(params))
    got = runs[0][f"{mesh}/0/moment_elems"]
    assert got < whole * (0.5 if mesh == "data4" else 0.75), (got, whole)
    assert all(r[f"{mesh}/0/moment_elems"] == got for r in runs)


@pytest.mark.parametrize("case", ("no_data_axis", "no_mesh", "env_off"))
def test_fallbacks_run_the_plain_update(runs, case):
    assert all(r[case] for r in runs)


def test_host_mesh_takes_the_running_ranks(runs):
    """``make_host_mesh(model=m)``: (data, model) over the world, ``model``
    cut to the world's size."""
    for r in runs:
        assert r["host_meshes"] == [{"data": 4, "model": 1},
                                    {"data": 2, "model": 2},
                                    {"data": 1, "model": 4}]


def test_scatter_env_switch(monkeypatch):
    from repro_torch.optim.adamw import zero1_scatter_enabled
    monkeypatch.delenv("REPRO_ZERO1_SCATTER", raising=False)
    assert zero1_scatter_enabled()
    monkeypatch.setenv("REPRO_ZERO1_SCATTER", "0")
    assert not zero1_scatter_enabled()


def test_unflatten_keeps_no_reference_cycle():
    """``tree.unflatten`` frees its leaves as soon as the caller drops
    them, without waiting for the garbage collector: a reference cycle
    there held every step's parameters and moments alive on the card
    (4 ranks of qwen3-0.6b's ZeRO-1 steps ran out of its 80 GB)."""
    import gc
    import weakref

    from repro_torch import tree as tree_util
    t = torch.ones(4)
    ref = weakref.ref(t)
    enabled = gc.isenabled()
    gc.disable()
    try:
        out = tree_util.unflatten({"a": 0, "b": [1, (2,)]}, [t, t, t])
        assert out["b"][1][0] is t
        del t, out
        assert ref() is None
    finally:
        if enabled:
            gc.enable()
