"""The train steps on a mesh (``launch.steps.make_train_step`` and
``make_fed_train_step`` under ``dist.sharding.use_mesh``) against the same
steps on one rank over the global batch, in ONE 4-rank gloo world on the
CPU (the port alone: ``tests/test_torch_lm_train.py`` holds the one-rank
steps to the reference).

Every rank draws qwen3-0.6b's smoke weights (f32) and the same global
batches, steps on its rows (``local_shard(batch, data_specs(batch, mesh),
mesh)``) for 3 steps on ``(data 2, model 2)`` and on ``(data 4, model 1)``,
and runs the one-rank step on the whole batch beside it:

  * labels of -1 only on data rank 0's rows, so the ranks' counts differ
    and the global count matters (a per-rank mean read beside: it misses);
  * ``accum`` 2, whose first global microbatch spans data ranks 0 and 1 on
    ``(data 4)``;
  * losses within 1e-5 relative, on every rank; parameters and moments
    (gathered from the ranks' ZeRO-1 blocks) as ``test_torch_lm_train``
    holds the one-rank steps to the reference: parameters within 1e-5 of
    each leaf's largest magnitude (elements whose first gradient is under
    1e-4 of its leaf's largest within 2 lr a step: AdamW's first step
    shows the f32 noise of such a gradient in full, and the mesh sums its
    gradient in another order), moments within 1e-4; every rank's
    parameters bit for bit equal to every other's;
  * a rank's moment bytes exactly the whole's / data ways;
  * the federated step's collective traffic: the gradient psum carries the
    adapter payload (plus the count and the loss, 12 bytes), the ZeRO-1
    gather hands back the adapter payload, and no base leaf moves; the
    base leaves are the same tensors after the step;
  * ``launch.train.run`` in the world: a (data 2, model 2) mesh of the
    ranks, losses within 1e-5 relative of the one-rank launcher's.
"""

import os

import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import spawn_local

WORLD = 4
TIMEOUT_S = 180
STEPS = 3
B, S = 8, 16
LR, FED_LR = 1e-4, 1e-3
MESHES = {"data2_model2": ((2, 2), ("data", "model")),
          "data4_model1": ((4, 1), ("data", "model"))}
CASES = ("train_accum1", "train_accum2", "fed")
LAUNCHER_ARGV = ["--device", "cpu", "--arch", "qwen3-0.6b", "--steps", "2",
                 "--batch", "4", "--seq", "16", "--model-parallel", "2"]


def _yield_cpu():
    """Lowest CPU priority for this module's processes: the suite runs its
    files in parallel workers, and some of their tests bound wall time."""
    os.nice(19)


def _batches(cfg, ways: int):
    """The global batches; -1 labels on every other position of data rank
    0's rows."""
    rng = np.random.default_rng(7)
    out = []
    for _ in range(STEPS):
        toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
        labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
        labels[:B // ways, ::2] = -1
        out.append({"tokens": torch.from_numpy(toks),
                    "labels": torch.from_numpy(labels)})
    return out


def _counting(collectives, rec):
    """Wrap ``collectives.psum`` / ``all_gather`` to record the bytes a
    rank hands to the psum and gets back from the gather; returns the
    undo."""
    psum, gather = collectives.psum, collectives.all_gather

    def counted_psum(x, mesh, axes):
        rec.append(("psum", tuple(x.shape), x.numel() * x.element_size()))
        return psum(x, mesh, axes)

    def counted_gather(x, mesh, axes, dim=0):
        y = gather(x, mesh, axes, dim)
        rec.append(("all_gather", tuple(y.shape),
                    y.numel() * y.element_size()))
        return y

    collectives.psum, collectives.all_gather = counted_psum, counted_gather

    def undo():
        collectives.psum, collectives.all_gather = psum, gather
    return undo


def _errors(got, want, noise, slack):
    """(worst share of a leaf's largest magnitude outside the noise
    elements, whether the noise elements stay within ``slack``)."""
    from repro_torch import tree as tree_util
    worst, within = 0.0, True
    for g, w, m in zip(tree_util.leaves(got), tree_util.leaves(want),
                       tree_util.leaves(noise) if noise is not None
                       else [None] * len(tree_util.leaves(want))):
        d = (g - w).abs()
        top = float(w.abs().max()) or 1e-30
        if m is not None:
            within &= bool((d[m] <= slack).all())
            d = d.masked_fill(m, 0.0)
        worst = max(worst, float(d.max()) / top)
    return worst, within


def _rank():
    _yield_cpu()
    os.environ.pop("REPRO_GRAD_DTYPE", None)
    os.environ.pop("REPRO_ZERO1_SCATTER", None)
    import torch.distributed as dist

    from repro_torch import tree as tree_util
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.lora import (attach_lora, lora_mask, lora_tree,
                                       tree_nbytes)
    from repro_torch.dist import collectives
    from repro_torch.dist.sharding import data_specs, local_shard, use_mesh
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.registry import get_model
    from repro_torch.optim.adamw import adamw_init, zero1_gather, zero1_init

    cfg = get_smoke_config("qwen3-0.6b")
    api = get_model(cfg)
    g = torch.Generator().manual_seed(0)
    base = api.init(cfg, g, device="cpu")
    fed = attach_lora(base, torch.Generator().manual_seed(1), rank=4,
                      alpha=8.0)
    for leaf in tree_util.leaves(lora_tree(fed)):     # B at 0.01, A kept
        if leaf.abs().max() == 0:
            leaf.normal_(generator=g).mul_(0.01)
    out = {"rank": dist.get_rank()}
    for name, (shape, names) in MESHES.items():
        mesh = make_mesh(shape, names, device_type="cpu")
        ways = shape[0]
        batches = _batches(cfg, ways)
        for case in CASES:
            is_fed = case == "fed"
            accum = 2 if case == "train_accum2" else 1
            params = fed if is_fed else base
            trained = lora_tree(params) if is_fed else params
            make = ((lambda: steps.make_fed_train_step(cfg, lr=FED_LR))
                    if is_fed else
                    (lambda: steps.make_train_step(cfg, lr=LR, accum=accum)))
            # the one-rank step over the global batch
            p1, st1, l1, noise = params, adamw_init(trained), [], None
            step1 = make()
            for i, b in enumerate(batches):
                p1, st1, loss = step1(p1, st1, b, i)
                l1.append(float(loss))
                if i == 0:
                    noise = tree_util.map_(
                        lambda mu: mu.abs() < 1e-4 * mu.abs().max(),
                        st1["mu"])
            # the mesh step over this rank's rows
            rec = []
            pm, stm, lm = params, zero1_init(trained, mesh), []
            stepm = make()
            with use_mesh(mesh):
                undo = _counting(collectives, rec)
                try:
                    for i, b in enumerate(batches):
                        mine = local_shard(b, data_specs(b, mesh), mesh)
                        pm, stm, loss = stepm(pm, stm, mine, i)
                        lm.append(float(loss))
                finally:
                    undo()
            key = f"{name}/{case}"
            lr = FED_LR if is_fed else LR
            trained_m = lora_tree(pm) if is_fed else pm
            trained_1 = lora_tree(p1) if is_fed else p1
            out[key + "/losses"] = (lm, l1)
            out[key + "/params"] = _errors(trained_m, trained_1, noise,
                                           2 * lr * STEPS)
            full = zero1_gather(stm, trained, mesh)
            out[key + "/moments"] = max(
                _errors(full[m], st1[m], None, 0.0)[0] for m in ("mu", "nu"))
            out[key + "/fingerprint"] = [
                x.numpy().tobytes().hex()[:64] + str(float(x.double().sum()))
                for x in tree_util.leaves(trained_m)]
            out[key + "/moment_bytes"] = (tree_nbytes(stm),
                                          tree_nbytes(adamw_init(trained)))
            if is_fed:
                out[key + "/base_kept"] = all(
                    a is b for a, b, m in zip(tree_util.leaves(pm),
                                              tree_util.leaves(params),
                                              tree_util.leaves(
                                                  lora_mask(params)))
                    if m is False)
                shapes = {tuple(x.shape) for x in
                          tree_util.leaves(lora_tree(params))}
                base_shapes = {tuple(x.shape) for x, m in zip(
                    tree_util.leaves(params),
                    tree_util.leaves(lora_mask(params))) if m is False}
                out[key + "/payload"] = tree_nbytes(lora_tree(params))
                psum_calls = [r for r in rec if r[0] == "psum"]
                out[key + "/psum_bytes"] = sum(r[2] for r in psum_calls) / \
                    STEPS
                out[key + "/gathered_bytes"] = sum(
                    r[2] for r in rec if r[0] == "all_gather") / STEPS
                out[key + "/base_shapes_moved"] = sorted(
                    {r[1] for r in rec if len(r[1]) > 1}
                    & (base_shapes - shapes))
            else:
                out[key + "/whole_bytes"] = tree_nbytes(params)
                out[key + "/psum_bytes"] = sum(
                    r[2] for r in rec if r[0] == "psum") / STEPS
            if case == "train_accum1":
                # a per-rank mean, averaged over the data ranks: what the
                # global count rules out
                b = batches[0]
                mine = local_shard(b, data_specs(b, mesh), mesh)
                with torch.no_grad():
                    h = api.loss(params, cfg, mine)
                per_rank = float(collectives.psum(h, mesh, ("data",))) / ways
                with torch.no_grad():
                    first = float(api.loss(params, cfg, b))
                out[key + "/per_rank_mean"] = (per_rank, first)
    from repro_torch.launch import train
    run = train.run(train.parse_args(LAUNCHER_ARGV))
    out["launcher"] = (run.losses, run.mesh_shape)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return spawn_local(WORLD, _rank, device_type="cpu", timeout_s=TIMEOUT_S,
                       store_dir=str(tmp_path_factory.mktemp("train_mesh")))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("mesh", MESHES)
def test_mesh_step_equals_one_rank_step(runs, mesh, case):
    key = f"{mesh}/{case}"
    for r in runs:
        lm, l1 = r[key + "/losses"]
        np.testing.assert_allclose(lm, l1, rtol=1e-5, atol=0)
        worst, within = r[key + "/params"]
        assert worst <= 1e-5 and within, (r["rank"], worst, within)
        assert r[key + "/moments"] <= 1e-4, (r["rank"], r[key + "/moments"])
    prints = {tuple(r[key + "/fingerprint"]) for r in runs}
    assert len(prints) == 1                     # every rank alike


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("mesh", MESHES)
def test_rank_holds_its_share_of_the_moments(runs, mesh, case):
    ways = MESHES[mesh][0][0]
    for r in runs:
        mine, whole = r[f"{mesh}/{case}/moment_bytes"]
        assert mine * ways == whole, (r["rank"], mine, whole)


@pytest.mark.parametrize("mesh", MESHES)
def test_fed_step_moves_only_adapter_bytes(runs, mesh):
    key = f"{mesh}/fed"
    for r in runs:
        payload = r[key + "/payload"]
        assert r[key + "/base_kept"]
        assert r[key + "/psum_bytes"] == payload + 8 + 4     # count, loss
        assert r[key + "/gathered_bytes"] == payload
        assert r[key + "/base_shapes_moved"] == []
        # the full fine-tune's psum carries every leaf
        assert r[f"{mesh}/train_accum1/psum_bytes"] == \
            r[f"{mesh}/train_accum1/whole_bytes"] + 8 + 4


@pytest.mark.parametrize("mesh", MESHES)
def test_global_count_matters_on_this_batch(runs, mesh):
    """The -1 labels on data rank 0's rows make a per-rank mean miss the
    global loss by ten times the steps' tolerance or more (read: 4.9e-4
    relative on (data 2), where random weights put every token's loss
    near ln 512)."""
    for r in runs:
        per_rank, whole = r[f"{mesh}/train_accum1/per_rank_mean"]
        first = r[f"{mesh}/train_accum1/losses"][0][0]
        assert abs(first - whole) <= 1e-5 * whole
        assert abs(per_rank - whole) > 1e-4 * whole, (per_rank, whole)


def test_launcher_runs_on_the_world_as_on_one_rank(runs, capsys):
    """``launch.train.run`` in a running group steps on a (data 2, model 2)
    mesh of its ranks, and its losses are the one-rank launcher's."""
    from repro_torch.launch import train
    want = train.run(train.parse_args(LAUNCHER_ARGV))
    capsys.readouterr()
    assert want.mesh_shape is None
    for r in runs:
        losses, shape = r["launcher"]
        assert shape == {"data": 2, "model": 2}
        np.testing.assert_allclose(losses, want.losses, rtol=1e-5, atol=0)
