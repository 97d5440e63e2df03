"""Sharded serving of gemma2's alternating cache against the JAX package's
unsharded run, on one 4-rank gloo world on the CPU.

gemma2-27b's smoke config in f32, its window cut to 8 slots so that the
local rings (8 slots) are shorter than the global rings (16) and both
wrap.  Each rank holds its rows of the batch and its stripe of each of
the two ring trees (``cache_specs``' seq layout over ``model``: 4 / 2
slots of a local ring and 8 / 4 of a global ring a rank on ``(data 2,
model 2)`` / ``(data 1, model 4)``); the attention layer's decode runs the
kernel's plain version on the rank's stripe of the local ring and of the
global ring and combines the partials over ``model``.  A 16-token prompt
(B 4), 8 greedy steps and one more ``decode_step``, synchronous and
ragged (lane 1 inactive from step 3, lane 2 joining at step 2):

  * greedy tokens, gathered over the batch axes, equal the reference's
    exactly; prefill and last logits within 1e-4 of the reference's and
    within 1e-5 of the port's own unsharded run (the combine's f32
    rounding);
  * each rank's prefilled stripes of both trees equal its ``local_shard``
    piece of the unsharded cache (positions exactly, values within 1e-5),
    and hold the whole cache's bytes / (batch ways x model ways).
"""

import contextlib
import os
import threading

import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import spawn_local

WORLD = 4
TIMEOUT_S = 240
ARCH = "gemma2-27b"
WINDOW = 8
MESHES = {"d2m2": ((2, 2), ("data", "model")),
          "d1m4": ((1, 4), ("data", "model"))}
LAYOUTS = ("sync", "ragged")
B, S, STEPS = 4, 16, 8
TOL_REF, TOL_COMBINE = 1e-4, 1e-5
_ENV_KEYS = ("REPRO_CACHE_SHARD", "REPRO_KV_INT8", "REPRO_FORCE_KERNELS",
             "XLA_FLAGS")


def _positions(i: int, layout: str):
    if layout == "sync":
        return S + i
    pos = np.full(B, S + i, np.int32)
    if i >= 3:
        pos[1] = -1
    pos[2] = -1 if i < 2 else S + i - 2
    return pos


def _flat(cache, path=""):
    """{path: numpy leaf} of a cache tree."""
    if isinstance(cache, dict):
        out = {}
        for k, v in cache.items():
            out.update(_flat(v, f"{path}/{k}"))
        return out
    return {path: cache.numpy().copy()}


def _port_run(cfg, params, tokens, layout, mesh=None):
    """Prefill, ``STEPS`` greedy serve steps and one ``decode_step``; under
    ``mesh`` this rank's rows and stripes."""
    from repro_torch.dist import sharding
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models.registry import get_model

    def ctx():
        return (sharding.use_mesh(mesh) if mesh is not None
                else contextlib.nullcontext())
    batch = {"tokens": torch.from_numpy(tokens)}
    rows = torch.arange(B)
    if mesh is not None:
        specs = sharding.data_specs(batch, mesh)
        batch = sharding.local_shard(batch, specs, mesh)
        rows = sharding.local_shard(rows, specs["tokens"][:1], mesh)
    rows = rows.numpy()
    with ctx():
        cache, lg = make_prefill_step(cfg)(params, batch)
    flat = _flat(cache)
    out = {"rows": rows, "prefill": lg.numpy(), "cache": flat,
           "cache_bytes": sum(t.nbytes for t in flat.values())}
    step = make_serve_step(cfg)
    tok = lg[:, -1].argmax(-1).to(torch.int32)[:, None]
    toks = [tok]
    for i in range(STEPS + 1):
        pos = _positions(i, layout)
        if not isinstance(pos, int):
            pos = torch.from_numpy(pos[rows])
        b = {"token": tok, "pos": pos}
        with ctx():
            if i < STEPS:
                tok, cache = step(params, cache, b)
                toks.append(tok)
            else:
                last, cache = get_model(cfg).decode_step(params, cfg, cache,
                                                         b)
    out["tokens"] = torch.cat(toks, 1).numpy()
    out["last"] = last.numpy()
    return out


def _port_ranks(payload):
    os.nice(19)
    for k in _ENV_KEYS:
        os.environ.pop(k, None)
    import torch.distributed as dist

    from repro_torch import bridge
    from repro_torch.configs import get_smoke_config
    from repro_torch.dist import collectives, sharding
    from repro_torch.launch.mesh import make_mesh
    cfg = get_smoke_config(ARCH).replace(sliding_window=WINDOW)
    params = bridge.params_from_jax(payload["params"], cfg, device="cpu")
    out = {"rank": dist.get_rank(), "cases": {}, "coords": {}}
    for name, (shape, names) in MESHES.items():
        mesh = make_mesh(shape, names, device_type="cpu")
        out["coords"][name] = {ax: mesh.get_local_rank(ax)
                               for ax in mesh.mesh_dim_names}
        bax = sharding.data_specs({"t": torch.zeros(B)}, mesh)["t"]
        for layout in LAYOUTS:
            r = _port_run(cfg, params, payload["tokens"], layout, mesh)
            toks = torch.from_numpy(r["tokens"])
            if bax:
                toks = collectives.all_gather(toks, mesh, bax[0], dim=0)
            r["gathered"] = toks.numpy()
            out["cases"][(name, layout)] = r
    return out


def _reference_runs(jcfg, jparams, tokens):
    import jax
    import jax.numpy as jnp

    from repro.launch.steps import make_prefill_step, make_serve_step
    from repro.models.registry import get_model
    step = jax.jit(make_serve_step(jcfg))
    api = get_model(jcfg)
    dec = jax.jit(lambda p, c, b: api.decode_step(p, jcfg, c, b))
    ring, lg = jax.jit(make_prefill_step(jcfg))(
        jparams, {"tokens": jnp.asarray(tokens)})
    runs = {}
    for layout in LAYOUTS:
        cache = ring
        tok = jnp.argmax(lg[:, -1], -1).astype(jnp.int32)[:, None]
        toks = [tok]
        for i in range(STEPS + 1):
            b = {"token": tok,
                 "pos": jnp.asarray(_positions(i, layout), jnp.int32)}
            if i < STEPS:
                tok, cache = step(jparams, cache, b)
                toks.append(tok)
            else:
                last, cache = dec(jparams, cache, b)
        runs[layout] = {
            "prefill": np.asarray(lg, np.float32),
            "tokens": np.concatenate([np.asarray(t) for t in toks], 1),
            "last": np.asarray(last, np.float32)}
    return runs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax

    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.models.registry import get_model as jax_get_model
    from repro_torch import bridge
    from repro_torch.configs import get_smoke_config
    tmp = tmp_path_factory.mktemp("sharded_alternating")
    jcfg = jax_smoke_config(ARCH).replace(sliding_window=WINDOW)
    jparams = jax_get_model(jcfg).init(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    tokens = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (B, S)).astype(np.int32)
    payload = {"params": tree, "tokens": tokens}
    world = {}

    def run_world():
        try:
            world["out"] = spawn_local(WORLD, _port_ranks, payload,
                                       device_type="cpu",
                                       timeout_s=TIMEOUT_S,
                                       store_dir=str(tmp))
        except BaseException as e:              # re-raised below
            world["error"] = e
    th = threading.Thread(target=run_world)
    th.start()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with pytest.MonkeyPatch.context() as mp:
            for k in _ENV_KEYS[:3]:
                mp.delenv(k, raising=False)
            ref = _reference_runs(jcfg, jparams, tokens)
            cfg = get_smoke_config(ARCH).replace(sliding_window=WINDOW)
            params = bridge.params_from_jax(tree, cfg, device="cpu")
            plain = {layout: _port_run(cfg, params, tokens, layout)
                     for layout in LAYOUTS}
    finally:
        torch.set_num_threads(n)
        th.join()
    if "error" in world:
        raise world["error"]
    return world["out"], ref, plain


CASES = [(m, lay) for m in MESHES for lay in LAYOUTS]


@pytest.mark.parametrize("case", CASES, ids=["-".join(c) for c in CASES])
def test_sharded_alternating_serve_matches_reference(runs, case):
    world, ref, plain = runs
    layout = case[1]
    want, mine = ref[layout], plain[layout]
    assert np.array_equal(mine["tokens"], want["tokens"])
    for what in ("prefill", "last"):
        np.testing.assert_allclose(mine[what], want[what], atol=TOL_REF,
                                   rtol=0)
    for r in world:
        got = r["cases"][case]
        assert np.array_equal(got["gathered"], want["tokens"])
        rows = got["rows"]
        for what in ("prefill", "last"):
            np.testing.assert_allclose(got[what], want[what][rows],
                                       atol=TOL_REF, rtol=0)
            np.testing.assert_allclose(got[what], mine[what][rows],
                                       atol=TOL_COMBINE, rtol=0)


@pytest.mark.parametrize("mesh", MESHES)
def test_each_rank_holds_its_stripe_of_both_trees(runs, mesh):
    from repro_torch.dist import sharding
    world, _, plain = runs
    whole = {}
    for path, t in plain["sync"]["cache"].items():
        _, tree, name = path.split("/")
        whole.setdefault(tree, {})[name] = torch.from_numpy(t)
    assert whole["local"]["k"].shape[2] == WINDOW
    assert whole["global"]["k"].shape[2] == S
    shape, names = MESHES[mesh]
    sizes = dict(zip(names, shape))
    specs = sharding.cache_specs(whole, sizes)
    for tree in ("local", "global"):
        assert specs[tree]["k"] == (None, "data" if sizes["data"] > 1
                                    else None, "model", None, None)
    for r in world:
        got = r["cases"][(mesh, "sync")]
        assert got["cache_bytes"] * shape[0] * shape[1] == \
            plain["sync"]["cache_bytes"]
        want = sharding.local_shard(whole, specs, sizes,
                                    coords=r["coords"][mesh])
        for tree in ("local", "global"):
            for name, t in want[tree].items():
                g = got["cache"][f"/{tree}/{name}"]
                assert g.shape == tuple(t.shape), (tree, name)
                if name == "kv_pos":
                    assert np.array_equal(g, t.numpy()), (tree, name)
                else:
                    np.testing.assert_allclose(g, t.numpy(),
                                               atol=TOL_COMBINE, rtol=0)
