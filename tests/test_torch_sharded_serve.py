"""The port's sharded serving path against the JAX package's unsharded one,
on one 4-rank gloo world on the CPU.

Each rank holds only its own pieces: its rows of the batch
(``data_specs``), its stripe of the cache (``cache_specs``' seq layout, or
a paged pool's block stripe, ``dist.decode.pool_specs``) and the
replicated weights, carried over from the reference by the bridge.  On
``(data 2, model 2)`` and ``(data 1, model 4)``, for both served smoke
configs (qwen3-0.6b: G = 2, D 64; fedtime-llama2-7b: G = 1, D 32; f32),
the world runs ``make_prefill_step`` on a 16-token prompt (B 4; a ring of
16 slots, so 4 or 8 a stripe) and 8 greedy steps of ``make_serve_step``,
which wrap the ring, then one more ``decode_step`` for its logits:

  * synchronous (one position), ragged (lane 1 inactive from step 3,
    lane 2 joining at step 2) and paged (a 16-block pool of 4 slots whose
    table straddles the stripes, shares a block between two rows and
    holds a -1 entry; ragged positions as above);
  * with a float cache and with ``REPRO_KV_INT8=1``.

The reference's unsharded ``make_prefill_step`` / ``make_serve_step`` /
``decode_step`` run in this process on the same weights and prompts.  A
sampled and guarded step (``sampling=True, guard=True``: seeded
generators, a poisoned lane, an inactive one) gathered over the batch
axes must equal the port's unsharded step.
Greedy tokens (gathered over the batch axes) must equal the reference's
exactly; logits must be within ``TOL_REF`` of the reference's and within
``TOL_COMBINE`` of the port's own unsharded run (the combine's f32
rounding: the partials of each stripe merged over ``model`` instead of
inside one call).  Each rank's prefilled stripe must equal its piece of
the unsharded cache under ``cache_specs`` and hold exactly the whole
cache's bytes / (batch ways x model ways); the attention output of an
inactive lane must be exactly 0; and a heads layout or a ring that does
not divide must raise ``NotImplementedError``.
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
ARCHS = ("qwen3-0.6b", "fedtime-llama2-7b")
MESHES = {"d2m2": ((2, 2), ("data", "model")),
          "d1m4": ((1, 4), ("data", "model"))}
LAYOUTS = ("sync", "ragged", "paged")
KVS = ("float", "int8")
B, S, STEPS = 4, 16, 8
BS, N_BLOCKS = 4, 16
# blocks straddle every stripe; rows 0 and 2 share block 5 at logical index
# 3 (slots 12-15, which 8 steps past a 16-token prompt never write); row 3's
# entry 2 is ungranted
TABLE = np.asarray([[0, 9, 14, 5], [12, 3, 7, 10], [2, 13, 8, 5],
                    [15, 4, -1, 11]], np.int32)
# int8: jitted, XLA's CPU compiler turns the quantizer's divisions into
# products with reciprocals, so a code can land one step away from the
# port's (as on the wire, tests/test_torch_wire_hop.py); that moved logits
# by 1.63e-3 at most here, with every token equal
TOL_REF = {"float": 1e-4, "int8": 5e-3}
# the port's own unsharded run: the combine's f32 rounding (float); with
# int8 a hidden state that differs in its last bits can move a quantized
# K/V code one step, as against the reference
TOL_COMBINE = {"float": 1e-5, "int8": TOL_REF["int8"]}
_ENV_KEYS = ("REPRO_CACHE_SHARD", "REPRO_KV_INT8", "REPRO_FORCE_KERNELS",
             "XLA_FLAGS")


def _yield_cpu():
    """Lowest CPU priority for this module's processes: the suite runs its
    files in parallel workers, and some of their tests bound wall time."""
    os.nice(19)


@contextlib.contextmanager
def _kv_env(kv: str):
    """``REPRO_KV_INT8`` for one run, restored after (both packages read it
    when a cache is built)."""
    old = os.environ.get("REPRO_KV_INT8")
    os.environ["REPRO_KV_INT8"] = "1" if kv == "int8" else "0"
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("REPRO_KV_INT8", None)
        else:
            os.environ["REPRO_KV_INT8"] = old


def _positions(i: int, layout: str):
    """Step ``i``'s positions: an int (synchronous) or (B,) int32 with -1
    for an inactive lane."""
    if layout == "sync":
        return S + i
    pos = np.full(B, S + i, np.int32)
    if i >= 3:
        pos[1] = -1
    pos[2] = -1 if i < 2 else S + i - 2
    return pos


def _to_pool(ring):
    """(L, B, S, ...) ring leaf (a tensor, or an array) -> (L, N_BLOCKS, BS,
    ...) pool under ``TABLE`` (a shared block holds its last writer's
    tile)."""
    shape = (ring.shape[0], N_BLOCKS, BS) + tuple(ring.shape[3:])
    if torch.is_tensor(ring):
        pool = torch.full(shape, -1 if ring.dtype == torch.int32 else 0,
                          dtype=ring.dtype)
    else:
        ring = np.asarray(ring)
        pool = np.full(shape, -1 if ring.dtype == np.int32 else 0,
                       ring.dtype)
    for b in range(B):
        for j, pb in enumerate(TABLE[b]):
            if pb >= 0:
                pool[:, pb] = ring[:, b, j * BS:(j + 1) * BS]
    return pool


def _np(x):
    if torch.is_tensor(x):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(x)


# ---------------------------------------------------------------------------
# The port: one run, sharded (in a rank) or not
# ---------------------------------------------------------------------------

def _port_run(cfg, params, tokens, layout, mesh=None):
    """Prefill, ``STEPS`` greedy serve steps and one ``decode_step``; under
    ``mesh`` this rank's rows and stripe.  Returns numpy arrays of this
    rank's rows and the cache's bytes after the prefill."""
    from repro_torch.dist import sharding
    from repro_torch.dist.decode import pool_specs
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
    prefill = make_prefill_step(cfg)
    step = make_serve_step(cfg)
    extra = {}
    if layout == "paged":
        # the pool is made from the whole batch's rings, then striped
        whole, lg = make_prefill_step(cfg)(
            params, {"tokens": torch.from_numpy(tokens)})
        cache = {n: _to_pool(t) for n, t in whole.items()}
        if mesh is not None:
            cache = sharding.local_shard(cache, pool_specs(cache, mesh), mesh)
        lg = lg[torch.from_numpy(rows)]
        extra = {"block_tbl": torch.from_numpy(TABLE[rows]), "ring_len": S}
    else:
        with ctx():
            cache, lg = prefill(params, batch)
    out = {"rows": rows, "prefill": _np(lg),
           "cache_bytes": sum(t.nbytes for t in cache.values()),
           "cache": {n: t.clone() for n, t in cache.items()}}
    tok = lg[:, -1].argmax(-1).to(torch.int32)[:, None]
    toks = [tok]
    for i in range(STEPS + 1):
        pos = _positions(i, layout)
        if not isinstance(pos, int):
            pos = torch.from_numpy(pos[rows])
        b = {"token": tok, "pos": pos, **extra}
        with ctx():
            if i < STEPS:
                tok, cache = step(params, cache, b)
                toks.append(tok)
            else:
                last, cache = get_model(cfg).decode_step(params, cfg, cache,
                                                         b)
    out["tokens"] = torch.cat(toks, 1).numpy()
    out["last"] = _np(last)
    return out


def _tree(cache):
    return {n: _np(t) for n, t in cache.items()}


def _port_ranks(payload):
    """One rank: every (mesh, arch, layout, cache) case, then the refused
    layouts."""
    _yield_cpu()
    for k in _ENV_KEYS:
        os.environ.pop(k, None)
    import torch.distributed as dist

    from repro_torch import bridge
    from repro_torch.configs import get_smoke_config
    from repro_torch.dist import collectives, sharding
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models.layers import attention

    idle = []
    real = attention.stripe_flash_decode

    def spy(q, k, v, kv_pos, q_pos, mesh, **kw):
        o = real(q, k, v, kv_pos, q_pos, mesh, **kw)
        if torch.is_tensor(q_pos) and q_pos.ndim == 1 and \
                bool((q_pos < 0).any()):
            idle.append(float(o[q_pos < 0].abs().max()))
        return o
    attention.stripe_flash_decode = spy

    out = {"rank": dist.get_rank(), "cases": {}, "coords": {}}
    meshes = {name: make_mesh(shape, names, device_type="cpu")
              for name, (shape, names) in MESHES.items()}
    for name, mesh in meshes.items():
        out["coords"][name] = {ax: mesh.get_local_rank(ax)
                               for ax in mesh.mesh_dim_names}
    for arch in ARCHS:
        cfg = get_smoke_config(arch)
        params = bridge.params_from_jax(payload[arch]["params"], cfg,
                                        device="cpu")
        tokens = payload[arch]["tokens"]
        for name, mesh in meshes.items():
            bax = sharding.data_specs({"t": torch.zeros(B)}, mesh)["t"]
            for layout in LAYOUTS:
                for kv in KVS:
                    del idle[:]
                    with _kv_env(kv):
                        r = _port_run(cfg, params, tokens, layout, mesh)
                    toks = torch.from_numpy(r["tokens"])
                    if bax:
                        toks = collectives.all_gather(toks, mesh, bax[0],
                                                      dim=0)
                    r["gathered"] = toks.numpy()
                    r["cache"] = _tree(r["cache"])
                    r["idle"] = list(idle)
                    out["cases"][(arch, name, layout, kv)] = r
    # the refused layouts: model on the heads, a ring that does not divide
    cfg = get_smoke_config(ARCHS[0])
    params = bridge.params_from_jax(payload[ARCHS[0]]["params"], cfg,
                                    device="cpu")
    mesh = meshes["d2m2"]
    batch = sharding.local_shard(
        {"tokens": torch.from_numpy(payload[ARCHS[0]]["tokens"])},
        {"tokens": ("data", None)}, mesh)
    refused = {}
    for what, tokens, env in (
            ("heads", batch["tokens"], "heads"),
            ("odd ring", batch["tokens"][:, :S - 1], "seq")):
        os.environ["REPRO_CACHE_SHARD"] = env
        try:
            with sharding.use_mesh(mesh):
                make_prefill_step(cfg)(params, {"tokens": tokens})
            refused[what] = "no error"
        except NotImplementedError as e:
            refused[what] = str(e)
        finally:
            os.environ.pop("REPRO_CACHE_SHARD", None)
    # a decode step on a seq stripe under the heads switch
    with sharding.use_mesh(mesh):
        cache, lg = make_prefill_step(cfg)(params, batch)
    os.environ["REPRO_CACHE_SHARD"] = "heads"
    try:
        from repro_torch.launch.steps import make_serve_step
        with sharding.use_mesh(mesh):
            make_serve_step(cfg)(params, cache, {
                "token": lg[:, -1].argmax(-1)[:, None], "pos": S})
        refused["heads decode"] = "no error"
    except NotImplementedError as e:
        refused["heads decode"] = str(e)
    finally:
        os.environ.pop("REPRO_CACHE_SHARD", None)
    out["refused"] = refused
    out["sample_guard"] = {name: _sample_guard_step(cfg, params, payload[
        ARCHS[0]]["tokens"], meshes[name]) for name in MESHES}
    return out


def _sample_guard_step(cfg, params, tokens, mesh=None):
    """A prefill and two ragged steps of ``make_serve_step(sampling=True,
    guard=True)``: rows 0 and 2 sampled from seeded generators (row 2 also
    cut by top-k and top-p), rows 1 and 3 greedy; lane 1 inactive at the
    second step, lane 3 poisoned at the first.  Returns each step's tokens
    and ``ok`` of the whole batch (gathered under ``mesh``)."""
    from repro_torch.dist import collectives, sharding
    from repro_torch.launch.steps import make_prefill_step, make_serve_step

    def ctx():
        return (sharding.use_mesh(mesh) if mesh is not None
                else contextlib.nullcontext())
    batch = {"tokens": torch.from_numpy(tokens)}
    bax = None
    if mesh is not None:
        specs = sharding.data_specs(batch, mesh)
        bax = specs["tokens"][0] if specs["tokens"] else None
        batch = sharding.local_shard(batch, specs, mesh)
    with ctx():
        cache, lg = make_prefill_step(cfg)(params, batch)
    step = make_serve_step(cfg, sampling=True, guard=True)
    tok = lg[:, -1].argmax(-1).to(torch.int32)[:, None]
    out = []
    for i in range(2):
        pos = torch.full((B,), S + i, dtype=torch.int32)
        if i == 1:
            pos[1] = -1
        b = {"pos": pos,
             "temperature": torch.tensor([0.8, 0.0, 1.2, 0.0]),
             "top_k": torch.tensor([0, 0, 5, 0]),
             "top_p": torch.tensor([1.0, 1.0, 0.9, 1.0]),
             "generators": [torch.Generator().manual_seed(100 * i + r)
                            if r in (0, 2) else None for r in range(B)],
             "poison": torch.tensor([False, False, False, i == 0])}
        if mesh is not None:                  # the rows of this rank
            b = sharding.local_shard(b, sharding.data_specs(b, mesh), mesh)
        with ctx():
            tok, ok, cache = step(params, cache, {"token": tok, **b})
        got = torch.cat([tok, ok[:, None].to(torch.int32)], 1)
        if bax is not None:
            got = collectives.all_gather(got, mesh, bax, dim=0)
        out.append(got.numpy())
    return np.stack(out)


# ---------------------------------------------------------------------------
# The reference, in this process, unsharded
# ---------------------------------------------------------------------------

def _reference_runs(jcfg, jparams, tokens):
    """The reference's unsharded runs of every layout under the cache type
    ``REPRO_KV_INT8`` says (read when the steps are traced): one prefill,
    then each layout's steps; one jitted function of each kind, traced
    once a layout."""
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
        cache, extra = ring, {}
        if layout == "paged":
            cache = {n: jnp.asarray(_to_pool(t)) for n, t in ring.items()}
            extra = {"block_tbl": jnp.asarray(TABLE),
                     "ring_len": jnp.asarray(S, jnp.int32)}
        tok = jnp.argmax(lg[:, -1], -1).astype(jnp.int32)[:, None]
        toks = [tok]
        for i in range(STEPS + 1):
            b = {"token": tok, "pos": jnp.asarray(_positions(i, layout),
                                                  jnp.int32), **extra}
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
    tmp = tmp_path_factory.mktemp("sharded_serve")
    payload, models = {}, {}
    for i, arch in enumerate(ARCHS):
        jcfg = jax_smoke_config(arch)
        jparams = jax_get_model(jcfg).init(jcfg, jax.random.PRNGKey(i))
        tree = jax.tree.map(np.asarray, jparams)
        tokens = np.random.default_rng(i).integers(
            0, jcfg.vocab_size, (B, S)).astype(np.int32)
        payload[arch] = {"params": tree, "tokens": tokens}
        cfg = get_smoke_config(arch)
        models[arch] = (jcfg, jparams, cfg,
                        bridge.params_from_jax(tree, cfg, device="cpu"))
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
    ref, plain = {}, {}
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with pytest.MonkeyPatch.context() as mp:
            for k in _ENV_KEYS[:3]:
                mp.delenv(k, raising=False)
            for arch, (jcfg, jparams, cfg, params) in models.items():
                for kv in KVS:
                    with _kv_env(kv):
                        got = _reference_runs(jcfg, jparams,
                                              payload[arch]["tokens"])
                        for layout in LAYOUTS:
                            ref[(arch, layout, kv)] = got[layout]
                            r = _port_run(cfg, params,
                                          payload[arch]["tokens"], layout)
                            r["cache"] = _tree(r["cache"])
                            plain[(arch, layout, kv)] = r
        jcfg, _, cfg, params = models[ARCHS[0]]
        plain["sample_guard"] = _sample_guard_step(
            cfg, params, payload[ARCHS[0]]["tokens"])
    finally:
        torch.set_num_threads(n)
        th.join()
    if "error" in world:
        raise world["error"]
    return world["out"], ref, plain


CASES = [(a, m, lay, kv) for a in ARCHS for m in MESHES for lay in LAYOUTS
         for kv in KVS]
CASE_IDS = ["-".join(c) for c in CASES]


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_sharded_serve_matches_reference(runs, case):
    """Tokens equal the reference's unsharded run exactly; prefill and last
    logits within ``TOL_REF`` of the reference's and ``TOL_COMBINE`` of the
    port's own unsharded run."""
    world, ref, plain = runs
    arch, _, layout, kv = case
    want, mine = ref[(arch, layout, kv)], plain[(arch, layout, kv)]
    assert np.array_equal(mine["tokens"], want["tokens"])
    for what in ("prefill", "last"):
        np.testing.assert_allclose(mine[what], want[what], atol=TOL_REF[kv],
                                   rtol=0)
    for r in world:
        got = r["cases"][case]
        assert np.array_equal(got["gathered"], want["tokens"])
        rows = got["rows"]
        assert np.array_equal(got["tokens"], want["tokens"][rows])
        for what in ("prefill", "last"):
            np.testing.assert_allclose(got[what], want[what][rows],
                                       atol=TOL_REF[kv], rtol=0)
            np.testing.assert_allclose(got[what], mine[what][rows],
                                       atol=TOL_COMBINE[kv], rtol=0)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_inactive_lane_attends_to_exactly_zero(runs, arch, mesh):
    """Each rank's rows hold an idle lane at some step (lane 1 from step
    3, lane 2 before step 2): its sharded attention output is exactly 0 in
    every layer of every such step."""
    world, _, _ = runs
    for r in world:
        for layout in ("ragged", "paged"):
            for kv in KVS:
                idle = r["cases"][(arch, mesh, layout, kv)]["idle"]
                assert idle and all(x == 0.0 for x in idle), idle


@pytest.mark.parametrize("case", [c for c in CASES if c[2] != "paged"],
                         ids=[i for c, i in zip(CASES, CASE_IDS)
                              if c[2] != "paged"])
def test_prefilled_stripe_is_the_whole_cache_piece(runs, case):
    """After the prefill each rank holds exactly its piece of the unsharded
    cache under ``cache_specs`` (values within the f32 rounding of a
    smaller batch, positions exactly) and exactly the whole cache's bytes
    / (batch ways x model ways)."""
    from repro_torch.dist import sharding
    world, _, plain = runs
    arch, mesh, layout, kv = case
    whole = {n: torch.from_numpy(t) for n, t in
             plain[(arch, layout, kv)]["cache"].items()}
    shape, names = MESHES[mesh]
    sizes = dict(zip(names, shape))
    specs = sharding.cache_specs(whole, sizes)
    assert specs["k"] == (None, "data" if sizes["data"] > 1 else None,
                          "model", None, None)
    whole_bytes = plain[(arch, layout, kv)]["cache_bytes"]
    for r in world:
        got = r["cases"][case]
        want = sharding.local_shard(whole, specs, sizes,
                                    coords=r["coords"][mesh])
        assert got["cache_bytes"] * shape[0] * shape[1] == whole_bytes
        for n, t in want.items():
            g = got["cache"][n]
            assert g.shape == tuple(t.shape), n
            if n == "kv_pos" or t.dtype == torch.int8:
                assert np.array_equal(g, _np(t)), n
            else:
                np.testing.assert_allclose(g, _np(t),
                                           atol=TOL_COMBINE["float"], rtol=0)


@pytest.mark.parametrize("mesh", MESHES)
def test_paged_pool_stripe_bytes(runs, mesh):
    """A rank holds the pool's block stripe: the whole pool's bytes / model
    ways (the pool is replicated over ``data``)."""
    world, _, plain = runs
    ways = MESHES[mesh][0][1]
    for arch in ARCHS:
        for kv in KVS:
            whole = plain[(arch, "paged", kv)]["cache_bytes"]
            for r in world:
                got = r["cases"][(arch, mesh, "paged", kv)]
                assert got["cache_bytes"] * ways == whole
                assert got["cache"]["k"].shape[1] == N_BLOCKS // ways


@pytest.mark.parametrize("what", ["heads", "odd ring", "heads decode"])
def test_layouts_the_port_refuses(runs, what):
    world, _, _ = runs
    for r in world:
        assert "tensor-parallel" in r["refused"][what], r["refused"][what]


@pytest.mark.parametrize("mesh", MESHES)
def test_sampling_and_guard_under_a_mesh(runs, mesh):
    """``make_serve_step(sampling=True, guard=True)`` on each rank's rows,
    gathered: the same sampled and greedy tokens and the same ``ok`` as
    the unsharded step (the poisoned lane not ok at its step, the
    inactive lane ok and passed through)."""
    world, _, plain = runs
    want = plain["sample_guard"]
    assert want[0, 3, 1] == 0 and want[1, 3, 1] == 1   # poison, then ok
    assert want[1, 1, 1] == 1                          # inactive: ok
    for r in world:
        assert np.array_equal(r["sample_guard"][mesh], want)
