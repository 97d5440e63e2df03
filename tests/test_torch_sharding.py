"""The port's partition rules (``repro_torch.dist.sharding``) against the JAX
package's (``repro.dist.sharding``): pure functions of shapes, no process.

On both served smoke trees (qwen3-0.6b, fedtime-llama2-7b), each built by
its own side from a seed, and on FedTime's smoke tree with LoRA attached,
``param_specs`` and ``opt_state_specs`` equal the reference's spec for
spec, over ``{data 4, model 2}``, the production meshes and a few others;
``_batch_axes`` and ``_axis_candidates`` equal the reference's over a grid
of mesh shapes and sizes.  A port spec is the tuple of a
``PartitionSpec``'s entries.
"""

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import fedtime as jfedtime
from repro.core import lora as jlora
from repro.dist import sharding as jsharding
from repro.models.registry import get_model as jget_model
from repro_torch import configs
from repro_torch.core import fedtime, lora
from repro_torch.dist import sharding
from repro_torch.launch.mesh import PRODUCTION_MESH_SHAPES
from repro_torch.models.registry import get_model

ARCHS = ("qwen3-0.6b", "fedtime-llama2-7b")
MESH_SHAPES = {
    "data4_model2": {"data": 4, "model": 2},
    "single": PRODUCTION_MESH_SHAPES["single"],
    "multi": PRODUCTION_MESH_SHAPES["multi"],
    "data3": {"data": 3, "model": 1},
    "pod2_data2_model4": {"pod": 2, "data": 2, "model": 4},
    "model8": {"data": 1, "model": 8},
}


def _trees(kind: str):
    """(reference tree, port tree) of one smoke configuration, shapes only:
    the reference's through ``jax.eval_shape``, the port's on the meta
    device (the rules read nothing but shapes)."""
    key = jax.random.PRNGKey(0)
    g = torch.Generator()
    if kind == "fedtime_lora":
        jcfg = jconfigs.get_smoke_config("fedtime-llama2-7b")
        cfg = configs.get_smoke_config("fedtime-llama2-7b")
        jp = jax.eval_shape(lambda k: jlora.attach_lora(
            jfedtime.init(jcfg, k, num_channels=2), k, rank=4, alpha=8.0),
            key)
        p = lora.attach_lora(fedtime.init(cfg, g, num_channels=2,
                                          device="meta"), g, rank=4,
                             alpha=8.0)
        return jp, p
    jcfg = jconfigs.get_smoke_config(kind)
    cfg = configs.get_smoke_config(kind)
    jp = jax.eval_shape(lambda k: jget_model(jcfg).init(jcfg, k), key)
    p = get_model(cfg).init(cfg, g, device="meta")
    return jp, p


@pytest.fixture(scope="module", params=ARCHS + ("fedtime_lora",))
def trees(request):
    return _trees(request.param)


def _as_tuples(spec_tree):
    if isinstance(spec_tree, dict):
        return {k: _as_tuples(v) for k, v in spec_tree.items()}
    return tuple(spec_tree)


@pytest.mark.parametrize("mesh", MESH_SHAPES)
def test_param_and_opt_state_specs_equal_the_reference(trees, mesh):
    jp, p = trees
    shape = MESH_SHAPES[mesh]
    for name in ("param_specs", "opt_state_specs"):
        want = _as_tuples(getattr(jsharding, name)(jp, shape))
        got = getattr(sharding, name)(p, shape)
        assert got == want, name


def test_specs_shard_what_the_rules_say():
    """Spot checks on qwen3-0.6b's smoke tree over {data 4, model 2}: the
    spec tables are not all-replicated by accident."""
    _, p = _trees("qwen3-0.6b")
    shape = MESH_SHAPES["data4_model2"]
    ps = sharding.param_specs(p, shape)
    os_ = sharding.opt_state_specs(p, shape)
    flat = []

    def walk(a, b, path=""):
        if isinstance(a, dict):
            for k in a:
                walk(a[k], b[k], f"{path}/{k}")
        else:
            flat.append((path, a, b))
    walk(ps, os_)
    assert any("model" in s for _, s, _ in flat)
    assert any("data" in s for _, _, s in flat)
    for path, s, o in flat:
        assert len(o) in (0, len(s)) or not s   # widening keeps the length


def test_batch_axes_and_candidates_equal_the_reference():
    grid = [{}, {"data": 2}, {"data": 4, "model": 2}, {"pod": 2, "data": 2},
            {"pod": 2, "data": 16, "model": 16}, {"pod": 3, "data": 1},
            {"pod": 1, "data": 1, "model": 4}]
    for shape in grid:
        assert sharding._axis_candidates(shape) == \
            jsharding._axis_candidates(shape), shape
        for n in (1, 2, 3, 4, 6, 8, 32, 64, 96):
            assert sharding._batch_axes(n, shape) == \
                jsharding._batch_axes(n, shape), (shape, n)


def test_mesh_shape_of_a_mesh_object_and_a_dict():
    class Fake:
        mesh_dim_names = ("pod", "data", "model")
        shape = (2, 2, 2)
    assert sharding._mesh_shape(Fake()) == {"pod": 2, "data": 2, "model": 2}
    assert sharding._mesh_shape({"data": 4}) == {"data": 4}

    class Shaped:
        shape = {"data": 8, "model": 1}
    assert sharding._mesh_shape(Shaped()) == {"data": 8, "model": 1}


def test_collective_bytes_take_a_mesh_object():
    """``core.comm.collective_bytes_per_round`` reads a mesh's axes as the
    reference's does (its ``tests/test_dist_fed_mapping.py:75`` passes a
    ``Mesh``)."""
    from repro_torch.core import comm
    from repro_torch.dist import fed

    class Fake:
        mesh_dim_names = ("pod", "data", "model")
        shape = (2, 16, 16)
    _, p = _trees("fedtime_lora")
    for wire in comm.WIRE_FORMATS:
        by_mesh = comm.collective_bytes_per_round(p, Fake(), wire)
        by_dict = comm.collective_bytes_per_round(
            p, PRODUCTION_MESH_SHAPES["multi"], wire)
        assert by_mesh == by_dict == fed.expected_collective_bytes(
            p, Fake(), wire)
        assert np.all(np.asarray(list(by_mesh.values())) > 0)


def test_payload_and_ring_byte_helpers_equal_the_reference():
    from repro.dist import fed as jfed
    from repro_torch.dist import fed
    for nbytes in (4096, 1000, 4 * 8_388_608):
        for n in (1, 2, 8, 16):
            for wire in ("f32", "bf16", "int8"):
                assert fed.ring_allreduce_bytes(nbytes, n, wire=wire) == \
                    jfed.ring_allreduce_bytes(nbytes, n, wire=wire)
    jp, p = _trees("fedtime_lora")
    assert fed.adapter_payload_bytes(p) == jfed.adapter_payload_bytes(jp) > 0


# ---------------------------------------------------------------------------
# The serving rules: caches, batches, placement, the residual stream
# ---------------------------------------------------------------------------

CACHE_MESHES = {
    "d2m2": ({"data": 2, "model": 2}, 64),
    "m4": ({"data": 1, "model": 4}, 64),
    "odd": ({"data": 2, "model": 4}, 30),      # 30 slots: seq cannot shard
}
CACHE_KINDS = ("ring", "int8", "paged")
POOL = dict(n_blocks=12, block=16)


def _cache_trees(arch: str, kind: str, seq: int, monkeypatch):
    """(reference cache, port cache) of a served smoke config: layer-stacked
    rings of 4 rows and ``seq`` slots (float or int8), or a pool of
    ``POOL`` blocks (the pool's leaves are the ring's with the block count
    as the batch and the block size as the slots)."""
    from repro.models import transformer as jtf
    from repro_torch.models import transformer as ttf
    monkeypatch.setenv("REPRO_KV_INT8", "1" if kind == "int8" else "0")
    jcfg = jconfigs.get_smoke_config(arch)
    cfg = configs.get_smoke_config(arch)
    B, S = (POOL["n_blocks"], POOL["block"]) if kind == "paged" else (4, seq)
    jc = jax.eval_shape(lambda: jtf.init_cache(jcfg, B, S))
    c = ttf.init_cache(cfg, B, S, device="cpu")
    return jc, c


@pytest.mark.parametrize("mode", [None, "seq", "heads"])
@pytest.mark.parametrize("mesh", CACHE_MESHES)
@pytest.mark.parametrize("kind", CACHE_KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_equal_the_reference(arch, kind, mesh, mode,
                                         monkeypatch):
    """``cache_specs`` over the served smoke caches, mode given or read
    from ``REPRO_CACHE_SHARD`` (both sides read it), leaf for leaf."""
    shape, seq = CACHE_MESHES[mesh]
    jc, c = _cache_trees(arch, kind, seq, monkeypatch)
    monkeypatch.setenv("REPRO_CACHE_SHARD", mode or "heads")
    for m in (mode, None) if mode else (None,):
        want = _as_tuples(jsharding.cache_specs(jc, shape, m))
        assert sharding.cache_specs(c, shape, m) == want, m
    monkeypatch.delenv("REPRO_CACHE_SHARD")
    want = _as_tuples(jsharding.cache_specs(jc, shape))
    got = sharding.cache_specs(c, shape)
    assert got == want
    if kind != "paged" and mesh != "odd":        # the seq layout
        assert got["k"][-3] == "model" and got["kv_pos"][-1] == "model"


def test_cache_specs_read_a_pool_as_the_reference_does(monkeypatch):
    """A pool's (L, n_blocks, bs, Hk, D) leaf reads as if n_blocks were
    the batch and bs the slots, on both sides; the port lays a pool out by
    ``dist.decode.pool_specs`` instead: the block axis over ``model``."""
    from repro_torch.dist.decode import pool_specs
    jc, c = _cache_trees("qwen3-0.6b", "paged", 0, monkeypatch)
    shape = {"data": 2, "model": 4}
    got = sharding.cache_specs(c, shape)
    assert got == _as_tuples(jsharding.cache_specs(jc, shape))
    assert got["k"] == (None, "data", "model", None, None)
    assert pool_specs(c, shape) == {"k": (None, "model", None, None, None),
                                    "v": (None, "model", None, None, None),
                                    "kv_pos": (None, "model", None)}
    with pytest.raises(ValueError, match="do not split"):
        pool_specs(c, {"data": 1, "model": 8})


BATCHES = {                                   # {name: shape}
    "prefill": {"tokens": lambda B: (B, 16)},
    "sync": {"token": lambda B: (B, 1), "pos": lambda B: ()},
    "paged": {"token": lambda B: (B, 1), "pos": lambda B: (B,),
              "block_tbl": lambda B: (B, 4)},
}


def _batch(name: str, B: int, zeros):
    return {k: zeros(f(B)) for k, f in BATCHES[name].items()}


@pytest.mark.parametrize("B", [4, 3, 1, 8])
@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("mesh", ["data4_model2", "multi", "model8",
                                  "pod2_data2_model4"])
def test_data_specs_equal_the_reference(batch, B, mesh):
    import jax.numpy as jnp
    shape = MESH_SHAPES[mesh]
    want = _as_tuples(jsharding.data_specs(
        _batch(batch, B, lambda s: jnp.zeros(s, jnp.int32)), shape))
    assert sharding.data_specs(
        _batch(batch, B, lambda s: torch.zeros(s, dtype=torch.int32)),
        shape) == want


def test_data_specs_of_a_list_and_a_number():
    """The port's additions: a list (sampling's per-row generators) shards
    by its length, a Python number (``ring_len``) replicates."""
    specs = sharding.data_specs({"generators": [None] * 4, "ring_len": 64},
                                {"data": 2, "model": 2})
    assert specs == {"generators": ("data",), "ring_len": ()}
    got = sharding.local_shard({"generators": list("abcd"), "ring_len": 64},
                               specs, {"data": 2, "model": 2},
                               coords={"data": 1, "model": 0})
    assert got == {"generators": ["c", "d"], "ring_len": 64}


def test_to_shardings_equal_the_reference(monkeypatch):
    """``to_shardings`` gives each leaf its ``Placement`` (spec, mesh,
    global shape); the reference's ``NamedSharding`` carries the same
    spec.  ``local_shape`` is a rank's piece."""
    from jax.sharding import Mesh
    jc, c = _cache_trees("qwen3-0.6b", "ring", 64, monkeypatch)
    shape = {"data": 2, "model": 2}
    specs = sharding.cache_specs(c, shape)
    jmesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                 ("data", "model"))
    want = jsharding.to_shardings(jsharding.cache_specs(jc, shape), jmesh)
    got = sharding.to_shardings(specs, shape, c)
    for name in c:
        assert tuple(want[name].spec) == got[name].spec
        assert got[name].mesh is shape
        assert got[name].shape == tuple(c[name].shape)
    assert got["k"].local_shape() == (2, 2, 32, 2, 64)
    assert got["kv_pos"].local_shape() == (2, 2, 32)
    assert sharding.to_shardings(specs, shape)["k"].shape is None


@pytest.mark.parametrize("decode", [False, True])
def test_residual_constraint_equals_the_reference(decode):
    """The reference's layout hint leaves the values as they are, under a
    mesh or not; the port's returns ``x`` itself."""
    from jax.sharding import Mesh
    x = np.random.default_rng(0).standard_normal((2, 8, 16)).astype(
        np.float32)
    t = torch.from_numpy(x)
    jmesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                 ("data", "model"))
    for ctx in (jmesh, None):
        if ctx is None:
            want = jsharding.residual_constraint(x, decode=decode)
        else:
            with ctx:
                want = jsharding.residual_constraint(jax.numpy.asarray(x),
                                                     decode=decode)
        assert np.array_equal(np.asarray(want), x)
    assert sharding.residual_constraint(t, decode=decode) is t
    with sharding.use_mesh({"data": 2, "model": 2}):
        assert sharding.residual_constraint(t, decode=decode) is t


def _all_coords(shape: dict):
    import itertools
    names = list(shape)
    for idx in itertools.product(*(range(shape[n]) for n in names)):
        yield dict(zip(names, idx))


def _reassemble(pieces, spec, shape: dict, nd: int):
    """Put each rank's piece back at its block offsets (pieces of a
    replicated dim must agree)."""
    out = None
    for coords, piece in pieces:
        if out is None:
            full = list(piece.shape)
            for d, e in enumerate(sharding._entries(spec, nd)):
                full[d] *= sharding._ways(e, shape)
            out = torch.full(full, -7, dtype=piece.dtype)
        index = []
        for d, e in enumerate(sharding._entries(spec, nd)):
            i = sharding._block(e, shape, coords) if e is not None else 0
            n = piece.shape[d]
            index.append(slice(i * n, (i + 1) * n))
        seen = out[tuple(index)]
        assert torch.all((seen == -7) | (seen == piece))
        out[tuple(index)] = piece
    return out


@pytest.mark.parametrize("mode", ["seq", "heads"])
@pytest.mark.parametrize("mesh", CACHE_MESHES)
@pytest.mark.parametrize("kind", CACHE_KINDS)
def test_local_shard_reassembles_the_whole_tree(kind, mesh, mode,
                                                monkeypatch):
    """Every rank's ``local_shard`` under each spec, put back at its block
    offsets, is the whole tree exactly; each piece has its placement's
    ``local_shape``, a sharded leaf is its own copy, and a pool's
    ``pool_specs`` pieces reassemble too."""
    from repro_torch.dist.decode import pool_specs
    shape, seq = CACHE_MESHES[mesh]
    _, c = _cache_trees("fedtime-llama2-7b", kind, seq, monkeypatch)
    g = torch.Generator().manual_seed(0)
    c = {n: (torch.randint(-100, 100, t.shape, generator=g).to(t.dtype))
         for n, t in c.items()}
    spec_sets = [sharding.cache_specs(c, shape, mode)]
    if kind == "paged" and mesh != "odd":
        spec_sets.append(pool_specs(c, shape))
    for specs in spec_sets:
        places = sharding.to_shardings(specs, shape, c)
        pieces = {n: [] for n in c}
        for coords in _all_coords(shape):
            local = sharding.local_shard(c, specs, shape, coords=coords)
            for n, t in local.items():
                assert tuple(t.shape) == places[n].local_shape(), n
                if specs[n]:
                    assert t.data_ptr() != c[n].data_ptr()
                pieces[n].append((coords, t))
        for n, t in c.items():
            assert torch.equal(_reassemble(pieces[n], specs[n], shape,
                                           t.ndim), t), n


# ---------------------------------------------------------------------------
# The serving steps with no mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("force_window", [0, 8])
def test_make_prefill_step_equals_the_reference(force_window, monkeypatch):
    from repro.launch import steps as jsteps
    from repro_torch import bridge
    from repro_torch.launch import steps
    monkeypatch.delenv("REPRO_KV_INT8", raising=False)
    jcfg = jconfigs.get_smoke_config("qwen3-0.6b")
    cfg = configs.get_smoke_config("qwen3-0.6b")
    jparams = jget_model(jcfg).init(jcfg, jax.random.PRNGKey(0))
    params = bridge.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                    device="cpu")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 12))
    jcache, jlg = jsteps.make_prefill_step(jcfg, force_window=force_window)(
        jparams, {"tokens": jax.numpy.asarray(tokens)})
    cache, lg = steps.make_prefill_step(cfg, force_window=force_window)(
        params, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=1e-4,
                               rtol=0)
    assert set(cache) == set(jcache)
    assert cache["k"].shape == jcache["k"].shape
    np.testing.assert_allclose(cache["k"].numpy(), np.asarray(jcache["k"]),
                               atol=1e-4, rtol=0)
    assert np.array_equal(cache["kv_pos"].numpy(),
                          np.asarray(jcache["kv_pos"]))


@pytest.mark.parametrize("window", [0, 1024])
@pytest.mark.parametrize("family", ["dense", "ssm"])
def test_decode_force_window_equals_the_reference(window, family):
    from repro.launch import steps as jsteps
    from repro_torch.launch import steps
    for arch in ARCHS:
        jcfg = jconfigs.get_config(arch).replace(sliding_window=window,
                                                 family=family)
        cfg = configs.get_config(arch).replace(sliding_window=window,
                                               family=family)
        for n in (1, 4096, 262_143, 262_144, 524_288):
            assert steps.decode_force_window(cfg, n) == \
                jsteps.decode_force_window(jcfg, n), (arch, n)
        full = window == 0 and family == "dense"
        assert (steps.decode_force_window(cfg, 262_144) > 0) == full
