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
