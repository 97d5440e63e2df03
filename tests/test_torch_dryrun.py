"""The port's dry run (``repro_torch.launch.dryrun``, ``launch.specs``,
``launch.mesh.dry_world``) against the reference's (``repro.launch.specs``,
``repro.launch.hlo_cost``), on the CPU with no card.

The reference's spec functions take a plain ``{axis: size}`` mesh, so its
side runs in this process with no emulated devices (nothing sets
``XLA_FLAGS``).  Held here: the input shapes field by field;
``param_shapes`` leaf by leaf at full width, with ``fed`` both ways; the
local shape of every argument ``dryrun_args`` gives rank 0 of a fake
256 / 512-rank world against the reference's spec applied to the global
shape (cache, batch and moments; the parameters are whole on every rank,
the port's one divergence, which also keeps the moments whole over
``model``); each step's counted FLOPs at smoke size against the
reference's ``hlo_cost.analyze`` of the same step compiled on one device;
the counter's peak on fakes against the same counter on real tensors;
the federated step's all-reduce bytes in a fake world against their
closed form; the skip table and the ring stripe that the fake run
derives from shapes against the host reads they replace; the CLI.  No
fake group outlives its test.
"""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro import configs as jconfigs
from repro.configs import base as jbase
from repro.dist import sharding as jsharding
from repro.launch import hlo_cost as jhlo_cost
from repro.launch import specs as jspecs
from repro.launch import steps as jsteps
from repro.models.registry import get_model as jget_model
from repro_torch import configs
from repro_torch import tree as tree_util
from repro_torch.core.lora import lora_tree
from repro_torch.launch import dryrun, specs
from repro_torch.launch.hlo_cost import analyze, count
from repro_torch.launch.mesh import (PRODUCTION_MESH_SHAPES, dry_world,
                                     make_production_mesh)
from repro_torch.launch.steps import (make_fed_train_step,
                                      make_prefill_step, make_serve_step,
                                      make_train_step)
from repro_torch.models.layers import attention
from repro_torch.models import transformer, zamba2

ARCHS = ("qwen3-0.6b", "smollm-360m", "fedtime-llama2-7b")
SHAPES = [s.name for s in configs.INPUT_SHAPES]


@pytest.fixture(autouse=True)
def _no_group_left():
    assert not dist.is_initialized()
    yield
    assert not dist.is_initialized()


def _flat(tree, prefix=""):
    """{path: (shape, dtype name)} of a nested dict of tensors or of
    ``jax.ShapeDtypeStruct``s."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    dt = tree.dtype
    name = str(dt)[6:] if isinstance(dt, torch.dtype) else jnp.dtype(dt).name
    return {prefix: (tuple(tree.shape), name)}


def _local(shape, spec, mesh: dict, drop=()):
    """The local shape of a global ``shape`` under a reference spec on a
    ``{axis: size}`` mesh (axes in ``drop`` not sharding)."""
    entries = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
    out = []
    for n, e in zip(shape, entries):
        axes = () if e is None else (e,) if isinstance(e, str) else e
        out.append(n // math.prod(mesh[a] for a in axes if a not in drop))
    return tuple(out)


def test_input_shapes_equal_the_reference():
    assert [tuple(vars(s).values()) for s in configs.INPUT_SHAPES] == \
        [tuple(vars(s).values()) for s in jbase.INPUT_SHAPES]
    assert configs.SHAPES_BY_NAME.keys() == jbase.SHAPES_BY_NAME.keys()
    assert configs.ASSIGNED_ARCHS == tuple(
        a for a in jconfigs.ASSIGNED_ARCHS if a in configs.ALL_ARCHS)


@pytest.mark.parametrize("fed", [False, True])
@pytest.mark.parametrize("arch", ARCHS + ("zamba2-2.7b",
                                          "seamless-m4t-medium"))
def test_param_shapes_equal_the_reference(arch, fed):
    """Full width: every leaf's path, shape and type, fakes against the
    reference's ``jax.eval_shape`` tree (with ``fed``: LoRA at the
    family's targets and the NF4 base)."""
    want = _flat(jspecs.param_shapes(jconfigs.get_config(arch), fed=fed))
    got = _flat(specs.param_shapes(configs.get_config(arch), fed=fed))
    assert got == want


def _reference_layouts(arch, shape, mesh: dict, fed: bool):
    """The reference's global trees of one pair and its specs of them:
    {"batch": (tree, specs), "cache": ..., "params": ..., }."""
    jcfg = jconfigs.get_config(arch)
    s = jbase.SHAPES_BY_NAME[shape]
    api = jget_model(jcfg)
    from repro.models.registry import (decode_batch_shapes,
                                       train_batch_shapes)
    out = {}
    if s.kind == "decode":
        fw = jsteps.decode_force_window(jcfg, s.seq_len)
        cache = jax.eval_shape(lambda: api.init_cache(
            jcfg, s.global_batch, s.seq_len, force_window=fw,
            dtype=jnp.bfloat16))
        out["cache"] = (cache, jsharding.cache_specs(cache, mesh))
        batch = {k: jax.ShapeDtypeStruct(*v) for k, v in
                 decode_batch_shapes(jcfg, s.global_batch).items()}
    else:
        batch = {k: jax.ShapeDtypeStruct(*v) for k, v in
                 train_batch_shapes(jcfg, s.global_batch,
                                    s.seq_len).items()}
        if s.kind == "prefill":
            batch.pop("labels")
    out["batch"] = (batch, jsharding.data_specs(batch, mesh))
    if s.kind == "train":
        params = jspecs.param_shapes(jcfg, fed=fed)
        if fed:
            from repro.core.lora import lora_tree as jlora_tree
            params = jax.eval_shape(jlora_tree, params)
        out["moments"] = (params, jsharding.opt_state_specs(params, mesh))
    return out


def _check_tree(name, got_tree, ref, mesh, drop=()):
    tree, spec = ref
    want = {p: _local(shp, s, mesh, drop) for (p, (shp, _)), s in zip(
        sorted(_flat(tree).items()),
        [spec_of(spec, p) for p in sorted(_flat(tree))])}
    got = {p: shp for p, (shp, _) in _flat(got_tree).items()}
    assert got == want, name


def spec_of(spec_tree, path):
    node = spec_tree
    for k in path.strip("/").split("/"):
        node = node[k]
    return tuple(node)


@pytest.mark.parametrize("multi", [False, True], ids=["single", "multi"])
@pytest.mark.parametrize("arch", ARCHS + ("seamless-m4t-medium",))
def test_dryrun_args_local_shapes_follow_the_reference_specs(arch, multi):
    """Rank 0's arguments of every input shape in a fake 256 / 512-rank
    world: the batch rows and the cache stripe are the reference's specs
    applied to the global shapes; the moments are the reference's ZeRO-1
    blocks without its ``model`` split (the parameters, and so the
    moments, are whole over ``model`` in the port: its divergence, which
    ``in_specs`` states as ``()`` for every parameter); the parameters
    are whole.  An encoder-decoder's frames and memory (K/V and positions)
    follow the same specs: the memory's slots over ``model``, as a ring's.
    The fake group is gone after the world."""
    mesh_shape = PRODUCTION_MESH_SHAPES["multi" if multi else "single"]
    cfg = configs.get_config(arch)
    with dry_world(math.prod(mesh_shape.values())):
        mesh = make_production_mesh(multi_pod=multi)
        assert dist.get_world_size() == math.prod(mesh_shape.values())
        for shape in SHAPES:
            fed = arch == "fedtime-llama2-7b" and shape == "train_4k"
            kind, args, in_specs, _ = specs.dryrun_args(cfg, shape, mesh,
                                                        fed=fed)
            ref = _reference_layouts(arch, shape, mesh_shape, fed)
            params = args[0]
            assert all(s == () for s in tree_util.leaves(in_specs[0]))
            assert _flat(params) == _flat(specs.param_shapes(cfg, fed=fed))
            if kind in ("train", "fed_train"):
                _check_tree("batch", args[2], ref["batch"], mesh_shape)
                for m in ("mu", "nu"):
                    _check_tree("moments", args[1][m], ref["moments"],
                                mesh_shape, drop=("model",))
                    assert all(str(x.dtype) == "torch.float32"
                               for x in tree_util.leaves(args[1][m]))
            elif kind == "prefill":
                _check_tree("batch", args[1], ref["batch"], mesh_shape)
            else:
                _check_tree("cache", args[1], ref["cache"], mesh_shape)
                _check_tree("batch", args[2], ref["batch"], mesh_shape)
    assert not dist.is_initialized()


def test_dry_world_refuses_a_running_group_and_always_leaves():
    with dry_world(4):
        with pytest.raises(RuntimeError, match="already running"):
            with dry_world(4):
                pass
        assert dist.get_world_size() == 4
    assert not dist.is_initialized()
    with pytest.raises(KeyError):
        with dry_world(8):
            raise KeyError("inside")
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# Counted FLOPs against the reference's HLO count, at smoke size
# ---------------------------------------------------------------------------

B, S = 2, 64


def _smoke_steps(arch, **over):
    """{kind: (reference step, reference args)} at B x S on ``arch``'s
    smoke config (with the fields in ``over`` replaced)."""
    jcfg = jconfigs.get_smoke_config(arch).replace(**over)
    key = jax.random.PRNGKey(0)
    api = jget_model(jcfg)
    jp = jax.eval_shape(lambda k: api.init(jcfg, k), key)
    tok = jax.ShapeDtypeStruct((B, S), jnp.int32)
    cache = jax.eval_shape(lambda: api.init_cache(jcfg, B, S,
                                                  dtype=jnp.bfloat16))
    dec = {"token": jax.ShapeDtypeStruct((B, 1), jnp.int32),
           "pos": jax.ShapeDtypeStruct((), jnp.int32)}
    from repro.optim.adamw import adamw_init as jadamw_init
    opt = jax.eval_shape(jadamw_init, jp)
    step = jax.ShapeDtypeStruct((), jnp.int32)
    return {
        "train": (jsteps.make_train_step(jcfg),
                  (jp, opt, {"tokens": tok, "labels": tok}, step)),
        "prefill": (jsteps.make_prefill_step(jcfg), (jp, {"tokens": tok})),
        "decode": (jsteps.make_serve_step(jcfg), (jp, cache, dec)),
    }


def _reference_flops(fn, args) -> float:
    return jhlo_cost.analyze(jax.jit(fn).lower(*args).compile().as_text())[
        "flops_per_device"]


def _port_count(cfg, kind, fed=False):
    step = {"train": make_fed_train_step(cfg) if fed
            else make_train_step(cfg), "prefill": make_prefill_step(cfg),
            "decode": make_serve_step(cfg)}[kind]
    _, args, _, _ = specs.step_args(cfg, kind, B, S, fed=fed)
    return dryrun.measure(step, args)


def test_counted_flops_against_the_reference_compiled_step():
    """qwen3-0.6b's smoke config at B 2 x S 64.  Prefill: equal, 2 B S L
    (projections) + 4 L B H S^2 D + 2 B d V (the last token's logits),
    319,291,392.  Serve: within 1%.  Train: the port counts the logits
    product once more, 2 B S d V exactly: its chunked cross-entropy
    recomputes each chunk's logits in the backward pass (a checkpoint),
    which XLA's simplifier folds into the forward's."""
    cfg = configs.get_smoke_config("qwen3-0.6b")
    ref = {k: _reference_flops(*v) for k, v in
           _smoke_steps("qwen3-0.6b").items()}
    got = {k: analyze(_port_count(cfg, k)[0])["flops_per_device"]
           for k in ("train", "prefill", "decode")}
    assert ref["prefill"] == got["prefill"] == 319_291_392
    assert abs(got["decode"] - ref["decode"]) <= 0.01 * ref["decode"]
    logits = 2 * B * S * cfg.d_model * cfg.vocab_size
    assert ref["train"] == 1_308_622_848
    assert got["train"] - ref["train"] == logits


def test_counted_flops_of_the_hybrid_against_the_reference():
    """zamba2-2.7b's smoke config at B 2 x S 64, its heads at D 80 (the
    kernel's instance, which the serve step's shape rule asks for; the
    smoke heads, G 1 D 64, have none): prefill and serve count the
    reference's FLOPs exactly (the Mamba2 layers' projections and chunk
    products, the shared blocks' attention and MLP, 1,099,956,224 and
    17,336,320).  Train recomputes what the reference recomputes, each
    group and each Mamba2 layer inside it, but torch's non-reentrant
    checkpoint ends a group's recompute once it holds every tensor the
    backward saved, before the group's last Mamba2 layer (whose input that
    layer's own checkpoint saved), where the reference's compiled step
    recomputes it: 2 layers' forwards fewer, each counted here by the
    port's counter.  Without recompute the port counts the chunked
    cross-entropy's recompute of the logits, 2 B S d V, less 524,288 more
    (read: 33,030,144), so train counts 191,627,264 fewer in all."""
    cfg = configs.get_smoke_config("zamba2-2.7b").replace(head_dim=80)
    ref = {k: _reference_flops(*v) for k, v in
           _smoke_steps("zamba2-2.7b", head_dim=80).items()}
    got = {k: analyze(_port_count(cfg, k)[0])["flops_per_device"]
           for k in ("train", "prefill", "decode")}
    assert ref["prefill"] == got["prefill"] == 1_099_956_224
    assert ref["decode"] == got["decode"] == 17_336_320
    params = zamba2.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    with torch.no_grad():
        one = analyze(count(zamba2._mamba_layer, transformer.layer(
            transformer.layer(params["mamba"], 0), 0), cfg,
            torch.zeros(B, S, cfg.d_model))[1])["flops_per_device"]
    logits = 2 * B * S * cfg.d_model * cfg.vocab_size
    assert ref["train"] == 4_814_012_416
    assert ref["train"] - got["train"] == 2 * one - (logits - 524_288) \
        == 191_627_264


def test_counted_flops_of_the_encdec_against_the_reference():
    """seamless-m4t-medium's smoke config at B 2 x S 64 (64 frames, a
    memory of 128 slots in the serve step's cache): prefill and serve
    count the reference's FLOPs exactly (the encoder, the decoder's self
    and cross attention over the memory, the last token's logits; the
    serve step's cross decode over every memory slot, as the reference's
    wide decode computes it: 738,721,792 and 6,553,600).  Train: the port
    counts the chunked cross-entropy's recompute of the logits once more,
    2 B S d V, as for qwen3-0.6b's step."""
    arch = "seamless-m4t-medium"
    cfg = configs.get_smoke_config(arch)
    jcfg = jconfigs.get_smoke_config(arch)
    api = jget_model(jcfg)
    jp = jax.eval_shape(lambda k: api.init(jcfg, k), jax.random.PRNGKey(0))
    from repro.models.registry import train_batch_shapes as jshapes
    from repro.optim.adamw import adamw_init as jadamw_init
    batch = {k: jax.ShapeDtypeStruct(*v)
             for k, v in jshapes(jcfg, B, S).items()}
    rows = {k: v for k, v in batch.items() if k != "labels"}
    cache = jax.eval_shape(lambda: api.init_cache(jcfg, B, S,
                                                  dtype=jnp.bfloat16))
    dec = {"token": jax.ShapeDtypeStruct((B, 1), jnp.int32),
           "pos": jax.ShapeDtypeStruct((), jnp.int32)}
    ref = {"train": _reference_flops(jsteps.make_train_step(jcfg), (
               jp, jax.eval_shape(jadamw_init, jp), batch,
               jax.ShapeDtypeStruct((), jnp.int32))),
           "prefill": _reference_flops(jsteps.make_prefill_step(jcfg),
                                       (jp, rows)),
           "decode": _reference_flops(jsteps.make_serve_step(jcfg),
                                      (jp, cache, dec))}
    got = {k: analyze(_port_count(cfg, k)[0])["flops_per_device"]
           for k in ("train", "prefill", "decode")}
    assert ref["prefill"] == got["prefill"] == 738_721_792
    assert ref["decode"] == got["decode"] == 6_553_600
    logits = 2 * B * S * cfg.d_model * cfg.vocab_size
    assert ref["train"] == 2_885_681_152
    assert got["train"] - ref["train"] == logits


def _real(x):
    """Real zero tensors of the fakes' shapes and types."""
    if isinstance(x, torch.Tensor):
        return torch.zeros(x.shape, dtype=x.dtype)
    if isinstance(x, (list, tuple)):
        return type(x)(_real(y) for y in x)
    if isinstance(x, dict):
        return {k: _real(v) for k, v in x.items()}
    return x


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "fedtime-llama2-7b"])
def test_fed_step_flops_against_the_reference(arch):
    """The federated step at smoke size (LoRA at wq, wk, wv, wo; NF4 base):
    the port counts the logits product once more (the chunked CE's
    recompute) and skips the first layer's input gradients, which no leaf
    needs (the embedding is frozen), while the reference's scan computes
    them in every layer: wq, wk and wv's products with their gradient and
    their LoRA A's."""
    jcfg = jconfigs.get_smoke_config(arch)
    jp = jspecs.param_shapes(jcfg, fed=True)
    from repro.core.lora import lora_tree as jlora_tree
    from repro.optim.adamw import adamw_init as jadamw_init
    opt = jax.eval_shape(lambda p: jadamw_init(jlora_tree(p)), jp)
    tok = jax.ShapeDtypeStruct((B, S), jnp.int32)
    ref = _reference_flops(jsteps.make_fed_train_step(jcfg), (
        jp, opt, {"tokens": tok, "labels": tok},
        jax.ShapeDtypeStruct((), jnp.int32)))
    cfg = configs.get_smoke_config(arch)
    got = analyze(_port_count(cfg, "train", fed=True)[0])[
        "flops_per_device"]
    d, dh = cfg.d_model, cfg.resolved_head_dim()
    rows, r = B * S, cfg.fedtime.lora_rank
    logits = 2 * rows * d * cfg.vocab_size
    first_layer = (2 * rows * d * (cfg.num_heads + 2 * cfg.num_kv_heads) * dh
                   + 3 * 2 * rows * r * d)
    assert got - ref == logits - first_layer


@pytest.mark.parametrize("kind,fed", [("train", False), ("train", True),
                                      ("prefill", False),
                                      ("decode", False)],
                         ids=["train", "fed_train", "prefill", "serve"])
def test_peak_on_fakes_equals_peak_on_real_tensors(kind, fed):
    """The same counter on the same step: fakes (the dry run) against real
    CPU tensors drawn from a seed give the same FLOPs, bytes and peak of
    live bytes, so the fake run takes the real path.  The serve step's
    kernel counts its outputs only on both sides."""
    arch = "fedtime-llama2-7b" if fed else "qwen3-0.6b"
    cfg = configs.get_smoke_config(arch)
    c_fake, m_fake = _port_count(cfg, kind, fed)
    _, fargs, _, _ = specs.step_args(cfg, kind, B, S, fed=fed)
    real = _real(fargs)
    step = {"train": make_fed_train_step(cfg) if fed
            else make_train_step(cfg), "prefill": make_prefill_step(cfg),
            "decode": make_serve_step(cfg)}[kind]
    c_real, m_real = dryrun.measure(step, real)
    assert analyze(c_real) == analyze(c_fake)
    assert m_real == m_fake
    assert c_fake.peak_bytes > 0


@pytest.mark.parametrize("kind,fed", [("train", False), ("train", True),
                                      ("prefill", False),
                                      ("decode", False)],
                         ids=["train", "fed_train", "prefill", "serve"])
def test_encdec_peak_on_fakes_equals_peak_on_real_tensors(kind, fed):
    """``test_peak_on_fakes_equals_peak_on_real_tensors`` on
    seamless-m4t-medium's smoke config: its frames beside the tokens, the
    serve step's cross decode over the memory."""
    cfg = configs.get_smoke_config("seamless-m4t-medium")
    c_fake, m_fake = _port_count(cfg, kind, fed)
    _, fargs, _, _ = specs.step_args(cfg, kind, B, S, fed=fed)
    step = {"train": make_fed_train_step(cfg) if fed
            else make_train_step(cfg), "prefill": make_prefill_step(cfg),
            "decode": make_serve_step(cfg)}[kind]
    c_real, m_real = dryrun.measure(step, _real(fargs))
    assert analyze(c_real) == analyze(c_fake)
    assert m_real == m_fake
    assert c_fake.peak_bytes > 0


def test_fed_step_all_reduce_bytes_in_a_fake_world():
    """In a fake 256-rank world (data 16, model 16) the federated step
    all-reduces each adapter gradient in f32 over ``data``, the count of
    labels (int64) and the loss (f32): that many all-reduces and exactly
    those bytes; its ZeRO-1 update all-gathers each scattered adapter
    leaf.  The world is gone after the test."""
    cfg = configs.get_smoke_config("fedtime-llama2-7b")
    with dry_world(256):
        mesh = make_production_mesh()
        kind, args, _, _ = specs.step_args(cfg, "train", 16, 32, mesh,
                                           fed=True)
        counter, _ = dryrun.measure(make_fed_train_step(cfg), args, mesh)
    adapters = tree_util.leaves(lora_tree(args[0]))
    grads = sum(4 * a.numel() for a in adapters)
    r = analyze(counter)
    assert r["collective_bytes"]["all-reduce"] == grads + 8 + 4
    assert r["collective_counts"]["all-reduce"] == len(adapters) + 2
    scattered = [a for a, mu in zip(adapters,
                                    tree_util.leaves(args[1]["mu"]))
                 if mu.shape != a.shape]
    assert r["collective_bytes"]["all-gather"] == sum(
        4 * a.numel() for a in scattered)
    assert r["collective_counts"]["all-gather"] == len(scattered)
    for k in ("reduce-scatter", "all-to-all", "collective-permute"):
        assert r["collective_bytes"][k] == 0


# ---------------------------------------------------------------------------
# What the fake run reads off shapes instead of the host
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,bq,bkv", [(4096, 512, 2048), (5000, 512, 2048),
                                      (100, 16, 32), (97, 32, 16)])
def test_causal_skip_table_from_shapes_equals_the_host_read(S, bq, bkv):
    pos = torch.arange(S, dtype=torch.int32)[None].expand(2, S)
    q_pos = torch.nn.functional.pad(pos, (0, -S % bq), value=-1)
    kv_pos = torch.nn.functional.pad(pos, (0, -S % bkv), value=-1)
    want = attention._causal_live_blocks(q_pos, kv_pos, "causal", bq, bkv)
    got = attention._causal_live_blocks(q_pos, kv_pos, "causal", bq, bkv,
                                        arange_len=S)
    assert got == want


@pytest.mark.parametrize("S,cache_len,ways", [(64, 64, 4), (100, 64, 4),
                                              (40, 64, 2), (300, 128, 8),
                                              (129, 128, 16)])
def test_ring_stripe_from_shapes_equals_the_masked_select(S, cache_len,
                                                          ways):
    """Each model rank's stripe of the prefilled ring, built from the
    lengths alone, equals the stripe of the whole ring."""
    rng = np.random.default_rng(0)
    k = torch.from_numpy(rng.standard_normal((2, S, 2, 4)).astype(
        np.float32))
    v = k + 1
    pos = torch.arange(S, dtype=torch.int32)
    whole = transformer._scatter_ring(k, v, pos, cache_len)
    size = cache_len // ways
    for r in range(ways):
        part = transformer._scatter_ring(k, v, pos, cache_len, r * size,
                                         size)
        for name in whole:
            assert torch.equal(part[name],
                               whole[name][:, r * size:(r + 1) * size])


def test_cli_writes_the_reference_keys(tmp_path, capsys, monkeypatch):
    dryrun.main(["--arch", "qwen3-0.6b", "--shape", "decode_32k", "--mesh",
                 "single", "--outdir", str(tmp_path)])
    assert "OK   qwen3-0.6b x decode_32k x single" in capsys.readouterr().out
    r = json.loads((tmp_path / "qwen3-0.6b__decode_32k__single.json")
                   .read_text())
    for key in ("arch", "shape", "mesh", "step_kind", "fed", "accum",
                "num_devices", "lower_s", "compile_s", "flops_per_device",
                "bytes_accessed_per_device", "collectives", "memory"):
        assert key in r
    assert set(r["collectives"]) == {"bytes", "counts", "total_bytes"}
    assert set(r["memory"]) == {"argument_bytes", "output_bytes",
                                "temp_bytes", "alias_bytes"}
    assert r["port"] == "torch" and r["num_devices"] == 256
    assert not any(k.startswith("xla_") for k in r)
    # a pair whose kernel call the shape rule refuses fails the CLI: smollm
    # with its (G, D) = (3, 64) instance taken out of the kernels' table
    from repro_torch.kernels import flash_decode as fd
    monkeypatch.setattr(fd, "HEAD_GEOMETRIES", tuple(
        g for g in fd.HEAD_GEOMETRIES if g != (3, 64)))
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", "smollm-360m", "--shape", "decode_32k",
                     "--outdir", str(tmp_path)])
    assert "G, D" in capsys.readouterr().out
