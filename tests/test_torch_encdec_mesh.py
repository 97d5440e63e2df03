"""seamless-m4t-medium's serving path on a mesh: one 2-rank gloo world on
the CPU, (data 1, model 2), against the port's own unsharded run (which
``tests/test_torch_encdec.py`` holds to the reference).

Each rank prefills the whole batch (B 2: 24 frames and a 16-token prompt a
row, smoke config in f32) into its stripe of every self ring (24 slots, 12
a rank) and of the memory (24 slots, 12 a rank: the reference's layout of
``mem_k``, sequence over ``model``), then runs 8 greedy steps of
``make_serve_step``; every self-ring and cross decode of a step is one
``stripe_flash_decode`` whose partials are combined over ``model``.

Held: greedy tokens equal the unsharded run's; last logits within 1e-5 of
the unsharded logits' largest magnitude (the combine's f32 rounding);
each rank's memory K/V, memory positions and self rings equal its piece
of the unsharded cache; two stripe decodes a decoder layer a step.  This
module imports no jax: the ranks import it.
"""

import os

import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import spawn_local

ARCH = "seamless-m4t-medium"
WORLD = 2
TIMEOUT_S = 240
B, F, S, STEPS = 2, 24, 16, 8
RING = S + STEPS
TOL = 1e-5


def _inputs():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((B, F, 256)).astype(np.float32),
            rng.integers(0, 512, (B, S)))


def _run(mesh=None):
    """Prefill and STEPS greedy serve steps (under ``mesh``: this rank's
    stripes); returns numpy arrays of the tokens, the last step's logits,
    the prefilled cache and the stripe-decode calls."""
    import contextlib

    from repro_torch.configs import get_smoke_config
    from repro_torch.dist import sharding
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models.layers import attention
    from repro_torch.models.registry import get_model
    cfg = get_smoke_config(ARCH)
    api = get_model(cfg)
    params = api.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    frames, tokens = _inputs()
    batch = {"frames": torch.from_numpy(frames),
             "tokens": torch.from_numpy(tokens)}
    calls = [0]
    real = attention.stripe_flash_decode

    def counted(*a, **k):
        calls[0] += 1
        return real(*a, **k)

    attention.stripe_flash_decode = counted

    def ctx():
        return (sharding.use_mesh(mesh) if mesh is not None
                else contextlib.nullcontext())
    try:
        with ctx():
            cache, lg = make_prefill_step(cfg, cache_len=RING)(params, batch)
        out = {"cache": {"mem_k": cache["mem_k"].numpy().copy(),
                         "mem_v": cache["mem_v"].numpy().copy(),
                         "mem_pos": cache["mem_pos"].numpy().copy(),
                         "self_k": cache["self"]["k"].numpy().copy(),
                         "self_pos": cache["self"]["kv_pos"].numpy().copy()}}
        tok = lg[:, -1].argmax(-1).to(torch.int32)[:, None]
        toks = [tok]
        for i in range(STEPS):
            with ctx():
                lg, cache = api.decode_step(params, cfg, cache,
                                            {"token": tok, "pos": S + i})
            tok = lg[:, -1].argmax(-1).to(torch.int32)[:, None]
            toks.append(tok)
    finally:
        attention.stripe_flash_decode = real
    out.update(tokens=torch.cat(toks, 1).numpy(), last=lg.numpy(),
               calls=calls[0], layers=cfg.num_layers)
    return out


def _rank(_):
    """One rank of the world."""
    os.nice(19)
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((1, WORLD), ("data", "model"), device_type="cpu")
    out = _run(mesh)
    out["rank"] = dist.get_rank()
    out["model_rank"] = mesh.get_local_rank("model")
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("encdec_mesh")
    ranks = spawn_local(WORLD, _rank, None, device_type="cpu",
                        timeout_s=TIMEOUT_S, store_dir=str(tmp))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        whole = _run()
    finally:
        torch.set_num_threads(n)
    return ranks, whole


def test_sharded_tokens_and_logits_equal_the_unsharded_run(runs):
    ranks, whole = runs
    top = float(np.abs(whole["last"]).max())
    for r in ranks:
        assert np.array_equal(r["tokens"], whole["tokens"])
        assert float(np.abs(r["last"] - whole["last"]).max()) <= TOL * top
    assert whole["calls"] == 0


def test_each_rank_holds_its_stripe_of_the_memory_and_rings(runs):
    ranks, whole = runs
    w = whole["cache"]
    assert w["mem_k"].shape == (2, B, F, 4, 64)
    for r in ranks:
        m = r["model_rank"]
        mem = slice(m * F // WORLD, (m + 1) * F // WORLD)
        ring = slice(m * RING // WORLD, (m + 1) * RING // WORLD)
        c = r["cache"]
        assert np.array_equal(c["mem_k"], w["mem_k"][:, :, mem])
        assert np.array_equal(c["mem_v"], w["mem_v"][:, :, mem])
        assert np.array_equal(c["mem_pos"], w["mem_pos"][:, mem])
        assert np.array_equal(c["self_k"], w["self_k"][:, :, ring])
        assert np.array_equal(c["self_pos"], w["self_pos"][:, :, ring])


def test_every_decode_is_a_stripe_decode(runs):
    """Per layer a step: the self ring's and the cross attention's."""
    ranks, _ = runs
    for r in ranks:
        assert r["calls"] == 2 * r["layers"] * STEPS
