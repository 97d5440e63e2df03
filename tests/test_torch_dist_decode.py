"""The port's sequence-sharded flash-decode against the JAX package's, on a
4-rank gloo world on the CPU.

The reference's ``test_sharded_flash_decode_on_emulated_mesh``
(``tests/test_flash_decode.py``) and
``test_sharded_paged_decode_on_emulated_mesh``
(``tests/test_paged_pool.py``) run ``repro.dist.decode
.sharded_flash_decode`` on 4 emulated devices.  Here one reference
subprocess runs their cases on their mesh, ``(data 2, model 2)``, and one
port world of 4 ranks runs ``repro_torch.dist.decode`` on the same
numpy-drawn inputs on that mesh and on ``(data 1, model 4)``, the card's
layout:

  * a ring of 256 slots (B 2, Hk 2, G 4, D 64, f32): causal, a window of
    70, and an int8 cache under the prefix kind with per-row prefixes;
  * a 16-block pool of 16 slots striped over ``model`` (B 4, Hk 2, G 4,
    D 32) whose table straddles the stripes, shares a block between two
    rows, holds -1 entries, and an inactive lane (position -1).

Each rank's output is held to the reference's sharded output (on its
mesh), to the reference's unsharded oracle and to the port's own unsharded
path, at the
reference's tolerances (1e-5; int8 3e-2); the inactive lane must be
exactly 0, and every rank must hold the same output.  A planted fault (one
stripe's partials dropped from the combine) shows what the tolerance
separates.
"""

import os
import subprocess
import sys
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import spawn_local

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
TIMEOUT_S = 240
MESHES = {"d2m2": ((2, 2), ("data", "model")),
          "d1m4": ((1, 4), ("data", "model"))}
REF_MESH = "d2m2"
RING = dict(B=2, S=256, Hk=2, G=4, D=64)
PAGED = dict(nb=16, bs=16, Hk=2, G=4, D=32, B=4, T=4)
KINDS = ("causal", "window", "prefix_int8")
TOL = {"causal": 1e-5, "window": 1e-5, "prefix_int8": 3e-2, "paged": 1e-5}
_ENV_KEYS = ("REPRO_CACHE_SHARD", "REPRO_FORCE_KERNELS", "XLA_FLAGS")



def _yield_cpu():
    """Lowest CPU priority for this module's processes: the suite runs its
    files in parallel workers, and some of their tests bound wall time."""
    os.nice(19)


def _quant(x):
    """int8 codes and bf16 absmax scales (kept as exact f32 values)."""
    amax = np.abs(x).max(-1, keepdims=True)
    s = (np.maximum(amax, 1e-6) / 127.0).astype(ml_dtypes.bfloat16)
    s = s.astype(np.float32)
    return np.clip(np.round(x / s), -127, 127).astype(np.int8), s


def _inputs():
    rng = np.random.default_rng(0)
    B, S, Hk, G, D = (RING[k] for k in ("B", "S", "Hk", "G", "D"))
    inp = {"q": rng.normal(size=(B, 1, Hk * G, D)).astype(np.float32),
           "k": rng.normal(size=(B, S, Hk, D)).astype(np.float32),
           "v": rng.normal(size=(B, S, Hk, D)).astype(np.float32),
           "kv_pos": np.broadcast_to(np.arange(S, dtype=np.int32),
                                     (B, S)).copy(),
           "prefix": np.asarray([10, 60], np.int32)}
    inp["kq"], inp["ks"] = _quant(inp["k"])
    inp["vq"], inp["vs"] = _quant(inp["v"])
    nb, bs, Hk, G, D, B, T = (PAGED[k] for k in
                              ("nb", "bs", "Hk", "G", "D", "B", "T"))
    # blocks straddle every stripe; rows 0 and 2 share block 0 at the same
    # logical index; row 3 is inactive
    tbl = np.asarray([[0, 8, 1, 9], [15, 2, -1, -1], [0, 12, 5, -1],
                      [3, 11, 6, 14]], np.int32)
    pos = np.asarray([T * bs - 1, 2 * bs - 5, 2 * bs + 7, -1], np.int32)
    kv_pos = np.full((nb, bs), -1, np.int32)
    for b in range(B):
        for j in range(T):
            if tbl[b, j] >= 0:
                for o in range(bs):
                    if j * bs + o <= pos[b]:
                        kv_pos[tbl[b, j], o] = j * bs + o
    inp.update(pq=rng.normal(size=(B, 1, Hk * G, D)).astype(np.float32),
               pk=rng.normal(size=(nb, bs, Hk, D)).astype(np.float32),
               pv=rng.normal(size=(nb, bs, Hk, D)).astype(np.float32),
               ptbl=tbl, ppos=pos, pkv_pos=kv_pos)
    return inp


def _ring_args(inp, kind, to):
    """(q, k, v, kv_pos, q_pos, kw) of a ring case, through ``to`` (a
    converter to the side's arrays)."""
    S = RING["S"]
    q, kv_pos = to(inp["q"]), to(inp["kv_pos"])
    if kind == "prefix_int8":
        return (q, to(inp["kq"]), to(inp["vq"]), kv_pos, S - 1,
                dict(k_scale=to(inp["ks"], bf16=True),
                     v_scale=to(inp["vs"], bf16=True), kind="prefix",
                     prefix_len=to(inp["prefix"])))
    kw = dict(window=70) if kind == "window" else {}
    return q, to(inp["k"]), to(inp["v"]), kv_pos, S - 1, kw


_REFERENCE = r"""
import os, sys
os.nice(19)                    # as _yield_cpu, before jax starts threads
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
sys.path.insert(0, {tests!r})
from test_torch_dist_decode import MESHES, REF_MESH, KINDS, _ring_args
from repro.dist.decode import seq_shard_mesh
from repro.dist import decode as jdecode
# jitted: the same function, traced once a case instead of dispatched op by
# op inside an eager shard_map (half the subprocess's time)
sharded_flash_decode = jax.jit(
    jdecode.sharded_flash_decode,
    static_argnames=("mesh", "kind", "window", "softcap", "block_kv"))
from repro.kernels import ref
from repro.kernels.flash_decode import flash_decode_xla

inp = dict(np.load(sys.argv[1]))

def to(x, bf16=False):
    return jnp.asarray(x, jnp.bfloat16) if bf16 else jnp.asarray(x)

out = {{}}
for kind in KINDS:
    q, k, v, kv_pos, pos, kw = _ring_args(inp, kind, to)
    out["oracle/" + kind] = np.asarray(ref.flash_decode_ref(
        q, k, v, kv_pos, jnp.asarray(pos, jnp.int32), **kw))
ptbl, ppos = jnp.asarray(inp["ptbl"]), jnp.asarray(inp["ppos"])
paged = (jnp.asarray(inp["pq"]), jnp.asarray(inp["pk"]),
         jnp.asarray(inp["pv"]), jnp.asarray(inp["pkv_pos"]), ppos)
out["oracle/paged"] = np.asarray(flash_decode_xla(*paged, block_tables=ptbl))
for name in (REF_MESH,):
    mesh = jax.make_mesh(*MESHES[name])
    with mesh:
        assert seq_shard_mesh(RING_S) is not None
        for kind in KINDS:
            q, k, v, kv_pos, pos, kw = _ring_args(inp, kind, to)
            out[name + "/" + kind] = np.asarray(sharded_flash_decode(
                q, k, v, kv_pos, jnp.asarray(pos, jnp.int32), mesh,
                block_kv=64, **kw))
        out[name + "/paged"] = np.asarray(sharded_flash_decode(
            *paged, mesh, block_tables=ptbl))
np.savez(sys.argv[2], **out)
print("REFERENCE_OK")
""".format(tests=str(ROOT / "tests")).replace("RING_S", str(RING["S"]))


def _torch(x, bf16=False):
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t.to(torch.bfloat16) if bf16 else t


def _port_ranks(inp):
    """One rank: every case on both meshes, on CPU tensors."""
    _yield_cpu()
    for k in _ENV_KEYS:
        os.environ.pop(k, None)
    import torch.distributed as dist

    from repro_torch.dist.decode import seq_shard_mesh, sharded_flash_decode
    from repro_torch.dist.sharding import use_mesh
    from repro_torch.launch.mesh import make_mesh

    out = {"rank": dist.get_rank()}
    paged = (_torch(inp["pq"]), _torch(inp["pk"]), _torch(inp["pv"]),
             _torch(inp["pkv_pos"]), _torch(inp["ppos"]))
    for name, (shape, names) in MESHES.items():
        mesh = make_mesh(shape, names, device_type="cpu")
        with use_mesh(mesh):
            out[name + "/gate"] = seq_shard_mesh(RING["S"]) is mesh
        for kind in KINDS:
            q, k, v, kv_pos, pos, kw = _ring_args(inp, kind, _torch)
            out[f"{name}/{kind}"] = sharded_flash_decode(
                q, k, v, kv_pos, pos, mesh, block_kv=64, **kw).numpy()
        out[name + "/paged"] = sharded_flash_decode(
            *paged, mesh, block_tables=_torch(inp["ptbl"])).numpy()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_decode")
    inp = _inputs()
    np.savez(tmp / "in.npz", **inp)
    env = {k: v for k, v in os.environ.items() if k not in _ENV_KEYS}
    env["PYTHONPATH"] = str(ROOT / "src")
    ref = subprocess.Popen(
        [sys.executable, "-c", _REFERENCE, str(tmp / "in.npz"),
         str(tmp / "ref.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        port = spawn_local(WORLD, _port_ranks, inp, device_type="cpu",
                           timeout_s=TIMEOUT_S, store_dir=str(tmp))
        so, se = ref.communicate(timeout=TIMEOUT_S)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0 and "REFERENCE_OK" in so, so + se
    return inp, port, dict(np.load(tmp / "ref.npz"))


def _unsharded(inp, kind):
    from repro_torch.kernels import ops
    if kind == "paged":
        return ops.flash_decode(
            _torch(inp["pq"]), _torch(inp["pk"]), _torch(inp["pv"]),
            _torch(inp["pkv_pos"]), _torch(inp["ppos"]),
            block_tables=_torch(inp["ptbl"])).numpy()
    q, k, v, kv_pos, pos, kw = _ring_args(inp, kind, _torch)
    return ops.flash_decode(q, k, v, kv_pos, pos, **kw).numpy()


@pytest.mark.parametrize("kind", KINDS + ("paged",))
@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_decode_matches_reference_and_unsharded(runs, mesh, kind):
    inp, port, ref = runs
    tol = TOL[kind]
    want = _unsharded(inp, kind)
    np.testing.assert_allclose(want, ref["oracle/" + kind], rtol=tol,
                               atol=tol)
    for r in port:
        got = r[f"{mesh}/{kind}"]
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, ref[f"{REF_MESH}/{kind}"],
                                   rtol=tol, atol=tol)
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
        np.testing.assert_array_equal(got, port[0][f"{mesh}/{kind}"])


@pytest.mark.parametrize("mesh", MESHES)
def test_inactive_lane_decodes_to_exactly_zero(runs, mesh):
    _, port, ref = runs
    for r in port:
        assert np.all(r[mesh + "/paged"][3] == 0.0)
        assert np.any(r[mesh + "/paged"][:3] != 0.0)
    assert np.all(ref[REF_MESH + "/paged"][3] == 0.0)


@pytest.mark.parametrize("mesh", MESHES)
def test_seq_shard_gate_on_the_ambient_mesh(runs, mesh):
    _, port, _ = runs
    assert all(r[mesh + "/gate"] for r in port)


def test_seq_shard_gate_rules(monkeypatch):
    from repro_torch.dist.decode import seq_shard_mesh
    from repro_torch.dist.sharding import current_mesh, use_mesh
    monkeypatch.delenv("REPRO_CACHE_SHARD", raising=False)
    assert seq_shard_mesh(256) is None                  # no ambient mesh
    shape = {"data": 2, "model": 2}
    with use_mesh(shape):
        assert current_mesh() is shape
        assert seq_shard_mesh(256) is shape
        assert seq_shard_mesh(255) is None              # does not divide
        monkeypatch.setenv("REPRO_CACHE_SHARD", "heads")
        assert seq_shard_mesh(256) is None
    with use_mesh({"data": 4, "model": 1}):
        assert seq_shard_mesh(256) is None              # no model axis
    assert current_mesh() is None


def test_a_dropped_stripe_is_outside_the_tolerance(runs):
    """The planted fault: the combine over 4 stripes of the causal ring
    with one stripe's partials left out misses the unsharded output by far
    more than the tolerance the sharded path is held to."""
    from repro_torch.kernels.flash_decode import flash_decode_ref
    inp, _, _ = runs
    q, k, v, kv_pos, pos, kw = _ring_args(inp, "causal", _torch)
    S, stripe = RING["S"], RING["S"] // 4
    parts = [flash_decode_ref(q, k[:, i:i + stripe], v[:, i:i + stripe],
                              kv_pos[:, i:i + stripe], pos,
                              return_partials=True)
             for i in range(0, S, stripe)][1:]
    m = torch.stack([p[0] for p in parts])
    w = torch.exp(m - m.amax(0))
    l = (torch.stack([p[1] for p in parts]) * w).sum(0)
    acc = (torch.stack([p[2] for p in parts]) * w).sum(0)
    out = (acc / l).reshape(q.shape).numpy()
    err = np.abs(out - _unsharded(inp, "causal")).max()
    assert err > 100 * TOL["causal"], err
