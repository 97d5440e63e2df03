"""The port's ring all-reduce and ``dist/fed`` against the JAX package's, on
8-rank gloo worlds on the CPU.

The reference runs its ring on emulated host devices
(``tests/test_ring_collective.py``'s ``_RING_PARITY`` and ``_RING_EF``);
the port runs SPMD, one process a rank (``repro_torch.launch.mesh
.spawn_local``).  One reference subprocess (8 emulated devices) and one
port world of 8 ranks run every case once for the module, on the same
numpy-drawn inputs:

  * meshes ``(data 8, model 1)`` and ``(pod 2, data 2, model 2)``, 16
    members of 1220 elements each (two 610-element leaves), integer
    payloads;
  * the f32 wire with unit weights, bit for bit with the reference, with
    its psum path (``REPRO_FED_RING=0``) and with the exact sum; every
    wire with float weights, one-shot and two rounds with state, against
    the exact weighted sum (the reference's tolerances: f32 1e-6, bf16
    5e-2, int8 0.3) and against the reference's ring;
  * the byte ledger per axis = ``ring_wire_plan`` = ``fed
    .expected_collective_bytes`` = ``comm.collective_bytes_per_round``
    (given the ``DeviceMesh`` itself) = the ``obs`` counters, on both
    sides;
  * the residual each rank carries, against the reference's state row of
    its block;
  * error feedback over 24 int8 rounds on ``(data 4, model 2)``;
  * ``fed.aggregate_adapters(alive=)`` with a NaN member row.

Where the two rings are not bit for bit: XLA's CPU compiler contracts the
reference's jitted member sum and hop into FMAs and turns ``/127`` into
``*(1/127)`` (``tests/test_torch_wire_hop.py``).  With float weights the
f32 wire then differs in the last bits (4.8e-7 at most on these inputs);
on the int8 wire a code can land one step away and the difference rides
on through later hops (0.0103 at most over the 24 error-feedback rounds,
under half a code step of those rows; 1.1e-6 on the parity meshes).  The
bf16 wire came out bit for bit.  ``WIRE_GAP`` holds each wire to one step
of its code at these magnitudes, inside the reference's own tolerances
against the exact sum.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import spawn_local

ROOT = Path(__file__).resolve().parents[1]
WORLD = 8
TIMEOUT_S = 300
N_MEMBERS = 16
MESHES = {"data8": ((8, 1), ("data", "model")),
          "pod2": ((2, 2, 2), ("pod", "data", "model"))}
EF_MESH = ((4, 2), ("data", "model"))
EF_ROUNDS = 24
STATE_ROUNDS = 2
WIRES = ("f32", "bf16", "int8")
TOL = {"f32": 1e-6, "bf16": 5e-2, "int8": 0.3}
# port vs reference ring, max abs difference of an output or a residual:
# f32 sum order; one bf16 step at |x| < 8 (2**-5) and slack; about two int8
# code steps of a N(0, 1) row (amax / 127 ~ 0.024).  The reference's own
# tolerances against the exact sum are 5e-2 (bf16) and 0.3 (int8).
WIRE_GAP = {"f32": 1e-6, "bf16": 0.04, "int8": 0.05}
NAN_MEMBER = 5
_ENV_KEYS = ("REPRO_FED_WIRE", "REPRO_FED_QBLOCK", "REPRO_FED_RING",
             "REPRO_FORCE_KERNELS", "REPRO_ZERO1_SCATTER",
             "REPRO_CACHE_SHARD", "XLA_FLAGS")



def _yield_cpu():
    """Lowest CPU priority for this module's processes: the suite runs its
    files in parallel workers, and some of their tests bound wall time."""
    os.nice(19)


def _inputs():
    rng = np.random.default_rng(0)
    wf = rng.random(N_MEMBERS).astype(np.float32)
    alive = np.ones(N_MEMBERS, bool)
    alive[NAN_MEMBER] = False
    return {
        "a": rng.integers(-8, 9, (N_MEMBERS, 5, 61, 2)).astype(np.float32),
        "b": rng.integers(-8, 9, (N_MEMBERS, 2, 61, 5)).astype(np.float32),
        "wf": wf / wf.sum(),
        "ef": rng.normal(size=(4, 777)).astype(np.float32),
        "alive": alive,
    }


_REFERENCE = r"""
import os, sys
os.nice(19)                    # as _yield_cpu, before jax starts threads
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["REPRO_TRACE"] = "1"
import jax, jax.numpy as jnp, numpy as np
from repro import obs
from repro.dist import fed, fedcomm

MESHES = {meshes!r}
inp = dict(np.load(sys.argv[1]))
out = {{}}

def flat(t):
    return np.concatenate([np.asarray(t["wq"][k]).reshape(-1)
                           for k in ("lora_a", "lora_b")])

members = {{"wq": {{"lora_a": jnp.asarray(inp["a"]),
                    "lora_b": jnp.asarray(inp["b"])}}}}
n = inp["a"].shape[0]
ones = jnp.ones((n,), jnp.float32)
wf = jnp.asarray(inp["wf"])
for name, (shape, names) in MESHES.items():
    mesh = jax.make_mesh(shape, names)
    with mesh:
        out[name + "/int"] = flat(fedcomm.ring_aggregate(members, ones, mesh,
                                                         wire="f32"))
        os.environ["REPRO_FED_RING"] = "0"
        out[name + "/psum"] = flat(fed.aggregate_adapters(members, ones,
                                                          mesh))
        del os.environ["REPRO_FED_RING"]
        for wire in {wires!r}:
            obs.reset()
            o = fedcomm.ring_aggregate(members, wf, mesh, wire=wire)
            out[f"{{name}}/{{wire}}/oneshot"] = flat(o)
            for k, v in obs.get_tracer().counters.items():
                out[f"{{name}}/{{wire}}/counter/{{k}}"] = np.asarray(v)
            st = fedcomm.init_state(members, mesh, wire=wire)
            for r in range({rounds}):
                o, st = fedcomm.ring_aggregate(members, wf, mesh, wire=wire,
                                               state=st)
                out[f"{{name}}/{{wire}}/state{{r}}"] = flat(o)
            for ax, v in st.items():
                out[f"{{name}}/{{wire}}/res/{{ax}}"] = np.asarray(v)
        bad = jax.tree.map(lambda x: x.at[{nan}].set(jnp.nan), members)
        out[name + "/masked"] = flat(fed.aggregate_adapters(
            bad, wf, mesh, alive=jnp.asarray(inp["alive"]), wire="f32"))
mesh = jax.make_mesh({ef_shape!r}, {ef_names!r})
ef = {{"a": jnp.asarray(inp["ef"])}}
w = jnp.full((4,), 0.25, jnp.float32)
with mesh:
    out["ef/oneshot"] = np.asarray(
        fedcomm.ring_aggregate(ef, w, mesh, wire="int8")["a"])
    st = fedcomm.init_state(ef, mesh, wire="int8")
    rounds = []
    for r in range({ef_rounds}):
        o, st = fedcomm.ring_aggregate(ef, w, mesh, wire="int8", state=st)
        rounds.append(np.asarray(o["a"]))
out["ef/rounds"] = np.stack(rounds)
out["local"] = flat(fed.aggregate_adapters(members, wf, None))
np.savez(sys.argv[2], **out)
print("REFERENCE_OK")
""".format(meshes=MESHES, wires=WIRES, rounds=STATE_ROUNDS, nan=NAN_MEMBER,
           ef_shape=EF_MESH[0], ef_names=EF_MESH[1], ef_rounds=EF_ROUNDS)


def _port_ranks(inp):
    """One rank of the port's world: every case, on CPU tensors."""
    _yield_cpu()
    for k in _ENV_KEYS:
        os.environ.pop(k, None)
    os.environ["REPRO_TRACE"] = "1"
    import torch.distributed as dist

    from repro_torch import obs
    from repro_torch.core import comm
    from repro_torch.dist import collectives, fed, fedcomm
    from repro_torch.launch.mesh import make_mesh

    def flat(t):
        return torch.cat([t["wq"][k].reshape(-1)
                          for k in ("lora_a", "lora_b")]).numpy()

    members = {"wq": {"lora_a": torch.from_numpy(inp["a"]),
                      "lora_b": torch.from_numpy(inp["b"])}}
    elems = (inp["a"].size + inp["b"].size) // N_MEMBERS
    like = {"wq": {k: torch.empty(elems // 2, device="meta")
                   for k in ("lora_a", "lora_b")}}
    ones = torch.ones(N_MEMBERS)
    wf = torch.from_numpy(inp["wf"])
    out = {"rank": dist.get_rank()}
    for name, (shape, names) in MESHES.items():
        mesh = make_mesh(shape, names, device_type="cpu")
        axes = fed.aggregation_axes(mesh)
        out[name + "/block"] = collectives.block_index(mesh, axes)
        out[name + "/sizes"] = {ax: collectives.axis_size(mesh, ax)
                                for ax in axes}
        if "pod" in names:                     # axis tuples, major first
            x = torch.tensor([float(dist.get_rank())])
            out["gather/pod,data"] = collectives.all_gather(
                x, mesh, ("pod", "data")).tolist()
            out["gather/data,pod"] = collectives.all_gather(
                x, mesh, ("data", "pod")).tolist()
            out["psum/pod,data"] = float(collectives.psum(
                x, mesh, ("pod", "data")))
            out["block/pod,data"] = collectives.block_index(
                mesh, ("pod", "data"))
        out[name + "/fed_psum"] = float(fed.fed_psum(
            {"x": torch.full((3,), float(dist.get_rank()))}, mesh)["x"][0])
        out[name + "/int"] = flat(fedcomm.ring_aggregate(members, ones, mesh,
                                                         wire="f32"))
        os.environ["REPRO_FED_RING"] = "0"
        out[name + "/psum"] = flat(fed.aggregate_adapters(members, ones,
                                                          mesh))
        del os.environ["REPRO_FED_RING"]
        for wire in WIRES:
            key = f"{name}/{wire}"
            obs.reset()
            ledger = []
            o = fedcomm.ring_aggregate(members, wf, mesh, wire=wire,
                                       byte_ledger=ledger)
            out[key + "/oneshot"] = flat(o)
            out[key + "/ledger"] = ledger
            out[key + "/counters"] = dict(obs.get_tracer().counters)
            out[key + "/plan"] = {
                ax: comm.ring_wire_plan(elems, n, wire).per_device_bytes
                for ax, n in out[name + "/sizes"].items()}
            out[key + "/expected"] = fed.expected_collective_bytes(
                like, mesh, wire)
            out[key + "/accounted"] = comm.collective_bytes_per_round(
                like, mesh, wire)
            st = fedcomm.init_state(members, mesh, wire=wire)
            out[key + "/res_len"] = {ax: r.numel() for ax, r in st.items()}
            for r in range(STATE_ROUNDS):
                o, st = fedcomm.ring_aggregate(members, wf, mesh, wire=wire,
                                               state=st)
                out[f"{key}/state{r}"] = flat(o)
            out[key + "/res"] = {ax: v.numpy() for ax, v in st.items()}
        bad = {"wq": {k: v.clone() for k, v in members["wq"].items()}}
        for v in bad["wq"].values():
            v[NAN_MEMBER] = float("nan")
        out[name + "/masked"] = flat(fed.aggregate_adapters(
            bad, wf, mesh, alive=torch.from_numpy(inp["alive"]),
            wire="f32"))
    mesh = make_mesh(*EF_MESH, device_type="cpu")
    ef = {"a": torch.from_numpy(inp["ef"])}
    w = torch.full((4,), 0.25)
    out["ef/oneshot"] = fedcomm.ring_aggregate(ef, w, mesh,
                                               wire="int8")["a"].numpy()
    st = fedcomm.init_state(ef, mesh, wire="int8")
    rounds = []
    for _ in range(EF_ROUNDS):
        o, st = fedcomm.ring_aggregate(ef, w, mesh, wire="int8", state=st)
        rounds.append(o["a"].numpy())
    out["ef/rounds"] = np.stack(rounds)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_ring")
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


def _exact(inp, w):
    w = np.asarray(w, np.float64)
    return np.concatenate([np.tensordot(w, inp[k].astype(np.float64), 1)
                           .reshape(-1) for k in ("a", "b")])


@pytest.mark.parametrize("mesh", MESHES)
def test_f32_ring_integer_payload_bit_for_bit(runs, mesh):
    """Unit weights on integer payloads: every rank's f32 ring equals the
    reference's ring, the psum path of both sides, and the exact sum."""
    inp, port, ref = runs
    exact = _exact(inp, np.ones(N_MEMBERS)).astype(np.float32)
    np.testing.assert_array_equal(ref[mesh + "/int"], exact)
    np.testing.assert_array_equal(ref[mesh + "/psum"], exact)
    for r in port:
        np.testing.assert_array_equal(r[mesh + "/int"], ref[mesh + "/int"])
        np.testing.assert_array_equal(r[mesh + "/psum"], exact)


@pytest.mark.parametrize("mesh", MESHES)
def test_fed_psum_sums_over_the_federation_axes(runs, mesh):
    """Each rank sums its rank number with the ranks that share its
    ``model`` coordinate (the federation axes are ``data`` and ``pod``;
    ``model`` is the minor axis of both meshes)."""
    _, port, _ = runs
    model = MESHES[mesh][0][-1]
    for r in port:
        want = sum(q for q in range(WORLD) if q % model == r["rank"] % model)
        assert r[mesh + "/fed_psum"] == want


def test_collectives_read_axis_tuples_major_first(runs):
    """On (pod 2, data 2, model 2), rank = 4·pod + 2·data + model: a gather
    over ("pod", "data") lays blocks pod-major, over ("data", "pod")
    data-major, as ``PartitionSpec`` orders an axis tuple; the sum over
    both axes and the block index agree."""
    _, port, _ = runs
    for r in port:
        rank = r["rank"]
        pod, data, model = rank // 4, rank // 2 % 2, rank % 2
        assert r["gather/pod,data"] == [model, 2 + model, 4 + model,
                                        6 + model]
        assert r["gather/data,pod"] == [model, 4 + model, 2 + model,
                                        6 + model]
        assert r["psum/pod,data"] == 4 * model + 12
        assert r["block/pod,data"] == 2 * pod + data


@pytest.mark.parametrize("mesh", MESHES)
def test_ring_output_replicated_on_every_rank(runs, mesh):
    _, port, _ = runs
    for wire in WIRES:
        for key in ("oneshot",) + tuple(f"state{r}"
                                        for r in range(STATE_ROUNDS)):
            k = f"{mesh}/{wire}/{key}"
            for r in port[1:]:
                np.testing.assert_array_equal(r[k], port[0][k], err_msg=k)


@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("mesh", MESHES)
def test_weighted_ring_against_exact_and_reference(runs, mesh, wire):
    """Float weights, one-shot: within the reference's tolerance of the
    exact weighted sum, and within ``WIRE_GAP`` of the reference's ring."""
    inp, port, ref = runs
    exact = _exact(inp, inp["wf"])
    got = port[0][f"{mesh}/{wire}/oneshot"]
    want = ref[f"{mesh}/{wire}/oneshot"]
    np.testing.assert_allclose(got, exact, rtol=0, atol=TOL[wire])
    np.testing.assert_allclose(want, exact, rtol=0, atol=TOL[wire])
    np.testing.assert_allclose(got, want, rtol=0, atol=WIRE_GAP[wire])


@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("mesh", MESHES)
def test_byte_ledger_equals_plan_expected_and_accounted(runs, mesh, wire):
    """One number measured four ways, per axis: the ring's ledger, the
    chunk plan, ``expected_collective_bytes``, ``collective_bytes_per_round``
    of the ``DeviceMesh`` -- and the ``obs`` counters of both sides; 4·(n-1)
    transfers a rank per axis."""
    _, port, ref = runs
    key = f"{mesh}/{wire}"
    for r in port:
        sizes = r[mesh + "/sizes"]
        per_axis, hops = {}, {}
        for ax, nbytes in r[key + "/ledger"]:
            per_axis[ax] = per_axis.get(ax, 0) + nbytes
            hops[ax] = hops.get(ax, 0) + 1
        assert per_axis == r[key + "/plan"], (per_axis, r[key + "/plan"])
        assert hops == {ax: 4 * (n - 1) for ax, n in sizes.items()}
        for ax in sizes:
            assert per_axis[ax] == r[key + "/expected"][ax]
            assert per_axis[ax] == r[key + "/accounted"][ax]
            assert r[key + "/counters"][f"ring.wire_bytes.{ax}"] == \
                per_axis[ax]
            assert float(ref[f"{key}/counter/ring.wire_bytes.{ax}"]) == \
                per_axis[ax]
        assert r[key + "/counters"]["ring.rounds"] == 1
        assert float(ref[f"{key}/counter/ring.rounds"]) == 1


@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("mesh", MESHES)
def test_state_rounds_and_residual_rows(runs, mesh, wire):
    """Two rounds carrying state: outputs as the one-shot test holds them,
    and each rank's residual against the reference's state row of its
    block (all zero on the f32 wire)."""
    inp, port, ref = runs
    exact = _exact(inp, inp["wf"])
    key = f"{mesh}/{wire}"
    for rnd in range(STATE_ROUNDS):
        got = port[0][f"{key}/state{rnd}"]
        np.testing.assert_allclose(got, exact, rtol=0, atol=TOL[wire])
        np.testing.assert_allclose(got, ref[f"{key}/state{rnd}"], rtol=0,
                                   atol=WIRE_GAP[wire])
    for r in port:
        for ax, res in r[key + "/res"].items():
            row = ref[f"{key}/res/{ax}"][r[mesh + "/block"]]
            assert res.shape == row.shape == (r[key + "/res_len"][ax],)
            if wire == "f32":
                assert not res.any() and not row.any()
            np.testing.assert_allclose(res, row, rtol=0,
                                       atol=WIRE_GAP[wire])


def test_error_feedback_debiases_int8_rounds(runs):
    """24 int8 rounds carrying state: the time-average's bias falls below
    0.35x the one-shot bias, on the port as on the reference, and each
    round stays within ``WIRE_GAP`` of the reference's."""
    inp, port, ref = runs
    exact = inp["ef"].astype(np.float64).mean(axis=0)
    for side in (port[0], ref):
        bias_one = np.abs(side["ef/oneshot"] - exact).mean()
        bias_ef = np.abs(side["ef/rounds"].mean(axis=0) - exact).mean()
        assert bias_ef < 0.35 * bias_one, (bias_ef, bias_one)
    np.testing.assert_allclose(port[0]["ef/rounds"], ref["ef/rounds"],
                               rtol=0, atol=WIRE_GAP["int8"])
    for r in port[1:]:
        np.testing.assert_array_equal(r["ef/rounds"], port[0]["ef/rounds"])


@pytest.mark.parametrize("mesh", MESHES)
def test_mask_members_keeps_a_nan_row_out(runs, mesh):
    """A dead member's row holds NaN: ``alive=`` zeroes the row and its
    weight and renormalizes the survivors', on the ring."""
    inp, port, ref = runs
    w = np.where(inp["alive"], inp["wf"], 0.0)
    exact = _exact(inp, w / w.sum())
    for r in port:
        got = r[mesh + "/masked"]
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, exact, rtol=0, atol=TOL["f32"])
        np.testing.assert_allclose(got, ref[mesh + "/masked"], rtol=0,
                                   atol=TOL["f32"])


def test_local_reduction_without_a_mesh(runs):
    """No mesh, a shape dict or a dead axis: the local weighted sum, with
    the state passed through."""
    from repro_torch.dist import fed, fedcomm
    inp, _, ref = runs
    members = {"wq": {"lora_a": torch.from_numpy(inp["a"]),
                      "lora_b": torch.from_numpy(inp["b"])}}
    wf = torch.from_numpy(inp["wf"])

    def flat(t):
        return torch.cat([t["wq"][k].reshape(-1)
                          for k in ("lora_a", "lora_b")]).numpy()
    got = flat(fed.aggregate_adapters(members, wf, None))
    np.testing.assert_allclose(got, ref["local"], rtol=0, atol=TOL["f32"])
    np.testing.assert_allclose(got, _exact(inp, inp["wf"]), rtol=0,
                               atol=TOL["f32"])
    st = {"data": torch.zeros(3)}
    out, st2 = fed.aggregate_adapters(members, wf, {"data": 8, "model": 1},
                                      state=st)
    np.testing.assert_array_equal(flat(out), got)
    assert st2 is st
    np.testing.assert_array_equal(
        flat(fedcomm.ring_aggregate(members, wf, None)), got)


def test_residual_lengths_match_the_reference(runs):
    _, port, ref = runs
    for mesh in MESHES:
        for wire in WIRES:
            for ax, n in port[0][f"{mesh}/{wire}/res_len"].items():
                assert ref[f"{mesh}/{wire}/res/{ax}"].shape[1] == n


def test_ring_enabled_reads_the_env(monkeypatch):
    from repro_torch.dist import fedcomm
    monkeypatch.delenv("REPRO_FED_RING", raising=False)
    assert fedcomm.ring_enabled()
    monkeypatch.setenv("REPRO_FED_RING", "0")
    assert not fedcomm.ring_enabled()
