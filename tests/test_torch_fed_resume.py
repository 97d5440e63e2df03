"""Round-state snapshots and resume of the port's federated fit, on the CPU
(the port alone: the reference's files do not load in the port, nor the
port's in the reference).

As the reference's ``tests/test_fault.py`` holds its own fit: a fit that
stops and resumes from its snapshot lands on the uninterrupted fit's
adapters, round losses and fleet ledger bit for bit, in process and after a
real kill -9 of a child process.  The timeline is deterministic (a random
fault plan with ``base_fit_s`` set, a deadline, the int8 wire), and the
children run the port alone (no JAX) on one torch thread each.
"""

import dataclasses
import os
import shutil
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import tree as tree_util
from repro_torch.configs import get_smoke_config
from repro_torch.fault import FaultPlan
from repro_torch.train import checkpoint
from repro_torch.train.fed_trainer import federated_fit

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _torch_one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_env(monkeypatch):
    for name in ("REPRO_FED_WIRE", "REPRO_FED_QBLOCK", "REPRO_FORCE_KERNELS",
                 "REPRO_SECAGG_STEP", "REPRO_FLEET_OUT"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("REPRO_TRACE", "0")


def _mini(n_clients=8, clusters=2):
    cfg = get_smoke_config("fedtime-llama2-7b")
    cfg = cfg.replace(fedtime=dataclasses.replace(
        cfg.fedtime, num_clusters=clusters, clients_per_round=n_clients))
    ft = cfg.fedtime
    rng = np.random.default_rng(0)
    data = []
    for i in range(n_clients):
        shift = 0.0 if i < n_clients // 2 else 5.0
        data.append(
            (rng.standard_normal((4, ft.lookback, 2)).astype(np.float32)
             + shift,
             rng.standard_normal((4, ft.horizon, 2)).astype(np.float32)
             + shift))
    return cfg, data


def _kw(**over):
    return dict(rounds=3, batch_size=4, device="cpu",
                fault_plan=FaultPlan.random(8, 0.25, 3, seed=1),
                deadline_s=2.0, wire="int8", **over)


def _state(res):
    return ([l.numpy() for ad in res.adapters_per_cluster
             for l in tree_util.leaves(ad)],
            [(l.round, l.cluster, l.train_loss, l.comm.bytes_up)
             for l in res.logs],
            [r.to_dict() for r in res.fleet.records])


def _assert_same(a, b):
    (la, ga, ra), (lb, gb, rb) = _state(a), _state(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    assert ga == gb
    assert ra == rb


@pytest.mark.parametrize("secure", [False, True])
def test_resume_in_process_bit_identical(tmp_path, secure):
    """Stop after round 1 (and, separately, right after round 1's first
    cluster), resume from the snapshot, and land bit for bit on the
    uninterrupted fit: adapters, round losses, ledger records."""
    cfg, data = _mini()
    kw = _kw(secure_aggregation=secure)
    full = federated_fit(cfg, data, **kw)
    snap = str(tmp_path / "snap.ckpt")
    mid = str(tmp_path / "mid.ckpt")
    done = []

    def keep(msg):
        done.append(msg)
        if len(done) == 3:                 # after (round 1, cluster 0)
            shutil.copy(snap, mid)
            shutil.copytree(snap + ".d", mid + ".d")

    federated_fit(cfg, data, **{**kw, "rounds": 2}, snapshot_path=snap,
                  progress=keep)
    assert [f for f in os.listdir(tmp_path) if ".tmp." in f] == []
    _assert_same(full, federated_fit(cfg, data, **kw, snapshot_path=snap,
                                     resume=True))
    _assert_same(full, federated_fit(cfg, data, **kw, snapshot_path=mid,
                                     resume=True))
    assert secure or full.fleet.rejections_by_reason()   # faults fired
    with pytest.raises(ValueError):
        federated_fit(cfg, data, **kw, resume=True)


def test_snapshot_writes_only_what_the_window_changed(tmp_path,
                                                    monkeypatch):
    """Each window's snapshot writes its own cluster's server state and
    the EF residuals of the uploads it encoded (every server's in the
    first window), not the whole fleet's; the parts directory ends with
    one file a server and a client, named after the last window that
    changed it."""
    cfg, data = _mini()
    writes = []
    save = checkpoint.save

    def recording(path, *a, **k):
        writes.append(path)
        return save(path, *a, **k)

    monkeypatch.setattr(checkpoint, "save", recording)
    snap = str(tmp_path / "snap.ckpt")
    res = federated_fit(cfg, data, **_kw(), snapshot_path=snap)
    # the parts come before their window's round state
    per_window, pending = [], []
    for path in writes:
        if path == snap:
            per_window.append(sorted(pending))
            pending = []
        else:
            pending.append(os.path.basename(path).split(".")[0])
    # a window encodes every upload that reached the wire in it: the late
    # ones too, not the buffered ones it drains
    encoded = {}
    for r in res.fleet.records:
        why = r.extra or {}
        here = encoded.setdefault((r.round, r.cluster), set())
        if why.get("reason") == "deadline" or (
                r.wire_bytes and why.get("reason") != "stale"
                and not why.get("buffered_staleness")):
            here.add(f"client{r.client}")
    windows = sorted(encoded)
    assert len(windows) == 6
    want = [sorted(encoded[w] | ({"server0", "server1"} if i == 0
                                 else {f"server{w[1]}"}))
            for i, w in enumerate(windows)]
    assert per_window == want
    last = {k: f"{k}.r{w[0]}c{w[1]}" for w, keys in zip(windows, want)
            for k in keys}
    assert sorted(os.listdir(snap + ".d")) == sorted(last.values())


_CHILD = """
import dataclasses, os, signal, sys
import numpy as np, torch
sys.path.insert(0, os.path.join({repo!r}, "src"))
torch.set_num_threads(1)
from repro_torch import tree as tree_util
from repro_torch.configs import get_smoke_config
from repro_torch.fault import FaultPlan
from repro_torch.train.fed_trainer import federated_fit

mode, out = sys.argv[1], sys.argv[2]
cfg = get_smoke_config("fedtime-llama2-7b")
cfg = cfg.replace(fedtime=dataclasses.replace(
    cfg.fedtime, num_clusters=2, clients_per_round=8))
ft = cfg.fedtime
rng = np.random.default_rng(0)
data = []
for i in range(8):
    shift = 0.0 if i < 4 else 5.0
    data.append(
        (rng.standard_normal((4, ft.lookback, 2)).astype(np.float32) + shift,
         rng.standard_normal((4, ft.horizon, 2)).astype(np.float32) + shift))

kw = dict(rounds=3, batch_size=4, device="cpu",
          fault_plan=FaultPlan.random(8, 0.25, 3, seed=1), deadline_s=2.0,
          wire="int8")
snap = os.path.join(out, "snap.ckpt")

done = [0]
def killer(msg):
    done[0] += 1
    if done[0] == 3:       # kill -9 mid round 1, right after (1, cluster 0)
        os.kill(os.getpid(), signal.SIGKILL)

if mode == "crash":
    federated_fit(cfg, data, **kw, snapshot_path=snap, progress=killer)
elif mode == "resume":
    res = federated_fit(cfg, data, **kw, snapshot_path=snap, resume=True)
elif mode == "full":
    res = federated_fit(cfg, data, **kw)
if mode in ("resume", "full"):
    leaves = [l.numpy() for ad in res.adapters_per_cluster
              for l in tree_util.leaves(ad)]
    np.savez(os.path.join(out, mode + ".npz"),
             losses=np.asarray([l.train_loss for l in res.logs]),
             records=np.asarray([repr(r.to_dict())
                                 for r in res.fleet.records]),
             **{{str(i): l for i, l in enumerate(leaves)}})
"""


def test_kill9_mid_round_resumes_bit_identical(tmp_path):
    """A fit killed with SIGKILL mid-run resumes the same round from its
    snapshot in a fresh process and finishes bit for bit equal to an
    uninterrupted third process."""
    script = tmp_path / "child.py"
    script.write_text(_CHILD.format(repo=REPO))
    env = {k: v for k, v in os.environ.items()
           if k not in ("REPRO_FED_WIRE", "REPRO_FED_QBLOCK",
                        "REPRO_FORCE_KERNELS", "REPRO_SECAGG_STEP",
                        "REPRO_FLEET_OUT")}
    env["REPRO_TRACE"] = "0"

    def run(mode):
        return subprocess.run([sys.executable, str(script), mode,
                               str(tmp_path)], env=env, timeout=240)

    crashed = run("crash")
    assert crashed.returncode == -signal.SIGKILL    # really kill -9'd
    assert (tmp_path / "snap.ckpt").exists()
    assert run("resume").returncode == 0
    assert run("full").returncode == 0
    a = np.load(tmp_path / "resume.npz")
    b = np.load(tmp_path / "full.npz")
    assert set(a.files) == set(b.files) and len(b.files) > 2
    for k in b.files:
        assert np.array_equal(a[k], b[k]), k
