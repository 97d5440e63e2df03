"""The port's checkpoint writer (``repro_torch.train.checkpoint``) and
round-state snapshots (``repro_torch.fault.snapshot``), on the CPU.

The port writes its own format (``RTCKPT01``: an integrity header, a JSON
index, raw bytes); the reference's msgpack + zstd files are not readable
by it, nor the other way round.  What is held, as the reference's
``tests/test_fault.py`` holds it for its own writer: every leaf round-trips
bit for bit (bf16 included), no temp file is left behind, truncation and
corruption are refused with the reference's messages, and a snapshot
round-trips numpy's PCG64 state (128-bit integers, kept as JSON) so that a
restored generator draws what the saved one would have.
"""

import os

import numpy as np
import pytest
import torch

from repro_torch.fault import (SNAPSHOT_SCHEMA, load_round_state,
                               save_round_state)
from repro_torch.train import checkpoint


def _tree():
    g = torch.Generator().manual_seed(0)
    return {"a": torch.randn(3, 4, generator=g),
            "bf16": torch.randn(5, 7, generator=g).to(torch.bfloat16),
            "b": {"c": torch.arange(5, dtype=torch.int32),
                  "mask": torch.tensor([True, False, True]),
                  "empty": torch.zeros((0, 3)),
                  "u32": np.arange(9, dtype=np.uint32) * 477_218_588,
                  "scalar": torch.tensor(2.5, dtype=torch.float64)},
            "np": np.linspace(-1, 1, 11, dtype=np.float32).reshape(11, 1)}


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", v


def test_round_trip_bit_for_bit_and_atomic(tmp_path):
    tree = _tree()
    p = tmp_path / "ck.rtckpt"
    n = checkpoint.save(str(p), tree)
    assert n == p.stat().st_size and p.read_bytes()[:8] == b"RTCKPT01"
    assert [f for f in os.listdir(tmp_path) if ".tmp." in f] == []
    back = checkpoint.load(str(p), "cpu")
    got, want = dict(_leaves(back)), dict(_leaves(tree))
    assert got.keys() == want.keys()
    for path, w in want.items():
        w = w if torch.is_tensor(w) else torch.from_numpy(w)
        g = got[path]
        assert g.dtype == w.dtype and g.shape == w.shape, path
        assert torch.equal(g.view(-1).view(torch.uint8)
                           if g.numel() else g,
                           w.reshape(-1).view(torch.uint8)
                           if w.numel() else w), path
    # rewriting over an existing file replaces it whole
    checkpoint.save(str(p), {"only": torch.ones(2)})
    assert list(checkpoint.load(str(p), "cpu")) == ["only"]
    assert [f for f in os.listdir(tmp_path) if ".tmp." in f] == []


def test_refuses_truncation_corruption_and_foreign_files(tmp_path):
    p = tmp_path / "ck.rtckpt"
    checkpoint.save(str(p), {"a": torch.arange(100, dtype=torch.float32)})
    raw = p.read_bytes()
    for cut, name in ((raw[:-7], "trunc"), (raw[:11], "head")):
        q = tmp_path / name
        q.write_bytes(cut)
        with pytest.raises(ValueError, match="truncated checkpoint"):
            checkpoint.load(str(q), "cpu")
    body = bytearray(raw)
    body[-3] ^= 0xFF
    corr = tmp_path / "corr"
    corr.write_bytes(bytes(body))
    with pytest.raises(ValueError, match="CRC mismatch"):
        checkpoint.load(str(corr), "cpu")
    foreign = tmp_path / "foreign"
    foreign.write_bytes(b"RPCKPT01" + raw[8:])
    with pytest.raises(ValueError, match="not a checkpoint"):
        checkpoint.load(str(foreign), "cpu")
    with pytest.raises(ValueError):
        checkpoint.save(str(tmp_path / "bad"), {"a/b": torch.ones(1)})
    with pytest.raises(ValueError):
        checkpoint.save(str(tmp_path / "bad"), torch.ones(1))


def test_failed_write_leaves_the_old_file_and_no_temp(tmp_path, monkeypatch):
    p = tmp_path / "ck.rtckpt"
    checkpoint.save(str(p), {"a": torch.ones(3)})
    before = p.read_bytes()

    def boom(fd):
        raise OSError("disk full")

    monkeypatch.setattr(os, "fsync", boom)
    with pytest.raises(OSError):
        checkpoint.save(str(p), {"a": torch.zeros(3)})
    assert p.read_bytes() == before
    assert [f for f in os.listdir(tmp_path) if ".tmp." in f] == []


def test_round_state_snapshot_round_trips_pcg64(tmp_path):
    p = str(tmp_path / "snap.rtckpt")
    rng = np.random.default_rng(7)
    rng.random(13)
    arrays = {"servers": {"0": {"w": torch.ones((2, 3)),
                                "m": torch.zeros(4, dtype=torch.bfloat16)}},
              "residuals": {"3": np.full(5, 0.25, np.float32)}}
    meta = {"round": 3, "rng": rng.bit_generator.state,
            "big": {"state": 2 ** 100}}
    n = save_round_state(p, arrays, meta)
    assert n == os.path.getsize(p)
    m, a = load_round_state(p, "cpu")
    assert m["round"] == 3 and m["big"]["state"] == 2 ** 100
    assert m["schema"] == SNAPSHOT_SCHEMA
    assert torch.equal(a["servers"]["0"]["w"], torch.ones((2, 3)))
    assert a["servers"]["0"]["m"].dtype == torch.bfloat16
    np.testing.assert_array_equal(a["residuals"]["3"].numpy(),
                                  arrays["residuals"]["3"])
    restored = np.random.default_rng(0)
    restored.bit_generator.state = m["rng"]
    np.testing.assert_array_equal(restored.random(5), rng.random(5))
    with pytest.raises(FileNotFoundError):
        load_round_state(str(tmp_path / "missing"), "cpu")
    checkpoint.save(p, {"w": torch.ones(1)}, {"schema": "other/v0"})
    with pytest.raises(ValueError, match="snapshot schema"):
        load_round_state(p, "cpu")
    checkpoint.save(p, {"w": torch.ones(1)})
    with pytest.raises(ValueError, match="not a round-state snapshot"):
        load_round_state(p, "cpu")
