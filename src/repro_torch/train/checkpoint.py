"""Checkpointing of nested-dict tensor trees in the port's own format.

The reference writes msgpack + zstd under the magic ``RPCKPT01``; the
card's machine has neither package, so the port writes its own file under
``RTCKPT01`` (neither side reads the other's files):

    header   magic (8 bytes) | payload length (u64) | CRC32 of payload (u32)
    payload  index length (u64) | JSON index | raw leaf bytes

The JSON index lists each leaf's path (``/key/key``), dtype, shape and
byte offset, beside the caller's JSON metadata (``meta``, which may hold
what no tensor holds: numpy's 128-bit PCG64 state); the raw bytes follow
it, leaf after leaf.  Any dtype torch holds round-trips bit for bit, bf16
included.

Crash safety: ``save`` writes to a temp file in the same directory,
flushes and fsyncs it, then atomically renames it over the destination, so
a kill -9 at any instant leaves either the previous complete checkpoint or
the new one, never a torn file; a best-effort fsync of the directory pins
the rename.  ``load`` verifies the length and the CRC and refuses
truncated or corrupt files.

Leaves on the card are copied to the host as one byte buffer a device,
so a checkpoint synchronizes each device once, not once a leaf.
"""

from __future__ import annotations

import json
import os
import struct
import zlib
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

MAGIC = b"RTCKPT01"
_HEADER_FMT = "<8sQI"
_HEADER_LEN = struct.calcsize(_HEADER_FMT)
_INDEX_FMT = "<Q"


def _flatten(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            if not isinstance(k, str) or "/" in k or not k:
                raise ValueError(f"checkpoint key {k!r} at {prefix or '/'}: "
                                 "keys are non-empty strings without '/'")
            out += _flatten(tree[k], f"{prefix}/{k}")
        return out
    return [(prefix, tree)]


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _host_bytes(tensors: List[torch.Tensor]) -> List[np.ndarray]:
    """Each tensor's raw bytes as a uint8 view of one host buffer a device
    (one copy to the host, one synchronize, a device)."""
    out: List[np.ndarray] = [None] * len(tensors)
    by_device: Dict[torch.device, List[int]] = {}
    for i, t in enumerate(tensors):
        by_device.setdefault(t.device, []).append(i)
    for idx in by_device.values():
        flat = [tensors[i].detach().contiguous().reshape(-1)
                .view(torch.uint8) for i in idx]
        blob = torch.cat(flat).cpu().numpy()
        at = 0
        for i, f in zip(idx, flat):
            out[i] = blob[at:at + f.numel()]
            at += f.numel()
    return out


def save(path: str, tree: Any, meta: Any = None) -> int:
    """Atomically write ``tree`` (nested dicts of tensors or arrays) and
    the JSON-serializable ``meta`` to ``path``.  Returns the bytes
    written."""
    if not isinstance(tree, dict):
        raise ValueError("a checkpoint holds a dict of leaves and dicts")
    leaves = _flatten(tree)
    tensors = [v if torch.is_tensor(v) else torch.from_numpy(np.array(v))
               for _, v in leaves]
    raw = _host_bytes(tensors)
    index, at = [], 0
    for (p, _), t, b in zip(leaves, tensors, raw):
        index.append({"path": p, "dtype": _dtype_name(t.dtype),
                      "shape": list(t.shape), "offset": at})
        at += b.size
    head = json.dumps({"meta": meta, "leaves": index}).encode("utf-8")
    parts = [struct.pack(_INDEX_FMT, len(head)), head, *raw]
    crc = 0
    for part in parts:
        crc = zlib.crc32(part, crc)
    length = len(parts[0]) + len(head) + at
    header = struct.pack(_HEADER_FMT, MAGIC, length, crc)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    # the temp file is in the SAME directory (os.replace must not cross
    # devices) and fsync'd before the rename, so the data is durable when
    # the new name appears
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            f.write(header)
            for part in parts:
                f.write(part)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    try:                                  # pragma: no cover - fs dependent
        dfd = os.open(os.path.dirname(path) or ".", os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError:
        pass
    return _HEADER_LEN + length


def load(path: str, device="cuda") -> dict:
    """Read a checkpoint written by :func:`save` back into nested dicts of
    tensors on ``device``.  Raises ``ValueError`` on a file that is not
    such a checkpoint, is truncated, or fails its CRC."""
    return read(path, device)[1]


def read(path: str, device="cuda") -> Tuple[Any, dict]:
    """:func:`load`, with the ``meta`` that :func:`save` was given:
    ``(meta, tree)``."""
    with open(path, "rb") as f:
        raw = bytearray(f.read())
    if len(raw) < _HEADER_LEN:
        raise ValueError(
            f"truncated checkpoint {path}: {len(raw)} bytes is shorter than "
            f"the {_HEADER_LEN}-byte header; the file was cut off mid-write")
    magic, length, crc = struct.unpack(_HEADER_FMT, raw[:_HEADER_LEN])
    if magic != MAGIC:
        raise ValueError(f"{path} is not a checkpoint of this format "
                         f"(magic {bytes(magic)!r}, expected {MAGIC!r})")
    body = memoryview(raw)[_HEADER_LEN:]
    if len(body) != length:
        raise ValueError(
            f"truncated checkpoint {path}: the header promises {length} "
            f"payload bytes, the file has {len(body)}; the write was "
            "interrupted, restore from the previous snapshot")
    if zlib.crc32(body) != crc:
        raise ValueError(f"corrupt checkpoint {path}: payload CRC mismatch; "
                         "the file was damaged after writing")
    (n_head,) = struct.unpack_from(_INDEX_FMT, body)
    start = struct.calcsize(_INDEX_FMT) + n_head
    index = json.loads(bytes(body[struct.calcsize(_INDEX_FMT):start]))
    root: dict = {}
    for entry in index["leaves"]:
        dtype = getattr(torch, entry["dtype"])
        shape = entry["shape"]
        count = int(np.prod(shape, dtype=np.int64))
        t = (torch.frombuffer(body, dtype=dtype, count=count,
                              offset=start + entry["offset"])
             if count else torch.empty(0, dtype=dtype))
        parts = [p for p in entry["path"].split("/") if p]
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        # a copy: the file's buffer is not aligned for the leaf's dtype
        node[parts[-1]] = t.reshape(shape).to(device, copy=True)
    return index["meta"], root
