"""Write-ahead request journal: crash-recoverable serving state.

The engine appends one record per request-lifecycle event to a single
journal file; after a crash a fresh engine replays the journal and
resubmits every submitted-but-unfinished request with its generated
tokens as resume state, so decode continues through the engine's resume
path bit for bit (the request's sample counter continues from
``len(generated)``, as eviction and recompute already guarantee).

File format:

  * 8-byte file magic ``RTJRNL01``;
  * then records, each ``u32 payload_len | u32 crc32(payload) | payload``
    (little-endian), the payload a UTF-8 JSON object carrying at least
    ``{"t": kind}``; a prompt is a list of ints.

The framing is the reference's (``repro/serve/journal.py``), but its
payloads are msgpack under the magic ``RPJRNL01``: the two journals are
not interchangeable, and each engine replays only its own.

Durability contract:

  * ``submit`` / ``finish`` records are flushed and fsync'd at once — an
    acknowledged request is never lost, and a finished, shed or
    quarantined request is never resurrected;
  * ``token`` records buffer in memory and are flushed and fsync'd once an
    engine step (``commit``) — a crash loses at most the current step's
    tokens, which replay regenerates deterministically.

Replay reads sequentially and stops at the first torn or corrupt record
(short header, short payload, CRC mismatch, undecodable JSON): everything
before the tear is trusted, everything after is discarded.  The next
engine appending to the same file first truncates the torn tail, so the
file stays parseable.

Record kinds:

  ``submit``  — full request spec (prompt, horizon, sampling, SLOs);
  ``token``   — one emitted token (id, token);
  ``finish``  — terminal: ``reason`` in {"length", "eos", "deadline",
                "ttft_slo", "quarantined:*", "shed"}.
"""

from __future__ import annotations

import json
import os
import struct
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.serve.request import Request, SamplingParams

__all__ = ["RequestJournal", "JournalState", "replay_journal"]

_FILE_MAGIC = b"RTJRNL01"
_REC_FMT = "<II"                       # payload length, payload CRC32
_REC_LEN = struct.calcsize(_REC_FMT)
# no record (even a long-prompt submit) approaches this; a length field
# beyond it means the bytes are garbage
_MAX_RECORD = 64 * 1024 * 1024


def _pack_request(req: Request) -> dict:
    s = req.sampling
    return {
        "t": "submit", "id": req.id,
        "prompt": [int(t) for t in np.asarray(req.prompt)],
        "max_new_tokens": int(req.max_new_tokens),
        "eos_id": None if req.eos_id is None else int(req.eos_id),
        "arrival_step": int(req.arrival_step),
        "deadline_s": None if req.deadline_s is None else float(req.deadline_s),
        "ttft_slo_s": None if req.ttft_slo_s is None else float(req.ttft_slo_s),
        "sampling": {"temperature": float(s.temperature),
                     "top_k": int(s.top_k), "top_p": float(s.top_p),
                     "seed": int(s.seed)},
    }


def _frame(payload: dict) -> bytes:
    raw = json.dumps(payload, separators=(",", ":")).encode()
    return struct.pack(_REC_FMT, len(raw), zlib.crc32(raw)) + raw


class RequestJournal:
    """Append-only write-ahead log over one file.  An existing journal
    (after a crash) is scanned first, its torn tail truncated away, and new
    records continue after the last durable one, so replay sees one
    history across engine generations."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        fresh = not os.path.exists(path)
        if fresh:
            self._f = open(path, "wb")
            self._f.write(_FILE_MAGIC)
        else:
            good = _scan(path)[1]
            self._f = open(path, "r+b")
            self._f.truncate(good)
            self._f.seek(good)
        self._pending: List[bytes] = []
        if fresh:
            self._fsync()

    def _fsync(self) -> None:
        self._f.flush()
        os.fsync(self._f.fileno())

    def _append_durable(self, payload: dict) -> None:
        """Buffered tokens first (replay order), then the record, then
        fsync: the record is durable on return."""
        self.commit(sync=False)
        self._f.write(_frame(payload))
        self._fsync()

    # -- engine-facing API ---------------------------------------------------

    def log_submit(self, req: Request) -> None:
        """Durable on return: an acknowledged submit survives a crash."""
        self._append_durable(_pack_request(req))

    def log_token(self, req_id: str, token: int) -> None:
        """Buffered; durable at the next ``commit`` or ``log_finish``."""
        self._pending.append(_frame({"t": "token", "id": req_id,
                                     "tok": int(token)}))

    def log_finish(self, req_id: str, reason: str) -> None:
        """Durable on return: a finished, shed or quarantined request is
        never replayed."""
        self._append_durable({"t": "finish", "id": req_id, "reason": reason})

    def commit(self, sync: bool = True) -> None:
        """Write the buffered token records (once an engine step)."""
        if self._pending:
            self._f.write(b"".join(self._pending))
            self._pending.clear()
            if sync:
                self._fsync()

    def close(self) -> None:
        if not self._f.closed:
            self.commit()
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# Replay
# ---------------------------------------------------------------------------

@dataclass
class JournalState:
    """What a journal scan recovered."""

    submitted: Dict[str, dict] = field(default_factory=dict)  # id -> spec
    tokens: Dict[str, List[int]] = field(default_factory=dict)
    finished: Dict[str, str] = field(default_factory=dict)    # id -> reason
    torn: bool = False             # a torn or corrupt tail was discarded
    records: int = 0

    @property
    def unfinished_ids(self) -> List[str]:
        """Submitted-but-unfinished ids in original submit order (the
        replaying engine resubmits in this order, keeping FIFO)."""
        return [i for i in self.submitted if i not in self.finished]

    def unfinished_requests(self) -> List[Request]:
        """Every unfinished request, rebuilt for resubmission.  One with
        journaled tokens comes back as a resume request (prompt extended by
        its generated tokens, ``resume`` carrying the original prompt
        length), so the engine continues its decode with the sample counter
        at ``len(generated)``: bit for bit the uninterrupted run."""
        out: List[Request] = []
        for rid in self.unfinished_ids:
            spec = self.submitted[rid]
            prompt = np.asarray(spec["prompt"], np.int32)
            gen = self.tokens.get(rid, [])
            resume = None
            if gen:
                resume = {"generated": list(gen),
                          "prompt_len": int(prompt.shape[0])}
                prompt = np.concatenate([prompt, np.asarray(gen, np.int32)])
            s = spec["sampling"]
            out.append(Request(
                id=rid, prompt=prompt,
                max_new_tokens=int(spec["max_new_tokens"]),
                sampling=SamplingParams(
                    temperature=float(s["temperature"]),
                    top_k=int(s["top_k"]), top_p=float(s["top_p"]),
                    seed=int(s["seed"])),
                eos_id=spec["eos_id"],
                arrival_step=0,            # replay admits at once
                deadline_s=spec.get("deadline_s"),
                ttft_slo_s=spec.get("ttft_slo_s"),
                resume=resume))
        return out


def _scan(path: str) -> Tuple[List[dict], int]:
    """Decode records in order; returns ``(payloads, good_bytes)``, where
    ``good_bytes`` is the offset just past the last intact record (the
    truncation point for appending after a crash)."""
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:len(_FILE_MAGIC)] != _FILE_MAGIC:
        raise ValueError(f"{path}: not a request journal of this engine "
                         f"(magic {raw[:8]!r}, want {_FILE_MAGIC!r})")
    out: List[dict] = []
    off = len(_FILE_MAGIC)
    while off + _REC_LEN <= len(raw):
        length, crc = struct.unpack_from(_REC_FMT, raw, off)
        body = raw[off + _REC_LEN: off + _REC_LEN + length]
        if length > _MAX_RECORD or len(body) != length \
                or zlib.crc32(body) != crc:
            break                          # torn tail: stop, trust prefix
        try:
            payload = json.loads(body.decode())
        except ValueError:
            break
        out.append(payload)
        off += _REC_LEN + length
    return out, off


def replay_journal(path: str) -> JournalState:
    """Scan ``path`` and fold its records into a :class:`JournalState`.
    Unknown record kinds are skipped; a torn tail sets ``state.torn`` and is
    otherwise ignored."""
    payloads, good = _scan(path)
    state = JournalState()
    state.torn = good < os.path.getsize(path)
    for p in payloads:
        kind = p.get("t")
        if kind == "submit":
            # a re-submit under the same id (a client retrying a shed
            # request) restarts that id's history
            state.submitted[p["id"]] = p
            state.tokens.pop(p["id"], None)
            state.finished.pop(p["id"], None)
        elif kind == "token":
            state.tokens.setdefault(p["id"], []).append(int(p["tok"]))
        elif kind == "finish":
            state.finished[p["id"]] = p["reason"]
        state.records += 1
    return state
