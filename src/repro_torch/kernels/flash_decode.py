"""Flash-decode over ring or paged KV caches, and the paged pool's block copy.

Two CUDA kernels (``csrc/flash_decode.cu``, ``csrc/block_copy.cu``) with
their plain PyTorch versions beside them:

  * ``flash_decode_cuda`` without ``block_tables`` replaces the TPU kernel
    ``repro/kernels/flash_decode.py::flash_decode``: one decode token per
    request against its contiguous ring ``(B, S, Hk, D)``.
  * ``flash_decode_cuda`` with ``block_tables`` replaces
    ``::_flash_decode_paged``: the same body over one shared pool
    ``(n_blocks, block_size, Hk, D)`` read through the ``(B, T)`` table.
  * ``paged_block_copy_leaves_cuda`` replaces ``::paged_block_copy``: the
    copy-on-write move of one block across every layer of every leaf of
    the pool, one launch an event; ``paged_block_copy_cuda`` is its
    one-leaf case, with the reference's per-leaf signature.

Flash-decode is bound by bytes on the H100: at B=4, S=4096, Hk=8, D=128 in
bf16 one call reads 67.1 MB of K and V, about 20 us at 3.35 TB/s.  The
block copy is bound by launch latency (3.7 MB an event at qwen3-0.6b with
16-slot blocks), so an event is one launch over all its leaves.  The
kernels' sources say how their design answers that.

One flash-decode kernel serves both layouts.  It picks its splits for the
card (``_ring_splits``, ``_paged_splits``: from the SM count and the work,
at most 8, one thread-block cluster per (row, KV head), no more clusters
than the card holds at once) and merges them inside its one launch, so a
call is one kernel and no other device work, and can be captured in a CUDA
graph.  It reads ``q_pos`` and ``prefix_len`` in place and masks a ragged
cache itself instead of padding it.

``LAUNCHES`` counts each kernel's launches: a wrapper adds one where it
launches its kernel and nowhere else, so a run can show that its main path
went through the kernels.  Each kernel also has a shape rule
(``flash_decode_shape``, ``paged_block_copy_leaves_shape``: the kernel's own
argument checks, then outputs of its shapes and types, with no card query,
for the fake tensors of the dry run) and a cost rule (``flash_decode_cost``,
``paged_block_copy_cost``: its FLOPs and bytes, each input read once and
each output written once, for ``repro_torch.obs.cost``).
``flash_decode_launcher`` is the flash-decode wrapper without its count,
to time the bare kernel.  The plain versions are
what ``repro_torch.kernels.ops`` runs for tensors on the CPU, and what the
card checks the kernels against.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional

import torch

from repro_torch.kernels.build import library
from repro_torch.obs.cost import aligned16, on_card, tensor_bytes

# Finite mask fill: -inf poisons the online-softmax recurrences on rows
# with no valid slot; with a finite floor masked probabilities are zeroed
# explicitly and a row with no valid slot comes out exactly 0.
_NEG = -1e30

_KINDS = {"causal": 0, "prefix": 1, "full": 2}
# The (G, D) head geometries both kernels are built for: those of the ported
# configurations (csrc/flash_decode.cu, with_heads): qwen3-0.6b's smoke
# config and full width (G 2, D 64 / 128; qwen3-1.7b and gemma2-27b too),
# fedtime-llama2-7b's (G 1, D 32 / 128; qwen2-moe-a2.7b too), smollm-360m's
# (G 3, D 64), mixtral-8x7b's (G 4, D 128), zamba2-2.7b's shared
# attention (G 1, D 80) and seamless-m4t-medium's self and cross attention
# (G 1, D 64; the smoke heads of qwen2-moe-a2.7b and zamba2-2.7b too).
HEAD_GEOMETRIES = ((2, 64), (2, 128), (1, 32), (1, 128), (3, 64), (4, 128),
                   (1, 80), (1, 64))
_KV_TYPES = {torch.bfloat16: 0, torch.float32: 1, torch.int8: 2}

LAUNCHES: Dict[str, int] = {"flash_decode": 0, "flash_decode_paged": 0,
                            "paged_block_copy": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# Shared helpers (the reference's, unchanged)
# ---------------------------------------------------------------------------

def _slot_mask(kp, qp, plen, *, kind: str, window: int):
    """Boolean keep-mask over KV slots from absolute positions (kp < 0 ==
    empty slot); mirrors the reference's ``_slot_mask``."""
    valid = kp >= 0
    if kind == "causal":
        m = kp <= qp
    elif kind == "prefix":
        m = (kp <= qp) | (kp < plen)
    elif kind == "full":
        m = torch.ones_like(valid)
    else:
        raise ValueError(kind)
    if window > 0 and kind != "full":
        m = m & (qp - kp < window)
    return m & valid


def _combine(m, l, acc, axis: int):
    """Merge independent online-softmax partials along ``axis``:
    out = sum_i exp(m_i - m*) acc_i / sum_i exp(m_i - m*) l_i: what the
    kernel's cluster merge computes in split order."""
    m_g = m.amax(dim=axis, keepdim=True)
    w = torch.exp(m - m_g)
    l_tot = (l * w).sum(dim=axis)
    acc_tot = (acc * w).sum(dim=axis)
    return acc_tot / torch.clamp(l_tot, min=1e-30)


def _rows(x, batch: int, device) -> torch.Tensor:
    """None, a Python int, or a scalar / (B,) tensor -> contiguous (B,)
    int32 on ``device``.  Python numbers become a device fill, never a
    host-to-device copy (a blocking copy would synchronise the stream)."""
    if x is None or isinstance(x, int):
        return torch.full((batch,), x or 0, dtype=torch.int32, device=device)
    t = torch.as_tensor(x).to(device=device, dtype=torch.int32).reshape(-1)
    return t.expand(batch).contiguous()


def paged_gather(k, v, kv_pos, k_scale, v_scale, block_tables):
    """The (B, T*block_size) logical cache view of a paged pool.

    k/v: (n_blocks, bs, Hk, D); block_tables: (B, T) physical block ids
    (-1 == ungranted: those slots come back with position -1, masked).  When
    T*bs equals a ring's length the view is bit-identical to that ring.
    Plain version only; the kernel reads the pool in place."""
    tbl = block_tables.long()
    B, T = tbl.shape
    safe = tbl.clamp(0, k.shape[0] - 1)

    def g(x):
        y = x[safe]                                # (B, T, bs, ...)
        return y.reshape((B, T * x.shape[1]) + tuple(x.shape[2:]))

    kv_pos_g = torch.where(tbl[:, :, None] >= 0, kv_pos[safe],
                           torch.full_like(kv_pos[safe], -1))
    kv_pos_g = kv_pos_g.reshape(B, T * kv_pos.shape[1])
    ks = g(k_scale) if k_scale is not None else None
    vs = g(v_scale) if v_scale is not None else None
    return g(k), g(v), kv_pos_g, ks, vs


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def flash_decode_ref(q, k, v, kv_pos, q_pos, *, k_scale=None, v_scale=None,
                     kind: str = "causal", window: int = 0, prefix_len=None,
                     softcap: float = 0.0, block_tables=None,
                     return_partials: bool = False, block_kv: int = 0,
                     n_splits: int = 0):
    """Plain decode step: dequantize the whole cache, form the full score
    matrix, masked f32 softmax.

    q: (B, 1, H, D); k, v: (B, S, Hk, D) rings (+ (B, S, Hk, 1) bf16 absmax
    scales for int8 caches), or with ``block_tables`` (B, T) an
    (n_blocks, bs, Hk, D) pool gathered to its logical view first; kv_pos:
    (B, S) / (S,) / (n_blocks, bs) slot positions (-1 == empty); q_pos
    scalar or (B,).  Returns (B, 1, H, D) in q.dtype, or with
    ``return_partials`` the f32 (m, l, acc) of shapes (B, Hk, G, 1) /
    (B, Hk, G, 1) / (B, Hk, G, D).  ``block_kv``/``n_splits`` tile the
    kernel's work and do not change the result."""
    del block_kv, n_splits
    if block_tables is not None:
        k, v, kv_pos, k_scale, v_scale = paged_gather(
            k, v, kv_pos, k_scale, v_scale, block_tables)
    B, S, Hk, D = k.shape
    H = q.shape[2]
    G = H // Hk
    kf, vf = k.float(), v.float()
    if k_scale is not None:
        kf = kf * k_scale.float()
        vf = vf * v_scale.float()
    qg = q[:, 0].reshape(B, Hk, G, D).float()
    s = torch.einsum("bhgd,bkhd->bhgk", qg, kf) * D ** -0.5
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    kv_pos = kv_pos.to(torch.int32)
    if kv_pos.ndim == 1:
        kv_pos = kv_pos[None].expand(B, S)
    kp = kv_pos[:, None, None, :]
    qp = _rows(q_pos, B, q.device).reshape(B, 1, 1, 1)
    plen = _rows(prefix_len, B, q.device).reshape(B, 1, 1, 1)
    mask = _slot_mask(kp, qp, plen, kind=kind, window=window)
    s = torch.where(mask, s, torch.full_like(s, _NEG))
    m = s.amax(dim=-1, keepdim=True)                 # (B, Hk, G, 1)
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhgk,bkhd->bhgd", p, vf)
    if return_partials:
        return m, l, acc
    out = acc / torch.clamp(l, min=1e-30)
    return out.reshape(B, 1, H, D).to(q.dtype)


def paged_block_copy_ref(leaf, src: int, dst: int):
    """Plain block copy, in place: ``leaf[:, dst] = leaf[:, src]``."""
    leaf[:, dst] = leaf[:, src]
    return leaf


def paged_block_copy_leaves_ref(leaves, src: int, dst: int):
    """Plain block copy of every leaf of an event, in place."""
    for leaf in leaves:
        paged_block_copy_ref(leaf, src, dst)
    return leaves


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float


_ARGTYPES = {
    "fd_flash_decode_ring": ([_P, _I, _P, _P, _P, _P, _P, _LL]
                             + [_P, _I, _I] * 2 + [_P] * 4 + [_I] * 8
                             + [_F, _F, _I, _P]),
    "fd_flash_decode_paged": ([_P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                               ctypes.c_uint, _I]
                              + [_P, _I, _I] * 2 + [_P] * 4 + [_I] * 7
                              + [_F, _F, _I, _P]),
    "fd_ring_max_clusters": [_I] * 4,
    "fd_paged_max_clusters": [_I] * 4,
}


def _fn(name: str):
    """The C entry ``name`` of ``csrc/flash_decode.cu``, typed."""
    fn = getattr(library("flash_decode"), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = _I
    return fn


# Leaves one block-copy launch takes (csrc/block_copy.cu, kMaxLeaves): an
# int8 pool's K, V, their scales and kv_pos fit.
MAX_COPY_LEAVES = 8


def _copy_lib():
    lib = library("block_copy")
    fn = lib.bc_block_copy_leaves
    if fn.argtypes is None:
        fn.argtypes = [_I, _P, _P, _P, _P, _LL, _LL, _P]
        fn.restype = _I
    return fn


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"flash_decode kernel: {msg}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


# ---------------------------------------------------------------------------
# The split policy (the card's, not the reference's)
# ---------------------------------------------------------------------------

MAX_SPLITS = 8               # one portable thread-block cluster
_MIN_SPLIT_SLOTS = 32        # a split streams at least this many slots
_SM_COUNT: Dict[int, int] = {}
_MAX_CLUSTERS: Dict[tuple, tuple] = {}


def _device_index(device) -> int:
    idx = torch.device(device).index
    return torch.cuda.current_device() if idx is None else idx


def _sm_count(device) -> int:
    """The device's SM count, read once per device."""
    idx = _device_index(device)
    n = _SM_COUNT.get(idx)
    if n is None:
        n = _SM_COUNT[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return n


def _max_clusters(layout: str, device, kv_type: int, G: int, D: int):
    """``c[n - 1]``: how many clusters of n blocks (n = 1..8) the device
    holds at once for the kernel of this layout ("ring" or "paged"), cache
    type and head geometry (G, D), the one a call with them launches
    (``cudaOccupancyMaxActiveClusters``), read once per device."""
    idx = _device_index(device)
    key = (layout, idx, kv_type, G, D)
    c = _MAX_CLUSTERS.get(key)
    if c is None:
        name = f"fd_{layout}_max_clusters"
        fn = _fn(name)
        with torch.cuda.device(idx):
            c = tuple(fn(kv_type, G, D, n) for n in range(1, MAX_SPLITS + 1))
        if min(c) < 0:
            raise RuntimeError(f"flash_decode {layout} kernel: the cluster "
                               f"occupancy query failed ({c})")
        _MAX_CLUSTERS[key] = c
    return c


def _card_splits(pairs: int, most: int, sm_count: int, requested: int,
                 max_clusters, layout: str) -> int:
    """The split count both layouts share: a request (at most 8) honoured
    up to ``most``; by default enough splits for about two blocks an SM,
    at most ``most`` and 8, and fewer where the card could not hold every
    (row, head)'s cluster at once."""
    _check_requested(requested, layout)
    if requested:
        return min(requested, most)
    pairs = max(1, pairs)
    per_pair = -(-2 * sm_count // pairs)
    n = max(1, min(MAX_SPLITS, per_pair, most))
    while max_clusters is not None and n > 1 and max_clusters[n - 1] < pairs:
        n -= 1
    return n


def _check_requested(requested: int, layout: str) -> None:
    if requested < 0 or requested > MAX_SPLITS:
        raise ValueError(f"flash_decode kernel: n_splits must be in "
                         f"[0, {MAX_SPLITS}] for the {layout}, not "
                         f"{requested}")


def _ring_splits(B: int, Hk: int, S: int, sm_count: int,
                 requested: int = 0, max_clusters=None):
    """``(n_splits, split_len)`` of the kernel for a (B, S, Hk, D) ring.

    The B * Hk (row, head) pairs are each cut into ``n_splits`` contiguous
    splits of ``floor(i * S / n)`` .. ``floor((i + 1) * S / n)`` slots, one
    block each, all the splits of a pair one cluster.  By default enough
    splits for about two blocks an SM, each of at least 32 slots, at most 8
    (the portable cluster): 8 at the fixed batch's B=4, Hk=8, S=576 on 132
    SMs (qwen3-0.6b: 256 blocks of 72 slots), 3 at Hk=32 (fedtime-llama2-7b:
    384 blocks of 192 slots).  Given ``max_clusters`` (the device's
    ``_max_clusters``), fewer where the card could not hold every pair's
    cluster at once: a cluster lives inside one GPC, so a kernel that fits
    two blocks an SM may not fit 32 clusters of 8.  A requested count is
    honoured up to S (no split is empty) and must be at most 8.
    ``split_len`` is the longest split."""
    most = S if requested else S // _MIN_SPLIT_SLOTS
    n = _card_splits(B * Hk, most, sm_count, requested, max_clusters, "ring")
    return n, -(-S // n)


def _paged_splits(B: int, Hk: int, T: int, bs: int, sm_count: int,
                  requested: int = 0, max_clusters=None):
    """``(n_splits, split_entries)`` of the kernel for a (B, T) block table
    over a pool of ``bs``-slot blocks.

    Each (row, head) pair's T table entries are cut into ``n_splits`` runs
    of whole entries, ``floor(i * T / n)`` .. ``floor((i + 1) * T / n)``, one
    block each, all the splits of a pair one cluster; the last split may be
    uneven.  The count follows ``_ring_splits``' rule over the T * bs
    logical slots (about two blocks an SM, splits of at least 32 slots, at
    most 8, no more than the card holds at once given ``max_clusters``), and
    never exceeds T: 3 at the engine's pool of qwen3-0.6b (B=12 lanes, Hk=8,
    T=8 entries of 16 slots: 288 blocks), 1 at fedtime-llama2-7b's (Hk=32:
    384 blocks).  A requested count is honoured up to T and must be at most
    8.  ``split_entries`` is the longest split."""
    most = T if requested else min(T, T * bs // _MIN_SPLIT_SLOTS)
    n = _card_splits(B * Hk, most, sm_count, requested, max_clusters,
                     "paged pool")
    return n, -(-T // n)


def _fast_divisor(d: int):
    """``(mul, shr)`` with ``n // d == (n * mul >> 32) >> shr`` for every
    ``0 <= n < 2**31`` (``mul`` 0 for d = 1: the quotient is n): the paged
    kernel's block index of a slot, a multiply and a shift in place of a
    division by the runtime block size."""
    if d == 1:
        return 0, 0
    p = 31 + (d - 1).bit_length()             # 31 + ceil(log2 d)
    return -(-(1 << p) // d), p - 32


def _scalar_or_rows(x, batch: int, dev, name: str):
    """(pointer, stride, value) of q_pos / prefix_len for the kernel: None
    or a Python int goes in as a value; an int32 tensor of one value or of
    (B,) is read in place with stride 0 or 1 (other integer types are
    converted first)."""
    if x is None or isinstance(x, int):
        return None, 0, int(x or 0)
    t = torch.as_tensor(x)
    _require(t.device == dev, f"{name} on q's device")
    if t.dtype != torch.int32:
        t = t.to(torch.int32)
    if t.numel() == 1:
        return t, 0, 0
    _require(t.ndim == 1 and t.shape[0] == batch, f"{name} must be a scalar "
             f"or (B,)")
    return t.contiguous(), 1, 0


def _common_checks(q, k, v, k_scale, v_scale, kind):
    _require(on_card(q), "q must be a CUDA tensor")
    B, one, H, D = q.shape
    _require(one == 1, "q must be (B, 1, H, D)")
    _require(q.dtype in (torch.bfloat16, torch.float32), "q must be bf16/f32")
    _require(k.dtype in _KV_TYPES and v.dtype == k.dtype,
             "k, v must share one of bf16/f32/int8")
    quant = k.dtype == torch.int8
    _require(quant == (k_scale is not None) == (v_scale is not None),
             "int8 caches need k_scale and v_scale, others take none")
    _require(kind in _KINDS, f"unknown kind {kind!r}")
    _require(k.ndim == 4 and v.shape == k.shape and k.shape[3] == D,
             "k, v must be (.., .., Hk, D) with q's D")
    Hk = k.shape[2]
    _require(H % Hk == 0 and (H // Hk, D) in HEAD_GEOMETRIES,
             f"(G, D) = (H/Hk, D) must be one of "
             f"{', '.join(map(str, HEAD_GEOMETRIES))} (the kernels' "
             f"instances); got H/Hk = {H}/{Hk}, D = {D}")
    if quant:
        _require(k_scale.dtype == torch.bfloat16
                 and v_scale.dtype == torch.bfloat16
                 and k_scale.shape == k.shape[:3] + (1,)
                 and v_scale.shape == k_scale.shape,
                 "scales must be bf16 (.., .., Hk, 1)")
    return B, H, D, Hk


def _check_tensors(tensors, dev):
    for t in tensors:
        if t is not None:
            _require(t.device == dev, "all tensors on q's device")
            _require(t.is_contiguous(), "tensors must be contiguous")
            _require(aligned16(t), "tensors must be 16B aligned")


class _Call:
    """A checked flash-decode call: its geometry and the kernel's view of
    ``q_pos`` / ``prefix_len`` (``_scalar_or_rows``)."""
    __slots__ = ("B", "H", "D", "Hk", "G", "paged", "T", "bs", "nb", "S",
                 "kvp_stride", "qp", "pl")


def _check_call(q, k, v, kv_pos, q_pos, *, k_scale=None, v_scale=None,
                kind: str = "causal", prefix_len=None, block_tables=None,
                n_splits: int = 0, **_) -> _Call:
    """Every argument check of the kernel that needs no card: devices,
    types, shapes, layouts, contiguity, alignment and the split request.
    Raises where the kernel would."""
    c = _Call()
    dev = q.device
    c.B, c.H, c.D, c.Hk = _common_checks(q, k, v, k_scale, v_scale, kind)
    c.G = c.H // c.Hk
    B = c.B
    _require(kv_pos.dtype == torch.int32, "kv_pos must be int32")
    tbl = block_tables
    c.paged = tbl is not None
    if c.paged:
        c.nb, c.bs = k.shape[:2]
        _require(tbl.dtype == torch.int32 and tbl.ndim == 2
                 and tbl.shape[0] == B and tbl.shape[1] >= 1,
                 "block_tables must be (B, T) int32")
        c.T = tbl.shape[1]
        _require(kv_pos.shape == (c.nb, c.bs),
                 "kv_pos must be (n_blocks, bs)")
        _require(c.T * c.bs < 2 ** 31 and c.nb * c.bs < 2 ** 31,
                 "the table and the pool must hold under 2**31 slots")
        _check_requested(n_splits, "paged pool")
    else:
        _require(k.shape[0] == B, "ring batch must match q")
        c.S = k.shape[1]
        _require(c.S >= 1, "the ring must hold a slot")
        if kv_pos.ndim == 1:
            _require(kv_pos.shape == (c.S,), "kv_pos must be (B, S) or (S,)")
            c.kvp_stride = 0
        else:
            _require(kv_pos.shape == (B, c.S),
                     "kv_pos must be (B, S) or (S,)")
            c.kvp_stride = c.S
        _check_requested(n_splits, "ring")
    _check_tensors((q, k, v, kv_pos, tbl, k_scale, v_scale), dev)
    c.qp = _scalar_or_rows(q_pos, B, dev, "q_pos")
    c.pl = _scalar_or_rows(prefix_len, B, dev, "prefix_len")
    return c


def _outputs(c: _Call, q, return_partials: bool):
    """The kernel's outputs, allocated: ``(out, m, l, acc)``."""
    if return_partials:
        m = torch.empty((c.B, c.Hk, c.G, 1), dtype=torch.float32,
                        device=q.device)
        acc = torch.empty((c.B, c.Hk, c.G, c.D), dtype=torch.float32,
                          device=q.device)
        return None, m, torch.empty_like(m), acc
    return torch.empty_like(q), None, None, None


def flash_decode_shape(q, k, v, kv_pos, q_pos, *,
                       return_partials: bool = False, **kw):
    """The kernel's shape rule: its argument checks, then its outputs
    (``flash_decode_ref``'s shapes and types), unwritten, with no card
    query and no launch.  What ``repro_torch.kernels.ops`` runs for fake
    tensors."""
    c = _check_call(q, k, v, kv_pos, q_pos, **kw)
    out, m, l, acc = _outputs(c, q, return_partials)
    return (m, l, acc) if return_partials else out


def flash_decode_cost(q, k, v, kv_pos, q_pos, *, k_scale=None, v_scale=None,
                      prefix_len=None, block_tables=None,
                      return_partials: bool = False, **_):
    """``(flops, bytes)`` of one call from its shapes: the QK and PV
    products over every slot the kernel walks (the ring's S, or the
    table's T entries of bs slots a row), 4 B H D slots FLOPs; each input
    read once (K, V, their scales and kv_pos at those slots, q, the table,
    q_pos and prefix_len where they are tensors) and the output written
    once."""
    B, _, H, D = q.shape
    tbl = block_tables
    if tbl is None:
        slots = B * k.shape[1]
        kvp = tensor_bytes(kv_pos)
    else:
        slots = B * tbl.shape[1] * k.shape[1]
        kvp = slots * kv_pos.element_size()
    per_slot = sum(math.prod(t.shape[2:]) * t.element_size()
                   for t in (k, v, k_scale, v_scale) if t is not None)
    if return_partials:
        out = B * H * (D + 2) * 4
    else:
        out = tensor_bytes(q)
    nbytes = (tensor_bytes((q, tbl, q_pos, prefix_len)) + slots * per_slot
              + kvp + out)
    return 4 * H * D * slots, nbytes


def flash_decode_launcher(q, k, v, kv_pos, q_pos, *, k_scale=None,
                          v_scale=None, kind: str = "causal", window: int = 0,
                          prefix_len=None, softcap: float = 0.0,
                          block_kv: int = 0, n_splits: int = 0,
                          block_tables=None, return_partials: bool = False):
    """Check the arguments and allocate the kernel's outputs.

    Returns ``(launch, outputs)``: ``launch()`` runs the kernel on the
    current stream, raises when the launch fails, and counts nothing; it is
    the whole of ``flash_decode_cuda`` but its count.  ``outputs`` is the
    (B, 1, H, D) output in q's type, or with ``return_partials`` the merged
    f32 ``(m, l, acc)`` of ``flash_decode_ref``'s shapes.  ``launch.grid``
    says its splits, blocks, cluster size and how many such clusters the
    card holds at once.  ``block_kv`` is the reference's tile and does not
    apply; ``n_splits`` (at most 8) fixes the split count instead of the
    card's choice (``_ring_splits``, ``_paged_splits``).

    Raises on a device, type, shape or layout the kernel does not take."""
    del block_kv
    _require(q.is_cuda, "q must be a CUDA tensor")
    c = _check_call(q, k, v, kv_pos, q_pos, k_scale=k_scale,
                    v_scale=v_scale, kind=kind, prefix_len=prefix_len,
                    block_tables=block_tables, n_splits=n_splits)
    dev = q.device
    B, Hk, G, D = c.B, c.Hk, c.G, c.D
    kv_type = _KV_TYPES[k.dtype]
    tbl = block_tables
    layout = "paged" if c.paged else "ring"
    resident = _max_clusters(layout, dev, kv_type, G, D)
    if c.paged:
        n, _ = _paged_splits(B, Hk, c.T, c.bs, _sm_count(dev), n_splits,
                             resident)
    else:
        n, _ = _ring_splits(B, Hk, c.S, _sm_count(dev), n_splits, resident)
    qp, pl = c.qp, c.pl
    out, m, l, acc = _outputs(c, q, return_partials)
    outs = (m, l, acc) if return_partials else out
    head = (q.data_ptr(), int(q.dtype == torch.float32), k.data_ptr(),
            v.data_ptr(), _ptr(k_scale), _ptr(v_scale), kv_pos.data_ptr())
    where = (_ptr(qp[0]), qp[1], qp[2], _ptr(pl[0]), pl[1], pl[2], _ptr(out),
             _ptr(m), _ptr(l), _ptr(acc), B, Hk, G, D)
    tail = (n, _KINDS[kind], int(window), float(softcap), float(D ** -0.5),
            kv_type)
    if c.paged:
        name = "fd_flash_decode_paged"
        args = (head + (tbl.data_ptr(), c.T, c.bs, c.nb,
                        *_fast_divisor(c.bs))
                + where + tail)
    else:
        name = "fd_flash_decode_ring"
        args = head + (c.kvp_stride,) + where + (c.S,) + tail
    fn = _fn(name)

    def launch():
        rc = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"flash_decode {layout} kernel launch failed "
                               f"(code {rc})")

    # the tensors behind the pointers, outputs included, live as long as
    # the launcher
    launch.tensors = (q, k, v, kv_pos, tbl, k_scale, v_scale, qp[0], pl[0],
                      out, m, l, acc)
    launch.grid = {"splits": n, "blocks": n * Hk * B, "cluster": n,
                   "resident_clusters": resident[n - 1]}
    return launch, outs


def flash_decode_cuda(q, k, v, kv_pos, q_pos, **kw):
    """The CUDA flash-decode kernel; same arguments and result as
    ``flash_decode_ref``.  Takes CUDA tensors only; raises on a device,
    type, shape or layout the kernel does not take.  A call, ring or paged,
    is one kernel launch and no other device work."""
    launch, out = flash_decode_launcher(q, k, v, kv_pos, q_pos, **kw)
    launch()
    name = "flash_decode" if kw.get("block_tables") is None else \
        "flash_decode_paged"
    LAUNCHES[name] += 1
    return out


def _check_copy(leaves, src: int, dst: int) -> None:
    """The block copy kernel's argument checks (no card needed)."""
    n = len(leaves)
    if not 1 <= n <= MAX_COPY_LEAVES:
        raise ValueError(f"block copy kernel: 1 to {MAX_COPY_LEAVES} "
                         f"leaves, got {n}")
    dev = leaves[0].device
    for leaf in leaves:
        if not on_card(leaf) or leaf.device != dev:
            raise ValueError("block copy kernel: leaves must be CUDA "
                             "tensors on one device")
        if leaf.ndim < 2 or not leaf.is_contiguous():
            raise ValueError("block copy kernel: leaf must be a contiguous "
                             "(L, n_blocks, ...) tensor")
        nb = leaf.shape[1]
        if not (0 <= src < nb and 0 <= dst < nb):
            raise ValueError(f"block copy kernel: src {src} / dst {dst} "
                             f"outside [0, {nb})")


def paged_block_copy_leaves_shape(leaves, src: int, dst: int):
    """The block copy's shape rule: its checks; the leaves, unchanged (the
    kernel writes them in place)."""
    leaves = list(leaves)
    _check_copy(leaves, int(src), int(dst))
    return leaves


def paged_block_copy_cost(leaves, src: int = 0, dst: int = 0):
    """``(flops, bytes)`` of one event: no products; every layer's block
    of every leaf read once and written once."""
    del src, dst
    return 0, sum(2 * leaf.shape[0] * math.prod(leaf.shape[2:])
                  * leaf.element_size() for leaf in leaves)


def paged_block_copy_leaves_cuda(leaves, src: int, dst: int):
    """The CUDA block-copy kernel: block ``src`` -> ``dst`` in every layer
    of each layer-stacked pool leaf ``(L, n_blocks, ...)``, in place, in one
    launch (at most ``MAX_COPY_LEAVES`` leaves)."""
    leaves = list(leaves)
    n = len(leaves)
    src, dst = int(src), int(dst)
    if n and not leaves[0].is_cuda:
        raise ValueError("block copy kernel: leaves must be CUDA tensors on "
                         "one device")
    _check_copy(leaves, src, dst)
    dev = leaves[0].device
    bases = (_P * n)(*(leaf.data_ptr() for leaf in leaves))
    layers = (_I * n)(*(leaf.shape[0] for leaf in leaves))
    n_blocks = (_LL * n)(*(leaf.shape[1] for leaf in leaves))
    block_bytes = (_LL * n)(*(leaf[0, 0].numel() * leaf.element_size()
                              for leaf in leaves))
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _copy_lib()(n, bases, layers, n_blocks, block_bytes, src, dst,
                     stream)
    if rc != 0:
        raise RuntimeError(f"block copy kernel launch failed (code {rc})")
    LAUNCHES["paged_block_copy"] += 1
    return leaves


def paged_block_copy_cuda(leaf, src: int, dst: int):
    """The one-leaf case: block ``src`` -> ``dst`` in every layer of the
    layer-stacked pool leaf ``(L, n_blocks, ...)``, in place."""
    paged_block_copy_leaves_cuda([leaf], src, dst)
    return leaf
