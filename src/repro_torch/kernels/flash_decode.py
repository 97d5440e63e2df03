"""Flash-decode over ring or paged KV caches, and the paged pool's block copy.

Three CUDA kernels (``csrc/flash_decode.cu``, ``csrc/block_copy.cu``) with
their plain PyTorch versions beside them:

  * ``flash_decode_cuda`` without ``block_tables`` replaces the TPU kernel
    ``repro/kernels/flash_decode.py::flash_decode``: one decode token per
    request against its contiguous ring ``(B, S, Hk, D)``.
  * ``flash_decode_cuda`` with ``block_tables`` replaces
    ``::_flash_decode_paged``: the same body over one shared pool
    ``(n_blocks, block_size, Hk, D)`` read through the ``(B, T)`` table.
  * ``paged_block_copy_cuda`` replaces ``::paged_block_copy``: the
    copy-on-write move of one block across every layer of a pool leaf.

Flash-decode is bound by bytes on the H100: at B=4, S=4096, Hk=8, D=128 in
bf16 one call reads 67.1 MB of K and V, about 20 us at 3.35 TB/s.  The
block copy is bound by launch latency (1.8 MB per K or V leaf at
qwen3-0.6b with 16-slot blocks).  The kernels' sources say how their
design answers that.

The ring kernel picks its splits for the card (``_ring_splits``: from the
SM count and the work, at most 8, one thread-block cluster per (row, KV
head)) and merges them inside its one launch, so a ring call is one kernel
and no other device work.  The paged kernel keeps the reference's split
policy (``_auto_block_kv``, ``_pick_splits``), and its per-split (m, l,
acc) partials are combined here in plain PyTorch, as the reference
combines them outside Pallas.  Both kernels mask a ragged cache length
themselves instead of padding the cache.

``LAUNCHES`` counts each kernel's launches: a wrapper adds one where it
launches its kernel and nowhere else, so a run can show that its main path
went through the kernels.  ``flash_decode_launcher`` is the flash-decode
wrapper without its count (and, for the paged pool, without the combine),
to time the bare kernel.  The plain versions are what
``repro_torch.kernels.ops`` runs for tensors on the CPU, and what the card
checks the kernels against.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from repro_torch.kernels.build import library

# Finite mask fill: -inf poisons the online-softmax recurrences on rows
# with no valid slot; with a finite floor masked probabilities are zeroed
# explicitly and a row with no valid slot comes out exactly 0.
_NEG = -1e30

_KINDS = {"causal": 0, "prefix": 1, "full": 2}
_KV_TYPES = {torch.bfloat16: 0, torch.float32: 1, torch.int8: 2}

LAUNCHES: Dict[str, int] = {"flash_decode": 0, "flash_decode_paged": 0,
                            "paged_block_copy": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# Block policy and shared helpers (the reference's, unchanged)
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


def _pick_splits(n_blocks: int, requested: int) -> int:
    """Largest split count <= requested that divides the block count."""
    n = requested or (8 if n_blocks >= 32 else 4 if n_blocks >= 8 else 1)
    n = max(1, min(n, n_blocks))
    while n_blocks % n:
        n -= 1
    return n


def _auto_block_kv(S: int) -> int:
    """KV tile from the cache length: ~16 tiles, between 128 and 1024
    slots."""
    per = -(-S // 16)
    per = -(-per // 128) * 128
    return int(max(128, min(1024, per)))


def _combine(m, l, acc, axis: int):
    """Merge independent online-softmax partials along ``axis``:
    out = sum_i exp(m_i - m*) acc_i / sum_i exp(m_i - m*) l_i."""
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


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong


def _paged_lib():
    fn = library("flash_decode").fd_flash_decode_paged
    if fn.argtypes is None:
        fn.argtypes = ([_P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P]
                       + [_I] * 10 + [ctypes.c_float, ctypes.c_float, _I, _P])
        fn.restype = _I
    return fn


def _ring_lib():
    fn = library("flash_decode").fd_flash_decode_ring
    if fn.argtypes is None:
        fn.argtypes = ([_P, _I, _P, _P, _P, _P, _P, _LL, _P, _I, _I, _P, _I,
                        _I, _P, _P, _P, _P] + [_I] * 8
                       + [ctypes.c_float, ctypes.c_float, _I, _P])
        fn.restype = _I
    return fn


def _copy_lib():
    lib = library("block_copy")
    fn = lib.bc_block_copy
    if fn.argtypes is None:
        fn.argtypes = [_P, _I, _LL, _LL, _LL, _LL, _P]
        fn.restype = _I
    return fn


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"flash_decode kernel: {msg}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


# ---------------------------------------------------------------------------
# The ring's split policy (the card's, not the reference's)
# ---------------------------------------------------------------------------

MAX_RING_SPLITS = 8          # one portable thread-block cluster
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


def _ring_max_clusters(device, kv_type: int, D: int):
    """``c[n - 1]``: how many clusters of n ring blocks (n = 1..8) the
    device holds at once for the kernel of this cache type and D
    (``cudaOccupancyMaxActiveClusters``), read once per device."""
    idx = _device_index(device)
    key = (idx, kv_type, D)
    c = _MAX_CLUSTERS.get(key)
    if c is None:
        fn = library("flash_decode").fd_ring_max_clusters
        if fn.argtypes is None:
            fn.argtypes = [_I, _I, _I]
            fn.restype = _I
        with torch.cuda.device(idx):
            c = tuple(fn(kv_type, D, n)
                      for n in range(1, MAX_RING_SPLITS + 1))
        if min(c) < 0:
            raise RuntimeError(f"flash_decode ring kernel: the cluster "
                               f"occupancy query failed ({c})")
        _MAX_CLUSTERS[key] = c
    return c


def _ring_splits(B: int, Hk: int, S: int, sm_count: int,
                 requested: int = 0, max_clusters=None):
    """``(n_splits, split_len)`` of the ring kernel for a (B, S, Hk, D) ring.

    The B * Hk (row, head) pairs are each cut into ``n_splits`` contiguous
    splits of ``floor(i * S / n)`` .. ``floor((i + 1) * S / n)`` slots, one
    block each, all the splits of a pair one cluster.  By default enough
    splits for about two blocks an SM, each of at least 32 slots, at most 8
    (the portable cluster): 8 at the fixed batch's B=4, Hk=8, S=576 on 132
    SMs (256 blocks of 72 slots).  Given ``max_clusters`` (the device's
    ``_ring_max_clusters``), fewer where the card could not hold every
    pair's cluster at once: a cluster lives inside one GPC, so a kernel
    that fits two blocks an SM may not fit 32 clusters of 8.  A requested
    count is honoured up to S (no split is empty) and must be at most 8.
    ``split_len`` is the longest split."""
    if requested < 0 or requested > MAX_RING_SPLITS:
        raise ValueError(f"flash_decode kernel: n_splits must be in "
                         f"[0, {MAX_RING_SPLITS}] for the ring, not "
                         f"{requested}")
    if requested:
        n = min(requested, S)
    else:
        pairs = max(1, B * Hk)
        per_pair = -(-2 * sm_count // pairs)
        n = max(1, min(MAX_RING_SPLITS, per_pair, S // _MIN_SPLIT_SLOTS))
        while max_clusters is not None and n > 1 and \
                max_clusters[n - 1] < pairs:
            n -= 1
    return n, -(-S // n)


def _scalar_or_rows(x, batch: int, dev, name: str):
    """(pointer, stride, value) of q_pos / prefix_len for the ring kernel:
    None or a Python int goes in as a value; an int32 tensor of one value
    or of (B,) is read in place with stride 0 or 1 (other integer types
    are converted first)."""
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
    _require(q.is_cuda, "q must be a CUDA tensor")
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
    # the head geometries of the ported configurations (csrc/flash_decode.cu)
    _require(H == 2 * Hk, "G = H/Hk must be 2")
    _require(D in (64, 128), "D must be 64 or 128")
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
            _require(t.data_ptr() % 16 == 0, "tensors must be 16B aligned")


def _ring_launcher(q, k, v, kv_pos, q_pos, *, k_scale, v_scale, kind,
                   window, prefix_len, softcap, n_splits, return_partials):
    dev = q.device
    B, H, D, Hk = _common_checks(q, k, v, k_scale, v_scale, kind)
    G = H // Hk
    _require(k.shape[0] == B, "ring batch must match q")
    S = k.shape[1]
    _require(S >= 1, "the ring must hold a slot")
    _require(kv_pos.dtype == torch.int32, "kv_pos must be int32")
    if kv_pos.ndim == 1:
        _require(kv_pos.shape == (S,), "kv_pos must be (B, S) or (S,)")
        kvp_stride = 0
    else:
        _require(kv_pos.shape == (B, S), "kv_pos must be (B, S) or (S,)")
        kvp_stride = S
    _check_tensors((q, k, v, kv_pos, k_scale, v_scale), dev)
    qp, qp_stride, qp_val = _scalar_or_rows(q_pos, B, dev, "q_pos")
    pl, pl_stride, pl_val = _scalar_or_rows(prefix_len, B, dev,
                                            "prefix_len")
    kv_type = _KV_TYPES[k.dtype]
    resident = _ring_max_clusters(dev, kv_type, D)
    n, _ = _ring_splits(B, Hk, S, _sm_count(dev), n_splits, resident)
    if return_partials:
        m = torch.empty((B, Hk, G, 1), dtype=torch.float32, device=dev)
        l = torch.empty_like(m)
        acc = torch.empty((B, Hk, G, D), dtype=torch.float32, device=dev)
        out, outs = None, (m, l, acc)
    else:
        out = torch.empty_like(q)
        m = l = acc = None
        outs = out
    fn = _ring_lib()
    args = (q.data_ptr(), int(q.dtype == torch.float32), k.data_ptr(),
            v.data_ptr(), _ptr(k_scale), _ptr(v_scale), kv_pos.data_ptr(),
            kvp_stride, _ptr(qp), qp_stride, qp_val, _ptr(pl), pl_stride,
            pl_val, _ptr(out), _ptr(m), _ptr(l), _ptr(acc), B, Hk, G, D, S,
            n, _KINDS[kind], int(window), float(softcap), float(D ** -0.5),
            kv_type)

    def launch():
        rc = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"flash_decode ring kernel launch failed "
                               f"(code {rc})")

    # the tensors behind the pointers, outputs included, live as long as
    # the launcher
    launch.tensors = (q, k, v, kv_pos, k_scale, v_scale, qp, pl, out, m, l,
                      acc)
    launch.grid = {"splits": n, "blocks": n * Hk * B, "cluster": n,
                   "resident_clusters": resident[n - 1]}
    return launch, outs


def _paged_launcher(q, k, v, kv_pos, q_pos, *, k_scale, v_scale, kind,
                    window, prefix_len, softcap, n_splits, block_tables):
    dev = q.device
    B, H, D, Hk = _common_checks(q, k, v, k_scale, v_scale, kind)
    G = H // Hk
    nb, bs = k.shape[:2]
    tbl = block_tables
    _require(tbl.dtype == torch.int32 and tbl.ndim == 2
             and tbl.shape[0] == B, "block_tables must be (B, T) int32")
    T = tbl.shape[1]
    _require(kv_pos.shape == (nb, bs), "kv_pos must be (n_blocks, bs)")
    n_splits = _pick_splits(T, n_splits)
    split_len = (T // n_splits) * bs
    _require(kv_pos.dtype == torch.int32, "kv_pos must be int32")
    kv_pos = kv_pos.contiguous()
    tensors = [q, k, v, kv_pos, tbl, k_scale, v_scale]
    _check_tensors(tensors, dev)
    qp = _rows(q_pos, B, dev)
    plen = _rows(prefix_len, B, dev)
    m = torch.empty((B, Hk, n_splits, G), dtype=torch.float32, device=dev)
    l = torch.empty_like(m)
    acc = torch.empty((B, Hk, n_splits, G, D), dtype=torch.float32,
                      device=dev)
    fn = _paged_lib()
    args = (q.data_ptr(), int(q.dtype == torch.float32), k.data_ptr(),
            v.data_ptr(), _ptr(k_scale), _ptr(v_scale), kv_pos.data_ptr(),
            tbl.data_ptr(), qp.data_ptr(), plen.data_ptr(), m.data_ptr(),
            l.data_ptr(), acc.data_ptr(), B, Hk, G, D, bs, T, n_splits,
            split_len, _KINDS[kind], int(window), float(softcap),
            float(D ** -0.5), _KV_TYPES[k.dtype])

    def launch():
        rc = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"flash_decode kernel launch failed (code "
                               f"{rc})")

    launch.tensors = (*tensors, qp, plen, m, l, acc)
    launch.grid = {"splits": n_splits, "blocks": n_splits * Hk * B,
                   "cluster": 1}
    return launch, (m, l, acc)


def flash_decode_launcher(q, k, v, kv_pos, q_pos, *, k_scale=None,
                          v_scale=None, kind: str = "causal", window: int = 0,
                          prefix_len=None, softcap: float = 0.0,
                          block_kv: int = 0, n_splits: int = 0,
                          block_tables=None, return_partials: bool = False):
    """Check the arguments and allocate the kernel's outputs.

    Returns ``(launch, outputs)``: ``launch()`` runs the kernel on the
    current stream, raises when the launch fails, and counts nothing;
    ``launch.grid`` says its splits, blocks and cluster size.

    * The ring (no ``block_tables``): ``outputs`` is the (B, 1, H, D)
      output in q's type, or with ``return_partials`` the merged f32
      ``(m, l, acc)`` of ``flash_decode_ref``'s shapes; ``launch`` is the
      whole of ``flash_decode_cuda`` but its count.  ``block_kv`` is the
      reference's tile and does not apply; ``n_splits`` (at most 8) fixes
      the split count instead of ``_ring_splits``' choice.
    * The paged pool: ``outputs`` is the per-split f32 partials ``m``,
      ``l`` of shape (B, Hk, n_splits, G) and ``acc`` (B, Hk, n_splits, G,
      D), which ``flash_decode_cuda`` combines in PyTorch.

    Raises on a device, type, shape or layout the kernel does not take."""
    del block_kv
    kw = dict(k_scale=k_scale, v_scale=v_scale, kind=kind, window=window,
              prefix_len=prefix_len, softcap=softcap, n_splits=n_splits)
    if block_tables is None:
        return _ring_launcher(q, k, v, kv_pos, q_pos,
                              return_partials=return_partials, **kw)
    return _paged_launcher(q, k, v, kv_pos, q_pos, block_tables=block_tables,
                           **kw)


def flash_decode_cuda(q, k, v, kv_pos, q_pos, *, return_partials=False,
                      **kw):
    """The CUDA flash-decode kernel; same arguments and result as
    ``flash_decode_ref``.  Takes CUDA tensors only; raises on a device,
    type, shape or layout the kernel does not take.  A ring call is one
    kernel launch and no other device work."""
    if kw.get("block_tables") is None:
        launch, out = flash_decode_launcher(
            q, k, v, kv_pos, q_pos, return_partials=return_partials, **kw)
        launch()
        LAUNCHES["flash_decode"] += 1
        return out
    launch, (m, l, acc) = flash_decode_launcher(q, k, v, kv_pos, q_pos, **kw)
    launch()
    LAUNCHES["flash_decode_paged"] += 1
    B, _, H, D = q.shape
    m, l = m[..., None], l[..., None]
    if return_partials:
        m_loc = m.amax(dim=2)
        w = torch.exp(m - m_loc[:, :, None])
        return m_loc, (l * w).sum(dim=2), (acc * w).sum(dim=2)
    out = _combine(m, l, acc, axis=2)                # (B, Hk, G, D)
    return out.reshape(B, 1, H, D).to(q.dtype)


def paged_block_copy_cuda(leaf, src: int, dst: int):
    """The CUDA block-copy kernel: block ``src`` -> ``dst`` in every layer
    of the layer-stacked pool leaf ``(L, n_blocks, ...)``, in place."""
    if not leaf.is_cuda:
        raise ValueError("block copy kernel: leaf must be a CUDA tensor")
    if leaf.ndim < 2 or not leaf.is_contiguous():
        raise ValueError("block copy kernel: leaf must be a contiguous "
                         "(L, n_blocks, ...) tensor")
    L, nb = leaf.shape[:2]
    src, dst = int(src), int(dst)
    if not (0 <= src < nb and 0 <= dst < nb):
        raise ValueError(f"block copy kernel: src {src} / dst {dst} outside "
                         f"[0, {nb})")
    block_bytes = leaf[0, 0].numel() * leaf.element_size()
    stream = torch.cuda.current_stream(leaf.device).cuda_stream
    rc = _copy_lib()(leaf.data_ptr(), L, nb, block_bytes, src, dst, stream)
    if rc != 0:
        raise RuntimeError(f"block copy kernel launch failed (code {rc})")
    LAUNCHES["paged_block_copy"] += 1
    return leaf
