"""Attention: GQA + qk-norm + logit softcap + sliding window + prefix-LM,
with a memory-bounded blockwise (online-softmax) path for long sequences
and a ring-buffer (or paged-pool) KV cache for decode.

Position-based masking: every mask is derived from the absolute positions
of the query rows (``q_pos``) and of the KV slots (``kv_pos``); a slot with
position ``-1`` is invalid (empty ring slot).  One rule serves prefill,
sliding-window decode and prefix-LM.

Decode writes the new token's K/V into the cache IN PLACE (the reference
returns a new cache); ``attn_decode`` returns the same dict it was given.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from repro_torch.dist.decode import (cache_stripe, model_ways,
                                     stripe_flash_decode)
from repro_torch.dist.sharding import current_mesh
from repro_torch.kernels import ops
from repro_torch.models.layers.embeddings import apply_rope
from repro_torch.models.layers.linear import dense, init_dense
from repro_torch.models.layers.norms import init_rmsnorm, rmsnorm

_NEG_INF = torch.finfo(torch.float32).min


def init_attention(generator: torch.Generator, cfg, *, q_in: int | None = None,
                   kv_in: int | None = None, out_dim: int | None = None,
                   layers: int = 0, dtype=torch.float32, device=None):
    """q/k/v/o projections (+ per-head qk RMSNorm scales).  ``q_in`` /
    ``kv_in`` are the query and key/value inputs' widths and ``out_dim``
    the output's (each ``d_model`` by default; ``kv_in`` defaults to
    ``q_in``), as in the reference: zamba2's shared block reads
    ``concat(h, x0)``, 2 d_model wide, and writes d_model."""
    dh = cfg.resolved_head_dim()
    q_in = q_in or cfg.d_model
    kv_in = kv_in or q_in
    out_dim = out_dim or cfg.d_model
    kw = dict(layers=layers, dtype=dtype, device=device)
    p = {
        "wq": init_dense(generator, q_in, cfg.num_heads * dh, **kw),
        "wk": init_dense(generator, kv_in, cfg.num_kv_heads * dh, **kw),
        "wv": init_dense(generator, kv_in, cfg.num_kv_heads * dh, **kw),
        "wo": init_dense(generator, cfg.num_heads * dh, out_dim, **kw),
    }
    if cfg.qk_norm:
        p["q_norm"] = init_rmsnorm(dh, layers=layers, device=device)
        p["k_norm"] = init_rmsnorm(dh, layers=layers, device=device)
    return p


# ---------------------------------------------------------------------------
# Masking and full-sequence attention
# ---------------------------------------------------------------------------

def _as_b(pos, batch: int, device) -> torch.Tensor:
    pos = torch.as_tensor(pos, dtype=torch.int32, device=device)
    if pos.ndim == 1:
        pos = pos[None, :].expand(batch, pos.shape[0])
    return pos


def _mask(q_pos, kv_pos, kind: str, window: int, prefix_len):
    """(B, 1, 1, Sq, Skv) boolean mask from absolute positions."""
    qp = q_pos[:, None, None, :, None]
    kp = kv_pos[:, None, None, None, :]
    valid = kp >= 0
    if kind == "causal":
        m = kp <= qp
    elif kind == "prefix":
        pl = torch.as_tensor(prefix_len, dtype=torch.int32,
                             device=qp.device).reshape(-1, 1, 1, 1, 1)
        m = (kp <= qp) | (kp < pl)
    elif kind == "full":
        m = torch.ones(qp.shape[:-1] + (kp.shape[-1],), dtype=torch.bool,
                       device=qp.device)
    else:
        raise ValueError(kind)
    if window > 0 and kind != "full":
        m = m & (qp - kp < window)
    return m & valid


def _dequant_kv(x, scale, dtype):
    return (x.float() * scale.float()).to(dtype)


def _scores(q, k, softcap: float):
    """q (B, Sq, Hk, G, D), k (B, Skv, Hk, D) -> (B, Hk, G, Sq, Skv) f32."""
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float())
    s = s * q.shape[-1] ** -0.5
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    return s


def sdpa(q, k, v, *, q_pos, kv_pos, kind: str = "causal", window: int = 0,
         prefix_len=None, softcap: float = 0.0, block_q: int = 0,
         block_kv: int = 0, k_scale=None, v_scale=None,
         arange: bool = False):
    """Scaled dot-product attention with f32 scores and softmax.

    q: (B, Sq, H, D); k, v: (B, Skv, Hk, D); returns (B, Sq, H, D) in
    q.dtype.  ``block_kv`` > 0 (and Skv over it) selects the blockwise path
    of the reference: Q blocks of ``block_q`` rows, each an online softmax
    in f32 over KV blocks of ``block_kv`` slots, so no (Sq, Skv) score
    tensor is built.  Ragged tails are padded with position -1 (masked;
    padded Q rows are sliced off).  ``k_scale``/``v_scale`` ((B, Skv, Hk,
    1)) mark int8 k/v, dequantized one KV block at a time.  A fully masked
    row gives exactly 0 on both paths.  ``arange`` says that ``q_pos`` and
    ``kv_pos`` are both ``arange(S)`` (the trunk's own positions): the
    blockwise path then reads its causal skip table off the shapes instead
    of the positions, with no host read.

    Plain PyTorch on every device: the reference computes this in plain
    jnp, outside any Pallas kernel.
    """
    B, Sq, H, D = q.shape
    Hk = k.shape[2]
    G = H // Hk
    q_pos = _as_b(q_pos, B, q.device)
    kv_pos = _as_b(kv_pos, B, q.device)
    if block_kv > 0 and k.shape[1] > block_kv:
        return _sdpa_blockwise(q, k, v, q_pos, kv_pos, kind, window,
                               prefix_len, softcap, block_q, block_kv,
                               k_scale, v_scale, arange)
    if k_scale is not None:
        k = _dequant_kv(k, k_scale, q.dtype)
        v = _dequant_kv(v, v_scale, q.dtype)
    s = _scores(q.reshape(B, Sq, Hk, G, D), k, softcap)
    m = _mask(q_pos, kv_pos, kind, window, prefix_len)
    s = torch.where(m, s, torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1)
    # fully-masked rows produce uniform garbage; zero them via the mask
    p = torch.where(m.any(dim=-1, keepdim=True), p,
                    torch.zeros_like(p)).to(q.dtype)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.to(q.dtype))
    return o.reshape(B, Sq, H, D)


def _causal_live_blocks(q_pos, kv_pos, kind, block_q, block_kv,
                        arange_len: int = 0):
    """Under the causal mask, ``live[i][j]`` is False where no query of Q
    block i sees a slot of KV block j (every valid slot lies after the Q
    block's last position, or there is none): such a block is an exact
    no-op of the online softmax (p = 0, corr = 1), so skipping it changes
    no bit.  One host read of the positions; none where they are
    ``arange(arange_len)`` on both sides, padded with -1: Q block i's last
    position is then ``min(S, (i + 1) block_q) - 1`` and KV block j's
    first ``j block_kv``.  None for other kinds."""
    if kind != "causal":
        return None
    if arange_len:
        return [[j * block_kv <= min(arange_len, (i + 1) * block_q) - 1
                 for j in range(kv_pos.shape[1] // block_kv)]
                for i in range(q_pos.shape[1] // block_q)]
    B = q_pos.shape[0]
    q_last = q_pos.reshape(B, -1, block_q).amax(dim=(0, 2))
    none = torch.iinfo(kv_pos.dtype).max
    kv_first = torch.where(kv_pos >= 0, kv_pos, torch.full_like(
        kv_pos, none)).reshape(B, -1, block_kv).amin(dim=(0, 2))
    return (kv_first[None, :] <= q_last[:, None]).tolist()


def _sdpa_blockwise(q, k, v, q_pos, kv_pos, kind, window, prefix_len,
                    softcap, block_q, block_kv, k_scale, v_scale,
                    arange=False):
    B, Sq, H, D = q.shape
    Hk = k.shape[2]
    G = H // Hk
    pad_kv = -k.shape[1] % block_kv
    if pad_kv:
        pad4 = (0, 0, 0, 0, 0, pad_kv)
        k, v = F.pad(k, pad4), F.pad(v, pad4)
        kv_pos = F.pad(kv_pos, (0, pad_kv), value=-1)
        if k_scale is not None:
            k_scale, v_scale = F.pad(k_scale, pad4), F.pad(v_scale, pad4)
    if block_q <= 0 or Sq < block_q:
        block_q = Sq
    pad_q = -Sq % block_q
    if pad_q:
        q = F.pad(q, (0, 0, 0, 0, 0, pad_q))
        q_pos = F.pad(q_pos, (0, pad_q), value=-1)
    Sq_pad, Skv_pad = q.shape[1], k.shape[1]
    qg = q.reshape(B, Sq_pad, Hk, G, D)
    out = torch.empty((B, Sq_pad, Hk, G, D), dtype=q.dtype, device=q.device)
    live = _causal_live_blocks(q_pos, kv_pos, kind, block_q, block_kv,
                               Sq if arange else 0)
    for i in range(0, Sq_pad, block_q):
        qb, qpb = qg[:, i:i + block_q], q_pos[:, i:i + block_q]
        m_run = torch.full((B, Hk, G, block_q), _NEG_INF, device=q.device)
        l_run = torch.zeros((B, Hk, G, block_q), device=q.device)
        acc = torch.zeros((B, Hk, G, block_q, D), device=q.device)
        for j in range(0, Skv_pad, block_kv):
            if live is not None and not live[i // block_q][j // block_kv]:
                continue
            kb, vb = k[:, j:j + block_kv], v[:, j:j + block_kv]
            if k_scale is not None:           # dequantized a block at a time
                kb = _dequant_kv(kb, k_scale[:, j:j + block_kv], q.dtype)
                vb = _dequant_kv(vb, v_scale[:, j:j + block_kv], q.dtype)
            msk = _mask(qpb, kv_pos[:, j:j + block_kv], kind, window,
                        prefix_len)
            s = torch.where(msk, _scores(qb, kb, softcap),
                            torch.full((), _NEG_INF, device=q.device))
            m_new = torch.maximum(m_run, s.amax(dim=-1))
            # masked slots add exactly 0, so a row with no valid slot keeps
            # l = 0 and comes out 0
            p = torch.where(msk, torch.exp(s - m_new[..., None]),
                            torch.zeros((), device=q.device))
            corr = torch.exp(m_run - m_new)
            l_run = l_run * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", p.to(vb.dtype), vb).float()
            m_run = m_new
        o = acc / torch.clamp(l_run, min=1e-30)[..., None]
        out[:, i:i + block_q] = o.permute(0, 3, 1, 2, 4).to(q.dtype)
    return out.reshape(B, Sq_pad, H, D)[:, :Sq]


def _project_qkv(params, cfg, x, positions, kv_x=None, kv_positions=None,
                 use_rope: bool = True):
    """q from ``x``, k and v from ``kv_x`` (``x`` by default), each with
    the config's qk-norm, then RoPE at ``positions`` / ``kv_positions``
    (``positions`` by default) unless ``use_rope`` is off (a cross
    attention's memory carries no positions of the queries' sequence)."""
    dh = cfg.resolved_head_dim()
    kv_x = x if kv_x is None else kv_x
    B, Sq, Skv = x.shape[0], x.shape[1], kv_x.shape[1]
    q = dense(params["wq"], x).reshape(B, Sq, cfg.num_heads, dh)
    k = dense(params["wk"], kv_x).reshape(B, Skv, cfg.num_kv_heads, dh)
    v = dense(params["wv"], kv_x).reshape(B, Skv, cfg.num_kv_heads, dh)
    if cfg.qk_norm:
        q = rmsnorm(params["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(params["k_norm"], k, cfg.norm_eps)
    if use_rope:
        kv_positions = positions if kv_positions is None else kv_positions
        q = apply_rope(q, _as_b(positions, B, x.device), cfg.rope_theta)
        k = apply_rope(k, _as_b(kv_positions, B, x.device), cfg.rope_theta)
    return q, k, v


def attention(params, cfg, x, *, positions, kind: str = "causal",
              window: int = 0, prefix_len=None, kv_x=None, kv_positions=None,
              use_rope: bool = True, block_q: int = 0, block_kv: int = 0,
              return_kv: bool = False):
    """Full-sequence attention. x: (B, S, d_in) -> (B, S, out_dim).

    Self-attention by default; with ``kv_x`` (B, Skv, d_kv) a cross
    attention whose keys and values come from ``kv_x`` at
    ``kv_positions`` (an encoder-decoder's memory, with ``use_rope`` off).
    A self-attention's ``positions`` are ``arange(S)``, as every caller
    builds them, so the blockwise path reads its causal skip table off the
    shapes (``sdpa``'s ``arange``); a cross call reads its positions."""
    self_attn = kv_x is None and kv_positions is None
    q, k, v = _project_qkv(params, cfg, x, positions, kv_x, kv_positions,
                           use_rope)
    o = sdpa(q, k, v, q_pos=positions,
             kv_pos=positions if kv_positions is None else kv_positions,
             kind=kind, window=window, prefix_len=prefix_len,
             softcap=cfg.attn_logit_softcap, block_q=block_q,
             block_kv=block_kv, arange=self_attn)
    B, S = x.shape[0], x.shape[1]
    y = dense(params["wo"], o.reshape(B, S, -1))
    if return_kv:
        return y, (k, v)
    return y


# ---------------------------------------------------------------------------
# Decode with ring-buffer / paged KV cache
# ---------------------------------------------------------------------------

def kv_cache_int8() -> bool:
    """int8 KV cache with per-slot, per-head absmax scales; the reference's
    ``REPRO_KV_INT8`` switch, read the same way."""
    return os.environ.get("REPRO_KV_INT8", "0") == "1"


def init_attn_cache(batch: int, cache_len: int, num_kv_heads: int,
                    head_dim: int, *, layers: int = 0, dtype=torch.bfloat16,
                    device=None):
    """Empty ring cache (all positions -1); ``layers`` > 0 stacks a leading
    layer axis.  For a paged pool, ``batch`` is the block count and
    ``cache_len`` the block size."""
    lead = (layers,) if layers else ()
    shape = lead + (batch, cache_len, num_kv_heads, head_dim)
    pos = torch.full(lead + (batch, cache_len), -1, dtype=torch.int32,
                     device=device)
    if kv_cache_int8():
        sshape = shape[:-1] + (1,)
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(sshape, dtype=torch.bfloat16,
                                   device=device),
            "v_scale": torch.zeros(sshape, dtype=torch.bfloat16,
                                   device=device),
            "kv_pos": pos,
        }
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "kv_pos": pos}


def _quant_kv(x):
    """(..., dh) -> (int8 codes, bf16 scales (..., 1))."""
    x32 = x.float()
    amax = x32.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-6) / 127.0
    q = torch.clamp(torch.round(x32 / scale), -127, 127)
    return q.to(torch.int8), scale.to(torch.bfloat16)


def _write_rows(buf, idx, keep, val):
    """``buf[idx[b]] = val[b]`` for the rows where ``keep[b]``, without a
    host sync.  A row that must not write (inactive lane, ungranted block)
    is pointed at the first kept row's target with that row's value, so
    duplicate indices always carry one value; with no kept row every row
    rewrites the value already stored at index 0."""
    first = keep.to(torch.int32).argmax().reshape(1)   # 0 when none kept
    any_keep = keep.index_select(0, first)[0]
    tgt = torch.where(any_keep, idx.index_select(0, first)[0],
                      torch.zeros_like(idx[0]))
    val_first = torch.where(any_keep, val.index_select(0, first)[0],
                            buf.index_select(0, tgt.reshape(1))[0])
    rows = keep.reshape((-1,) + (1,) * (val.ndim - 1))
    buf[torch.where(keep, idx, tgt)] = torch.where(rows, val, val_first)


def attn_decode(params, cfg, x_t, cache, pos, *, window: int = 0,
                kind: str = "causal", prefix_len=None, block_tbl=None,
                ring_len=None):
    """One decode step.

    x_t: (B, 1, d); ``pos`` a scalar (every row at one position) or (B,)
    per-row positions (ragged continuous batching; ``pos[b] == -1`` marks
    row b inactive: its ring slot is left untouched and its output is
    fully masked, so exactly 0).  cache: one layer's ring from
    ``init_attn_cache``.  Returns (y_t, cache) with the cache updated in
    place.

    Paged mode (``block_tbl`` (B, T) int32 + ``ring_len``): the cache
    leaves are a shared block pool — k/v (n_blocks, bs, Hk, D), kv_pos
    (n_blocks, bs) — and row b's ring slot ``pos % ring_len`` resolves
    through its table row to a physical slot.  Inactive rows and ungranted
    blocks write nothing (live requests never share a write block: the
    engine copies a shared block before writing into it).

    Attention over the cache goes through ``ops.flash_decode``: the CUDA
    kernel on the card, its plain version on the CPU.

    Under an ambient mesh (``dist.sharding.use_mesh``) whose ``model`` axis
    is real, the cache this layer receives is this rank's own stripe and
    ``x_t``/``pos`` are this rank's rows: a ring stripe holds global slots
    ``[lo, lo + S_loc)`` of ``S_loc * model``, a pool stripe blocks ``[lo,
    lo + n_loc)`` (the table stays global).  Only the rank whose stripe
    holds a row's slot writes it; then the kernel runs on the stripe and
    the partials are combined over ``model``
    (``dist.decode.stripe_flash_decode``).  A layout with ``model`` on the
    heads (``REPRO_CACHE_SHARD=heads``) needs tensor-parallel projections,
    which are not ported: it raises ``NotImplementedError``.
    """
    B = x_t.shape[0]
    dev = x_t.device
    paged = block_tbl is not None
    int8 = "k_scale" in cache
    if isinstance(pos, int):           # a device fill, not a blocking copy
        pos = torch.full((), pos, dtype=torch.int32, device=dev)
    pos = pos.to(device=dev, dtype=torch.int32)
    ragged = pos.ndim == 1
    if paged and not ragged:
        raise ValueError("paged decode requires per-row (B,) positions")
    pos_b = pos[:, None] if ragged else pos.reshape(1, 1).expand(B, 1)
    q, k_t, v_t = _project_qkv(params, cfg, x_t, pos_b)
    new = {}
    if int8:
        new["k"], new["k_scale"] = _quant_kv(k_t[:, 0])
        new["v"], new["v_scale"] = _quant_kv(v_t[:, 0])
    else:
        new["k"], new["v"] = k_t[:, 0], v_t[:, 0]

    ways = model_ways(current_mesh())
    mesh, lo, _ = cache_stripe(cache["k"].shape[0 if paged else 1] * ways)

    if paged:
        n_blocks, bs = cache["k"].shape[:2]
        slot = torch.remainder(pos.clamp(min=0), ring_len)
        rows = torch.arange(B, device=dev)
        pb = block_tbl[rows, slot // bs].long() - lo       # physical block
        keep = (pos >= 0) & (pb >= 0) & (pb < n_blocks)
        idx = pb * bs + slot % bs
        for name, val in new.items():
            buf = cache[name]
            _write_rows(buf.view((n_blocks * bs,) + buf.shape[2:]), idx,
                        keep, val.to(buf.dtype))
        _write_rows(cache["kv_pos"].view(-1), idx, keep, pos)
    elif ragged or mesh is not None:
        # every row writes its own lane: inactive rows, and rows whose slot
        # lies on another rank's stripe, rewrite the old slot
        cache_len = cache["k"].shape[1]
        pos_r = pos if ragged else pos.reshape(1).expand(B)
        slots = torch.remainder(pos_r.clamp(min=0), cache_len * ways) - lo
        keep_r = (pos_r >= 0) & (slots >= 0) & (slots < cache_len)
        slots = slots.clamp(0, cache_len - 1).long()
        rows = torch.arange(B, device=dev)
        for name, val in new.items():
            buf = cache[name]
            keep = keep_r.reshape((B,) + (1,) * (val.ndim - 1))
            buf[rows, slots] = torch.where(keep, val.to(buf.dtype),
                                           buf[rows, slots])
        kvp = cache["kv_pos"]
        kvp[rows, slots] = torch.where(keep_r, pos_r, kvp[rows, slots])
    else:
        cache_len = cache["k"].shape[1]
        slot = torch.remainder(pos, cache_len).reshape(1).long()
        for name, val in new.items():
            buf = cache[name]
            buf.index_copy_(1, slot, val[:, None].to(buf.dtype))
        cache["kv_pos"].index_copy_(1, slot, pos_b)

    kw = dict(k_scale=cache.get("k_scale"), v_scale=cache.get("v_scale"),
              kind=kind, window=window, prefix_len=prefix_len,
              softcap=cfg.attn_logit_softcap, block_tables=block_tbl)
    if mesh is not None:
        o = stripe_flash_decode(q, cache["k"], cache["v"], cache["kv_pos"],
                                pos, mesh, **kw)
    else:
        o = ops.flash_decode(q.contiguous(), cache["k"], cache["v"],
                             cache["kv_pos"], pos, **kw)
    y = dense(params["wo"], o.reshape(B, 1, -1))
    return y, cache


def attn_cross_decode(params, cfg, x_t, mem_k, mem_v, mem_pos):
    """One decode step of a cross attention against a fixed memory.

    x_t: (B, 1, d); mem_k, mem_v: (B, F, Hk, D) one layer's memory K/V,
    projected once at prefill with no RoPE; mem_pos: (B, F) int32, -1 on an
    empty slot.  q is projected (and qk-normed where the config says so)
    and attends through ``ops.flash_decode`` with ``kind="full"`` at q
    position 0: every valid memory slot takes part, a slot at -1 adds
    nothing, and a row with no valid slot decodes to exactly 0.  The CUDA
    kernel on the card, its plain version on the CPU.  The memory is not
    changed.

    Under an ambient mesh with a real ``model`` axis the memory this layer
    receives is this rank's stripe of its slots (``dist.sharding``'s seq
    layout of ``mem_k``), and the partials are combined over ``model``
    (``dist.decode.stripe_flash_decode``), as the self ring's are."""
    B = x_t.shape[0]
    dh = cfg.resolved_head_dim()
    q = dense(params["wq"], x_t).reshape(B, 1, cfg.num_heads, dh)
    if cfg.qk_norm:
        q = rmsnorm(params["q_norm"], q, cfg.norm_eps)
    ways = model_ways(current_mesh())
    mesh, _, _ = cache_stripe(mem_k.shape[1] * ways)
    kw = dict(kind="full", softcap=cfg.attn_logit_softcap)
    if mesh is not None:
        o = stripe_flash_decode(q, mem_k, mem_v, mem_pos, 0, mesh, **kw)
    else:
        o = ops.flash_decode(q.contiguous(), mem_k, mem_v, mem_pos, 0, **kw)
    return dense(params["wo"], o.reshape(B, 1, -1))
