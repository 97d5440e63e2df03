"""Dense decoder-only transformer (qwen3-style: GQA + qk-norm, tied
embeddings, SwiGLU).

Parameters are a nested dict of tensors laid out as the reference's pytree:
every leaf under ``"layers"`` carries a leading layer axis (the reference
stacks layers with ``jax.vmap``), and ``w`` matrices are (in, out).  The
reference's ``lax.scan`` over layers is a Python loop here.  Decode updates
the cache in place.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.decode import cache_stripe
from repro_torch.dist.sharding import residual_constraint
from repro_torch.models.layers.attention import (_quant_kv, attention,
                                                 attn_decode, init_attention,
                                                 init_attn_cache,
                                                 kv_cache_int8)
from repro_torch.models.layers.embeddings import (embed, init_embedding,
                                                  unembed)
from repro_torch.models.layers.linear import dense, init_dense
from repro_torch.models.layers.mlp import init_mlp, mlp
from repro_torch.models.layers.norms import init_rmsnorm, rmsnorm

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# Sequence length at or above which attention takes the blockwise
# online-softmax path (memory-bounded), and its block sizes: the
# reference's values.  Read at each call.
BLOCKWISE_THRESHOLD = 4096
BLOCK_Q = 512
BLOCK_KV = 2048


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


def check_ported(cfg: ModelConfig) -> None:
    """Raise unless ``cfg`` is a model this port runs."""
    unported = [f for f, on in (("local_global_alternating",
                                 cfg.local_global_alternating),
                                ("post_block_norm", cfg.post_block_norm))
                if on]
    if cfg.family != "dense" or unported:
        raise NotImplementedError(
            f"{cfg.name}: only the plain dense family is ported "
            f"(family {cfg.family!r}, unported options {unported})")


def init_blocks(cfg: ModelConfig, generator: torch.Generator,
                device="cuda"):
    """The layer-stacked block parameters (leaves (L, ...)) drawn from
    ``generator``, with the reference's shapes, dtypes and scales."""
    check_ported(cfg)
    L = cfg.num_layers
    kw = dict(layers=L, dtype=dtype_of(cfg.param_dtype), device=device)
    return {
        "attn_norm": init_rmsnorm(cfg.d_model, layers=L, device=device),
        "attn": init_attention(generator, cfg, **kw),
        "mlp_norm": init_rmsnorm(cfg.d_model, layers=L, device=device),
        "mlp": init_mlp(generator, cfg.d_model, cfg.d_ff, cfg.activation,
                        **kw),
    }


def init(cfg: ModelConfig, generator: torch.Generator, device="cuda"):
    """Random parameters drawn from ``generator`` (which must live on
    ``device``), with the reference's shapes, dtypes and scales."""
    dtype = dtype_of(cfg.param_dtype)
    p = {
        "embed": init_embedding(generator, cfg.vocab_size, cfg.d_model,
                                dtype=dtype, device=device),
        "layers": init_blocks(cfg, generator, device),
        "final_norm": init_rmsnorm(cfg.d_model, device=device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = init_dense(generator, cfg.d_model, cfg.vocab_size,
                                  dtype=dtype, device=device)
    return p


def layer(tree, i: int):
    """Layer ``i``'s slice of a layer-stacked dict (views, no copies)."""
    return {k: layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# Blocks and the full-sequence trunk
# ---------------------------------------------------------------------------

def _blocks_for(S: int):
    """(block_q, block_kv) for a sequence of ``S``: the blockwise path's at
    ``BLOCKWISE_THRESHOLD`` and over, (0, 0) (naive) below it."""
    return (BLOCK_Q, BLOCK_KV) if S >= BLOCKWISE_THRESHOLD else (0, 0)


def _block(p, cfg: ModelConfig, x, *, positions, window, kind="causal",
           prefix_len=None, capture=None):
    """One pre-norm block.  With ``capture`` (a list) the layer's post-RoPE
    (k, v) is appended to it (prefill)."""
    a_in = rmsnorm(p["attn_norm"], x, cfg.norm_eps)
    bq, bkv = _blocks_for(x.shape[1])
    h = attention(p["attn"], cfg, a_in, positions=positions, kind=kind,
                  window=window, prefix_len=prefix_len, block_q=bq,
                  block_kv=bkv, return_kv=capture is not None)
    if capture is not None:
        h, kv = h
        capture.append(kv)
    x = x + h
    return x + mlp(p["mlp"], rmsnorm(p["mlp_norm"], x, cfg.norm_eps),
                   cfg.activation)


def forward_hidden(params, cfg: ModelConfig, x, *, positions,
                   prefix_len=None, remat: bool = False,
                   kind: str = "causal"):
    """Embedded input (B, S, d) -> final hidden (B, S, d).

    ``remat`` runs each block under ``torch.utils.checkpoint`` (the
    reference's ``jax.checkpoint`` of its scan body): the backward pass
    keeps each block's input and recomputes the rest.  Off by default here,
    so FedTime and PatchTST run as they did; ``forward`` turns it on."""
    kind = "prefix" if prefix_len is not None else kind
    x = residual_constraint(x)
    for i in range(cfg.num_layers):
        lp = layer(params["layers"], i)
        kw = dict(positions=positions, window=cfg.sliding_window, kind=kind,
                  prefix_len=prefix_len)
        if remat and torch.is_grad_enabled():
            x = checkpoint(_block, lp, cfg, x, use_reentrant=False, **kw)
        else:
            x = _block(lp, cfg, x, **kw)
        x = residual_constraint(x)
    return rmsnorm(params["final_norm"], x, cfg.norm_eps)


def forward(params, cfg: ModelConfig, tokens, *, prefix_len=None,
            remat: bool = True):
    """tokens (B, S) -> final hidden (B, S, d).  Use
    ``losses.chunked_ce`` for the LM loss (it never materializes the whole
    logits)."""
    check_ported(cfg)
    positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                             device=tokens.device)
    return forward_hidden(params, cfg, embed_tokens(params, cfg, tokens),
                          positions=positions, prefix_len=prefix_len,
                          remat=remat)


def embed_tokens(params, cfg: ModelConfig, tokens):
    x = embed(params["embed"], tokens).to(dtype_of(cfg.compute_dtype))
    if cfg.embedding_multiplier != 1.0:
        x = x * cfg.embedding_multiplier
    return x


def logits_fn(params, cfg: ModelConfig, hidden):
    if cfg.tie_embeddings:
        lg = unembed(params["embed"], hidden)
    else:
        lg = dense(params["lm_head"], hidden)
    if cfg.final_logit_softcap > 0:
        c = cfg.final_logit_softcap
        lg = c * torch.tanh(lg / c)
    return lg


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def ring_length(cfg: ModelConfig, seq_len: int, *,
                force_window: int = 0) -> int:
    """Ring-buffer slots per layer: the window when one applies, else the
    whole sequence."""
    w = force_window or cfg.sliding_window
    return min(seq_len, w) if w > 0 else seq_len


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, *,
               force_window: int = 0, dtype=torch.bfloat16, device="cuda"):
    """Layer-stacked ring caches: leaves (L, batch, ring, ...)."""
    check_ported(cfg)
    return init_attn_cache(batch, ring_length(cfg, seq_len,
                                              force_window=force_window),
                           cfg.num_kv_heads, cfg.resolved_head_dim(),
                           layers=cfg.num_layers, dtype=dtype, device=device)


def decode_step(params, cfg: ModelConfig, cache, token, pos, *,
                force_window: int = 0, prefix_len=None, block_tbl=None,
                ring_len=None):
    """token (B, 1) int, pos scalar or (B,) -> (logits (B, 1, V), cache).

    The cache is updated in place and returned.  ``block_tbl``/``ring_len``
    select the paged-pool layout (one shared block pool per layer, one
    table for every layer; see ``repro_torch.serve.cache_pool``)."""
    x = embed_tokens(params, cfg, token)
    w = force_window or cfg.sliding_window
    for i in range(cfg.num_layers):
        lp = layer(params["layers"], i)
        h, _ = attn_decode(lp["attn"], cfg,
                           rmsnorm(lp["attn_norm"], x, cfg.norm_eps),
                           layer(cache, i), pos, window=w,
                           prefix_len=prefix_len, block_tbl=block_tbl,
                           ring_len=ring_len)
        x = x + h
        x = x + mlp(lp["mlp"], rmsnorm(lp["mlp_norm"], x, cfg.norm_eps),
                    cfg.activation)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return logits_fn(params, cfg, x), cache


# ---------------------------------------------------------------------------
# Prefill: full forward capturing KV into ring caches + last-token logits
# ---------------------------------------------------------------------------

def _scatter_ring(k, v, positions, cache_len: int, lo: int = 0,
                  size: int = 0):
    """k, v: (B, S, Hk, dh) post-RoPE at ``positions`` = ``arange(S)`` ->
    ring cache of ``cache_len`` slots holding the last ``cache_len``
    positions (int8 when REPRO_KV_INT8).  With ``size`` < ``cache_len``
    only the stripe of global slots ``[lo, lo + size)`` is built (a rank's
    own piece of a ring sharded over ``model``); which positions land on
    it follows from the lengths alone, with no host read."""
    B, S = k.shape[:2]
    take = min(S, cache_len)
    if 0 < size < cache_len:
        src = torch.cat([torch.arange(a, b, device=k.device)
                         for a, b in _stripe_runs(S, take, cache_len, lo,
                                                  size)]
                        or [torch.zeros(0, dtype=torch.long,
                                        device=k.device)])
        pos_tail = positions.index_select(0, src)
        slots = torch.remainder(pos_tail, cache_len).long() - lo
        k, v, cache_len = k[:, src], v[:, src], size
    else:
        pos_tail = positions[-take:]
        slots = torch.remainder(pos_tail, cache_len).long()
        k, v = k[:, S - take:], v[:, S - take:]

    def scatter(val):
        out = torch.zeros((B, cache_len) + tuple(val.shape[2:]),
                          dtype=val.dtype, device=val.device)
        out[:, slots] = val
        return out

    cp = torch.full((B, cache_len), -1, dtype=torch.int32, device=k.device)
    cp[:, slots] = pos_tail[None].expand(B, pos_tail.shape[0])
    if kv_cache_int8():
        kq, ks = _quant_kv(k)
        vq, vs = _quant_kv(v)
        return {"k": scatter(kq), "v": scatter(vq), "k_scale": scatter(ks),
                "v_scale": scatter(vs), "kv_pos": cp}
    return {"k": scatter(k), "v": scatter(v), "kv_pos": cp}


def _stripe_runs(S: int, take: int, cache_len: int, lo: int, size: int):
    """The positions of ``[S - take, S)`` whose ring slot (position mod
    ``cache_len``) lies in ``[lo, lo + size)``, as increasing ``(start,
    stop)`` runs: one for each lap of the ring the positions span."""
    first = S - take
    runs = []
    for lap in range(first // cache_len, (S - 1) // cache_len + 1):
        a = max(first, lap * cache_len + lo)
        b = min(S, lap * cache_len + lo + size)
        if a < b:
            runs.append((a, b))
    return runs


def _finalize_prefill(params, cfg: ModelConfig, x, cache, true_len):
    """Last-token logits; with ``true_len`` (B,) (right-padded prompts)
    logits come from row position ``true_len - 1`` and ring slots written
    by pad positions are invalidated (kv_pos -> -1)."""
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    B, S = x.shape[:2]
    if true_len is None:
        return cache, logits_fn(params, cfg, x[:, -1:, :])
    tl = torch.as_tensor(true_len, dtype=torch.int32,
                         device=x.device).reshape(-1).expand(B)
    rows = torch.arange(B, device=x.device)
    last = x[rows, torch.clamp(tl - 1, 0, S - 1).long()][:, None, :]
    kvp = cache["kv_pos"]                        # (L, B, cache_len)
    cache["kv_pos"] = torch.where(kvp >= tl[None, :, None],
                                  torch.full_like(kvp, -1), kvp)
    return cache, logits_fn(params, cfg, last)


def prefill(params, cfg: ModelConfig, tokens, *, force_window: int = 0,
            prefix_len=None, cache_len: int = 0, true_len=None):
    """tokens (B, S) -> (cache, last-token logits (B, 1, V)).

    Runs the trunk layer by layer, capturing each layer's (k, v) into its
    ring buffer (layer-stacked leaves (L, B, ring, ...)).  ``true_len`` (B,)
    marks rows right-padded to a bucket length.

    Under an ambient mesh with a real ``model`` axis, ``tokens`` are this
    rank's rows and each layer's (k, v) goes straight into this rank's
    stripe of the ring (``dist.sharding.cache_specs``' seq layout), so a
    rank never holds more than one layer's whole ring, and that only
    transiently."""
    check_ported(cfg)
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device)
    x = residual_constraint(embed_tokens(params, cfg, tokens))
    kind = "prefix" if prefix_len is not None else "causal"
    ring = ring_length(cfg, max(S, cache_len), force_window=force_window)
    _, lo, size = cache_stripe(ring)
    w = force_window or cfg.sliding_window
    cache_dtype = dtype_of(cfg.compute_dtype)
    rings = []
    for i in range(cfg.num_layers):
        kv = []
        x = _block(layer(params["layers"], i), cfg, x, positions=positions,
                   window=w, kind=kind, prefix_len=prefix_len, capture=kv)
        x = residual_constraint(x)
        k, v = kv[0]
        rings.append(_scatter_ring(k.to(cache_dtype), v.to(cache_dtype),
                                   positions, ring, lo, size))
        del kv, k, v
    cache = {name: torch.stack([r[name] for r in rings])
             for name in rings[0]}
    return _finalize_prefill(params, cfg, x, cache, true_len)
