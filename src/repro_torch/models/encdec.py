"""Encoder-decoder backbone (seamless-m4t-medium), the reference's
``src/repro/models/encdec.py``.  [arXiv:2308.11596]

The audio front end (mel spectrogram and conv codec) is a stub, as in the
reference: the model takes precomputed frame embeddings (B, F, d_model).
A bidirectional encoder runs over the frames (``frame_proj``, then blocks
of full attention with RoPE, then ``enc_norm``: the memory); an
autoregressive decoder runs over the text tokens, each block a causal
self-attention, a cross attention over the memory (no RoPE) and an MLP.
The parameters are the reference's tree: ``encoder`` and ``decoder``
leaves stacked over layers, ``decoder`` blocks with a ``cross`` attention
beside ``attn``.  The reference's scans are Python loops here.

The cache is ``{"self": one ring a decoder layer (L, B, ring, ...),
"mem_k", "mem_v": the memory's K/V a layer (L, B, F, Hk, D), "mem_pos":
(B, F), -1 on an empty slot}``.  Prefill encodes once and projects every
layer's memory K/V once; a decode step writes its token into the self
rings in place and reads the memory, which it leaves unchanged.  Both
attentions of a decode step go through the flash-decode kernel on the card.
Under a mesh the memory takes the reference's layout, its slots over
``model`` like a ring's, and the cross decode combines each rank's stripe
as the self ring does (``attention.attn_cross_decode``).
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.decode import cache_stripe
from repro_torch.dist.sharding import residual_constraint
from repro_torch.models.layers.attention import (attention, attn_cross_decode,
                                                 attn_decode, init_attention,
                                                 init_attn_cache)
from repro_torch.models.layers.embeddings import init_embedding
from repro_torch.models.layers.linear import dense, init_dense
from repro_torch.models.layers.mlp import init_mlp, mlp
from repro_torch.models.layers.norms import init_rmsnorm, rmsnorm
from repro_torch.models.transformer import (_blocks_for, _scatter_ring,
                                            dtype_of, embed_tokens, layer,
                                            logits_fn, stack_rings)


def _init_stack(generator: torch.Generator, cfg: ModelConfig, layers: int,
                *, cross: bool, dtype, device):
    """A stack of ``layers`` encoder blocks, or decoder blocks (``cross``),
    drawn a layer slice at a time."""
    kw = dict(layers=layers, dtype=dtype, device=device)
    norm = dict(layers=layers, device=device)
    p = {"attn_norm": init_rmsnorm(cfg.d_model, **norm),
         "attn": init_attention(generator, cfg, **kw)}
    if cross:
        p["cross_norm"] = init_rmsnorm(cfg.d_model, **norm)
        p["cross"] = init_attention(generator, cfg, **kw)
    p["mlp_norm"] = init_rmsnorm(cfg.d_model, **norm)
    p["mlp"] = init_mlp(generator, cfg.d_model, cfg.d_ff, cfg.activation,
                        **kw)
    return p


def init(cfg: ModelConfig, generator: torch.Generator, device="cuda"):
    """Random parameters drawn from ``generator`` (which must live on
    ``device``), with the reference's shapes, dtypes and scales; every
    stacked leaf is drawn a layer slice at a time."""
    dtype = dtype_of(cfg.param_dtype)
    kw = dict(dtype=dtype, device=device)
    return {
        "frame_proj": init_dense(generator, cfg.d_model, cfg.d_model, **kw),
        "embed": init_embedding(generator, cfg.vocab_size, cfg.d_model,
                                **kw),
        "encoder": _init_stack(generator, cfg, cfg.encdec.encoder_layers,
                               cross=False, **kw),
        "enc_norm": init_rmsnorm(cfg.d_model, device=device),
        "decoder": _init_stack(generator, cfg, cfg.num_layers, cross=True,
                               **kw),
        "final_norm": init_rmsnorm(cfg.d_model, device=device),
    }


def _mlp_half(lp, cfg: ModelConfig, h):
    return h + mlp(lp["mlp"], rmsnorm(lp["mlp_norm"], h, cfg.norm_eps),
                   cfg.activation)


def _enc_block(lp, cfg: ModelConfig, h, positions, bq: int, bkv: int):
    h = h + attention(lp["attn"], cfg,
                      rmsnorm(lp["attn_norm"], h, cfg.norm_eps),
                      positions=positions, kind="full", block_q=bq,
                      block_kv=bkv)
    return _mlp_half(lp, cfg, h)


def _dec_block(lp, cfg: ModelConfig, h, memory, positions, mem_pos,
               window: int, bq: int, bkv: int, capture=None):
    """One decoder block over the whole sequence.  With ``capture`` (a
    list) the self-attention's post-RoPE (k, v) and the cross attention's
    memory (k, v) are appended to it (prefill)."""
    kv = capture is not None
    a = attention(lp["attn"], cfg, rmsnorm(lp["attn_norm"], h, cfg.norm_eps),
                  positions=positions, kind="causal", window=window,
                  block_q=bq, block_kv=bkv, return_kv=kv)
    if kv:
        a, self_kv = a
    h = h + a
    c = attention(lp["cross"], cfg,
                  rmsnorm(lp["cross_norm"], h, cfg.norm_eps),
                  positions=positions, kind="full", kv_x=memory,
                  kv_positions=mem_pos, use_rope=False, return_kv=kv)
    if kv:
        c, mem_kv = c
        capture.append((self_kv, mem_kv))
    return _mlp_half(lp, cfg, h + c)


def _run(block, lp, *args, remat: bool):
    """``block(lp, *args)``, under ``torch.utils.checkpoint`` when
    ``remat`` and gradients are on (the reference's ``jax.checkpoint`` of
    its scan body)."""
    if remat and torch.is_grad_enabled():
        return checkpoint(block, lp, *args, use_reentrant=False)
    return block(lp, *args)


def _arange(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=device)


def encode(params, cfg: ModelConfig, frames, *, remat: bool = True):
    """frames (B, F, d_model), the stub's embeddings -> the encoder's
    memory (B, F, d_model).  At F >= ``BLOCKWISE_THRESHOLD`` the encoder's
    attention takes ``sdpa``'s blockwise path (full attention: no skip
    table)."""
    F = frames.shape[1]
    positions = _arange(F, frames.device)
    x = dense(params["frame_proj"],
              frames.to(dtype_of(cfg.compute_dtype)))
    bq, bkv = _blocks_for(F)
    x = residual_constraint(x)
    for i in range(cfg.encdec.encoder_layers):
        x = residual_constraint(_run(_enc_block, layer(params["encoder"], i),
                                     cfg, x, positions, bq, bkv,
                                     remat=remat))
    return rmsnorm(params["enc_norm"], x, cfg.norm_eps)


def forward(params, cfg: ModelConfig, frames, tokens, *,
            remat: bool = True):
    """Teacher-forced decode -> the final decoder hidden (B, S, d).
    ``remat`` runs each encoder and decoder block under
    ``torch.utils.checkpoint`` when gradients are on."""
    memory = encode(params, cfg, frames, remat=remat)
    positions = _arange(tokens.shape[1], tokens.device)
    mem_pos = _arange(memory.shape[1], tokens.device)
    bq, bkv = _blocks_for(tokens.shape[1])
    x = residual_constraint(embed_tokens(params, cfg, tokens))
    for i in range(cfg.num_layers):
        x = residual_constraint(_run(
            _dec_block, layer(params["decoder"], i), cfg, x, memory,
            positions, mem_pos, cfg.sliding_window, bq, bkv, remat=remat))
    return rmsnorm(params["final_norm"], x, cfg.norm_eps)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, seq_len: int, *,
               force_window: int = 0, dtype=torch.bfloat16, device="cuda"):
    """Empty self rings (L, batch, ring, ...) and an empty memory of
    ``max_source_len`` slots a layer, every ``mem_pos`` at -1."""
    w = force_window or cfg.sliding_window
    ring = min(seq_len, w) if w > 0 else seq_len
    F, L = cfg.encdec.max_source_len, cfg.num_layers
    Hk, dh = cfg.num_kv_heads, cfg.resolved_head_dim()
    mem = (L, batch, F, Hk, dh)
    return {
        "self": init_attn_cache(batch, ring, Hk, dh, layers=L, dtype=dtype,
                                device=device),
        "mem_k": torch.zeros(mem, dtype=dtype, device=device),
        "mem_v": torch.zeros(mem, dtype=dtype, device=device),
        "mem_pos": torch.full((batch, F), -1, dtype=torch.int32,
                              device=device),
    }


def prefill(params, cfg: ModelConfig, frames, tokens, *,
            force_window: int = 0, cache_len: int = 0):
    """Encode the source once, then run the decoder over the prompt:
    each layer's post-RoPE K/V scattered into a ring of ``max(S,
    cache_len)`` slots (the window's, where one applies) and its memory
    K/V projected once with no RoPE.  -> (cache, last logits (B, 1, V)).

    Under an ambient mesh with a real ``model`` axis, ``frames`` and
    ``tokens`` are this rank's rows, and each ring and the memory come back
    as this rank's stripe of their slots (``dist.sharding``'s seq
    layout)."""
    memory = encode(params, cfg, frames, remat=False)
    B, S = tokens.shape
    F = memory.shape[1]
    positions = _arange(S, tokens.device)
    mem_pos = _arange(F, tokens.device)
    bq, bkv = _blocks_for(S)
    w = force_window or cfg.sliding_window
    total = max(S, cache_len)
    ring = min(total, w) if w > 0 else total
    _, lo, size = cache_stripe(ring)
    _, mlo, msize = cache_stripe(F)
    cdt = dtype_of(cfg.compute_dtype)
    x = residual_constraint(embed_tokens(params, cfg, tokens))
    rings, mem_k, mem_v = [], [], []
    for i in range(cfg.num_layers):
        kv = []
        x = residual_constraint(_dec_block(
            layer(params["decoder"], i), cfg, x, memory, positions, mem_pos,
            w, bq, bkv, capture=kv))
        (k, v), (mk, mv) = kv[0]
        rings.append(_scatter_ring(k.to(cdt), v.to(cdt), positions, ring,
                                   lo, size))
        mem_k.append(mk[:, mlo:mlo + msize].to(cdt))
        mem_v.append(mv[:, mlo:mlo + msize].to(cdt))
        del kv, k, v, mk, mv
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    cache = {"self": stack_rings(rings), "mem_k": torch.stack(mem_k),
             "mem_v": torch.stack(mem_v),
             "mem_pos": mem_pos[mlo:mlo + msize].expand(B, msize)
             .contiguous()}
    return cache, logits_fn(params, cfg, x[:, -1:, :])


def decode_step(params, cfg: ModelConfig, cache, token, pos, *,
                force_window: int = 0):
    """token (B, 1), pos scalar or (B,) -> (logits (B, 1, V), cache): per
    layer the self ring's decode (written in place), the cross decode over
    the memory, then the MLP.  The memory is left unchanged."""
    x = embed_tokens(params, cfg, token)
    w = force_window or cfg.sliding_window
    for i in range(cfg.num_layers):
        lp = layer(params["decoder"], i)
        a, _ = attn_decode(lp["attn"], cfg,
                           rmsnorm(lp["attn_norm"], x, cfg.norm_eps),
                           layer(cache["self"], i), pos, window=w)
        x = x + a
        x = x + attn_cross_decode(
            lp["cross"], cfg, rmsnorm(lp["cross_norm"], x, cfg.norm_eps),
            cache["mem_k"][i], cache["mem_v"][i], cache["mem_pos"])
        x = _mlp_half(lp, cfg, x)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return logits_fn(params, cfg, x), cache
