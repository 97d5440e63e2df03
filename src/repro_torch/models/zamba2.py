"""Zamba2 hybrid (zamba2-2.7b): a Mamba2 backbone with weight-shared
attention blocks, the reference's ``src/repro/models/zamba2.py``.
[arXiv:2411.15242]

The layers run as ``nG`` groups: one of ``num_shared_blocks`` shared
transformer blocks (block ``g % n``, round-robin), then
``shared_attn_every`` Mamba2 layers.  A shared block reads the
concatenation of the hidden state and the original embedding (2 d_model
wide) and writes d_model; its weights serve every application, while each
application has its own KV ring.  The parameters are the reference's tree:
``mamba`` leaves stacked ``(nG, nM, ...)``, ``shared`` leaves ``(n, ...)``.
The cache is ``{"mamba": {ssm_state, conv_buf} stacked (nG, nM, B, ...),
"attn": one ring a group, stacked (nG, B, ring, ...)}``; the attention is
always global (no window).  The reference's scans are Python loops here.

Decode writes each application's K/V into its ring in place (through the
flash-decode kernel's ring layout on the card) and returns a new stack of
Mamba2 states beside the same rings.  The hybrid cache is split over a
mesh's rows only (``launch.specs``): every rank holds its rows' whole
rings, so the attention runs with no ``model`` stripe.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import tree as tree_util
from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import use_mesh
from repro_torch.models.layers.attention import (attention, attn_decode,
                                                 init_attention,
                                                 init_attn_cache)
from repro_torch.models.layers.embeddings import init_embedding
from repro_torch.models.layers.linear import init_dense
from repro_torch.models.layers.mamba2 import (init_mamba2,
                                              init_mamba2_cache,
                                              mamba2_decode, mamba2_forward)
from repro_torch.models.layers.mlp import init_mlp, mlp
from repro_torch.models.layers.norms import init_rmsnorm, rmsnorm
from repro_torch.models.transformer import (_blocks_for, _scatter_ring,
                                            dtype_of, embed_tokens, layer,
                                            logits_fn, stack_rings)


def _group_counts(cfg: ModelConfig):
    k = cfg.hybrid.shared_attn_every
    if cfg.num_layers % k:
        raise ValueError(f"{cfg.name}: {cfg.num_layers} layers are not "
                         f"groups of {k}")
    return cfg.num_layers // k, k            # (n_groups, mamba per group)


def _init_shared_block(generator: torch.Generator, cfg: ModelConfig, *,
                       layers: int, dtype, device):
    d2 = 2 * cfg.d_model
    kw = dict(layers=layers, dtype=dtype, device=device)
    return {
        "attn_norm": init_rmsnorm(d2, layers=layers, device=device),
        "attn": init_attention(generator, cfg, q_in=d2, kv_in=d2,
                               out_dim=cfg.d_model, **kw),
        "mlp_norm": init_rmsnorm(d2, layers=layers, device=device),
        "mlp": init_mlp(generator, d2, cfg.d_ff, cfg.activation,
                        out_dim=cfg.d_model, **kw),
    }


def init(cfg: ModelConfig, generator: torch.Generator, device="cuda"):
    """Random parameters drawn from ``generator`` (which must live on
    ``device``), with the reference's shapes, dtypes and scales; every
    stacked leaf is drawn a layer slice at a time."""
    dtype = dtype_of(cfg.param_dtype)
    nG, nM = _group_counts(cfg)
    mamba = {"norm": init_rmsnorm(cfg.d_model, layers=nG * nM,
                                  device=device),
             "block": init_mamba2(generator, cfg, layers=nG * nM,
                                  dtype=dtype, device=device)}
    kw = dict(dtype=dtype, device=device)
    return {
        "embed": init_embedding(generator, cfg.vocab_size, cfg.d_model,
                                **kw),
        "mamba": tree_util.map_(lambda t: t.unflatten(0, (nG, nM)), mamba),
        "shared": _init_shared_block(
            generator, cfg, layers=cfg.hybrid.num_shared_blocks, **kw),
        "final_norm": init_rmsnorm(cfg.d_model, device=device),
        "lm_head": init_dense(generator, cfg.d_model, cfg.vocab_size, **kw),
    }


def _select_shared(params, g: int):
    """Round-robin shared block: block ``g % n`` (views)."""
    n = tree_util.leaves(params["shared"])[0].shape[0]
    return layer(params["shared"], g % n)


def _shared(sp, cfg: ModelConfig, h, x0, attend):
    """One application of a shared block: attention (``attend`` of the
    normed ``concat(h, x0)`` -> its output) and the MLP, each residual."""
    h = h + attend(rmsnorm(sp["attn_norm"], torch.cat([h, x0], dim=-1),
                           cfg.norm_eps))
    a_in = rmsnorm(sp["mlp_norm"], torch.cat([h, x0], dim=-1), cfg.norm_eps)
    return h + mlp(sp["mlp"], a_in, cfg.activation)


def _mamba_layer(lp, cfg: ModelConfig, h, **kw):
    """One pre-norm Mamba2 layer -> (h + y, its state or cache)."""
    y, st = mamba2_forward(lp["block"], cfg,
                           rmsnorm(lp["norm"], h, cfg.norm_eps), **kw)
    return h + y, st


def _group(params, g: int, cfg: ModelConfig, h, x0, positions,
           remat: bool):
    """Group ``g`` of the full-sequence trunk: its shared block, then its
    Mamba2 layers, each under ``torch.utils.checkpoint`` when ``remat``
    and gradients are on."""
    bq, bkv = _blocks_for(h.shape[1])
    sp = _select_shared(params, g)
    h = _shared(sp, cfg, h, x0, lambda a: attention(
        sp["attn"], cfg, a, positions=positions, kind="causal", block_q=bq,
        block_kv=bkv))
    for j in range(_group_counts(cfg)[1]):
        lp = layer(layer(params["mamba"], g), j)
        if remat and torch.is_grad_enabled():
            h = checkpoint(_mamba_layer, lp, cfg, h, use_reentrant=False)[0]
        else:
            h = _mamba_layer(lp, cfg, h)[0]
    return h


def forward(params, cfg: ModelConfig, tokens, *, remat: bool = True):
    """tokens (B, S) -> final hidden (B, S, d).  ``remat`` runs each group,
    and each Mamba2 layer inside it, under ``torch.utils.checkpoint`` when
    gradients are on, as the reference checkpoints them."""
    x0 = embed_tokens(params, cfg, tokens)
    positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                             device=tokens.device)
    h = x0
    for g in range(_group_counts(cfg)[0]):
        if remat and torch.is_grad_enabled():
            h = checkpoint(_group, params, g, cfg, h, x0, positions, True,
                           use_reentrant=False)
        else:
            h = _group(params, g, cfg, h, x0, positions, remat)
    return rmsnorm(params["final_norm"], h, cfg.norm_eps)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def _stack_states(cfg: ModelConfig, states):
    """Per-layer Mamba2 caches, in layer order -> leaves (nG, nM, B, ...)."""
    nG, nM = _group_counts(cfg)
    return {k: torch.stack([s[k] for s in states]).unflatten(0, (nG, nM))
            for k in states[0]}


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, *,
               force_window: int = 0, dtype=torch.bfloat16, device="cuda"):
    """Zero Mamba2 states ``(nG, nM, batch, ...)`` and empty rings of
    ``seq_len`` slots ``(nG, batch, seq_len, ...)``."""
    del force_window                  # attention here is always global
    nG, nM = _group_counts(cfg)
    one = init_mamba2_cache(cfg, batch, dtype, device)
    return {"mamba": {k: v.expand((nG, nM) + v.shape).clone()
                      for k, v in one.items()},
            "attn": init_attn_cache(batch, seq_len, cfg.num_kv_heads,
                                    cfg.resolved_head_dim(), layers=nG,
                                    dtype=dtype, device=device)}


def decode_step(params, cfg: ModelConfig, cache, token, pos, *,
                force_window: int = 0):
    """token (B, 1) -> (logits (B, 1, V), new cache): the rings updated in
    place, the Mamba2 states new."""
    del force_window
    x0 = embed_tokens(params, cfg, token)
    nG, nM = _group_counts(cfg)
    h, states = x0, []
    for g in range(nG):
        sp = _select_shared(params, g)
        ring = layer(cache["attn"], g)
        with use_mesh(None):          # rows-only: the whole ring is here
            h = _shared(sp, cfg, h, x0, lambda a: attn_decode(
                sp["attn"], cfg, a, ring, pos, window=0)[0])
        for j in range(nM):
            lp = layer(layer(params["mamba"], g), j)
            y, c2 = mamba2_decode(lp["block"], cfg,
                                  rmsnorm(lp["norm"], h, cfg.norm_eps),
                                  layer(layer(cache["mamba"], g), j))
            h = h + y
            states.append(c2)
    x = rmsnorm(params["final_norm"], h, cfg.norm_eps)
    return logits_fn(params, cfg, x), {"mamba": _stack_states(cfg, states),
                                       "attn": cache["attn"]}


def prefill(params, cfg: ModelConfig, tokens, *, force_window: int = 0,
            cache_len: int = 0):
    """Prompt prefill -> (cache, last logits (B, 1, V)): the trunk run
    group by group, each application's post-RoPE K/V scattered into a ring
    of ``max(S, cache_len)`` slots and each Mamba2 layer's state and conv
    tail kept."""
    del force_window
    x0 = embed_tokens(params, cfg, tokens)
    S = tokens.shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device)
    bq, bkv = _blocks_for(S)
    nG, nM = _group_counts(cfg)
    cdt = dtype_of(cfg.compute_dtype)
    total = max(S, cache_len)
    h, rings, states = x0, [], []
    for g in range(nG):
        sp = _select_shared(params, g)

        def attend(a):
            y, (k, v) = attention(sp["attn"], cfg, a, positions=positions,
                                  kind="causal", block_q=bq, block_kv=bkv,
                                  return_kv=True)
            rings.append(_scatter_ring(k.to(cdt), v.to(cdt), positions,
                                       total))
            return y

        h = _shared(sp, cfg, h, x0, attend)
        for j in range(nM):
            h, st = _mamba_layer(layer(layer(params["mamba"], g), j), cfg,
                                 h, return_cache=True)
            states.append(st)
    x = rmsnorm(params["final_norm"], h, cfg.norm_eps)
    return ({"mamba": _stack_states(cfg, states), "attn": stack_rings(rings)},
            logits_fn(params, cfg, x[:, -1:, :]))
