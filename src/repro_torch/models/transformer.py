"""Decoder-only transformer: qwen3-style (GQA + qk-norm, tied embeddings,
SwiGLU), smollm (llama-arch), the paper's LLaMA-2 backbone, gemma2
(local/global alternating attention, post-block norms, logit softcaps),
and the MoE family (mixtral-8x7b, qwen2-moe-a2.7b: the reference's
``moe_transformer``), whose blocks take the capacity-dispatched MoE block
(``models.layers.moe``) as their FFN half, under ``"moe_norm"``/``"moe"``
where a dense block has ``"mlp_norm"``/``"mlp"``.  ``forward_aux`` returns
the MoE router's statistics a layer beside the hidden states
(``moe.router_aux`` makes the reference's aux loss of them).

Parameters are a nested dict of tensors laid out as the reference's pytree:
every leaf under ``"layers"`` carries a leading layer axis (the reference
stacks layers with ``jax.vmap``), and ``w`` matrices are (in, out).  An
alternating config holds two such stacks, ``{"local", "global"}``, of
``num_layers / 2`` blocks each, run as pairs (local, then global), and its
cache is the same pair of ring trees: the local rings hold the window, the
global rings the whole sequence.  The reference's ``lax.scan`` over layers
is a Python loop here.  Decode updates the cache in place.
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
from repro_torch.models.layers.moe import init_moe, moe_block
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
    """Raise unless ``cfg`` is a dense or an MoE transformer."""
    if cfg.family not in ("dense", "moe") or (cfg.family == "moe"
                                               and cfg.moe is None):
        raise NotImplementedError(f"{cfg.name}: family {cfg.family!r} is "
                                  f"not a dense or an MoE transformer")
    if cfg.local_global_alternating and cfg.num_layers % 2:
        raise ValueError(f"{cfg.name}: local/global alternation needs an "
                         f"even layer count, not {cfg.num_layers}")


def _init_stack(cfg: ModelConfig, generator: torch.Generator, layers: int,
                device):
    kw = dict(layers=layers, dtype=dtype_of(cfg.param_dtype), device=device)
    p = {
        "attn_norm": init_rmsnorm(cfg.d_model, layers=layers, device=device),
        "attn": init_attention(generator, cfg, **kw),
    }
    if cfg.family == "moe":
        p["moe_norm"] = init_rmsnorm(cfg.d_model, layers=layers,
                                     device=device)
        p["moe"] = init_moe(generator, cfg, **kw)
    else:
        p["mlp_norm"] = init_rmsnorm(cfg.d_model, layers=layers,
                                     device=device)
        p["mlp"] = init_mlp(generator, cfg.d_model, cfg.d_ff,
                            cfg.activation, **kw)
    if cfg.post_block_norm:
        p["post_attn_norm"] = init_rmsnorm(cfg.d_model, layers=layers,
                                           device=device)
        p["post_mlp_norm"] = init_rmsnorm(cfg.d_model, layers=layers,
                                          device=device)
    return p


def init_blocks(cfg: ModelConfig, generator: torch.Generator,
                device="cuda"):
    """The layer-stacked block parameters (leaves (L, ...)) drawn from
    ``generator``, with the reference's shapes, dtypes and scales; for an
    alternating config the ``{"local", "global"}`` pair of stacks of
    ``L / 2`` each."""
    check_ported(cfg)
    if cfg.local_global_alternating:
        n = cfg.num_layers // 2
        return {"local": _init_stack(cfg, generator, n, device),
                "global": _init_stack(cfg, generator, n, device)}
    return _init_stack(cfg, generator, cfg.num_layers, device)


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


def schedule(cfg: ModelConfig, window: int):
    """The trunk's blocks in the order they run, as ``(stack, index,
    window)``: ``stack`` None for a plain stack (every block at
    ``window``), else ``"local"`` (the config's sliding window) and
    ``"global"`` (no window) in turn, pair by pair."""
    if cfg.local_global_alternating:
        return [(name, i, w) for i in range(cfg.num_layers // 2)
                for name, w in (("local", cfg.sliding_window),
                                ("global", 0))]
    return [(None, i, window) for i in range(cfg.num_layers)]


def _at(tree, stack, i: int):
    """Block ``i`` of ``stack`` (None: the tree is the stack itself)."""
    return layer(tree if stack is None else tree[stack], i)


# ---------------------------------------------------------------------------
# Blocks and the full-sequence trunk
# ---------------------------------------------------------------------------

def _blocks_for(S: int):
    """(block_q, block_kv) for a sequence of ``S``: the blockwise path's at
    ``BLOCKWISE_THRESHOLD`` and over, (0, 0) (naive) below it."""
    return (BLOCK_Q, BLOCK_KV) if S >= BLOCKWISE_THRESHOLD else (0, 0)


def _post_norm(p, name: str, cfg: ModelConfig, h):
    """gemma2's post-attention / post-MLP norm where the config has one."""
    if cfg.post_block_norm:
        h = rmsnorm(p[name], h, cfg.norm_eps, gemma_style=True)
    return h


def _ffn_half(p, cfg: ModelConfig, x):
    """The block's FFN half -> (x, aux): the MLP (aux None) or the MoE
    block (aux its router's statistics (2, E), ``moe.router_aux``)."""
    gemma = cfg.post_block_norm
    if cfg.family == "moe":
        h, aux = moe_block(p["moe"], cfg, rmsnorm(p["moe_norm"], x,
                                                   cfg.norm_eps,
                                                   gemma_style=gemma))
    else:
        h, aux = mlp(p["mlp"], rmsnorm(p["mlp_norm"], x, cfg.norm_eps,
                                       gemma_style=gemma),
                     cfg.activation), None
    return x + _post_norm(p, "post_mlp_norm", cfg, h), aux


def _block(p, cfg: ModelConfig, x, *, positions, window, kind="causal",
           prefix_len=None, capture=None):
    """One pre-norm block (with gemma2's post-block norms where the config
    has them) -> (x, aux), as ``_ffn_half``.  With ``capture`` (a list) the
    layer's post-RoPE (k, v) is appended to it (prefill)."""
    a_in = rmsnorm(p["attn_norm"], x, cfg.norm_eps,
                   gemma_style=cfg.post_block_norm)
    bq, bkv = _blocks_for(x.shape[1])
    h = attention(p["attn"], cfg, a_in, positions=positions, kind=kind,
                  window=window, prefix_len=prefix_len, block_q=bq,
                  block_kv=bkv, return_kv=capture is not None)
    if capture is not None:
        h, kv = h
        capture.append(kv)
    x = x + _post_norm(p, "post_attn_norm", cfg, h)
    return _ffn_half(p, cfg, x)


def final_norm(params, cfg: ModelConfig, x):
    return rmsnorm(params["final_norm"], x, cfg.norm_eps,
                   gemma_style=cfg.post_block_norm)


def _trunk(params, cfg: ModelConfig, x, *, positions, prefix_len, remat,
           kind):
    """Embedded input -> (final hidden, the MoE blocks' router statistics
    (L, 2, E) in f32; None for a dense trunk)."""
    kind = "prefix" if prefix_len is not None else kind
    x = residual_constraint(x)
    stats = []
    for stack, i, w in schedule(cfg, cfg.sliding_window):
        lp = _at(params["layers"], stack, i)
        kw = dict(positions=positions, window=w, kind=kind,
                  prefix_len=prefix_len)
        if remat and torch.is_grad_enabled():
            x, aux_l = checkpoint(_block, lp, cfg, x, use_reentrant=False,
                                  **kw)
        else:
            x, aux_l = _block(lp, cfg, x, **kw)
        x = residual_constraint(x)
        if aux_l is not None:
            stats.append(aux_l)
    return final_norm(params, cfg, x), \
        torch.stack(stats) if stats else None


def forward_hidden(params, cfg: ModelConfig, x, *, positions,
                   prefix_len=None, remat: bool = False,
                   kind: str = "causal"):
    """Embedded input (B, S, d) -> final hidden (B, S, d).

    ``remat`` runs each block under ``torch.utils.checkpoint`` (the
    reference's ``jax.checkpoint`` of its scan body): the backward pass
    keeps each block's input and recomputes the rest.  Off by default here,
    so FedTime and PatchTST run as they did; ``forward`` turns it on."""
    return _trunk(params, cfg, x, positions=positions,
                  prefix_len=prefix_len, remat=remat, kind=kind)[0]


def forward_aux(params, cfg: ModelConfig, tokens, *, prefix_len=None,
                remat: bool = True):
    """tokens (B, S) -> (final hidden (B, S, d), the MoE router's
    statistics (L, 2, E), f32; None for a dense model).  Their
    ``moe.router_aux`` over the B S tokens is the reference's aux loss
    summed over layers (``moe_transformer.forward``)."""
    check_ported(cfg)
    positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                             device=tokens.device)
    return _trunk(params, cfg, embed_tokens(params, cfg, tokens),
                  positions=positions, prefix_len=prefix_len, remat=remat,
                  kind="causal")


def forward(params, cfg: ModelConfig, tokens, *, prefix_len=None,
            remat: bool = True):
    """tokens (B, S) -> final hidden (B, S, d).  Use
    ``losses.chunked_ce`` for the LM loss (it never materializes the whole
    logits)."""
    return forward_aux(params, cfg, tokens, prefix_len=prefix_len,
                       remat=remat)[0]


def embed_tokens(params, cfg: ModelConfig, tokens):
    """Token embeddings in the compute dtype, times the config's multiplier
    cast to that dtype first, as the reference does (in bf16 gemma2-27b's
    sqrt(4608) = 67.882 is 68.0)."""
    x = embed(params["embed"], tokens).to(dtype_of(cfg.compute_dtype))
    if cfg.embedding_multiplier != 1.0:
        x = x * torch.tensor(cfg.embedding_multiplier, dtype=x.dtype)
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
    """Ring-buffer slots per layer of a uniform ring: the window when one
    applies, else the whole sequence."""
    w = force_window or cfg.sliding_window
    return min(seq_len, w) if w > 0 else seq_len


def _cache_lengths(cfg: ModelConfig, seq_len: int, *,
                   force_window: int = 0):
    """(local_len, global_len) ring sizes: an alternating config's local
    rings hold its window and its global rings the whole sequence (a forced
    window does not apply to them); a uniform config's are one length."""
    if cfg.local_global_alternating:
        return min(seq_len, cfg.sliding_window), seq_len
    ring = ring_length(cfg, seq_len, force_window=force_window)
    return ring, ring


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, *,
               force_window: int = 0, dtype=torch.bfloat16, device="cuda"):
    """Layer-stacked ring caches: leaves (L, batch, ring, ...); for an
    alternating config ``{"local", "global"}`` of (L / 2, batch, ring,
    ...) each."""
    check_ported(cfg)
    ll, gl = _cache_lengths(cfg, seq_len, force_window=force_window)
    kw = dict(dtype=dtype, device=device)
    mk = lambda n, ring: init_attn_cache(  # noqa: E731
        batch, ring, cfg.num_kv_heads, cfg.resolved_head_dim(), layers=n,
        **kw)
    if cfg.local_global_alternating:
        n = cfg.num_layers // 2
        return {"local": mk(n, ll), "global": mk(n, gl)}
    return mk(cfg.num_layers, ll)


def _block_decode(p, cfg: ModelConfig, x_t, cache, pos, *, window,
                  prefix_len=None, block_tbl=None, ring_len=None):
    gemma = cfg.post_block_norm
    h, _ = attn_decode(p["attn"], cfg,
                       rmsnorm(p["attn_norm"], x_t, cfg.norm_eps,
                               gemma_style=gemma),
                       cache, pos, window=window, prefix_len=prefix_len,
                       block_tbl=block_tbl, ring_len=ring_len)
    x_t = x_t + _post_norm(p, "post_attn_norm", cfg, h)
    return _ffn_half(p, cfg, x_t)[0]


def decode_step(params, cfg: ModelConfig, cache, token, pos, *,
                force_window: int = 0, prefix_len=None, block_tbl=None,
                ring_len=None):
    """token (B, 1) int, pos scalar or (B,) -> (logits (B, 1, V), cache).

    The cache is updated in place and returned.  ``block_tbl``/``ring_len``
    select the paged-pool layout (one shared block pool per layer, one
    table for every layer; see ``repro_torch.serve.cache_pool``), which
    needs uniform rings: an alternating config keeps contiguous lanes and
    raises for a table, as the reference does.  An MoE model's inactive
    lane still routes its token (and takes expert capacity), as in the
    reference."""
    if cfg.local_global_alternating and block_tbl is not None:
        raise ValueError("paged KV pools require uniform ring lengths; "
                         "local/global alternating layers keep "
                         "contiguous lanes")
    x = embed_tokens(params, cfg, token)
    for stack, i, w in schedule(cfg, force_window or cfg.sliding_window):
        x = _block_decode(_at(params["layers"], stack, i), cfg, x,
                          _at(cache, stack, i), pos, window=w,
                          prefix_len=prefix_len, block_tbl=block_tbl,
                          ring_len=ring_len)
    return logits_fn(params, cfg, final_norm(params, cfg, x)), cache


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
    by pad positions are invalidated (kv_pos -> -1), in both trees of an
    alternating cache."""
    x = final_norm(params, cfg, x)
    B, S = x.shape[:2]
    if true_len is None:
        return cache, logits_fn(params, cfg, x[:, -1:, :])
    tl = torch.as_tensor(true_len, dtype=torch.int32,
                         device=x.device).reshape(-1).expand(B)
    rows = torch.arange(B, device=x.device)
    last = x[rows, torch.clamp(tl - 1, 0, S - 1).long()][:, None, :]
    for rings in ((cache["local"], cache["global"])
                  if cfg.local_global_alternating else (cache,)):
        kvp = rings["kv_pos"]                    # (L, B, cache_len)
        rings["kv_pos"] = torch.where(kvp >= tl[None, :, None],
                                      torch.full_like(kvp, -1), kvp)
    return cache, logits_fn(params, cfg, last)


def stack_rings(rings):
    """A list of one layer's rings each -> the layer-stacked cache."""
    return {name: torch.stack([r[name] for r in rings]) for name in rings[0]}


def prefill(params, cfg: ModelConfig, tokens, *, force_window: int = 0,
            prefix_len=None, cache_len: int = 0, true_len=None):
    """tokens (B, S) -> (cache, last-token logits (B, 1, V)).

    Runs the trunk layer by layer, capturing each layer's (k, v) into its
    ring buffer (layer-stacked leaves (L, B, ring, ...); an alternating
    config's local layers into rings of its window, its global layers into
    rings of the whole length).  ``true_len`` (B,) marks rows right-padded
    to a bucket length.

    Under an ambient mesh with a real ``model`` axis, ``tokens`` are this
    rank's rows and each layer's (k, v) goes straight into this rank's
    stripe of its ring (``dist.sharding.cache_specs``' seq layout), so a
    rank never holds more than one layer's whole ring, and that only
    transiently."""
    check_ported(cfg)
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device)
    x = residual_constraint(embed_tokens(params, cfg, tokens))
    kind = "prefix" if prefix_len is not None else "causal"
    ll, gl = _cache_lengths(cfg, max(S, cache_len),
                            force_window=force_window)
    cache_dtype = dtype_of(cfg.compute_dtype)
    rings = {"local": [], "global": [], None: []}
    for stack, i, w in schedule(cfg, force_window or cfg.sliding_window):
        kv = []
        x, _ = _block(_at(params["layers"], stack, i), cfg, x,
                      positions=positions, window=w, kind=kind,
                      prefix_len=prefix_len, capture=kv)
        x = residual_constraint(x)
        k, v = kv[0]
        ring = gl if stack == "global" else ll
        _, lo, size = cache_stripe(ring)
        rings[stack].append(_scatter_ring(k.to(cache_dtype),
                                          v.to(cache_dtype), positions,
                                          ring, lo, size))
        del kv, k, v
    if cfg.local_global_alternating:
        cache = {"local": stack_rings(rings["local"]),
                 "global": stack_rings(rings["global"])}
    else:
        cache = stack_rings(rings[None])
    return _finalize_prefill(params, cfg, x, cache, true_len)
