"""xLSTM language model (xlstm-350m): mLSTM blocks with a periodic sLSTM
block, the reference's ``src/repro/models/xlstm_model.py``.

Every ``slstm_every``-th block is sLSTM, the rest mLSTM, run as ``nG``
groups of ``nM = slstm_every - 1`` mLSTM blocks and one sLSTM block.  The
parameters are the reference's tree: mLSTM leaves stacked ``(nG, nM, ...)``,
sLSTM leaves ``(nG, ...)``; the cache is the same pair of stacks of
recurrent states, ``(nG, nM, B, ...)`` and ``(nG, B, ...)``, O(1) in the
sequence length.  The reference's nested scans are Python loops here.
``decode_step`` returns a new cache (the serve step writes it back into
the pool's tensors, ``serve.cache_pool.freeze_inactive``).
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import tree as tree_util
from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers.embeddings import init_embedding
from repro_torch.models.layers.linear import init_dense
from repro_torch.models.layers.norms import init_rmsnorm, rmsnorm
from repro_torch.models.layers.xlstm import (
    init_mlstm_block, init_mlstm_cache, init_slstm_block, init_slstm_cache,
    mlstm_block_decode, mlstm_block_forward, slstm_block_decode,
    slstm_block_forward)
from repro_torch.models.transformer import (dtype_of, embed_tokens, layer,
                                            logits_fn)


def _group_counts(cfg: ModelConfig):
    k = cfg.xlstm.slstm_every
    if cfg.num_layers % k:
        raise ValueError(f"{cfg.name}: {cfg.num_layers} layers are not "
                         f"groups of {k}")
    return cfg.num_layers // k, k - 1        # (n_groups, mlstm per group)


def _blocks(cfg: ModelConfig):
    """The blocks in the order they run: ``("m", g, j)`` for mLSTM block j
    of group g, ``("s", g, None)`` for group g's sLSTM block."""
    nG, nM = _group_counts(cfg)
    return [b for g in range(nG)
            for b in [("m", g, j) for j in range(nM)] + [("s", g, None)]]


def _block_params(params, kind: str, g: int, j):
    return layer(layer(params["mlstm"], g), j) if kind == "m" else \
        layer(params["slstm"], g)


def init(cfg: ModelConfig, generator: torch.Generator, device="cuda"):
    """Random parameters drawn from ``generator`` (which must live on
    ``device``), with the reference's shapes, dtypes and scales; every
    stacked leaf is drawn a layer slice at a time."""
    dtype = dtype_of(cfg.param_dtype)
    nG, nM = _group_counts(cfg)
    kw = dict(dtype=dtype, device=device)
    mlstm = {"norm": init_rmsnorm(cfg.d_model, layers=nG * nM,
                                  device=device),
             "block": init_mlstm_block(generator, cfg, layers=nG * nM, **kw)}
    p = {
        "embed": init_embedding(generator, cfg.vocab_size, cfg.d_model,
                                **kw),
        "mlstm": tree_util.map_(lambda t: t.unflatten(0, (nG, nM)), mlstm),
        "slstm": {"norm": init_rmsnorm(cfg.d_model, layers=nG,
                                       device=device),
                  "block": init_slstm_block(generator, cfg, layers=nG,
                                            **kw)},
        "final_norm": init_rmsnorm(cfg.d_model, device=device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = init_dense(generator, cfg.d_model, cfg.vocab_size,
                                  **kw)
    return p


def _residual(bp, kind: str, cfg: ModelConfig, h):
    """One pre-norm block: h + block(norm(h))."""
    fwd = mlstm_block_forward if kind == "m" else slstm_block_forward
    return h + fwd(bp["block"], cfg, rmsnorm(bp["norm"], h, cfg.norm_eps))[0]


def forward(params, cfg: ModelConfig, tokens, *, remat: bool = True):
    """tokens (B, S) -> final hidden (B, S, d).  ``remat`` runs each block
    under ``torch.utils.checkpoint`` when gradients are on (the reference
    checkpoints each mLSTM layer and each group)."""
    x = embed_tokens(params, cfg, tokens)
    for kind, g, j in _blocks(cfg):
        bp = _block_params(params, kind, g, j)
        if remat and torch.is_grad_enabled():
            x = checkpoint(_residual, bp, kind, cfg, x, use_reentrant=False)
        else:
            x = _residual(bp, kind, cfg, x)
    return rmsnorm(params["final_norm"], x, cfg.norm_eps)


# ---------------------------------------------------------------------------
# Decode (a constant-size recurrent state)
# ---------------------------------------------------------------------------

def _stacked(cfg: ModelConfig, m_states, s_states):
    """Per-block state dicts, in ``_blocks`` order -> the cache tree."""
    nG, nM = _group_counts(cfg)

    def stack(states, shape):
        return {k: torch.stack([s[k] for s in states]).unflatten(0, shape)
                for k in states[0]}
    return {"mlstm": stack(m_states, (nG, nM)),
            "slstm": stack(s_states, (nG,))}


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, *,
               force_window: int = 0, dtype=torch.bfloat16, device="cuda"):
    """Zero states (sLSTM ``n`` at 1e-6): leaves ``(nG, nM, batch, ...)``
    and ``(nG, batch, ...)``, whatever ``seq_len``."""
    del seq_len, force_window                # O(1) in the sequence length
    nG, nM = _group_counts(cfg)

    def stack(one, lead):
        return {k: v.expand(lead + v.shape).clone() for k, v in one.items()}
    return {"mlstm": stack(init_mlstm_cache(cfg, batch, dtype, device),
                           (nG, nM)),
            "slstm": stack(init_slstm_cache(cfg, batch, device), (nG,))}


def decode_step(params, cfg: ModelConfig, cache, token, pos, *,
                force_window: int = 0):
    """token (B, 1) -> (logits (B, 1, V), new cache).  ``pos`` is unused:
    the state carries the position."""
    del pos, force_window
    x = embed_tokens(params, cfg, token)
    states = {"m": [], "s": []}
    for kind, g, j in _blocks(cfg):
        bp = _block_params(params, kind, g, j)
        c = (layer(layer(cache["mlstm"], g), j) if kind == "m"
             else layer(cache["slstm"], g))
        step = mlstm_block_decode if kind == "m" else slstm_block_decode
        y, c2 = step(bp["block"], cfg, rmsnorm(bp["norm"], x, cfg.norm_eps),
                     c)
        x = x + y
        states[kind].append(c2)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return logits_fn(params, cfg, x), _stacked(cfg, states["m"], states["s"])


def prefill(params, cfg: ModelConfig, tokens, *, force_window: int = 0,
            cache_len: int = 0):
    """Run the recurrence over the prompt -> (cache, last logits (B, 1,
    V)): the chunked mLSTM and the sLSTM loop carrying their states."""
    del force_window, cache_len
    x = embed_tokens(params, cfg, tokens)
    states = {"m": [], "s": []}
    for kind, g, j in _blocks(cfg):
        bp = _block_params(params, kind, g, j)
        h = rmsnorm(bp["norm"], x, cfg.norm_eps)
        if kind == "m":
            y, st = mlstm_block_forward(bp["block"], cfg, h,
                                        return_cache=True)
        else:
            y, st = slstm_block_forward(bp["block"], cfg, h)
        x = x + y
        states[kind].append(st)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return (_stacked(cfg, states["m"], states["s"]),
            logits_fn(params, cfg, x[:, -1:, :]))
