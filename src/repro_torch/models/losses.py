"""Loss functions: the LM cross-entropy over sequence chunks, and the
forecasting losses (paper Eq. (5)), in f32 whatever the inputs' dtype.

``chunked_ce`` computes LM cross-entropy one sequence chunk at a time so
the (B, S, vocab) logits tensor is never materialized (qwen3's 151,936
vocab at 8 x 4096 tokens would be 20 GB in f32).  Under autograd each
chunk runs under ``torch.utils.checkpoint``, so the backward pass also
holds one chunk's logits at a time: it recomputes them.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.transformer import dtype_of


def _ce_chunk_sum(hidden_chunk, weight, labels_chunk, tied: bool,
                  softcap: float):
    """hidden (B, c, d) -> the chunk's summed token loss (f32 scalar);
    labels < 0 add nothing.  ``weight`` is the tied table (V, d) or the
    head (d, V)."""
    logits = hidden_chunk @ (weight.T if tied else weight)
    logits = logits.float()
    if softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)
    lse = torch.logsumexp(logits, dim=-1)
    mask = labels_chunk >= 0
    gold = torch.gather(logits, -1,
                        labels_chunk.clamp(min=0).long()[..., None])[..., 0]
    return torch.where(mask, lse - gold, torch.zeros_like(lse)).sum()


def chunked_ce_sum(hidden, params, cfg, labels, *, chunk: int = 512):
    """hidden (B, S, d), labels (B, S) int (-1 = ignore) -> (summed token
    loss, f32 scalar; count of labels >= 0, int64 scalar).  The chunk is
    the largest size no larger than ``chunk`` that divides S, as in the
    reference."""
    B, S, d = hidden.shape
    chunk = min(chunk, S)
    while S % chunk:
        chunk -= 1
    dt = dtype_of(cfg.compute_dtype)
    tied = cfg.tie_embeddings
    weight = (params["embed"]["table"] if tied
              else params["lm_head"]["w"]).to(dt)
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(0, S, chunk):
        args = (hidden[:, i:i + chunk].to(dt), weight,
                labels[:, i:i + chunk], tied, cfg.final_logit_softcap)
        if torch.is_grad_enabled():
            tot = tot + checkpoint(_ce_chunk_sum, *args, use_reentrant=False)
        else:
            tot = tot + _ce_chunk_sum(*args)
    return tot, (labels >= 0).sum()


def chunked_ce(hidden, params, cfg, labels, *, chunk: int = 512):
    """hidden (B, S, d); labels (B, S) int, -1 = ignore -> scalar mean CE
    (``tot / max(cnt, 1)``)."""
    tot, cnt = chunked_ce_sum(hidden, params, cfg, labels, chunk=chunk)
    return tot / torch.clamp(cnt, min=1).float()


def mse(pred, target) -> torch.Tensor:
    """Paper Eq. (5): mean squared forecasting error."""
    return torch.mean(torch.square(pred.float() - target.float()))


def mae(pred, target) -> torch.Tensor:
    return torch.mean(torch.abs(pred.float() - target.float()))
