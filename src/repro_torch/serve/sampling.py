"""Token sampling: greedy / temperature / top-k / top-p (nucleus).

The reference draws from ``jax.random`` keys; the port draws from one
``torch.Generator`` per row.  The two streams differ, so the tests compare
masks and distributions, not sampled tokens.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

_NEG = torch.finfo(torch.float32).min


def greedy(logits: torch.Tensor) -> torch.Tensor:
    return logits.argmax(dim=-1).to(torch.int32)


def row_generator(seed: int, t: int, device) -> torch.Generator:
    """The generator for sample ``t`` of a request seeded ``seed``: a
    function of (seed, t) only, as the reference's ``fold_in(key, t)``, so a
    recomputed request draws the same stream."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + int(t)) % (2 ** 63))
    return g


def masked_logits(logits, *, temperature, top_k, top_p) -> torch.Tensor:
    """Temperature-scaled logits with the top-k and top-p cutoffs applied
    (masked entries set to the f32 minimum), per row.  ``top_k`` is clamped
    to the vocab; ``top_p`` outside (0, 1) keeps the whole row."""
    B, V = logits.shape
    dev = logits.device
    temperature = torch.as_tensor(temperature, dtype=torch.float32,
                                  device=dev)
    top_k = torch.as_tensor(top_k, dtype=torch.int64, device=dev)
    top_p = torch.as_tensor(top_p, dtype=torch.float32, device=dev)
    neg = torch.full((), _NEG, device=dev)

    lg = logits.float() / torch.clamp(temperature, min=1e-6)[:, None]
    sorted_desc = torch.sort(lg, dim=-1, descending=True).values
    kk = top_k.clamp(0, V)
    kth = sorted_desc[torch.arange(B, device=dev),
                      (kk - 1).clamp(min=0)][:, None]
    lg = torch.where((kk[:, None] > 0) & (lg < kth), neg, lg)

    sorted_k = torch.sort(lg, dim=-1, descending=True).values
    probs = torch.softmax(sorted_k, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = cum - probs < top_p[:, None]          # first token always kept
    cutoff = torch.where(keep, sorted_k,
                         torch.full((), float("inf"), device=dev))
    cutoff = cutoff.amin(dim=-1, keepdim=True)
    use_p = ((top_p > 0.0) & (top_p < 1.0))[:, None]
    return torch.where(use_p & (lg < cutoff), neg, lg)


def sample_vec(logits: torch.Tensor, *, temperature, top_k, top_p,
               generators: Sequence[Optional[torch.Generator]]
               ) -> torch.Tensor:
    """Per-row sampling for ragged serving batches: logits (B, V) -> tokens
    (B,) int32.

    ``temperature``/``top_k``/``top_p`` are (B,); ``generators`` holds one
    generator per row (a row's draw never depends on its neighbours), or
    None for rows that decode greedily.  Rows with ``temperature <= 0``
    return the argmax whatever their generator.  A row draws by the
    Gumbel-max rule over its masked logits."""
    B, V = logits.shape
    dev = logits.device
    greedy_tok = greedy(logits)
    lg = masked_logits(logits, temperature=temperature, top_k=top_k,
                       top_p=top_p)
    noise = torch.zeros((B, V), dtype=torch.float32, device=dev)
    tiny = torch.finfo(torch.float32).tiny
    for b, g in enumerate(generators):
        if g is not None:
            u = torch.rand(V, generator=g, device=dev).clamp_(min=tiny)
            noise[b] = -torch.log(-torch.log(u))
    sampled = (lg + noise).argmax(dim=-1).to(torch.int32)
    temperature = torch.as_tensor(temperature, dtype=torch.float32,
                                  device=dev)
    return torch.where(temperature <= 0.0, greedy_tok, sampled)
