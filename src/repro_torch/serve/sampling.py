"""Token sampling: greedy / temperature / top-k / top-p (nucleus).

The reference draws from ``jax.random`` keys; the port draws from an
explicit ``torch.Generator`` (``sample``, ``generate``) or one per row
(``sample_vec``).  The two streams differ, so the tests compare masks and
distributions, not sampled tokens.  Every sampler draws by the Gumbel-max
rule over its masked logits, and decodes greedily where the temperature
is 0 in f32.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

_NEG = torch.finfo(torch.float32).min


def greedy(logits: torch.Tensor) -> torch.Tensor:
    return logits.argmax(dim=-1).to(torch.int32)


def sample(logits: torch.Tensor, *, temperature: float = 1.0,
           top_k: int = 0, top_p: float = 0.0,
           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """logits (B, V) -> tokens (B,) int32, one setting for every row.

    Greedy at ``temperature`` <= 0 (in f32); the masks are
    ``masked_logits``' (a temperature under 1e-6 taken as 1e-6, ``top_k``
    clamped to the vocab, no nucleus cut at ``top_p`` >= 1).  One (B, V)
    draw from ``generator`` (the device's default generator when None)."""
    logits = logits.float()
    if float(np.float32(temperature)) <= 0.0:
        return greedy(logits)
    B, V = logits.shape
    dev = logits.device
    # the settings as device rows (a fill, not a host-to-device copy)
    lg = masked_logits(logits, temperature=torch.full((B,), temperature,
                                                      device=dev),
                       top_k=torch.full((B,), int(top_k), device=dev),
                       top_p=torch.full((B,), top_p, device=dev))
    u = torch.rand((B, V), generator=generator, device=dev)
    u = u.clamp_(min=torch.finfo(torch.float32).tiny)
    return (lg - torch.log(-torch.log(u))).argmax(dim=-1).to(torch.int32)


def generate(api, params, cfg, cache, first_token, *, steps: int,
             start_pos: int, generator: Optional[torch.Generator] = None,
             temperature: float = 0.0, top_k: int = 0, top_p: float = 0.0,
             force_window: int = 0):
    """Autoregressive loop over ``api.decode_step`` from a prefill's cache
    (the contiguous ring: the ring flash-decode kernel on the card).

    first_token: (B, 1) int from the prefill; the token at step i is fed at
    position ``start_pos + i``.  Returns (tokens (B, steps) int32, cache);
    the cache is updated in place."""
    tok = first_token.to(torch.int32)
    out = []
    for i in range(steps):
        logits, cache = api.decode_step(
            params, cfg, cache, {"token": tok, "pos": start_pos + i},
            force_window=force_window)
        tok = sample(logits[:, -1, :], temperature=temperature, top_k=top_k,
                     top_p=top_p, generator=generator)[:, None]
        out.append(tok)
    return torch.cat(out, dim=1), cache


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
