"""Serve step: one-token decode against the cache, through the flash-decode
kernels (``repro_torch.kernels.ops.flash_decode``)."""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.fault.guard import logits_finite
from repro_torch.models.registry import get_model
from repro_torch.serve.sampling import sample_vec


def make_serve_step(cfg: ModelConfig, *, force_window: int = 0,
                    sampling: bool = False, guard: bool = False):
    """One-token decode step ``serve_step(params, cache, batch) ->
    (next_token (B, 1), cache)``; the cache is updated in place.

    Two batch layouts share the step:

      * synchronous: ``{"token": (B, 1), "pos": scalar}``, every row at
        one position (the fixed-batch launcher);
      * ragged (continuous batching): ``pos`` is (B,) with per-slot
        positions, ``-1`` marking inactive lanes.  Inactive lanes are fully
        masked in attention, their cache slots are not written, and their
        token passes through unchanged.  With a paged pool the batch also
        carries ``block_tbl`` (B, T) int32 and ``ring_len``.

    ``sampling=True`` also reads per-slot ``temperature``/``top_k``/``top_p``
    ((B,) tensors) and ``generators`` (a list of B ``torch.Generator`` or
    None; None rows decode greedily), routing logits through
    ``repro_torch.serve.sampling.sample_vec``.

    ``guard=True`` (the fault-tolerant engine's step) also reads a (B,)
    bool ``poison`` row, always in the batch: the chaos NaN injector, which
    fills a poisoned lane's logits with NaN before sampling.  The step then
    returns ``(next_token, ok, cache)``, ``ok`` (B,) bool the per-lane
    ``fault.guard.logits_finite`` of the logits after the injection
    (inactive lanes report ok: they produced nothing).  A lane that is not
    ok still gets some token id from the sampler; the engine never emits
    it.  ``ok`` stays on the device beside the token.
    """
    api = get_model(cfg)

    def serve_step(params, cache, batch):
        logits, cache = api.decode_step(params, cfg, cache, batch,
                                        force_window=force_window)
        lg = logits[:, -1, :]
        if guard:
            poison = batch["poison"].to(lg.device)
            lg = lg.masked_fill(poison[:, None], float("nan"))
            ok = logits_finite(lg)
        if sampling:
            next_token = sample_vec(lg, temperature=batch["temperature"],
                                    top_k=batch["top_k"],
                                    top_p=batch["top_p"],
                                    generators=batch["generators"])[:, None]
        else:
            next_token = lg.argmax(dim=-1).to(torch.int32)[:, None]
        pos = torch.as_tensor(batch["pos"])
        if pos.ndim == 1:
            active = pos.to(next_token.device) >= 0
            next_token = torch.where(active[:, None], next_token,
                                     batch["token"].to(next_token.dtype))
            if guard:
                ok = ok | ~active
        if guard:
            return next_token, ok, cache
        return next_token, cache

    return serve_step
