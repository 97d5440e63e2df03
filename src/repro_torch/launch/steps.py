"""Step functions of the serving path (the reference's
``src/repro/launch/steps.py``).

  prefill_step — full forward building the KV cache + last logits
  serve_step   — one-token decode against the cache, through the
                 flash-decode kernels (``repro_torch.kernels.ops
                 .flash_decode``; a cache sharded over ``model`` combines
                 each rank's partials through ``repro_torch.dist.decode``)

Under a mesh (``repro_torch.dist.sharding.use_mesh``) each rank runs the
step on its own pieces: its rows of the batch
(``local_shard(batch, data_specs(batch, mesh), mesh)``), its stripe of the
cache, and the replicated parameters.  What a step returns is the rank's
own too: its stripe of the cache, its rows' logits and tokens.  A caller
that wants every row gathers them with ``dist.collectives.all_gather``
over the axes ``data_specs`` gives the batch's leading dim.

The reference's train and federated train steps are not ported yet.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.fault.guard import logits_finite
from repro_torch.models.registry import get_model
from repro_torch.serve.sampling import sample_vec


def make_prefill_step(cfg: ModelConfig, *, force_window: int = 0,
                      cache_len: int = 0):
    """``prefill_step(params, batch) -> (cache, last logits (B, 1, V))``
    for ``{"tokens": (B, S)}``.  ``cache_len`` (the port's addition; the
    reference's step leaves it at 0) sizes the ring past the prompt for the
    tokens a decode will add.  Under a mesh ``tokens`` are the rank's rows
    and the cache comes back as the rank's stripe."""
    api = get_model(cfg)

    def prefill_step(params, batch):
        return api.prefill(params, cfg, batch, force_window=force_window,
                           cache_len=cache_len)

    return prefill_step


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

    Under a mesh the step takes and returns this rank's rows (the batch
    placed by ``data_specs``) and its stripe of the cache, for every layout
    and with ``sampling`` or ``guard`` alike; the ranks of a ``model``
    group hold the same rows and return the same tokens.

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


def decode_force_window(cfg: ModelConfig, seq_len: int) -> int:
    """The reference's long_500k policy: a pure full-attention model
    decodes 262,144 tokens or more under its sliding-window variant;
    windowed and recurrent models run as they are."""
    if seq_len >= 262_144 and cfg.sliding_window == 0 and \
            cfg.family not in ("ssm", "hybrid"):
        return cfg.decode_sliding_window or 4096
    return 0
