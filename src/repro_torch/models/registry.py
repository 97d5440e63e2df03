"""Model API: family dispatch for init / prefill / decode.

  init(cfg, generator, device)                       -> params
  prefill(params, cfg, batch, ...)                   -> (cache, last logits)
  decode_step(params, cfg, cache, batch, ...)        -> (logits, cache)
  init_cache(cfg, batch_size, seq_len, ...)          -> cache

Batch dicts: prefill ``{"tokens": (B, S)}``; decode ``{"token": (B, 1),
"pos": scalar or (B,)}`` plus ``block_tbl``/``ring_len`` for a paged pool.
Only the dense family is ported; the others raise.
"""

from __future__ import annotations

from types import SimpleNamespace

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer


def _dense_api():
    def prefill(params, cfg, batch, *, force_window=0, cache_len=0,
                true_len=None):
        return transformer.prefill(params, cfg, batch["tokens"],
                                   force_window=force_window,
                                   cache_len=cache_len, true_len=true_len)

    def decode_step(params, cfg, cache, batch, *, force_window=0):
        return transformer.decode_step(params, cfg, cache, batch["token"],
                                       batch["pos"],
                                       force_window=force_window,
                                       block_tbl=batch.get("block_tbl"),
                                       ring_len=batch.get("ring_len"))

    return SimpleNamespace(init=transformer.init, prefill=prefill,
                           decode_step=decode_step,
                           init_cache=transformer.init_cache)


def get_model(cfg: ModelConfig):
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet "
                                  f"(dense only)")
    return _dense_api()
