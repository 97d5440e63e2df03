"""Model API: family dispatch for init / loss / prefill / decode.

  init(cfg, generator, device)                       -> params
  loss(params, cfg, batch)                           -> scalar LM cross-entropy
  loss_sum(params, cfg, batch)                       -> (summed loss, count)
  prefill(params, cfg, batch, ...)                   -> (cache, last logits)
  decode_step(params, cfg, cache, batch, ...)        -> (logits, cache)
  init_cache(cfg, batch_size, seq_len, ...)          -> cache

``loss_sum`` (the port's addition) is ``loss`` before its division by the
count of labels >= 0, for a caller that divides by a count taken over more
rows than it holds (``launch.steps`` on a mesh).

Batch dicts: train ``{"tokens": (B, S), "labels": (B, S)}`` (labels -1 =
ignore); prefill ``{"tokens": (B, S)}``; decode ``{"token": (B, 1), "pos":
scalar or (B,)}`` plus ``block_tbl``/``ring_len`` for a paged pool.  The
dense and MoE families are ported; the others raise.

An MoE model's ``loss`` adds the router's aux loss (summed over layers) to
the cross-entropy, as the reference's does.  Its ``loss_sum`` returns
``(ce_sum + aux * max(count, 1), count)``, so that one rank's
``loss_sum`` over its count is ``loss``; on a mesh the aux term a rank
adds is that of its own rows, weighted by its share of the labels.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer
from repro_torch.models.losses import chunked_ce, chunked_ce_sum


def _dense_api():
    def loss(params, cfg, batch):
        h = transformer.forward(params, cfg, batch["tokens"])
        return chunked_ce(h, params, cfg, batch["labels"])

    def loss_sum(params, cfg, batch):
        h = transformer.forward(params, cfg, batch["tokens"])
        return chunked_ce_sum(h, params, cfg, batch["labels"])

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

    return SimpleNamespace(init=transformer.init, loss=loss,
                           loss_sum=loss_sum, prefill=prefill,
                           decode_step=decode_step,
                           init_cache=transformer.init_cache)


def _moe_api():
    """The dense family's API with the router's aux loss in ``loss``."""
    api = _dense_api()

    def loss(params, cfg, batch):
        h, aux = transformer.forward_aux(params, cfg, batch["tokens"])
        return chunked_ce(h, params, cfg, batch["labels"]) + aux

    def loss_sum(params, cfg, batch):
        h, aux = transformer.forward_aux(params, cfg, batch["tokens"])
        tot, count = chunked_ce_sum(h, params, cfg, batch["labels"])
        return tot + aux * count.clamp(min=1), count

    api.loss, api.loss_sum = loss, loss_sum
    return api


_FAMILIES = {"dense": _dense_api, "moe": _moe_api}


def get_model(cfg: ModelConfig):
    _ported_only(cfg)
    return _FAMILIES[cfg.family]()


def _ported_only(cfg: ModelConfig) -> None:
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet "
                                  f"(families {tuple(_FAMILIES)})")


def train_batch_shapes(cfg: ModelConfig, batch: int, seq: int) -> dict:
    """``{name: (shape, dtype)}`` of a training batch."""
    _ported_only(cfg)
    return {"tokens": ((batch, seq), torch.int32),
            "labels": ((batch, seq), torch.int32)}


def decode_batch_shapes(cfg: ModelConfig, batch: int) -> dict:
    """``{name: (shape, dtype)}`` of a synchronous decode batch."""
    _ported_only(cfg)
    return {"token": ((batch, 1), torch.int32),
            "pos": ((), torch.int32)}
