"""Model API: family dispatch for init / loss / prefill / decode.

  init(cfg, generator, device)                       -> params
  loss(params, cfg, batch)                           -> scalar LM loss
  loss_parts(params, cfg, batch)                     -> (ce sum, count,
                                                         router stats)
  prefill(params, cfg, batch, ...)                   -> (cache, last logits)
  decode_step(params, cfg, cache, batch, ...)        -> (logits, cache)
  init_cache(cfg, batch_size, seq_len, ...)          -> cache

``loss_parts`` (the port's addition) is ``loss`` taken apart for a caller
that divides by a count taken over more rows than it holds and reduces the
router's statistics over them (``launch.steps`` on a mesh): the summed
token loss, the count of labels >= 0, and for an MoE model the router's
per-layer, per-expert sums ``(L, 2, E)`` (``models.layers.moe.
router_stats``; None for the other families).  An MoE model's ``loss`` is
``ce sum / count + moe.router_aux(cfg, stats, tokens)``, the router's aux
loss summed over layers, as the reference's.

Batch dicts: train ``{"tokens": (B, S), "labels": (B, S)}`` (labels -1 =
ignore), plus ``"frames": (B, F, d_model)`` for an encoder-decoder;
prefill the same without labels; decode ``{"token": (B, 1), "pos": scalar
or (B,)}`` plus ``block_tbl``/``ring_len`` for a paged pool.  The dense,
MoE, encdec (seamless-m4t), ssm (xLSTM) and hybrid (Zamba2) families are
ported; vlm raises.  An encdec, ssm or hybrid prefill refuses
``true_len``, as the reference's does.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec, transformer, xlstm_model, zamba2
from repro_torch.models.layers.moe import router_aux
from repro_torch.models.losses import chunked_ce, chunked_ce_sum


def _dense_api():
    def loss(params, cfg, batch):
        h = transformer.forward(params, cfg, batch["tokens"])
        return chunked_ce(h, params, cfg, batch["labels"])

    def loss_parts(params, cfg, batch):
        h = transformer.forward(params, cfg, batch["tokens"])
        return (*chunked_ce_sum(h, params, cfg, batch["labels"]), None)

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
                           loss_parts=loss_parts, prefill=prefill,
                           decode_step=decode_step,
                           init_cache=transformer.init_cache)


def _moe_api():
    """The dense family's API with the router's aux loss in ``loss``."""
    api = _dense_api()

    def loss(params, cfg, batch):
        h, stats = transformer.forward_aux(params, cfg, batch["tokens"])
        return chunked_ce(h, params, cfg, batch["labels"]) + \
            router_aux(cfg, stats, batch["tokens"].numel())

    def loss_parts(params, cfg, batch):
        h, stats = transformer.forward_aux(params, cfg, batch["tokens"])
        return (*chunked_ce_sum(h, params, cfg, batch["labels"]), stats)

    api.loss, api.loss_parts = loss, loss_parts
    return api


def _refuse_true_len(true_len) -> None:
    if true_len is not None:
        raise ValueError("prefill bucketing (true_len) is only supported "
                         "for attention-ring-cache families (dense/moe)")


def _recurrent_api(module):
    """The API of a family whose prefill carries a recurrent state through
    the prompt (``ssm``: xLSTM; ``hybrid``: Zamba2): ``module`` is its
    model module."""
    def loss(params, cfg, batch):
        h = module.forward(params, cfg, batch["tokens"])
        return chunked_ce(h, params, cfg, batch["labels"])

    def loss_parts(params, cfg, batch):
        h = module.forward(params, cfg, batch["tokens"])
        return (*chunked_ce_sum(h, params, cfg, batch["labels"]), None)

    def prefill(params, cfg, batch, *, force_window=0, cache_len=0,
                true_len=None):
        _refuse_true_len(true_len)
        return module.prefill(params, cfg, batch["tokens"],
                              force_window=force_window, cache_len=cache_len)

    def decode_step(params, cfg, cache, batch, *, force_window=0):
        return module.decode_step(params, cfg, cache, batch["token"],
                                  batch["pos"], force_window=force_window)

    return SimpleNamespace(init=module.init, loss=loss,
                           loss_parts=loss_parts, prefill=prefill,
                           decode_step=decode_step,
                           init_cache=module.init_cache)


def _ssm_api():
    return _recurrent_api(xlstm_model)


def _hybrid_api():
    return _recurrent_api(zamba2)


def _encdec_api():
    """The encoder-decoder's API: every call but decode takes the batch's
    ``frames`` beside its tokens; the loss is over the decoder's hidden
    states."""
    def hidden(params, cfg, batch):
        return encdec.forward(params, cfg, batch["frames"], batch["tokens"])

    def loss(params, cfg, batch):
        return chunked_ce(hidden(params, cfg, batch), params, cfg,
                          batch["labels"])

    def loss_parts(params, cfg, batch):
        return (*chunked_ce_sum(hidden(params, cfg, batch), params, cfg,
                                batch["labels"]), None)

    def prefill(params, cfg, batch, *, force_window=0, cache_len=0,
                true_len=None):
        _refuse_true_len(true_len)
        return encdec.prefill(params, cfg, batch["frames"], batch["tokens"],
                              force_window=force_window, cache_len=cache_len)

    def decode_step(params, cfg, cache, batch, *, force_window=0):
        return encdec.decode_step(params, cfg, cache, batch["token"],
                                  batch["pos"], force_window=force_window)

    return SimpleNamespace(init=encdec.init, loss=loss,
                           loss_parts=loss_parts, prefill=prefill,
                           decode_step=decode_step,
                           init_cache=encdec.init_cache)


_FAMILIES = {"dense": _dense_api, "moe": _moe_api, "encdec": _encdec_api,
             "ssm": _ssm_api, "hybrid": _hybrid_api}


def get_model(cfg: ModelConfig):
    _ported_only(cfg)
    return _FAMILIES[cfg.family]()


def _ported_only(cfg: ModelConfig) -> None:
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet "
                                  f"(families {tuple(_FAMILIES)})")


def train_batch_shapes(cfg: ModelConfig, batch: int, seq: int) -> dict:
    """``{name: (shape, dtype)}`` of a training batch: an encoder-decoder's
    also carries ``frames`` of ``min(seq, max_source_len)`` bf16 frame
    embeddings a row, as the reference's."""
    _ported_only(cfg)
    out = {"tokens": ((batch, seq), torch.int32),
           "labels": ((batch, seq), torch.int32)}
    if cfg.family == "encdec":
        F = min(seq, cfg.encdec.max_source_len)
        out = {"frames": ((batch, F, cfg.d_model), torch.bfloat16), **out}
    return out


def decode_batch_shapes(cfg: ModelConfig, batch: int) -> dict:
    """``{name: (shape, dtype)}`` of a synchronous decode batch."""
    _ported_only(cfg)
    return {"token": ((batch, 1), torch.int32),
            "pos": ((), torch.int32)}
