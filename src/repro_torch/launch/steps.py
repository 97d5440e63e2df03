"""Step functions of training and serving (the reference's
``src/repro/launch/steps.py``).

  train_step     — full fine-tuning: autograd + AdamW (on a mesh the
                   ZeRO-1 scatter update: each rank updates its block of
                   the moments and all-gathers the updated parameter block)
  fed_train_step — the paper's step: gradients for the LoRA adapters only,
                   summed over the mesh's data (+pod) axes; the base
                   weights get no gradient and no traffic
  prefill_step — full forward building the KV cache + last logits
  serve_step   — one-token decode against the cache, through the
                 flash-decode kernels (``repro_torch.kernels.ops
                 .flash_decode``; a cache sharded over ``model`` combines
                 each rank's partials through ``repro_torch.dist.decode``)

Under a mesh (``repro_torch.dist.sharding.use_mesh``) each rank runs the
step on its own pieces: its rows of the batch
(``local_shard(batch, data_specs(batch, mesh), mesh)``), its stripe of the
cache, and the replicated parameters.  What a serving step returns is
the rank's own too: its stripe of the cache, its rows' logits and tokens.
A caller that wants every row gathers them with
``dist.collectives.all_gather`` over the axes ``data_specs`` gives the
batch's leading dim.  A train step returns what every rank holds alike:
the updated parameters, the rank's moment blocks and the global loss.

The train steps differentiate the reference's loss of the global batch.
Its ``chunked_ce`` divides the token-loss sum over the whole batch by the
count of labels >= 0 in the whole batch, so a rank differentiates its
rows' sum over the global count (one psum of the counts first) and the
ranks then psum their gradients.  With ``accum`` > 1 the loss is the mean
over ``accum`` microbatches of each one's token mean, microbatch m being
rows ``[m B / accum, (m + 1) B / accum)`` of the global batch, which may
span ranks: a rank runs its share of each microbatch it meets, over that
microbatch's global count.  Means taken per rank and then averaged would
differ wherever labels are -1 and the ranks' counts differ.

An MoE model's router aux loss is that of each global microbatch too
(``_router_share``): the top-1 counts are psummed before the product.
Its token groups are each rank's own (``min(512, the rank's tokens)``),
which are the reference's groups only where a rank's tokens in a
microbatch are a multiple of the reference's group, ``min(512, the
microbatch's global tokens)``; elsewhere the capacity differs (a kept
divergence, ``tests/test_torch_moe_mesh.py``).
"""

from __future__ import annotations

import math
import os

import torch

from repro_torch import tree as tree_util
from repro_torch.configs.base import ModelConfig
from repro_torch.core.lora import lora_tree, merge_lora
from repro_torch.dist import collectives
from repro_torch.dist.sharding import (_axis_candidates, _mesh_shape,
                                       current_mesh)
from repro_torch.fault.guard import logits_finite
from repro_torch.models.layers.moe import router_aux
from repro_torch.models.registry import get_model
from repro_torch.optim.adamw import adamw_update_zero1
from repro_torch.serve.cache_pool import cache_batch_axes, freeze_inactive
from repro_torch.serve.sampling import sample_vec


# Families whose decode rewrites every lane's state (the reference's
# contiguous-lane freeze applies to them).
RECURRENT_FAMILIES = ("ssm", "hybrid")


def _mesh_update(params, grads, opt_state, step, *, lr):
    """AdamW on the ZeRO-1 scatter-update schedule when a mesh is active
    (``opt_state`` is then the rank's moment blocks, ``zero1_init``'s);
    plain AdamW otherwise.  Equal either way, bit for bit."""
    return adamw_update_zero1(params, grads, opt_state, step,
                              mesh=current_mesh(), lr=lr)


def row_split(mesh):
    """(axes, ways, block) of the batch's rows on ``mesh``: the combined
    (``pod``, ``data``) axes, major first, as ``data_specs`` splits a batch
    whose rows divide them (the set ``dist.fed.aggregation_axes`` names),
    how many ways, and this rank's block.  ``((), 1, 0)`` without a mesh or
    a live data axis."""
    cands = _axis_candidates(_mesh_shape(mesh)) if mesh is not None else []
    if not cands:
        return (), 1, 0
    axes = tuple(cands[0])
    ways = math.prod(collectives.axis_size(mesh, ax) for ax in axes)
    return axes, ways, collectives.block_index(mesh, axes)


def _micro_rows(rows: int, ways: int, block: int, accum: int) -> list:
    """For each global microbatch, this rank's rows in it as a local
    ``(lo, hi)``, or None where it holds none."""
    total = rows * ways
    if total % accum:
        raise ValueError(f"a global batch of {total} rows does not split "
                         f"into {accum} microbatches")
    size, off = total // accum, block * rows
    out = []
    for m in range(accum):
        lo, hi = max(m * size, off), min((m + 1) * size, off + rows)
        out.append((lo - off, hi - off) if lo < hi else None)
    return out


def _grad_dtype(accum: int):
    """The gradient sum's dtype over microbatches: f32, or bf16 when
    ``REPRO_GRAD_DTYPE=bf16`` (the reference's switch; it halves the
    carry at a precision cost).  None (the gradients' own) for one."""
    if accum <= 1:
        return None
    return (torch.bfloat16 if os.environ.get("REPRO_GRAD_DTYPE") == "bf16"
            else torch.float32)


def _value_and_grad(loss_parts, leaves, like, batch, accum: int, cfg):
    """(loss, gradients of ``leaves``) of the reference's loss of the
    global batch, this rank holding its rows of ``batch``.

    ``loss_parts(tree, batch) -> (summed token loss, count, router
    stats)`` (the registry's) of the tree made of ``like``'s structure and
    ``leaves``, differentiated through fresh aliases of them (the given
    tensors never require a gradient).  The counts are taken from the
    labels first, since every share needs its microbatch's global count
    before its backward pass.  Each microbatch's share is its summed loss
    over its global count, plus, for an MoE model, the rank's share of the
    router's aux loss over the microbatch's global tokens (``_router_share``);
    the shares' gradients are summed in ``_grad_dtype``, and on a mesh
    psummed over the batch's axes in f32.  The loss returned is the global
    loss on every rank."""
    mesh = current_mesh()
    axes, ways, block = row_split(mesh)
    accum = max(accum, 1)
    labels = batch["labels"]
    rows = _micro_rows(labels.shape[0], ways, block, accum)
    mb_tokens = labels.shape[0] * ways // accum * labels.shape[1]
    zero = torch.zeros((), dtype=torch.int64, device=labels.device)
    cnt = torch.stack([(labels[r[0]:r[1]] >= 0).sum() if r else zero
                       for r in rows])
    if axes:        # on the host: gloo sums int64 there, exactly
        cnt = collectives.psum(cnt.cpu(), mesh, axes).to(labels.device)
    denom = torch.clamp(cnt, min=1).float()
    acc_dt = _grad_dtype(accum)
    loss = torch.zeros((), dtype=torch.float32, device=labels.device)
    grads = None if acc_dt is None else [
        torch.zeros(x.shape, dtype=acc_dt, device=x.device) for x in leaves]
    for m, r in enumerate(rows):
        if r is None:
            if cfg.family == "moe":
                _router_share(cfg, None, mb_tokens, mesh, axes,
                              labels.device)
            continue
        mb = {k: v[r[0]:r[1]] for k, v in batch.items()}
        live = [x.detach().requires_grad_(True) for x in leaves]
        with torch.enable_grad():
            tot, _, stats = loss_parts(tree_util.unflatten(like, live), mb)
            part = tot / denom[m]
            if stats is not None:
                part = part + _router_share(cfg, stats, mb_tokens, mesh,
                                            axes, labels.device)
            got = torch.autograd.grad(part, live, allow_unused=True)
        got = [torch.zeros_like(x) if g is None else g
               for x, g in zip(leaves, got)]
        del live
        if acc_dt is None:
            grads = got
        else:
            grads = [(a.float() + g.float()).to(acc_dt)
                     for a, g in zip(grads, got)]
        loss = loss + part.detach()
        del got, part, tot, stats
    if axes:
        grads = [collectives.psum(g.float(), mesh, axes).to(
            acc_dt or g.dtype) for g in grads]
        loss = collectives.psum(loss, mesh, axes)
    if acc_dt is not None:
        loss = loss / accum
        grads = [g / accum for g in grads]
    return loss, grads


def _router_share(cfg: ModelConfig, stats, tokens: int, mesh, axes, device):
    """This rank's share of a microbatch's router aux loss: ``router_aux``
    of the top-1 counts of the whole microbatch (psummed over ``axes``)
    beside the rank's own probability sums, over the microbatch's global
    ``tokens``.  The aux is linear in the probability sums, so the ranks'
    shares add up to the reference's aux of the global microbatch, and
    their gradients (the counts carry none) to its gradient.  A rank that
    holds no row of the microbatch (``stats`` None) adds zero counts to
    the psum, which every rank of the group must join."""
    shape = (cfg.num_layers, cfg.moe.num_experts)
    counts = (torch.zeros(shape, device=device) if stats is None
              else stats[:, 0].detach())
    if axes:
        counts = collectives.psum(counts, mesh, axes)
    if stats is None:
        return None
    return router_aux(cfg, torch.stack([counts, stats[:, 1]], dim=1),
                      tokens)


def make_train_step(cfg: ModelConfig, *, lr: float = 1e-4, accum: int = 1):
    """``train_step(params, opt_state, batch, step) -> (params, opt_state,
    loss)``: autograd on the model's loss, then AdamW at ``step + 1``.

    ``accum`` > 1 splits the global batch into ``accum`` contiguous
    microbatches run one at a time (activation memory / accum at equal
    work), their gradients summed in f32 (``REPRO_GRAD_DTYPE=bf16``: bf16
    after each add) and divided by ``accum`` at the end, as the loss is.
    Under ``dist.sharding.use_mesh`` the batch is the rank's rows
    (``local_shard(batch, data_specs(batch, mesh), mesh)``), the parameters
    are whole on every rank and ``opt_state`` is the rank's moment blocks
    (``optim.adamw.zero1_init``); the global batch's rows must divide the
    data (+pod) ways."""
    api = get_model(cfg)

    def train_step(params, opt_state, batch, step):
        loss, grads = _value_and_grad(
            lambda p, mb: api.loss_parts(p, cfg, mb),
            tree_util.leaves(params), params, batch, accum, cfg)
        params, opt_state = _mesh_update(
            params, tree_util.unflatten(params, grads), opt_state,
            int(step) + 1, lr=lr)
        return params, opt_state, loss

    return train_step


def make_fed_train_step(cfg: ModelConfig, *, lr: float = 1e-3):
    """The paper's local step at mesh scale: every data slice of the mesh
    is a cluster member training its LoRA adapters on its rows, and the
    members' adapter gradients are summed over ``data`` (+``pod``), the
    aggregation of Algorithm 1, line 12.  Only ``lora_tree(params)`` is
    differentiated: the base leaves never require a gradient, and get no
    gradient and no traffic.  ``opt_state`` is shaped like the adapter
    tree (``adamw_init(lora_tree(params))``, or ``zero1_init`` of it under
    a mesh); the step returns ``merge_lora(params, adapters)``."""
    api = get_model(cfg)

    def fed_train_step(params, opt_state, batch, step):
        adapters = lora_tree(params)
        loss, grads = _value_and_grad(
            lambda ad, mb: api.loss_parts(merge_lora(params, ad), cfg, mb),
            tree_util.leaves(adapters), adapters, batch, 1, cfg)
        adapters, opt_state = _mesh_update(
            adapters, tree_util.unflatten(adapters, grads), opt_state,
            int(step) + 1, lr=lr)
        return merge_lora(params, adapters), opt_state, loss

    return fed_train_step


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

    A recurrent family (``RECURRENT_FAMILIES``: its decode rewrites every
    lane's state) has its new state written back into ``cache`` in place,
    for the active lanes only on a ragged batch
    (``serve.cache_pool.freeze_inactive``), as the reference freezes a
    contiguous ragged batch; the attention families' rings guard their own
    writes and take no select.

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
    axes = (cache_batch_axes(api, cfg) if cfg.family in RECURRENT_FAMILIES
            else None)

    def serve_step(params, cache, batch):
        logits, new_cache = api.decode_step(params, cfg, cache, batch,
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
        active = pos.to(next_token.device) >= 0 if pos.ndim == 1 else None
        if active is not None:
            next_token = torch.where(active[:, None], next_token,
                                     batch["token"].to(next_token.dtype))
            if guard:
                ok = ok | ~active
        cache = (new_cache if axes is None else
                 freeze_inactive(cache, new_cache, active, axes))
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
