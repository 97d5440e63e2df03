"""Client-side local training (paper Algorithm 1, UpdateDevice).

A client receives the global adapter tree, merges it into its frozen
(optionally NF4-quantized) base, runs ``steps`` of AdamW on the adapter
leaves only, and returns the updated adapters — the only thing that ever
leaves the device.  The reference's ``lax.scan`` is a loop here, and its
``jax.value_and_grad`` is autograd on the adapter leaves alone: the base
holds no gradient.
"""

from __future__ import annotations

import torch

from repro_torch import tree as tree_util
from repro_torch.core.lora import lora_tree, merge_lora
from repro_torch.optim.adamw import adamw_init, adamw_update


def local_update(loss_fn, base_params, adapters, batches, *, steps: int,
                 lr: float = 1e-3):
    """Run ``steps`` local steps.

    loss_fn: (params, batch) -> scalar.  batches: a dict of tensors with a
    leading dim >= 1, step i taking row ``i % rows``.  Returns
    (new_adapters, mean loss as a 0-d tensor)."""
    ad = tree_util.map_(lambda a: a.detach(), adapters)
    opt = adamw_init(ad)
    losses = []
    for i in range(steps):
        batch = {k: v[i % v.shape[0]] for k, v in batches.items()}
        live = tree_util.map_(lambda a: a.detach().requires_grad_(True), ad)
        loss = loss_fn(merge_lora(base_params, live), batch)
        grads = torch.autograd.grad(loss, tree_util.leaves(live))
        ad, opt = adamw_update(ad, tree_util.unflatten(ad, grads), opt,
                               i + 1, lr=lr)
        losses.append(loss.detach())
    return ad, torch.stack(losses).mean()


def client_payload(params) -> dict:
    """What the client transmits: adapters only."""
    return lora_tree(params)
