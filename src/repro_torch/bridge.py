"""Weights across the two packages.

The reference's parameters are a nested dict of arrays; the port keeps the
same tree (same keys, the stacked leading layer axis, ``w`` as (in, out),
the tied embedding table), so the bridge only converts leaves.  bf16 leaves
travel as numpy arrays of ``ml_dtypes.bfloat16`` (what ``np.asarray`` gives
for a bf16 JAX array), reinterpreted bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


def _to_tensor(a, device) -> torch.Tensor:
    a = np.array(a)                  # a private copy: never alias the source
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _map(tree, fn):
    return {k: _map(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def params_from_jax(tree, cfg: ModelConfig, device="cuda"):
    """The reference's parameter tree (leaves as numpy arrays) -> the port's
    parameters on ``device``.  Raises if the tree does not describe
    ``cfg``'s dense model."""
    params = _map(tree, lambda a: _to_tensor(a, device))
    table = params.get("embed", {}).get("table")
    if table is None or tuple(table.shape) != (cfg.vocab_size, cfg.d_model):
        raise ValueError(f"params_from_jax: embed table does not match "
                         f"{cfg.name} ({cfg.vocab_size}, {cfg.d_model})")
    wq = params.get("layers", {}).get("attn", {}).get("wq", {}).get("w")
    if wq is None or tuple(wq.shape) != (cfg.num_layers, cfg.d_model,
                                         cfg.q_dim):
        raise ValueError(f"params_from_jax: layers are not a stack of "
                         f"{cfg.num_layers} {cfg.name} blocks")
    return params


def params_to_numpy(params):
    """The port's parameters -> the reference's tree of numpy arrays."""
    return _map(params, _to_numpy)
