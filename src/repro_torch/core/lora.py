"""LoRA / QLoRA plumbing over parameter trees (paper C2).

A "linear site" is a sub-dict carrying a weight leaf ``w`` (or ``w_nf4``)
whose key is in the target set.  ``attach_lora`` adds (lora_a, lora_b,
lora_scale); ``quantize_base`` replaces ``w`` by NF4 codes;
``lora_tree``/``merge_lora`` take out and put back only the adapter leaves,
the federated payload.  Stacked layers are handled as in the reference: a
weight (L, in, out) gets adapters (L, in, r) / (L, r, out).
"""

from __future__ import annotations

from typing import Iterable

import torch

from repro_torch import tree as tree_util
from repro_torch.core.quant import nf4_quantize

DEFAULT_TARGETS = ("wq", "wk", "wv", "wo")
FAMILY_TARGETS = {"dense": DEFAULT_TARGETS,
                  "moe": DEFAULT_TARGETS + ("router",),
                  "encdec": DEFAULT_TARGETS,
                  "ssm": DEFAULT_TARGETS + ("up", "down"),  # xLSTM blocks
                  "hybrid": DEFAULT_TARGETS + ("in_proj", "out_proj")}

# sites that stay un-quantized even under QLoRA (small / numerically touchy)
NO_QUANT = ("router", "embed", "lm_head", "vis_proj", "frame_proj")


def _copy_dicts(tree):
    """New dicts all the way down, the same tensors at the leaves."""
    return {k: _copy_dicts(v) if isinstance(v, dict) else v
            for k, v in tree.items()}


def _sites(tree, targets, path=()):
    """(path, node) of every linear site under a target key, in sorted key
    order."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if not isinstance(v, dict):
            continue
        p = path + (k,)
        if k in targets and ("w" in v or "w_nf4" in v) and \
                not isinstance(v.get("w", v.get("w_nf4")), dict):
            out.append((p, v))
        out.extend(_sites(v, targets, p))
    return out


def attach_lora(params, generator: torch.Generator, *, rank: int,
                alpha: float, targets: Iterable[str] = DEFAULT_TARGETS):
    """A copy of ``params`` with adapters at the target sites: A ~ N(0, 1/r)
    drawn from ``generator`` (on the weights' device), B = 0, scale
    alpha / r of shape (*lead,)."""
    params = _copy_dicts(params)
    for _, node in _sites(params, tuple(targets)):
        w = node.get("w")
        if w is None:
            continue
        *lead, din, dout = w.shape
        a = torch.randn((*lead, din, rank), generator=generator,
                        device=w.device)
        node["lora_a"] = a * rank ** -0.5
        node["lora_b"] = torch.zeros((*lead, rank, dout),
                                     dtype=torch.float32, device=w.device)
        node["lora_scale"] = torch.full(tuple(lead), alpha / rank,
                                        dtype=torch.float32, device=w.device)
    return params


def _best_block(n: int, target: int) -> int:
    for qb in range(target, 1, -1):
        if n % qb == 0:
            return qb
    return 1


def quantize_base(params, *, qblock: int = 64,
                  targets: Iterable[str] = DEFAULT_TARGETS):
    """NF4-quantize the frozen base weights at LoRA sites (QLoRA).  A
    stacked weight is quantized one layer at a time (the same codes: blocks
    never cross a layer), so the full-width distance tensor is one layer's.
    Where ``qblock`` does not divide in*out the largest block below it that
    does is used, as in the reference, and such blocks may cross rows."""
    params = _copy_dicts(params)
    for path, node in _sites(params, tuple(targets)):
        if any(nq in path for nq in NO_QUANT) or "w" not in node:
            continue
        w = node.pop("w")
        n = w.shape[-2] * w.shape[-1]
        qb = qblock if n % qblock == 0 else _best_block(n, qblock)
        if w.ndim == 3:
            parts = [nf4_quantize(w[i], qb) for i in range(w.shape[0])]
            node["w_nf4"] = torch.stack([p[0] for p in parts])
            node["absmax"] = torch.stack([p[1] for p in parts])
        else:
            node["w_nf4"], node["absmax"] = nf4_quantize(w, qb)
    return params


# ---------------------------------------------------------------------------
# Adapter extraction / merging — the federated payload
# ---------------------------------------------------------------------------

def lora_tree(params):
    """Subtree holding ONLY the adapter leaves (lora_a / lora_b)."""
    out = {}
    for k, v in params.items():
        if k in ("lora_a", "lora_b"):
            out[k] = v
        elif isinstance(v, dict):
            sub = lora_tree(v)
            if sub:
                out[k] = sub
    return out


def merge_lora(params, adapters):
    """Put adapter leaves back into a full parameter tree (a new tree; the
    other leaves are shared)."""
    out = {}
    for k, v in params.items():
        if k in ("lora_a", "lora_b") and k in adapters:
            out[k] = adapters[k]
        elif isinstance(v, dict):
            out[k] = merge_lora(v, adapters.get(k, {}))
        else:
            out[k] = v
    return out


def lora_mask(params):
    """A tree of bools, True exactly on adapter leaves."""
    def rec(node, key=None):
        if isinstance(node, dict):
            return {k: rec(v, k) for k, v in node.items()}
        return key in ("lora_a", "lora_b")
    return rec(params)


def materialize_lora(params):
    """Fold adapters into base weights, W' = W + s·A·B (the deploy path
    after federation).  Quantized sites keep their adapters: they cannot
    be folded into NF4 codes losslessly.  A stacked site's scale (L,)
    scales each layer's product."""
    if not isinstance(params, dict):
        return params
    if "lora_a" in params and "w" in params and \
            not isinstance(params["w"], dict):
        w, s = params["w"], params["lora_scale"]
        delta = (params["lora_a"] @ params["lora_b"] *
                 s.reshape(s.shape + (1, 1))).to(w.dtype)
        return {"w": w + delta}
    return {k: materialize_lora(v) if isinstance(v, dict) else v
            for k, v in params.items()}


def tree_nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_util.leaves(tree))


def count_params(tree) -> int:
    return sum(t.numel() for t in tree_util.leaves(tree))


def trainable_fraction(params) -> float:
    """Paper's 'only 1.2% of parameters are trainable' metric."""
    return count_params(lora_tree(params)) / max(count_params(params), 1)
