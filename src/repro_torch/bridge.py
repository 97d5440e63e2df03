"""Weights across the two packages.

The reference's parameters are a nested dict of arrays; the port keeps the
same tree (same keys, the stacked leading layer axis, ``w`` as (in, out),
the tied embedding table, uint8 NF4 codes with f32 absmax scales), so the
bridge only converts leaves.  bf16 leaves
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
    """``fn`` on every leaf of a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def tree_to_torch(tree, device="cuda"):
    """Any tree of numpy arrays -> the same tree of tensors on ``device``,
    bit for bit (adapter trees, batches), with no shape check."""
    return _map(tree, lambda a: _to_tensor(a, device))


def _shape(params, *path):
    node = params
    for k in path:
        if not isinstance(node, dict) or k not in node:
            return None
        node = node[k]
    return tuple(node.shape)


def _check_dense(params, cfg: ModelConfig) -> None:
    """A dense or MoE tree: the embedding table, and the block stack (an
    alternating config's ``local`` and ``global`` stacks of half the layers
    each; an MoE model's routers beside its attention)."""
    table = _shape(params, "embed", "table")
    if table != (cfg.vocab_size, cfg.d_model):
        raise ValueError(f"params_from_jax: embed table does not match "
                         f"{cfg.name} ({cfg.vocab_size}, {cfg.d_model})")
    if cfg.local_global_alternating:
        stacks, n = (("layers", "local"), ("layers", "global")), \
            cfg.num_layers // 2
    else:
        stacks, n = (("layers",),), cfg.num_layers
    for stack in stacks:
        if _shape(params, *stack, "attn", "wq", "w") != (
                n, cfg.d_model, cfg.q_dim):
            raise ValueError(f"params_from_jax: {'/'.join(stack)} is not a "
                             f"stack of {n} {cfg.name} blocks")
    if cfg.family == "moe" and _shape(params, "layers", "moe", "router",
                                      "w") != (cfg.num_layers, cfg.d_model,
                                               cfg.moe.num_experts):
        raise ValueError(f"params_from_jax: layers carry no stack of "
                         f"{cfg.num_layers} {cfg.name} routers")


def _check_xlstm(params, cfg: ModelConfig) -> None:
    """An xLSTM tree: the embedding table, the ``(nG, nM)`` stack of mLSTM
    blocks and the ``(nG,)`` stack of sLSTM blocks."""
    k = cfg.xlstm.slstm_every if cfg.xlstm is not None else 0
    if not k or cfg.num_layers % k:
        raise ValueError(f"params_from_jax: {cfg.name} is not an xLSTM "
                         f"config")
    nG, nM, d = cfg.num_layers // k, k - 1, cfg.d_model
    d_inner = int(cfg.xlstm.mlstm_proj_factor * d)
    want = {("embed", "table"): (cfg.vocab_size, d),
            ("mlstm", "block", "up", "w"): (nG, nM, d, 2 * d_inner),
            ("mlstm", "block", "down", "w"): (nG, nM, d_inner, d),
            ("slstm", "block", "w_in", "w"): (nG, d, 4 * d),
            ("final_norm", "scale"): (d,)}
    for path, shape in want.items():
        got = _shape(params, *path)
        if got != shape:
            raise ValueError(f"params_from_jax: {'/'.join(path)} is {got}, "
                             f"not {shape} of {cfg.name}")


def _check_hybrid(params, cfg: ModelConfig) -> None:
    """A Zamba2 tree: the embedding table, the ``(nG, nM)`` stack of Mamba2
    layers and the ``(n,)`` stack of shared blocks, which read 2 d_model
    and write d_model."""
    hy = cfg.hybrid
    if hy is None or cfg.ssm is None or cfg.num_layers % hy.shared_attn_every:
        raise ValueError(f"params_from_jax: {cfg.name} is not a hybrid "
                         f"config")
    nG, nM = cfg.num_layers // hy.shared_attn_every, hy.shared_attn_every
    d, n = cfg.d_model, hy.num_shared_blocks
    d_inner = cfg.ssm.expand * d
    want = {("embed", "table"): (cfg.vocab_size, d),
            ("mamba", "block", "out_proj", "w"): (nG, nM, d_inner, d),
            ("mamba", "norm", "scale"): (nG, nM, d),
            ("shared", "attn", "wq", "w"): (n, 2 * d, cfg.q_dim),
            ("shared", "mlp", "down", "w"): (n, cfg.d_ff, d),
            ("lm_head", "w"): (d, cfg.vocab_size)}
    for path, shape in want.items():
        got = _shape(params, *path)
        if got != shape:
            raise ValueError(f"params_from_jax: {'/'.join(path)} is {got}, "
                             f"not {shape} of {cfg.name}")


def _check_encdec(params, cfg: ModelConfig) -> None:
    """An encoder-decoder tree: ``frame_proj``, the embedding table, the
    stacks of encoder and decoder blocks (each decoder block with its
    ``cross`` attention), ``enc_norm`` and ``final_norm``."""
    if cfg.encdec is None:
        raise ValueError(f"params_from_jax: {cfg.name} is not an "
                         f"encoder-decoder config")
    d, Le, Ld = cfg.d_model, cfg.encdec.encoder_layers, cfg.num_layers
    want = {("frame_proj", "w"): (d, d),
            ("embed", "table"): (cfg.vocab_size, d),
            ("encoder", "attn", "wq", "w"): (Le, d, cfg.q_dim),
            ("encoder", "mlp", "down", "w"): (Le, cfg.d_ff, d),
            ("enc_norm", "scale"): (d,),
            ("decoder", "attn", "wq", "w"): (Ld, d, cfg.q_dim),
            ("decoder", "cross", "wk", "w"): (Ld, d, cfg.kv_dim),
            ("decoder", "cross", "wo", "w"): (Ld, cfg.q_dim, d),
            ("decoder", "mlp", "down", "w"): (Ld, cfg.d_ff, d),
            ("final_norm", "scale"): (d,)}
    for path, shape in want.items():
        got = _shape(params, *path)
        if got != shape:
            raise ValueError(f"params_from_jax: {'/'.join(path)} is {got}, "
                             f"not {shape} of {cfg.name}")


def _check_fedtime(params, cfg: ModelConfig) -> None:
    """The FedTime tree: patch embedding, a block stack whose attention
    weights are plain ``w`` or NF4 ``w_nf4``/``absmax`` (with or without
    LoRA leaves), final norm, forecast head and RevIN."""
    ft = cfg.fedtime
    L, d = cfg.num_layers, cfg.d_model
    n = (ft.lookback - ft.patch_len) // ft.patch_stride + 1
    want = {("patch", "w_p"): (ft.patch_len, d),
            ("patch", "w_pos"): (n, d),
            ("final_norm", "scale"): (d,),
            ("head", "w"): (n * d, ft.horizon),
            ("layers", "mlp", "down", "w"): (L, cfg.d_ff, d)}
    for name, out in (("wq", cfg.q_dim), ("wk", cfg.kv_dim),
                      ("wv", cfg.kv_dim), ("wo", d)):
        din = cfg.q_dim if name == "wo" else d
        site = ("layers", "attn", name)
        if _shape(params, *site, "w") is not None:
            want[site + ("w",)] = (L, din, out)
        else:
            want[site + ("w_nf4",)] = (L, din, out // 2)
            absmax = _shape(params, *site, "absmax")
            if absmax is None or absmax[0] != L:
                raise ValueError(f"params_from_jax: {'/'.join(site)} has "
                                 f"neither w nor a stack of NF4 scales")
        if _shape(params, *site, "lora_a") is not None:
            want[site + ("lora_b",)] = (
                L, _shape(params, *site, "lora_a")[-1], out)
    for path, shape in want.items():
        got = _shape(params, *path)
        if got != shape:
            raise ValueError(f"params_from_jax: {'/'.join(path)} is {got}, "
                             f"not {shape} of {cfg.name}")
    m = _shape(params, "revin", "gamma")
    if m is None or _shape(params, "revin", "beta") != m:
        raise ValueError("params_from_jax: revin gamma/beta missing")


def params_from_jax(tree, cfg: ModelConfig, device="cuda"):
    """The reference's parameter tree (leaves as numpy arrays) -> the port's
    parameters on ``device``.  A tree with a ``patch`` embedding is a
    FedTime model and is checked as one, one with ``mlstm`` stacks an
    xLSTM model, one with ``mamba`` stacks a Zamba2 model, one with an
    ``encoder`` stack an encoder-decoder; any other must describe
    ``cfg``'s dense or MoE model.
    Raises if the tree does not match ``cfg``."""
    params = tree_to_torch(tree, device)
    if "patch" in params:
        _check_fedtime(params, cfg)
    elif "mlstm" in params:
        _check_xlstm(params, cfg)
    elif "mamba" in params:
        _check_hybrid(params, cfg)
    elif "encoder" in params:
        _check_encdec(params, cfg)
    else:
        _check_dense(params, cfg)
    return params


def params_to_numpy(params):
    """The port's parameters -> the reference's tree of numpy arrays."""
    return _map(params, _to_numpy)
