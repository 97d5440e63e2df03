"""Mixture-of-Experts block: top-k router + capacity-based dispatch (the
reference's ``src/repro/models/layers/moe.py``).

Dispatch is GShard-style, as in the reference: tokens are cut into groups
of ``group_size``; each (token, k) assignment takes a position in its
expert's buffer of ``C`` slots (a cumulative sum over the group's
token-major (token, k) order), and assignments past ``C`` are dropped
(their routed contribution is 0; shared experts and the residual still
apply).  Dispatch and combine are one-hot (G, g, E, C) tensors in the
activations' dtype, built one k at a time; every expert runs its ``C``
slots, so the products are the routed work (top-k / E of dense).  The
expert products are ``torch.einsum``: the reference computes them outside
any Pallas kernel.

Expert weights are stacked (E, d, f) / (E, f, d) (a leading layer axis in
a stacked model); the router is f32 whatever the model's dtype.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers.linear import draw_normal
from repro_torch.models.layers.mlp import init_mlp, mlp


def init_moe(generator: torch.Generator, cfg: ModelConfig, *,
             layers: int = 0, dtype=torch.float32, device=None):
    """Router, routed experts and (qwen2-moe) the shared experts fused into
    one wide MLP, with the reference's shapes, dtypes and scales; ``layers``
    > 0 stacks a leading layer axis (drawn a layer at a time)."""
    m = cfg.moe
    d, f, e = cfg.d_model, m.expert_d_ff or cfg.d_ff, m.num_experts
    lead = (layers,) if layers else ()
    kw = dict(device=device, stacked=bool(layers))

    def draw(shape, scale, dt):
        return draw_normal(generator, lead + shape, scale, dtype=dt, **kw)

    p = {
        "router": {"w": draw((d, e), d ** -0.5, torch.float32)},
        "gate_proj": draw((e, d, f), d ** -0.5, dtype),
        "up_proj": draw((e, d, f), d ** -0.5, dtype),
        "down_proj": draw((e, f, d), f ** -0.5, dtype),
    }
    if m.num_shared_experts > 0:
        p["shared"] = init_mlp(generator, d, m.num_shared_experts * f,
                               cfg.activation, layers=layers, dtype=dtype,
                               device=device)
    return p


def _capacity(group: int, top_k: int, num_experts: int, cf: float) -> int:
    c = int(group * top_k / num_experts * cf) + 1
    return max(4, -(-c // 4) * 4)        # round up to multiple of 4


def _slabs(n_groups: int) -> int:
    """``REPRO_MOE_SLABS``, read as the reference reads it: the expert
    compute runs in that many slabs of groups where it divides the group
    count, else in one.  The slabs compute the same values."""
    want = int(os.environ.get("REPRO_MOE_SLABS", "1"))
    return want if want > 1 and n_groups % max(want, 1) == 0 else 1


def _expert_compute(params, cfg: ModelConfig, disp, comb, xg):
    """(G', g, E, C) dispatch / combine and (G', g, d) tokens -> (G', g, d)
    routed output."""
    dt = xg.dtype
    expert_in = torch.einsum("Ggec,Ggd->Gecd", disp, xg)      # (G', E, C, d)

    def proj(name):
        return torch.einsum("Gecd,edf->Gecf", expert_in,
                            params[name].to(dt))

    if cfg.activation == "swiglu":
        h = F.silu(proj("gate_proj")) * proj("up_proj")
    elif cfg.activation == "geglu":
        h = F.gelu(proj("gate_proj"), approximate="tanh") * proj("up_proj")
    else:
        h = F.gelu(proj("up_proj"), approximate="tanh")
    expert_out = torch.einsum("Gecf,efd->Gecd", h,
                              params["down_proj"].to(dt))
    return torch.einsum("Ggec,Gecd->Ggd", comb, expert_out)


def router_aux(cfg: ModelConfig, stats: torch.Tensor, tokens) -> torch.Tensor:
    """The Switch load-balance loss, ``E · Σ_e frac_tokens_e · frac_probs_e
    · coef``, from router statistics ``(..., 2, E)`` over ``tokens``
    tokens (``[..., 0, :]`` each expert's top-1 count, ``[..., 1, :]`` its
    summed probability), summed over any leading (layer) axes.

    It is linear in the probability sums: over ranks that each hold some of
    the tokens, the global loss is the sum over ranks of ``router_aux`` of
    the global counts beside the rank's own probability sums, in value and
    in gradient (the counts carry none)."""
    m = cfg.moe
    frac = stats / tokens
    return m.num_experts * torch.sum(frac[..., 0, :] * frac[..., 1, :]) * \
        m.router_aux_loss_coef


def moe_block(params, cfg: ModelConfig, x: torch.Tensor, *,
              group_size: int = 512):
    """x: (B, S, d) -> (y, router statistics (2, E)), whose
    ``router_aux`` over the B S tokens is the reference's aux loss.
    Capacity-dropped tokens fall through with zero routed contribution
    (shared experts / residual still apply).  The token count must be a
    multiple of the group (``min(group_size, B S)``), as the reference
    asserts."""
    m = cfg.moe
    B, S, d = x.shape
    T = B * S
    g = min(group_size, T)
    if T % g:
        raise AssertionError((T, g))
    nG = T // g
    E, K = m.num_experts, m.top_k
    C = _capacity(g, K, E, m.capacity_factor)

    xt = x.reshape(nG, g, d)
    logits = torch.einsum("Ggd,de->Gge", xt.float(),
                          params["router"]["w"].float())
    probs = torch.softmax(logits, dim=-1)                     # (G, g, E)
    gate_vals, expert_idx = torch.topk(probs, K, dim=-1)      # (G, g, k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)             # renormalize

    # position of each (token, k) assignment inside its expert's buffer
    onehot = F.one_hot(expert_idx, E).to(torch.int32)         # (G, g, k, E)
    flat = onehot.reshape(nG, g * K, E)
    pos = torch.cumsum(flat, dim=1) - 1
    pos = (pos * flat).sum(-1).reshape(nG, g, K)              # (G, g, k)
    in_cap = pos < C

    dispatch = torch.zeros((nG, g, E, C), dtype=x.dtype, device=x.device)
    combine = torch.zeros_like(dispatch)
    for kk in range(K):
        oe = F.one_hot(expert_idx[..., kk], E).to(x.dtype)    # (G, g, E)
        oc = F.one_hot(torch.where(in_cap[..., kk], pos[..., kk],
                                   torch.full_like(pos[..., kk], C)),
                       C + 1).to(x.dtype)[..., :C]            # (G, g, C)
        d_k = oe[..., :, None] * oc[..., None, :]             # (G, g, E, C)
        dispatch = dispatch + d_k
        combine = combine + d_k * gate_vals[..., kk, None, None].to(x.dtype)

    n_slabs = _slabs(nG)
    if n_slabs > 1:
        slab = nG // n_slabs
        y = torch.cat([_expert_compute(params, cfg,
                                       dispatch[i:i + slab],
                                       combine[i:i + slab], xt[i:i + slab])
                       for i in range(0, nG, slab)])
    else:
        y = _expert_compute(params, cfg, dispatch, combine, xt)
    y = y.reshape(B, S, d)

    if "shared" in params:
        y = y + mlp(params["shared"], x, cfg.activation)

    # the load-balance (Switch) loss's statistics, f32, on each token's
    # top-1 choice
    return y, torch.stack([F.one_hot(expert_idx[..., 0], E).float().sum(
        (0, 1)), probs.sum(dim=(0, 1))])
