"""Mamba2 (SSD, state-space duality) block in the chunked-parallel form,
the reference's ``src/repro/models/layers/mamba2.py``.

The chunkwise matmul decomposition of the reference: products within a
chunk (an attention-like ``(B, C, L, L, H)`` decay product), each chunk's
end state, and a loop over chunks carrying the ``(H, P, N)`` state (the
reference's ``lax.scan`` is a Python loop here).  Every decay is a
difference of cumulative negative log-decays, so every ``exp`` argument is
<= 0, as in the reference.

State update:   h_t = exp(dt_t * -exp(A_log)) h_{t-1} + (dt_t x_t) ⊗ B_t
Output:         y_t = C_t · h_t + D ⊙ x_t
Gating/out:     out = out_proj( RMSNorm(y) * silu(z) )

A prompt that is not a chunk multiple is padded to one; the state returned
is then the state after the padded steps, while the conv tail is taken from
the unpadded positions, as in the reference.  ``A_log``, ``D`` and
``dt_bias`` are f32 whatever the model's dtype; the SSM state is f32, the
conv buffer in the cache's dtype.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers.linear import dense, draw_normal, init_dense
from repro_torch.models.layers.norms import init_rmsnorm, rmsnorm


def mamba2_dims(cfg: ModelConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    # in_proj emits [z, x, B, C, dt]
    conv_dim = d_inner + 2 * s.state_dim
    return d_inner, n_heads, conv_dim


def _dt_bias(generator: torch.Generator, shape, device):
    """The reference's inverse softplus of dt drawn log-uniform in [1e-3,
    1e-1], in f32."""
    lo, hi = math.log(1e-3), math.log(1e-1)
    u = torch.rand(shape, generator=generator, device=device)
    return torch.log(torch.expm1(torch.exp(lo + (hi - lo) * u)))


def init_mamba2(generator: torch.Generator, cfg: ModelConfig, *,
                layers: int = 0, dtype=torch.float32, device=None):
    """The reference's leaves, shapes, dtypes and scales; ``layers`` > 0
    stacks a leading layer axis (drawn a layer at a time)."""
    s = cfg.ssm
    d_inner, n_heads, conv_dim = mamba2_dims(cfg)
    lead = (layers,) if layers else ()
    kw = dict(layers=layers, dtype=dtype, device=device)
    proj_out = 2 * d_inner + 2 * s.state_dim + n_heads
    a_log = torch.log(torch.linspace(1.0, 16.0, n_heads, device=device))
    return {
        "in_proj": init_dense(generator, cfg.d_model, proj_out, **kw),
        "conv_w": draw_normal(generator, lead + (s.conv_width, conv_dim),
                              s.conv_width ** -0.5, dtype=dtype,
                              device=device, stacked=bool(layers)),
        "conv_b": torch.zeros(lead + (conv_dim,), dtype=dtype, device=device),
        "A_log": a_log.expand(lead + (n_heads,)).clone(),
        "D": torch.ones(lead + (n_heads,), device=device),
        "dt_bias": _dt_bias(generator, lead + (n_heads,), device),
        "norm": init_rmsnorm(d_inner, layers=layers, device=device),
        "out_proj": init_dense(generator, d_inner, cfg.d_model, **kw),
    }


def _causal_conv(x, w, b):
    """Depthwise causal conv over the sequence: x (B, S, Cd), w (W, Cd)."""
    W, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, W - 1, 0))
    out = torch.zeros_like(x)
    for i in range(W):
        out = out + xp[:, i:i + S, :] * w[i][None, None, :]
    return out + b[None, None, :]


def _split_proj(cfg: ModelConfig, zxbcdt):
    """in_proj's output -> (z, x, B, C, dt)."""
    s = cfg.ssm
    d_inner, n_heads, _ = mamba2_dims(cfg)
    return torch.split(zxbcdt, [d_inner, d_inner, s.state_dim, s.state_dim,
                                n_heads], dim=-1)


def mamba2_forward(params, cfg: ModelConfig, x: torch.Tensor,
                   initial_state=None, return_cache: bool = False):
    """x (B, S, d_model) -> (y, final state (B, H, P, N) f32), or with
    ``return_cache`` (y, {"ssm_state", "conv_buf"}): the decode cache
    after the prompt."""
    s = cfg.ssm
    d_inner, H, _ = mamba2_dims(cfg)
    P, N = s.head_dim, s.state_dim
    B_, S, _ = x.shape
    Lc = min(s.chunk_size, S)
    pad = (-S) % Lc
    if pad:
        # the state returned reflects the padded steps, as in the reference
        x = F.pad(x, (0, 0, 0, pad))
        S = S + pad
    nC = S // Lc

    z, xc, Bm, Cm, dt = _split_proj(cfg, dense(params["in_proj"], x))
    conv_in = torch.cat([xc, Bm, Cm], dim=-1)
    if return_cache:
        W = s.conv_width
        tail = conv_in[:, max(0, S - pad - (W - 1)):S - pad, :]
        if tail.shape[1] < W - 1:
            tail = F.pad(tail, (0, 0, W - 1 - tail.shape[1], 0))
    conv_out = F.silu(_causal_conv(conv_in, params["conv_w"].to(x.dtype),
                                   params["conv_b"].to(x.dtype)))
    xc, Bm, Cm = torch.split(conv_out, [d_inner, N, N], dim=-1)

    xh = xc.reshape(B_, S, H, P)
    dt = F.softplus(dt.float() + params["dt_bias"][None, None, :])  # (B,S,H)
    la = -torch.exp(params["A_log"])[None, None, :] * dt             # <= 0
    xb = xh.float() * dt[..., None]                      # dt folded into x

    # chunk views
    xb_c = xb.reshape(B_, nC, Lc, H, P)
    B_c = Bm.reshape(B_, nC, Lc, N).float()
    C_c = Cm.reshape(B_, nC, Lc, N).float()
    cum = torch.cumsum(la.reshape(B_, nC, Lc, H), dim=2)            # (B,C,L,H)

    # intra-chunk: a causal "attention" with decay, (B, C, Li, Lj, H)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    causal = torch.ones((Lc, Lc), dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(seg.masked_fill(~causal[None, None, :, :, None],
                                      float("-inf")))               # <= 1
    cb = torch.einsum("bcin,bcjn->bcij", C_c, B_c)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", cb[..., None] * decay, xb_c)

    # each chunk's end state, then the inter-chunk recurrence
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)               # (B,C,L,H)
    s_chunk = torch.einsum("bcln,bclhp->bchpn", B_c,
                           xb_c * decay_to_end[..., None])          # (B,C,H,P,N)
    chunk_decay = torch.exp(cum[:, :, -1, :])                       # (B,C,H)
    h = (initial_state if initial_state is not None else
         torch.zeros((B_, H, P, N), device=x.device))
    h_before = []                                 # the state BEFORE each chunk
    for c in range(nC):
        h_before.append(h)
        h = h * chunk_decay[:, c, :, None, None] + s_chunk[:, c]
    h_before = torch.stack(h_before, dim=1)                         # (B,C,H,P,N)

    y_inter = torch.einsum("bcln,bchpn->bclhp", C_c, h_before) * \
        torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(B_, S, H, P) + \
        params["D"][None, None, :, None] * xh.float()
    y = y.reshape(B_, S, d_inner).to(x.dtype)
    y = rmsnorm(params["norm"], y, cfg.norm_eps) * F.silu(z)
    out = dense(params["out_proj"], y)
    if pad:
        out = out[:, :S - pad]
    if return_cache:
        return out, {"ssm_state": h, "conv_buf": tail}
    return out, h


# ---------------------------------------------------------------------------
# Decode (the one-step recurrence)
# ---------------------------------------------------------------------------

def init_mamba2_cache(cfg: ModelConfig, batch: int, dtype=torch.bfloat16,
                      device="cuda"):
    s = cfg.ssm
    _, n_heads, conv_dim = mamba2_dims(cfg)
    return {
        "ssm_state": torch.zeros((batch, n_heads, s.head_dim, s.state_dim),
                                 device=device),
        "conv_buf": torch.zeros((batch, s.conv_width - 1, conv_dim),
                                dtype=dtype, device=device),
    }


def mamba2_decode(params, cfg: ModelConfig, x_t: torch.Tensor, cache):
    """x_t (B, 1, d_model) -> (y_t, new cache)."""
    s = cfg.ssm
    d_inner, H, _ = mamba2_dims(cfg)
    P, N = s.head_dim, s.state_dim
    B_ = x_t.shape[0]
    z, xc, Bm, Cm, dt = _split_proj(cfg, dense(params["in_proj"], x_t))
    conv_in = torch.cat([xc, Bm, Cm], dim=-1)                       # (B,1,Cd)

    buf = torch.cat([cache["conv_buf"],
                     conv_in.to(cache["conv_buf"].dtype)], dim=1)   # (B,W,Cd)
    # the buffer's and the weights' types promoted, as jnp promotes them
    # (a bf16 cache under f32 weights gives an f32 product)
    ct = torch.promote_types(buf.dtype, x_t.dtype)
    conv_out = F.silu(torch.einsum("bwc,wc->bc", buf.to(ct),
                                   params["conv_w"].to(ct)) +
                      params["conv_b"].to(x_t.dtype))
    xc1, Bm1, Cm1 = torch.split(conv_out, [d_inner, N, N], dim=-1)

    xh = xc1.reshape(B_, H, P).float()
    dt1 = F.softplus(dt[:, 0, :].float() + params["dt_bias"][None, :])
    a = torch.exp(-torch.exp(params["A_log"])[None, :] * dt1)       # (B,H)
    h_new = cache["ssm_state"] * a[:, :, None, None] + torch.einsum(
        "bhp,bn->bhpn", xh * dt1[..., None], Bm1.float())
    y = torch.einsum("bn,bhpn->bhp", Cm1.float(), h_new) + \
        params["D"][None, :, None] * xh
    y = y.reshape(B_, 1, d_inner).to(x_t.dtype)
    y = rmsnorm(params["norm"], y, cfg.norm_eps) * F.silu(z)
    return dense(params["out_proj"], y), {"ssm_state": h_new,
                                          "conv_buf": buf[:, 1:, :]}
