"""xLSTM blocks: mLSTM (matrix memory, chunkwise-parallel) and sLSTM (scalar
memory, a true recurrence), the reference's
``src/repro/models/layers/xlstm.py``.  [arXiv:2405.04517]

mLSTM runs in the reference's max-stabilised chunkwise form: products
within a chunk, and a loop over chunks carrying the state (the
reference's ``lax.scan`` is a Python loop here).  The exponential input
gate needs a running log-max ``m`` and a normaliser state ``n``.

Cell (per head):
  C_t = f_t C_{t-1} + i_t k_t v_t^T        (matrix memory,  f=σ(f̃), i=exp(ĩ))
  n_t = f_t n_{t-1} + i_t k_t              (normaliser)
  h_t = (C_t^T q_t) / max(|n_t^T q_t|, exp(-m_t))   with running log-max m_t

The order of the stabiliser's operations is the reference's: masked
intra-chunk weights are -inf, the chunk's row maximum is bounded below by
0, and the denominator's floor is exp(-m).  A prompt that is not a chunk
multiple is padded to one, and the state returned is the state after the
padded steps, as in the reference.

sLSTM is a sequential recurrence over time, one Python step a position
(the reference's ``lax.scan``).  Recurrent states are f32 whatever the
model's dtype; the conv buffer is in the cache's dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers.linear import dense, draw_normal, init_dense
from repro_torch.models.layers.norms import init_rmsnorm, rmsnorm


def mlstm_dims(cfg: ModelConfig):
    x = cfg.xlstm
    d_inner = int(x.mlstm_proj_factor * cfg.d_model)
    H = cfg.num_heads
    return d_inner, H, d_inner // H


def init_mlstm_block(generator: torch.Generator, cfg: ModelConfig, *,
                     layers: int = 0, dtype=torch.float32, device=None):
    """The reference's leaves, shapes, dtypes and scales; ``layers`` > 0
    stacks a leading layer axis (drawn a layer at a time)."""
    x = cfg.xlstm
    d_inner, H, _ = mlstm_dims(cfg)
    lead = (layers,) if layers else ()
    kw = dict(layers=layers, dtype=dtype, device=device)
    b_if = torch.cat([torch.zeros(H, device=device),             # i bias
                      torch.linspace(3.0, 6.0, H, device=device)])  # f bias
    return {
        "up": init_dense(generator, cfg.d_model, 2 * d_inner, **kw),
        "conv_w": draw_normal(generator, lead + (x.conv_width, d_inner),
                              x.conv_width ** -0.5, dtype=dtype,
                              device=device, stacked=bool(layers)),
        "conv_b": torch.zeros(lead + (d_inner,), dtype=dtype, device=device),
        "wq": init_dense(generator, d_inner, d_inner, **kw),
        "wk": init_dense(generator, d_inner, d_inner, **kw),
        "wv": init_dense(generator, d_inner, d_inner, **kw),
        "w_if": {"w": draw_normal(generator, lead + (d_inner, 2 * H),
                                  cfg.d_model ** -0.5, device=device,
                                  stacked=bool(layers))},
        "b_if": b_if.expand(lead + (2 * H,)).clone(),
        "norm": init_rmsnorm(d_inner, layers=layers, device=device),
        "down": init_dense(generator, d_inner, cfg.d_model, **kw),
    }


def _causal_conv(x, w, b):
    """Depthwise causal conv over the sequence: x (B, S, C), w (W, C)."""
    W, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, W - 1, 0))
    out = torch.zeros_like(x)
    for i in range(W):
        out = out + xp[:, i:i + S, :] * w[i][None, None, :]
    return out + b[None, None, :]


def init_mlstm_cache(cfg: ModelConfig, batch: int, dtype=torch.bfloat16,
                     device="cuda"):
    x = cfg.xlstm
    d_inner, H, dh = mlstm_dims(cfg)
    return {
        "C": torch.zeros((batch, H, dh, dh), device=device),
        "n": torch.zeros((batch, H, dh), device=device),
        "m": torch.zeros((batch, H), device=device),
        "conv_buf": torch.zeros((batch, x.conv_width - 1, d_inner),
                                dtype=dtype, device=device),
    }


def _mlstm_qkvif(params, cfg: ModelConfig, x):
    """-> (q, k, v, z, i_pre, log_f, xm): the reference's six, and the
    up-projection's first half (the conv's input), which a prefill keeps
    the tail of."""
    d_inner, H, dh = mlstm_dims(cfg)
    xm, z = dense(params["up"], x).chunk(2, dim=-1)
    cx = F.silu(_causal_conv(xm, params["conv_w"].to(x.dtype),
                             params["conv_b"].to(x.dtype)))
    B, S = x.shape[0], x.shape[1]
    q = dense(params["wq"], cx).reshape(B, S, H, dh) * (dh ** -0.5)
    k = dense(params["wk"], cx).reshape(B, S, H, dh)
    v = dense(params["wv"], xm).reshape(B, S, H, dh)
    gates = cx.float() @ params["w_if"]["w"] + params["b_if"][None, None, :]
    i_pre, f_pre = gates.chunk(2, dim=-1)                        # (B, S, H)
    return q, k, v, z, i_pre, F.logsigmoid(f_pre), xm


def _mlstm_chunk(qb, kb, vb, ib, fb, C_st, n_st, m_st, causal):
    """One chunk: (h (B, L, H, dh), C, n, m at the chunk's end)."""
    cum = torch.cumsum(fb, dim=1)                                # (B, L, H)
    # intra weights  w_ij = cum_i - cum_j + i_j   (j <= i)
    w = cum[:, :, None, :] - cum[:, None, :, :] + ib[:, None, :, :]
    w = w.masked_fill(~causal[None, :, :, None], float("-inf"))
    s_row = cum + m_st[:, None, :]                               # state path
    m_row = torch.maximum(w.amax(dim=2), s_row)
    m_row = m_row.clamp(min=0.0)     # lower bound: the |den| floor is exp(-m)
    p = torch.exp(w - m_row[:, :, None, :])                      # (B, L, L, H)
    pqk = p * torch.einsum("blhd,bmhd->blmh", qb, kb)
    num = torch.einsum("blmh,bmhd->blhd", pqk, vb)
    den = pqk.sum(dim=2)
    st_scale = torch.exp(s_row - m_row)
    num = num + st_scale[..., None] * torch.einsum("blhd,bhde->blhe", qb,
                                                   C_st)
    den = den + st_scale * torch.einsum("blhd,bhd->blh", qb, n_st)
    h = num / torch.maximum(den.abs(), torch.exp(-m_row))[..., None]

    # the state at the chunk's end
    cum_L = cum[:, -1, :]                                        # (B, H)
    w_end = cum_L[:, None, :] - cum + ib                         # (B, L, H)
    m_next = torch.maximum(m_st + cum_L, w_end.amax(dim=1))
    sc = torch.exp(w_end - m_next[:, None, :])
    decay = torch.exp(m_st + cum_L - m_next)
    C_new = decay[:, :, None, None] * C_st + torch.einsum(
        "blhd,blhe->bhde", sc[..., None] * kb, vb)
    n_new = decay[:, :, None] * n_st + torch.einsum("blh,blhd->bhd", sc, kb)
    return h, C_new, n_new, m_next


def mlstm_block_forward(params, cfg: ModelConfig, x: torch.Tensor,
                        state=None, return_cache: bool = False):
    """x (B, S, d_model) -> (y, state): the chunked stabilised mLSTM, from
    ``state`` (zeros by default).  ``return_cache`` adds the conv buffer
    (the last ``conv_width - 1`` conv inputs of the unpadded prompt)."""
    xc = cfg.xlstm
    d_inner, H, dh = mlstm_dims(cfg)
    B, S, _ = x.shape
    Lc = min(xc.chunk_size, S)
    pad = (-S) % Lc
    if pad:
        # pad to a chunk multiple (outputs sliced back; the state is the
        # padded one, as the reference's)
        x = F.pad(x, (0, 0, 0, pad))
        S = S + pad
    nC = S // Lc

    q, k, v, z, i_pre, log_f, xm = _mlstm_qkvif(params, cfg, x)

    def chunks(a):                   # (B, S, ...) -> (nC, B, Lc, ...)
        return a.reshape((B, nC, Lc) + a.shape[2:]).transpose(0, 1)

    qc, kc, vc = chunks(q.float()), chunks(k.float()), chunks(v.float())
    ic, fc = chunks(i_pre), chunks(log_f)
    if state is None:
        C_st = torch.zeros((B, H, dh, dh), device=x.device)
        n_st = torch.zeros((B, H, dh), device=x.device)
        m_st = torch.zeros((B, H), device=x.device)
    else:
        C_st, n_st, m_st = state["C"], state["n"], state["m"]
    causal = torch.tril(torch.ones((Lc, Lc), dtype=torch.bool,
                                   device=x.device))
    hs = []
    for c in range(nC):
        h, C_st, n_st, m_st = _mlstm_chunk(qc[c], kc[c], vc[c], ic[c], fc[c],
                                           C_st, n_st, m_st, causal)
        hs.append(h)
    h = torch.stack(hs, dim=1).reshape(B, S, d_inner).to(x.dtype)
    y = rmsnorm(params["norm"], h, cfg.norm_eps) * F.silu(z)
    out = dense(params["down"], y)
    if pad:
        out = out[:, :S - pad]
    new_state = {"C": C_st, "n": n_st, "m": m_st}
    if return_cache:
        W = xc.conv_width
        tail = xm[:, max(0, S - pad - (W - 1)):S - pad, :]
        if tail.shape[1] < W - 1:
            tail = F.pad(tail, (0, 0, W - 1 - tail.shape[1], 0))
        new_state["conv_buf"] = tail
    return out, new_state


def mlstm_block_decode(params, cfg: ModelConfig, x_t, cache):
    """x_t (B, 1, d_model): one recurrent mLSTM step -> (y, new cache)."""
    d_inner, H, dh = mlstm_dims(cfg)
    B = x_t.shape[0]
    xm, z = dense(params["up"], x_t).chunk(2, dim=-1)
    buf = torch.cat([cache["conv_buf"], xm.to(cache["conv_buf"].dtype)],
                    dim=1)
    dt = torch.promote_types(buf.dtype, x_t.dtype)
    w = params["conv_w"].to(x_t.dtype)
    cx = F.silu(torch.einsum("bwc,wc->bc", buf.to(dt), w.to(dt)) +
                params["conv_b"].to(x_t.dtype))[:, None, :]
    q = dense(params["wq"], cx).reshape(B, H, dh).float() * (dh ** -0.5)
    k = dense(params["wk"], cx).reshape(B, H, dh).float()
    v = dense(params["wv"], xm).reshape(B, H, dh).float()
    gates = cx[:, 0].float() @ params["w_if"]["w"] + params["b_if"][None, :]
    i_pre, f_pre = gates.chunk(2, dim=-1)                        # (B, H)
    log_f = F.logsigmoid(f_pre)

    m_new = torch.maximum(log_f + cache["m"], i_pre)
    f_sc = torch.exp(log_f + cache["m"] - m_new)
    i_sc = torch.exp(i_pre - m_new)
    C_new = f_sc[:, :, None, None] * cache["C"] + \
        i_sc[:, :, None, None] * (k[..., :, None] * v[..., None, :])
    n_new = f_sc[:, :, None] * cache["n"] + i_sc[:, :, None] * k
    num = torch.einsum("bhd,bhde->bhe", q, C_new)
    den = (q * n_new).sum(dim=-1)
    h = num / torch.maximum(den.abs(), torch.exp(-m_new))[..., None]
    h = h.reshape(B, 1, d_inner).to(x_t.dtype)
    y = rmsnorm(params["norm"], h, cfg.norm_eps) * F.silu(z)
    return dense(params["down"], y), {"C": C_new, "n": n_new, "m": m_new,
                                      "conv_buf": buf[:, 1:, :]}


# ---------------------------------------------------------------------------
# sLSTM (scalar memory, exponential gating, block-diagonal recurrence)
# ---------------------------------------------------------------------------

def slstm_dims(cfg: ModelConfig):
    H = cfg.num_heads
    d_ff = int(cfg.xlstm.slstm_proj_factor * cfg.d_model)
    return H, cfg.d_model // H, d_ff


def init_slstm_block(generator: torch.Generator, cfg: ModelConfig, *,
                     layers: int = 0, dtype=torch.float32, device=None):
    """The reference's leaves, shapes, dtypes and scales; ``layers`` > 0
    stacks a leading layer axis (drawn a layer at a time)."""
    H, dh, d_ff = slstm_dims(cfg)
    d = cfg.d_model
    lead = (layers,) if layers else ()
    kw = dict(layers=layers, dtype=dtype, device=device)
    b = torch.cat([torch.zeros(2 * d, device=device),
                   torch.full((d,), 3.0, device=device),         # f bias
                   torch.zeros(d, device=device)])
    return {
        "w_in": init_dense(generator, d, 4 * d, **kw),  # z, i, f, o pre-acts
        "r": draw_normal(generator, lead + (4, H, dh, dh), dh ** -0.5,
                         device=device, stacked=bool(layers)),
        "b": b.expand(lead + (4 * d,)).clone(),
        "norm": init_rmsnorm(d, layers=layers, device=device),
        "ffn_gate": init_dense(generator, d, d_ff, **kw),
        "ffn_up": init_dense(generator, d, d_ff, **kw),
        "ffn_down": init_dense(generator, d_ff, d, **kw),
    }


def init_slstm_cache(cfg: ModelConfig, batch: int, device="cuda"):
    """f32 states (B, d); ``n`` starts at 1e-6."""
    def zeros():
        return torch.zeros((batch, cfg.d_model), device=device)
    return {"c": zeros(), "n": zeros() + 1e-6, "m": zeros(), "h": zeros()}


def _slstm_cell(params, cfg: ModelConfig, x_pre, state):
    """One sLSTM step.  x_pre (B, 4d): the input pre-activations before the
    recurrent contribution; ``state`` a dict of (B, d)."""
    H, dh, _ = slstm_dims(cfg)
    B = x_pre.shape[0]
    hprev = state["h"].reshape(B, H, dh)
    rec = torch.einsum("ghde,bhd->bghe", params["r"], hprev).reshape(B, -1)
    pre = x_pre.float() + rec + params["b"][None, :]
    zp, ip, fp, op = pre.chunk(4, dim=-1)
    z = torch.tanh(zp)
    o = torch.sigmoid(op)
    log_f = F.logsigmoid(fp)
    m_new = torch.maximum(log_f + state["m"], ip)
    i_sc = torch.exp(ip - m_new)
    f_sc = torch.exp(log_f + state["m"] - m_new)
    c_new = f_sc * state["c"] + i_sc * z
    n_new = f_sc * state["n"] + i_sc
    h_new = o * c_new / n_new.clamp(min=1e-6)
    return {"c": c_new, "n": n_new, "m": m_new, "h": h_new}


def _slstm_ffn(params, h):
    return dense(params["ffn_down"],
                 F.gelu(dense(params["ffn_gate"], h), approximate="tanh") *
                 dense(params["ffn_up"], h))


def slstm_block_forward(params, cfg: ModelConfig, x: torch.Tensor,
                        state=None):
    """x (B, S, d_model) -> (y, state): one cell step a position."""
    x_pre = dense(params["w_in"], x)                             # (B, S, 4d)
    st = state if state is not None else init_slstm_cache(
        cfg, x.shape[0], device=x.device)
    hs = []
    for t in range(x.shape[1]):
        st = _slstm_cell(params, cfg, x_pre[:, t], st)
        hs.append(st["h"])
    h = torch.stack(hs, dim=1).to(x.dtype)                       # (B, S, d)
    return _slstm_ffn(params, rmsnorm(params["norm"], h, cfg.norm_eps)), st


def slstm_block_decode(params, cfg: ModelConfig, x_t, cache):
    """x_t (B, 1, d_model): one sLSTM step -> (y, new cache)."""
    st = _slstm_cell(params, cfg, dense(params["w_in"], x_t)[:, 0, :], cache)
    h = rmsnorm(params["norm"], st["h"][:, None, :].to(x_t.dtype),
                cfg.norm_eps)
    return _slstm_ffn(params, h), st
