"""Least times on one H100 for the TPU kernels that are still to port, at
the shapes the federated fit would give them.

    PYTHONPATH=src python tools/kernel_bounds.py

No path of the reference calls ``qlora_matmul``, ``rmsnorm`` or
``flash_attention``: its ``dense`` dequantizes NF4 and leaves the product to
XLA, and its norms and attention are plain jnp.  This prints, for one local
step's forward at fedtime-llama2-7b's widths (batch 4 x 2 channels = 8
series of 63 patch tokens, bf16), what each kernel would move and compute
per call and the bound that follows: the larger of bytes over 3.35 TB/s and
operations over the rate for their type (989 TFLOP/s for bf16 products on
the tensor cores, 67 TFLOP/s for f32 arithmetic outside them), from
NVIDIA's H100 SXM data sheet.  Each input is counted read once and each
output written once.  No device is used: these are shape arithmetic, not
measurements.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12


def _bound(name, nbytes, flops, calls, rate=BF16_FLOPS):
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = flops / rate * 1e3
    by, t = ("bytes", t_b) if t_b >= t_o else ("operations", t_o)
    print(f"{name}: {nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP per call "
          f"-> bound {t:.4f} ms ({by}); {calls} calls in a forward were it "
          f"on the path")


def main() -> None:
    from repro_torch.configs import get_config
    from repro_torch.core.patching import num_patches
    cfg = get_config("fedtime-llama2-7b")
    ft = cfg.fedtime
    L, d, H, D = cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.head_dim
    S = num_patches(ft.lookback, ft.patch_len, ft.patch_stride)
    series = 4 * 2
    M = series * S                                   # rows of every linear
    r, qb = ft.lora_rank, ft.qlora_block
    # qlora_matmul at wq: x (M, d) bf16, codes (d, d/2) u8, absmax f32 per
    # qblock, A (d, r), B (r, d) f32, y (M, d) bf16
    k = n = d
    nbytes = (M * k * 2 + k * n // 2 + k * n // qb * 4 + (k * r + r * n) * 4
              + M * n * 2)
    flops = 2 * M * k * n + 2 * M * k * r + 2 * M * r * n
    _bound("qlora_matmul (wq/wk/wv/wo, one layer's one site)", nbytes, flops,
           4 * L)
    # rmsnorm: x (M, d) bf16 in and out, an f32 scale
    _bound("rmsnorm (attn_norm / mlp_norm, one layer's one)",
           2 * M * d * 2 + d * 4, 4 * M * d, 2 * L + 1, rate=F32_FLOPS)
    # flash_attention, causal: q, k, v, o (series, H, S, D) bf16
    qkvo = 4 * series * H * S * D * 2
    _bound("flash_attention (causal, one layer)", qkvo,
           2 * 2 * series * H * D * S * (S + 1) // 2, L)


if __name__ == "__main__":
    main()
