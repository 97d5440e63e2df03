"""Least times on one H100 for the ``kernels.ops`` kernels (qlora_matmul,
rmsnorm, flash_attention) at the shapes ``chip_smoke.py`` drives them at.

    PYTHONPATH=src python tools/kernel_bounds.py

No model path of the reference calls these three: its ``dense``
dequantizes NF4 and leaves the product to XLA, and its norms and attention
are plain jnp.  This prints, per call, what each kernel moves and computes
and the bound that follows: the larger of bytes over 3.35 TB/s and
operations over the rate for their type (989 TFLOP/s for bf16 products on
the tensor cores; for f32 matrix products, three TF32 products at 494.7
TFLOP/s, an effective 164.9, since 3xTF32 on the tensor cores keeps the f32
limit and so is the least time the card could take; 67 TFLOP/s for other
f32 arithmetic, outside them), from NVIDIA's H100 SXM data sheet.  Each input is counted read once and each
output written once.  Two sets of shapes:

  * one local step's forward at fedtime-llama2-7b's widths (batch 4 x 2
    channels = 8 series of 63 patch tokens, bf16), with the number of calls
    a forward would make were the kernels on its path;
  * the reference benchmark's ``--full`` shapes
    (``benchmarks/kernels_bench.py``), in f32.

For bf16 qlora_matmul it also prints the floor of its f32 arithmetic on
the CUDA cores beside the bf16 tensor-core bound.  No device is used: these are shape arithmetic,
not measurements.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12                # f32 arithmetic outside the tensor cores
# f32 matrix products as 3xTF32 on the tensor cores: three TF32 products
# (494.7 TFLOP/s) for each f32 one
F32_MATMUL_FLOPS = 494.7e12 / 3


def _bound(name, nbytes, flops, calls=None, rate=BF16_FLOPS):
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = flops / rate * 1e3
    by, t = ("bytes", t_b) if t_b >= t_o else ("operations", t_o)
    where = (f"; {calls} calls in a forward were it on the path"
             if calls else "")
    print(f"{name}: {nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP per call "
          f"-> bound {t:.4f} ms ({by}){where}")


def _qlora(name, M, k, n, r, qb, elem, calls=None):
    """x (M, k) and y (M, n) of ``elem`` bytes, codes (k, n/2) u8, absmax
    f32 per qblock, A (k, r) and B (r, n) f32."""
    nbytes = (M * k * elem + k * n // 2 + k * n // qb * 4
              + (k * r + r * n) * 4 + M * n * elem)
    flops = 2 * M * k * n + 2 * M * k * r + 2 * M * r * n
    _bound(name, nbytes, flops, calls,
           rate=BF16_FLOPS if elem == 2 else F32_MATMUL_FLOPS)
    if elem == 2:
        print(f"  the same in f32 FMAs on the CUDA cores: "
              f"{flops / F32_FLOPS * 1e3:.4f} ms")


def _rmsnorm(name, rows, d, elem, calls=None):
    """x and y (rows, d) of ``elem`` bytes, a scale of d values."""
    _bound(name, 2 * rows * d * elem + d * elem, 4 * rows * d, calls,
           rate=F32_FLOPS)


def _attention(name, B, H, S, D, elem, causal, calls=None):
    """q, k, v, o (B, H, S, D) of ``elem`` bytes."""
    pairs = S * (S + 1) // 2 if causal else S * S
    _bound(name, 4 * B * H * S * D * elem, 4 * B * H * D * pairs, calls,
           rate=BF16_FLOPS if elem == 2 else F32_MATMUL_FLOPS)


def main() -> None:
    from repro_torch.configs import get_config
    from repro_torch.core.patching import num_patches
    cfg = get_config("fedtime-llama2-7b")
    ft = cfg.fedtime
    L, d, H, D = cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.head_dim
    S = num_patches(ft.lookback, ft.patch_len, ft.patch_stride)
    series = 4 * 2
    M = series * S                                   # rows of every linear
    print(f"fedtime-llama2-7b local step, bf16 ({series} series x {S} "
          f"tokens):")
    _qlora("qlora_matmul (wq/wk/wv/wo, one layer's one site)", M, d, d,
           ft.lora_rank, ft.qlora_block, 2, 4 * L)
    _rmsnorm("rmsnorm (attn_norm / mlp_norm, one layer's one)", M, d, 2,
             2 * L + 1)
    _attention("flash_attention (causal, one layer)", series, H, S, D, 2,
               True, L)
    print("reference benchmark --full shapes, f32:")
    _qlora("qlora_matmul (512, 1024, 1024, r 8, qblock 64)", 512, 1024, 1024,
           8, 64, 4)
    _rmsnorm("rmsnorm (64, 4096)", 64, 4096, 4)
    for causal in (True, False):
        _attention(f"flash_attention ({'causal' if causal else 'full'}, 4, "
                   f"8, 1024, 128)", 4, 8, 1024, 128, 4, causal)


if __name__ == "__main__":
    main()
