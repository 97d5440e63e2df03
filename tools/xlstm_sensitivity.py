"""How far xlstm-350m at random weights moves its logits for a rounding.

    PYTHONPATH=src python tools/xlstm_sensitivity.py [--device cuda]

At the published widths (24 blocks, d_model 1024), drawn from seed 0 in
f32 and in bf16, on one 640-token batch of 4 rows (numpy seed 3), prints
at positions 31, 127, 255 and 511 the largest logit gap between:

  * a chunked forward of the first 512 tokens and of all 640 (the same
    values, GEMMs of another M);
  * the first two rows run at batch 4 and at batch 2;
  * (f32) the 512-token forward and the same with its embeddings scaled by
    1 + 1e-6 N(0, 1).

It needs the card for the full widths (``--device cpu`` runs the smoke
config).  ``chip_smoke.py`` phase 12b holds prefill + decode against a
longer prefill in f32 for what this shows.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

POSITIONS = (31, 127, 255, 511)


def _logits(xm, params, cfg, toks):
    with torch.no_grad():
        return xm.logits_fn(params, cfg, xm.forward(params, cfg, toks,
                                                    remat=False)).float()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models import xlstm_model as xm
    from repro_torch.models.registry import get_model
    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device (--device cpu: smoke config)")
        torch.backends.cuda.matmul.allow_tf32 = False
        print(torch.cuda.get_device_name(0))
    base = (get_config if dev.type == "cuda" else get_smoke_config)(
        "xlstm-350m")
    for dt in ("float32", "bfloat16"):
        cfg = base.replace(param_dtype=dt, compute_dtype=dt)
        params = get_model(cfg).init(
            cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
        toks = torch.as_tensor(np.random.default_rng(3).integers(
            0, cfg.vocab_size, (4, 640)), device=dev)
        a = _logits(xm, params, cfg, toks[:, :512])
        longer = _logits(xm, params, cfg, toks)[:, :512]
        half = _logits(xm, params, cfg, toks[:2, :512])
        if dt == "float32":
            real = xm.embed_tokens

            def noisy(p, c, t):
                x = real(p, c, t)
                g = torch.Generator(device=dev).manual_seed(1)
                return x * (1 + 1e-6 * torch.randn(x.shape, generator=g,
                                                   device=dev))
            xm.embed_tokens = noisy
            try:
                perturbed = _logits(xm, params, cfg, toks[:, :512])
            finally:
                xm.embed_tokens = real
        for pos in POSITIONS:
            line = (f"{cfg.name} {dt} position {pos}: 512 vs 640 tokens "
                    f"{float((a[:, pos] - longer[:, pos]).abs().max()):.4g}"
                    f", batch 4 vs 2 "
                    f"{float((a[:2, pos] - half[:, pos]).abs().max()):.4g}")
            if dt == "float32":
                line += (", embeddings x (1 + 1e-6 N) "
                         f"{float((a[:, pos] - perturbed[:, pos]).abs().max()):.4g}")
            print(line + f"; largest |logit| {float(a[:, pos].abs().max()):.3g}")
        del params
        if dev.type == "cuda":
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
