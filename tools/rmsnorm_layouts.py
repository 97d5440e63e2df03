"""Time the rmsnorm kernel's layouts on the card, at the shapes
``chip_smoke.py`` phase 2b drives it at, beside ``F.rms_norm`` and the
layout ``rmsnorm_layout`` picks.

    PYTHONPATH=src python tools/rmsnorm_layouts.py [--top 8]

For each shape it times every layout the kernel takes (threads a row in a
block, rows a block, blocks a row in a cluster; chunks a thread the fewest
that cover the row) with ``chip_smoke.Timer`` (CUDA-graph replay between
CUDA events, L2 flushed), holds each output to the plain version, and
prints the fastest ``--top`` layouts with the picked one and the timer's
floor (a one-element ``fill_``).  Runs on the card only.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [("fit", (504, 4096), torch.bfloat16),
          ("benchmark --full", (64, 4096), torch.float32),
          ("ragged", (4, 37, 512), torch.float32)]


def layouts(rows: int, d: int, itemsize: int):
    """Every layout the kernel takes for this shape, chunks a thread the
    fewest that cover a row."""
    from repro_torch.kernels.rmsnorm import Layout, _MAX_THREADS, _MAX_NV
    chunks = -(-d * itemsize // 16)
    out = []
    for tpr in (32, 64, 128, 256, 512):
        for cl in (1, 2, 4):
            nv = 1
            while nv * tpr * cl < chunks:
                nv *= 2
            if nv > _MAX_NV:
                continue
            rpb = 1
            while tpr * rpb <= _MAX_THREADS:
                if rpb <= rows:
                    out.append(Layout(tpr, rpb, cl, nv))
                rpb *= 2
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--top", type=int, default=8)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("rmsnorm_layouts: needs the card")
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    from chip_smoke import Timer, _card
    from repro_torch.kernels import rmsnorm as rn
    card = _card()
    timer = Timer()
    one = torch.empty(1, device="cuda")
    print(f"[{card}] timer floor (one-element fill_): "
          f"{timer.ms(lambda: one.fill_(1.0), 50):.4f} ms")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    g = torch.Generator(device="cuda").manual_seed(7)
    for label, shape, dtype in SHAPES:
        x = torch.randn(shape, generator=g, device="cuda").to(dtype)
        s = torch.randn(shape[-1], generator=g, device="cuda").to(dtype)
        want = rn.rmsnorm_ref(x, s).float()
        rows, d = x.numel() // shape[-1], shape[-1]
        picked = rn.rmsnorm_layout(rows, d, x.element_size(), sms)
        times = []
        for lay in layouts(rows, d, x.element_size()):
            launch, y = rn.rmsnorm_launcher(x, s, layout=lay)
            launch()
            torch.cuda.synchronize()
            err = float((y.float() - want).abs().max())
            lim = 2e-5 + (2.0 ** -7 if dtype == torch.bfloat16 else 0.0) * \
                float(want.abs().max())
            if err > lim:
                raise SystemExit(f"rmsnorm_layouts: {label} {lay}: "
                                 f"max_abs_err {err} over {lim}")
            times.append((timer.ms(launch, 30), lay))
        w = s.to(dtype)
        lib = timer.ms(lambda: torch.nn.functional.rms_norm(
            x, (d,), weight=w, eps=1e-6), 30)
        times.sort()
        print(f"[{card}] rmsnorm {label} {tuple(shape)} {dtype}: "
              f"F.rms_norm {lib:.4f} ms, {len(times)} layouts; picked "
              f"{tuple(picked)}: "
              + next(f"{t:.4f} ms" for t, l in times if l == picked))
        for t, lay in times[:args.top]:
            print(f"  {t:.4f} ms  tpr {lay.tpr} rpb {lay.rpb} cl {lay.cl} "
                  f"nv {lay.nv}  ({-(-rows // lay.rpb) * lay.cl} blocks)")


if __name__ == "__main__":
    main()
