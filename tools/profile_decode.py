"""Where a decode step's time goes, on one NVIDIA GPU.

    PYTHONPATH=src python tools/profile_decode.py [--arch qwen3-0.6b] \
        [--steps 8] [--layout ring]

``--arch`` (a served config: qwen3-0.6b, fedtime-llama2-7b, zamba2-2.7b,
...) at full width with random weights: prefill 4 x 512, three warm decode
steps, then ``--steps`` decode steps under ``torch.profiler`` (CPU and CUDA
activities).  Prints the card's name and power limit, the wall time of a
step (host clock, ending in a synchronize), the summed device time of the
kernels it ran, the device's busy share (device time / wall), the kernel
launches per step, and the top operators by device time; then the same
for one more prefill of the 4 x 512 prompts (after the first, which warms
the card).  ``--layout paged`` runs the same steps through a paged pool
(16-slot blocks, every lane's blocks granted) instead of the contiguous
ring, for a family with one ring of one geometry a layer (dense, MoE).
"""

from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _profiled(fn, reps: int):
    """(wall a call with the profiler off, with it on, device us a call,
    kernel launches a call, the profile's operator table) over ``reps``
    calls of ``fn``, each run ending in a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    wall_plain = (time.perf_counter() - t0) / reps
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / reps
    events = prof.key_averages()
    # kernels only: an operator's row repeats the device time of the
    # kernels it launched
    dev_us = sum(e.self_device_time_total for e in events
                 if e.device_type == DeviceType.CUDA) / reps
    launches = sum(e.count for e in events
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                "cudaLaunchKernelExC")) / reps
    return wall_plain, wall, dev_us, launches, events


def main() -> None:
    ap = argparse.ArgumentParser()
    from repro_torch.configs import ALL_ARCHS
    ap.add_argument("--arch", choices=ALL_ARCHS, default="qwen3-0.6b")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--layout", choices=("ring", "paged"), default="ring")
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_decode: needs a CUDA device")

    from repro_torch.configs import get_config
    from repro_torch.models.registry import get_model

    card = _card()
    cfg = get_config(args.arch)
    api = get_model(cfg)
    dev = torch.device("cuda")
    params = api.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    B, P, bs = 4, 512, 16
    ring = P + 3 + args.steps
    ring = -(-ring // bs) * bs
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, P)),
                             device=dev)
    cache, logits = api.prefill(params, cfg, {"tokens": tokens},
                                cache_len=ring)
    extra = {}
    if args.layout == "paged":
        T = ring // bs
        table = torch.arange(B * T, dtype=torch.int32,
                             device=dev).reshape(B, T)
        cache = {n: leaf.reshape((leaf.shape[0], B * T, bs)
                                 + tuple(leaf.shape[3:])).contiguous()
                 for n, leaf in cache.items()}
        extra = {"block_tbl": table, "ring_len": ring}
    tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    pos = P

    def step():
        nonlocal tok, cache, pos
        p = (torch.full((B,), pos, dtype=torch.int32, device=dev)
             if extra else pos)
        lg, cache = api.decode_step(params, cfg, cache,
                                    {"token": tok, "pos": p, **extra})
        tok = lg[:, -1].argmax(-1).to(torch.int32)[:, None]
        pos += 1

    for _ in range(3):
        step()
    wall_plain, wall, dev_us, launches, events = _profiled(step, args.steps)
    print(f"[{card}] {cfg.name} decode B={B}, ring {ring} ({args.layout}), "
          f"{args.steps} steps: wall {wall_plain * 1e3:.2f} ms/step "
          f"(profiler off; {wall * 1e3:.2f} with it), device "
          f"{dev_us / 1e3:.3f} ms/step, busy share "
          f"{dev_us / 1e6 / wall_plain:.3f}, kernel launches "
          f"{launches:.0f}/step")
    print(events.table(sort_by="self_device_time_total",
                       row_limit=args.top, max_name_column_width=60))
    del cache

    def prefill():
        api.prefill(params, cfg, {"tokens": tokens}, cache_len=ring)

    wall_plain, wall, dev_us, launches, events = _profiled(prefill, 1)
    print(f"[{card}] {cfg.name} prefill {B} x {P}: wall "
          f"{wall_plain * 1e3:.2f} ms (profiler off; {wall * 1e3:.2f} with "
          f"it), device {dev_us / 1e3:.3f} ms, busy share "
          f"{dev_us / 1e6 / wall_plain:.3f}, kernel launches {launches:.0f}")
    print(events.table(sort_by="self_device_time_total",
                       row_limit=args.top, max_name_column_width=60))


if __name__ == "__main__":
    main()
