"""Where a local step of the federated fit spends its time, on one NVIDIA GPU.

    PYTHONPATH=src python tools/profile_fit.py [--steps 4] [--wire int8]

fedtime-llama2-7b at full width (32 layers, d_model 4096, bf16, NF4
attention weights, LoRA rank 8) with random weights and one synthetic ETTh1
client of 2 channels, batch 4 (8 series of 63 patch tokens): two warm local
steps, then ``--steps`` local steps (``core.client.local_update``) and one
upload through the wire (``dist.fedcomm.quantize_update``), with the
profiler off and then under ``torch.profiler`` (CPU and CUDA activities).
Prints the card's name and power limit, the wall time of a local step and of
an upload (host clock, ending in a synchronize), the summed device time of
the kernels a step ran, the device's busy share (device time / wall), the
kernel launches per step, and the top operators by device time.
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


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--wire", choices=("int8", "bf16"), default="int8")
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_fit: needs a CUDA device")

    from repro_torch.configs import get_config
    from repro_torch.core import fedtime
    from repro_torch.core.client import local_update
    from repro_torch.core.lora import (attach_lora, count_params, lora_tree,
                                       quantize_base)
    from repro_torch.data.federated import client_windows, partition_clients
    from repro_torch.data.timeseries import (DATASETS, generate,
                                             train_test_split)
    from repro_torch.dist import fedcomm

    card = _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("fedtime-llama2-7b")
    ft = cfg.fedtime
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    params = quantize_base(attach_lora(
        fedtime.init(cfg, gen, num_channels=2, device=dev), gen,
        rank=ft.lora_rank, alpha=ft.lora_alpha), qblock=ft.qlora_block)
    train, _ = train_test_split(generate(DATASETS["etth1"]))
    (x, y), = client_windows(partition_clients(train, 1, seed=0,
                                               channels_per_client=2),
                             ft.lookback, ft.horizon, max_windows=64)
    sel = np.random.default_rng(0).integers(0, len(x), (args.steps, 4))
    batches = {"x": torch.from_numpy(x[sel]).to(dev),
               "y": torch.from_numpy(y[sel]).to(dev)}
    adapters = lora_tree(params)

    def loss_fn(p, batch):
        return fedtime.loss(p, cfg, batch)

    def steps(n):
        ad, _ = local_update(loss_fn, params, adapters, batches, steps=n)
        return ad

    steps(2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ad = steps(args.steps)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / args.steps
    fedcomm.quantize_update(ad, None, wire=args.wire)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fedcomm.quantize_update(ad, None, wire=args.wire)
    torch.cuda.synchronize()
    upload = time.perf_counter() - t0
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        steps(args.steps)
        torch.cuda.synchronize()
    wall_prof = (time.perf_counter() - t0) / args.steps
    events = prof.key_averages()
    # kernels only: an operator's row repeats the device time of the
    # kernels it launched
    dev_us = sum(e.self_device_time_total for e in events
                 if e.device_type == DeviceType.CUDA) / args.steps
    launches = sum(e.count for e in events
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                "cudaLaunchKernelExC")) / args.steps
    print(f"[{card}] fedtime-llama2-7b local step, batch 4 x 2 channels "
          f"(8 series x 63 patches), {args.steps} steps: wall "
          f"{wall * 1e3:.1f} ms/step (profiler off; {wall_prof * 1e3:.1f} "
          f"with it), device {dev_us / 1e3:.1f} ms/step, busy share "
          f"{dev_us / 1e6 / wall:.3f}, kernel launches {launches:.0f}/step; "
          f"one {args.wire} upload of {count_params(ad)} "
          f"adapter elements {upload * 1e3:.2f} ms")
    print(events.table(sort_by="self_device_time_total",
                       row_limit=args.top, max_name_column_width=60))


if __name__ == "__main__":
    main()
