"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its numbers beside the card's name and power limit:

  1. build the CUDA kernels from src/repro_torch/csrc (one nvcc per source,
     all at once) and print ptxas's register / spill report;
  2. hold every kernel against its plain PyTorch version:
     - flash-decode and the block copy at qwen3-0.6b's widths (Hk=8, G=2,
       D=128): at the main path's own call shapes (the fixed batch's 4 x
       576-slot ring; the engine's 12 lanes over its 96-block pool of 16
       slots, with idle lanes, shared blocks and -1 table entries; the CoW
       block copy on the pool's 28-layer K and kv_pos leaves), and at
       longer caches (B=4, S in {1024, 4096}, bf16 and int8, ring and
       paged);
     - the wire hop, int8 and bf16, full and quantize-only, at the fit's
       upload size (8,388,608 adapter elements in rows of 128) and at a
       ragged 1001 rows, equal bit for bit;
     with the wrapper's time, the kernel's alone, the plain version's, the
     least time the card could take (bound) and one library call's time as
     a yardstick where one exists; for each flash-decode case its grid
     (splits, blocks, cluster size) and the device operations one wrapper
     call makes (``torch.profiler``; a ring call must be exactly one);
  2b. drive ``repro_torch.kernels.ops``' qlora_matmul, rmsnorm and
     flash_attention, which no model path calls (as in the reference), at
     the shapes fedtime-llama2-7b's local step would give them (bf16, 8
     series x 63 patch tokens, d_model 4096, 32 heads of 128, LoRA rank 8,
     NF4 qblock 64), at the reference benchmark's --full shapes (f32) and
     at one ragged shape each; the launch counts set to 0 before and read
     after; each output held against the plain version beside a planted
     fault's reading, and timed as in phase 2 (the library yardsticks:
     ``F.rms_norm``, ``scaled_dot_product_attention``, the port's dense
     path);
  3. serve qwen3-0.6b at full width with random weights: the fixed-batch
     launcher (prefill 4x512, 64 decode steps over the contiguous ring),
  4. then the continuous-batching engine (paged pool, prefix sharing, a
     12-request trace with a shared-prefix cluster), checking that every
     request finishes, all logits are finite, copy-on-write fired, and that
     phases 3-4 launched every serving kernel (launch counters set to 0
     before phase 3, read after phase 4); a few of the main path's own
     flash-decode calls are copied as they run and held against the plain
     version afterwards;
  5. fit fedtime-llama2-7b at full width (32 layers, d_model 4096, bf16,
     NF4 base, LoRA rank 8; the schedule cut to 8 clients, 2 clusters, 2
     clients a round, 2 local steps, 2 rounds, batch 4) with
     ``federated_fit``, once on the int8 wire and once on bf16, and score it
     with ``evaluate_forecaster``: each run's hop kernel launched (its count
     set to 0 before the run, read after), losses and metrics finite, the
     bytes up equal to the wire's price times the uploads, peak device
     memory printed, and the run's first hop calls held against the plain
     version;
  6. check the model path on the card against the plain path on the CPU at
     the smoke configs in f32: qwen3-0.6b prefill + teacher-forced decode
     (ring and paged), and a 2-round fit on the int8 wire.

Any failed check raises, so the script exits non-zero and prints no result.
The last three lines are the kernels' JSON summary, the card's name and
power limit, and {"ok": true, "device": {...}}.  Without a CUDA device, or
without the repository beside it, it fails.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
F32_FLOPS = 67e12                # f32 outside the tensor cores
BF16_FLOPS = 989e12              # bf16 products on the tensor cores
# Flash-decode, kernel vs plain version on the same inputs: the f32 output
# before its cast (acc / l) differs only by the order of the sums; each
# reading is printed beside that of a planted fault (one KV tile of one row
# dropped from the plain version), which the limit must separate.  The bf16
# outputs are each the f32 output rounded by at most half a bf16 step (2**-8
# of the rounded value), so they may differ by that rounding on both sides
# plus the f32 difference: |got - want| <= 2**-8 (|got| + |want|) +
# TOL_F32_OUT.
TOL_F32_OUT = 1e-5
BF16_HALF_STEP = 2.0 ** -8
TOL_F32_MODEL = 1e-3             # f32 logits, card vs CPU (sum order)
# f32 smoke fit, card vs CPU: round losses, relative.  The losses are means
# of local losses whose adapters differ by f32 sum order (and, through it,
# by at most one int8 wire step in an element of an upload).
TOL_FIT_LOSS = 1e-4

# The federated fit (phase 5): fedtime-llama2-7b at full width; the schedule
# is cut from the config's 555 clients, 8 clusters, 16 clients a round and 40
# local steps to fit the run's time limit.  Widths and depth are not cut.
FIT_SCHEDULE = dict(num_clients=8, num_clusters=2, clients_per_round=2,
                    local_steps=2)
FIT = dict(rounds=2, batch_size=4)
FIT_CHANNELS = 2                 # channels per client
HOP_QBLOCK = 128                 # REPRO_FED_QBLOCK's default
HOP_ELEMS = 32 * 4 * (4096 * 8 + 8 * 4096)   # the LoRA payload: 8,388,608

# The main path's geometry (phases 3-4), which phase 2 also runs.
FIXED = dict(batch=4, prompt_len=512, gen=64)         # ring of 576 slots
ENGINE = dict(slots=12, cache_len=128, block_size=16)  # 96-block pool
ENGINE_POOL_BLOCKS = (ENGINE["slots"] * ENGINE["cache_len"]
                      // ENGINE["block_size"])


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

class Timer:
    """Mean device time of one call.  The call is captured once in a CUDA
    graph and the graph replayed between two CUDA events, so the events
    bracket the call's device work and not the host's Python between its
    launches; the 50 MB L2 is flushed before every replay (the main path
    finds the cache cold: a decode step streams every layer's cache once).
    """

    def __init__(self):
        self.flush = torch.empty(64 * 2 ** 20, dtype=torch.float32,
                                 device="cuda")
        # one side stream for every warm-up: cuBLAS keeps a workspace for
        # each stream it has run on, which a new stream per call would pile up
        self.side = torch.cuda.Stream()

    def ms(self, fn, iters: int) -> float:
        side = self.side
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(2):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn()
        torch.cuda.synchronize()
        evs = [(torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
        for start, end in evs:
            self.flush.zero_()
            start.record()
            graph.replay()
            end.record()
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in evs) / iters


def _bound_ms(nbytes: float, flops: float, rate: float = F32_FLOPS) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def _quant(x):
    amax = x.abs().amax(-1, keepdim=True)
    scale = (torch.clamp(amax, min=1e-6) / 127.0).to(torch.bfloat16)
    q = torch.clamp(torch.round(x / scale.float()), -127, 127)
    return q.to(torch.int8), scale


def _decode_case(rows, S: int, int8: bool, paged: bool, *, n_blocks=0,
                 Hk=8, G=2, D=128, bs=16, seed=0):
    """Inputs of one decode call at qwen3-0.6b's widths: one row per entry
    of ``rows`` (its position; -1 is an idle lane, which must come out 0).
    The ring holds positions 0..q_pos of each row.  The paged pool
    (``n_blocks`` blocks of ``bs``) shares its first two blocks between all
    active rows, and leaves the table entries past each row's position,
    and every entry of an idle lane, ungranted (-1)."""
    dev = "cuda"
    B = len(rows)
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, 1, Hk * G, D), generator=g, device=dev)
    q_pos = torch.tensor(rows, dtype=torch.int32, device=dev)
    if paged:
        T = S // bs
        n_blocks = n_blocks or B * T + 8
        perm = torch.randperm(n_blocks, generator=g, device=dev).tolist()
        tbl = np.full((B, T), -1, np.int32)
        kv_pos = np.full((n_blocks, bs), -1, np.int32)
        nxt = 2
        for b, qp in enumerate(rows):
            for j in range(qp // bs + 1 if qp >= 0 else 0):
                if j < 2:
                    tbl[b, j] = perm[j]            # shared prefix blocks
                else:
                    tbl[b, j] = perm[nxt]
                    nxt += 1
                ar = np.arange(j * bs, (j + 1) * bs)
                kv_pos[tbl[b, j]] = np.where(ar <= qp, ar, -1)
        kv_shape = (n_blocks, bs, Hk, D)
        kv_pos = torch.from_numpy(kv_pos).to(dev)
        tbl = torch.from_numpy(tbl).to(dev)
    else:
        kv_shape = (B, S, Hk, D)
        ar = torch.arange(S, device=dev, dtype=torch.int32)
        kv_pos = torch.where(ar[None] <= q_pos[:, None], ar[None],
                             torch.full_like(ar[None], -1)).contiguous()
        tbl = None
    k = torch.randn(kv_shape, generator=g, device=dev)
    v = torch.randn(kv_shape, generator=g, device=dev)
    kw = {}
    if int8:
        k, ks = _quant(k)
        v, vs = _quant(v)
        kw = {"k_scale": ks, "v_scale": vs}
    else:
        k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
    q = q.to(torch.bfloat16)
    if tbl is not None:
        kw["block_tables"] = tbl
    return (q, k, v, kv_pos, q_pos), kw


def _needed_slots(args, kw):
    """Physical slots some row's mask keeps: the data-dependent part of the
    work (each such K/V row is read once at the least)."""
    from repro_torch.kernels import flash_decode as fd
    q, k, v, kv_pos, q_pos = args
    B = q.shape[0]
    tbl = kw.get("block_tables")
    if tbl is None:
        keep = fd._slot_mask(kv_pos, q_pos[:, None], 0, kind="causal",
                             window=0)
        return int(keep.sum())
    bs = k.shape[1]
    T = tbl.shape[1]
    _, _, gpos, _, _ = fd.paged_gather(k, v, kv_pos, None, None, tbl)
    keep = fd._slot_mask(gpos, q_pos[:, None], 0, kind="causal", window=0)
    phys = (tbl.clamp(min=0).long()[:, :, None] * bs
            + torch.arange(bs, device=tbl.device)).reshape(B, T * bs)
    return int(torch.unique(phys[keep]).numel())


def _sdpa_inputs(args, kw):
    """The library yardstick's inputs: the gathered, dequantized cache in
    bf16 and a boolean mask, laid out for scaled_dot_product_attention."""
    from repro_torch.kernels import flash_decode as fd
    q, k, v, kv_pos, q_pos = args
    ks, vs = kw.get("k_scale"), kw.get("v_scale")
    if kw.get("block_tables") is not None:
        k, v, kv_pos, ks, vs = fd.paged_gather(k, v, kv_pos, ks, vs,
                                               kw["block_tables"])
    if ks is not None:
        k = (k.float() * ks.float()).to(torch.bfloat16)
        v = (v.float() * vs.float()).to(torch.bfloat16)
    mask = fd._slot_mask(kv_pos, q_pos[:, None], 0, kind="causal", window=0)
    return (q.transpose(1, 2), k.transpose(1, 2).contiguous(),
            v.transpose(1, 2).contiguous(), mask[:, None, None, :])


def _f32_outs(args, kw):
    """The f32 outputs before the cast, (B, Hk, G, D): the kernel's (a
    comparison launch, not counted) and the plain version's.  The ring
    kernel's are its own merged sums (``return_partials``); the paged
    kernel's per-split partials are combined as its wrapper does."""
    from repro_torch.kernels import flash_decode as fd
    if kw.get("block_tables") is None:
        launch, (m, l, acc) = fd.flash_decode_launcher(
            *args, return_partials=True, **kw)
        launch()
        got = acc / torch.clamp(l, min=1e-30)
    else:
        launch, (m, l, acc) = fd.flash_decode_launcher(*args, **kw)
        launch()
        got = fd._combine(m[..., None], l[..., None], acc, axis=2)
    m, l, acc = fd.flash_decode_ref(*args, return_partials=True, **kw)
    return got, acc / torch.clamp(l, min=1e-30)


def _device_ops_per_call(fn, calls: int = 4) -> float:
    """Kernels (and copies or fills) one call of ``fn`` puts on the device,
    counted by ``torch.profiler`` over ``calls`` calls after a warm one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / calls


def _hold_to_plain(label: str, args, kw, got=None) -> float:
    """Hold one flash-decode call against the plain version on the same
    inputs: the f32 output within TOL_F32_OUT, the output (``got``, or a
    new call) within what bf16 rounding allows, idle lanes exactly 0, and a
    planted fault (the plain version with one KV tile of row 0 dropped)
    outside TOL_F32_OUT.  Returns the f32 reading."""
    from repro_torch.kernels import flash_decode as fd
    if got is None:
        got = fd.flash_decode_cuda(*args, **kw)
    want = fd.flash_decode_ref(*args, **kw)
    k32, r32 = _f32_outs(args, kw)
    err = float((k32 - r32).abs().max())
    g, w = got.float(), want.float()
    over = float(((g - w).abs() - BF16_HALF_STEP * (g.abs() + w.abs())
                  - TOL_F32_OUT).max())
    q_pos = fd._rows(args[4], args[0].shape[0], args[0].device)
    kv_pos, tbl = args[3].clone(), kw.get("block_tables")
    active = (q_pos >= 0).nonzero().flatten().tolist()
    b0 = active[0]
    if tbl is None:                           # the first 128-slot tile of b0
        kv_pos[b0, :128] = -1
    else:                                     # its last granted block
        kv_pos[int(tbl[b0, int(q_pos[b0]) // args[1].shape[1]])] = -1
    _, planted32 = _f32_outs(args[:3] + (kv_pos, q_pos), kw)
    planted = float((k32 - planted32).abs().max())
    idle = [b for b in range(len(q_pos)) if b not in active]
    _check(bool(torch.isfinite(got).all()), f"{label}: non-finite output")
    _check(err <= TOL_F32_OUT, f"{label}: f32 output max err {err} > "
           f"{TOL_F32_OUT}")
    _check(over <= 0.0, f"{label}: bf16 output off by more than its "
           f"rounding allows ({over} over)")
    _check(not idle or torch.count_nonzero(got[idle]) == 0,
           f"{label}: idle lane not exactly 0")
    _check(planted > TOL_F32_OUT, f"{label}: a dropped tile reads {planted}, "
           f"inside the tolerance {TOL_F32_OUT}")
    print(f"  {label}: f32 max_abs_err {err:.3g} (tol {TOL_F32_OUT}; one "
          f"tile dropped reads {planted:.3g}), bf16 max_abs_err "
          f"{float((g - w).abs().max()):.3g} (within rounding), "
          f"{len(idle)} idle lanes exactly 0")
    return err


def phase_kernels(card: str, timer: Timer) -> dict:
    """Every kernel against its plain version at the main path's own call
    shapes (the fixed batch's ring and the engine's pool, bf16, the rows the
    JSON line keeps) and at longer caches (S = 1024, 4096; bf16 and int8)."""
    from repro_torch.kernels import flash_decode as fd
    F = torch.nn.functional
    P, gen = FIXED["prompt_len"], FIXED["gen"]
    S_eng = ENGINE["cache_len"]
    engine_rows = [S_eng - 1, 100, -1, 64, 17, -1, 90, 40, 3, -1, 111, 56]
    cases = [("main path: fixed batch ring", [P + gen - 1] * FIXED["batch"],
              P + gen, False, False, 0),
             ("main path: engine pool", engine_rows, S_eng, False, True,
              ENGINE_POOL_BLOCKS)]
    for S in (1024, 4096):
        rows4 = [S - 1, S - 100, 3 * S // 4, S // 2 + 5]
        for int8 in (False, True):
            for paged in (False, True):
                cases.append((f"S={S} {'int8' if int8 else 'bf16'}", rows4,
                              S, int8, paged, 0))
    rows = {}
    for label, q_rows, S, int8, paged, n_blocks in cases:
        name = "flash_decode_paged" if paged else "flash_decode"
        args, kw = _decode_case(q_rows, S, int8, paged, n_blocks=n_blocks)
        err = _hold_to_plain(f"{name} {label}", args, kw)
        q, k, v = args[:3]
        B, _, H, D = q.shape
        Hk = k.shape[2]
        slots = _needed_slots(args, kw)
        row_bytes = Hk * D * k.element_size() * 2
        if int8:
            row_bytes += Hk * 2 * 2          # bf16 scales
        tbl = kw.get("block_tables")
        meta = (args[3].numel() * 4 +
                (tbl.numel() * 4 if tbl is not None else 0))
        nbytes = (q.numel() * 2 + slots * row_bytes + meta + B * H * D * 2)
        flops = 4 * (H // Hk) * D * Hk * slots
        bound, by = _bound_ms(nbytes, flops)
        launch, _ = fd.flash_decode_launcher(*args, **kw)
        per_call = _device_ops_per_call(
            lambda: fd.flash_decode_cuda(*args, **kw))
        grid = launch.grid
        resident = (f" ({grid['resident_clusters']} such clusters fit the "
                    f"card at once)" if not paged else "")
        print(f"  {name} {label}: grid {grid['splits']} splits x {Hk} "
              f"heads x {B} rows = {grid['blocks']} blocks, cluster "
              f"{grid['cluster']}{resident}; the wrapper puts {per_call:g} "
              f"kernels (and copies or fills) on the device a call")
        if not paged:
            _check(per_call == 1, f"{name} {label}: the ring wrapper ran "
                   f"{per_call} device operations a call, not 1")
        ms = timer.ms(lambda: fd.flash_decode_cuda(*args, **kw), 50)
        kernel_ms = timer.ms(launch, 50)
        plain = timer.ms(lambda: fd.flash_decode_ref(*args, **kw), 5)
        sq, sk, sv, smask = _sdpa_inputs(args, kw)
        lib = timer.ms(lambda: F.scaled_dot_product_attention(
            sq, sk, sv, attn_mask=smask, enable_gqa=True), 50)
        print(f"[{card}] kernel {name} {label} (B={B}, S={S}): wrapper "
              f"{ms:.4f} ms, kernel alone {kernel_ms:.4f} ms, plain "
              f"{plain:.4f} ms, bound {bound:.4f} ms ({by}, "
              f"{nbytes / 1e6:.2f} MB), sdpa {lib:.4f} ms")
        if label.startswith("main path"):        # the rows the JSON keeps
            rows[name] = dict(max_abs_err=err, ms=ms, kernel_ms=kernel_ms,
                              plain_ms=plain, bound_ms=bound, bound_by=by,
                              library_ms=lib, shape=label)
    g = torch.Generator(device="cuda").manual_seed(1)
    n_blocks = ENGINE_POOL_BLOCKS                  # the engine's pool leaves
    for leaf_name, shape, dtype in (
            ("k", (28, n_blocks, 16, 8, 128), torch.bfloat16),
            ("kv_pos", (28, n_blocks, 16), torch.int32)):
        base = torch.randint(-1000, 1000, shape, generator=g, device="cuda")
        leaf = base.to(dtype)
        want = leaf.clone()
        fd.paged_block_copy_ref(want, 5, 40)
        fd.paged_block_copy_cuda(leaf, 5, 40)
        torch.cuda.synchronize()
        _check(torch.equal(leaf, want), f"block copy {leaf_name} not exact")
        nbytes = 2 * shape[0] * leaf[0, 0].numel() * leaf.element_size()
        bound, by = _bound_ms(nbytes, 0.0)
        ms = timer.ms(lambda: fd.paged_block_copy_cuda(leaf, 5, 40), 50)
        plain = timer.ms(lambda: fd.paged_block_copy_ref(leaf, 5, 40), 50)
        lib = timer.ms(lambda: leaf[:, 40].copy_(leaf[:, 5]), 50)
        print(f"[{card}] kernel paged_block_copy {leaf_name} "
              f"{tuple(shape)} {str(dtype)[6:]}: max_abs_err 0 (exact), "
              f"kernel {ms:.4f} ms, plain {plain:.4f} ms, bound {bound:.4f} "
              f"ms ({by}, {nbytes / 1e6:.2f} MB), copy_ {lib:.4f} ms")
        if leaf_name == "k":               # the wrapper runs only the kernel
            rows["paged_block_copy"] = dict(
                max_abs_err=0.0, ms=ms, kernel_ms=ms, plain_ms=plain,
                bound_ms=bound, bound_by=by, library_ms=lib,
                shape=f"engine pool leaf {tuple(shape)}")
    return rows


def _hop_case(rows: int, wire: str, full: bool, seed: int = 0):
    """Inputs of one hop at the adapter delta's scale: ``rows`` rows of
    HOP_QBLOCK values with an all-zero row (the 1e-30 scale floor) and a
    row whose scale is 1 (ties at x.5).  ``full``: codes (and scales)
    received; else the quantize-only form that every upload runs."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    n, Q = rows * HOP_QBLOCK, HOP_QBLOCK
    acc = torch.randn(n, generator=g, device="cuda") * 1e-2
    res = torch.randn(n, generator=g, device="cuda") * 1e-5
    acc[:Q] = 0.0
    res[:2 * Q] = 0.0
    acc[Q:2 * Q] = torch.arange(Q, device="cuda") - Q / 2 + 0.5
    acc[Q] = 127.0
    codes = scales = None
    if full and wire == "int8":
        codes = torch.randint(-127, 128, (n,), generator=g, device="cuda",
                              dtype=torch.int8)
        scales = torch.rand(rows, generator=g, device="cuda") * 1e-3
    elif full:
        codes = (torch.randn(n, generator=g, device="cuda") * 1e-2).to(
            torch.bfloat16)
    return acc, codes, scales, res


def _hop_bytes(args, wire: str) -> int:
    """Each input read once and each output written once: acc, res (f32),
    received codes and scales where given; acc, res, codes and (int8) one
    scale per row out."""
    acc, codes, scales, res = args
    code_bytes = 1 if wire == "int8" else 2
    rows = acc.numel() // HOP_QBLOCK
    out = acc.numel() * (8 + code_bytes) + (4 * rows if wire == "int8"
                                            else 0)
    inp = sum(t.numel() * t.element_size()
              for t in (acc, codes, scales, res) if t is not None)
    return inp + out


def _hold_hop(label: str, args, wire: str, got=None) -> float:
    """The hop kernel (``got``, or a new call) against its plain version on
    the same inputs: every output equal bit for bit.  Returns the largest
    difference as a number (0)."""
    from repro_torch.kernels import wire_hop as wh
    if got is None:
        got = wh.fused_hop_cuda(*args, wire=wire, qblock=HOP_QBLOCK)
    want = wh.fused_hop_ref(*args, wire=wire, qblock=HOP_QBLOCK)
    torch.cuda.synchronize()
    err = 0.0
    for name, a, b in zip(("acc", "codes", "scales", "res"), got, want):
        _check((a is None) == (b is None), f"{label}: {name} missing")
        if a is None:
            continue
        _check(a.dtype == b.dtype and a.shape == b.shape,
               f"{label}: {name} dtype/shape")
        _check(torch.equal(a.view(torch.uint8), b.view(torch.uint8)),
               f"{label}: {name} not equal bit for bit")
        err = max(err, float((a.float() - b.float()).abs().max()))
    print(f"  {label}: acc, codes, scales, residual equal bit for bit")
    return err


def phase_hop_kernels(card: str, timer: Timer) -> dict:
    """The wire-hop kernel against its plain version, both wires and both
    forms, at the main path's size (HOP_ELEMS, qblock 128) and at a ragged
    row count; timed at the main path's size.  The JSON keeps the
    quantize-only form, the one every upload runs."""
    from repro_torch.kernels import wire_hop as wh
    rows_main = HOP_ELEMS // HOP_QBLOCK
    rows = {}
    for wire in ("int8", "bf16"):
        for full in (False, True):
            form = "full" if full else "quantize-only"
            ragged = _hop_case(1001, wire, full, seed=1)
            _hold_hop(f"wire_hop_{wire} {form} 1001 x {HOP_QBLOCK}",
                      ragged, wire)
            args = _hop_case(rows_main, wire, full)
            err = _hold_hop(f"wire_hop_{wire} {form} {rows_main} x "
                            f"{HOP_QBLOCK}", args, wire)
            nbytes = _hop_bytes(args, wire)
            # f32 operations per element: the adds, abs, max, quotient,
            # rint, clamp, product and difference of the int8 wire; the
            # adds, two casts and the difference of bf16
            ops = (11 if full else 10) if wire == "int8" else 5
            bound, by = _bound_ms(nbytes, ops * HOP_ELEMS)
            kw = dict(wire=wire, qblock=HOP_QBLOCK)
            ms = timer.ms(lambda: wh.fused_hop_cuda(*args, **kw), 50)
            launch, _ = wh.wire_hop_launcher(*args, **kw)
            kernel_ms = timer.ms(launch, 50)
            plain = timer.ms(lambda: wh.fused_hop_ref(*args, **kw), 10)
            print(f"[{card}] kernel wire_hop_{wire} {form} ({HOP_ELEMS} "
                  f"elements, qblock {HOP_QBLOCK}): wrapper {ms:.4f} ms, "
                  f"kernel alone {kernel_ms:.4f} ms, plain {plain:.4f} ms, "
                  f"bound {bound:.4f} ms ({by}, {nbytes / 1e6:.2f} MB), "
                  f"library none")
            if not full:
                rows[f"wire_hop_{wire}"] = dict(
                    max_abs_err=err, ms=ms, kernel_ms=kernel_ms,
                    plain_ms=plain, bound_ms=bound, bound_by=by,
                    library_ms=None,
                    shape=f"quantize-only, {HOP_ELEMS} elements")
            del args
    return rows


# ---------------------------------------------------------------------------
# phase 2b: the kernels.ops entries qlora_matmul, rmsnorm, flash_attention
# ---------------------------------------------------------------------------

def _ops_cases(cfg):
    """(kernel, label, make) for each call of the ops phase: the shapes
    fedtime-llama2-7b's local step would give each kernel (bf16, 8 series x
    63 patch tokens), the reference benchmark's --full shapes (f32) and one
    ragged shape.  ``make(gen)`` draws the call's arguments on the card."""
    from repro_torch.core.patching import num_patches
    ft = cfg.fedtime
    S = num_patches(ft.lookback, ft.patch_len, ft.patch_stride)
    series = FIT["batch_size"] * FIT_CHANNELS
    M = series * S
    d, H, Dh = cfg.d_model, cfg.num_heads, cfg.head_dim
    s = ft.lora_alpha / ft.lora_rank
    bf16, f32 = torch.bfloat16, torch.float32

    def qlora(M, K, N, r, qb, dtype):
        def make(g):
            from repro_torch.core.quant import nf4_quantize
            w = torch.randn((K, N), generator=g, device="cuda") * 0.02
            wq, am = nf4_quantize(w, qb)
            x = torch.randn((M, K), generator=g, device="cuda").to(dtype)
            a = torch.randn((K, r), generator=g, device="cuda") * 0.1
            b = torch.randn((r, N), generator=g, device="cuda") * 0.1
            return (x, wq, am.reshape(K, N // qb), a, b, s)
        return make

    def norm(shape, dtype):
        return lambda g: (
            torch.randn(shape, generator=g, device="cuda").to(dtype),
            torch.randn(shape[-1], generator=g, device="cuda").to(dtype))

    def attn(shape, dtype, causal):
        return lambda g: tuple(
            torch.randn(shape, generator=g, device="cuda").to(dtype)
            for _ in range(3)) + (causal,)

    return [
        ("qlora_matmul", f"fit wq (M {M}, K = N {d}, r {ft.lora_rank}, "
         f"qblock {ft.qlora_block}, bf16)",
         qlora(M, d, d, ft.lora_rank, ft.qlora_block, bf16)),
        ("qlora_matmul", "benchmark --full (512, 1024, 1024, r 8, f32)",
         qlora(512, 1024, 1024, 8, 64, f32)),
        ("qlora_matmul", "ragged (37, 200, 192, r 8, f32)",
         qlora(37, 200, 192, 8, 64, f32)),
        ("rmsnorm", f"fit ({M}, {d}) bf16", norm((M, d), bf16)),
        ("rmsnorm", "benchmark --full (64, 4096) f32", norm((64, 4096), f32)),
        ("rmsnorm", "ragged (4, 37, 512) f32", norm((4, 37, 512), f32)),
        ("flash_attention", f"fit causal ({series}, {H}, {S}, {Dh}) bf16",
         attn((series, H, S, Dh), bf16, True)),
        ("flash_attention", "benchmark --full causal (4, 8, 1024, 128) f32",
         attn((4, 8, 1024, 128), f32, True)),
        ("flash_attention", "benchmark --full full (4, 8, 1024, 128) f32",
         attn((4, 8, 1024, 128), f32, False)),
        ("flash_attention", "ragged causal (2, 4, 100, 128) f32",
         attn((2, 4, 100, 128), f32, True)),
    ]


def _ops_call(name, args):
    """The ops entry with the reference's signature."""
    from repro_torch.kernels import ops
    if name == "flash_attention":
        return ops.flash_attention(*args[:3], causal=args[3])
    return getattr(ops, name)(*args)


def _attention_plain(q, k, v, keep):
    """The plain attention's f32 arithmetic with an explicit (S, S) keep
    mask, for the planted faults."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * (
        q.shape[-1] ** -0.5)
    s = s.masked_fill(~keep, torch.finfo(torch.float32).min)
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, -1), v.float())


def _ops_plain(name, args):
    """(the plain version's output that the kernel is held to, the limit
    (atol, rtol), its reason, [(a planted fault, its output)]).

    In bf16, qlora and rmsnorm round once, at the end, on both sides: one
    bf16 step (a relative 2**-7) over the f32 limit.  The plain attention
    casts p to bf16 and the kernel does not, so a bf16 attention output is
    held to the plain version run on the same inputs in f32, within its own
    rounding: half a step (2**-8)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import qlora_matmul as qm
    from repro_torch.kernels import rmsnorm as rn
    bf16 = args[0].dtype == torch.bfloat16
    if name == "qlora_matmul":
        x, wq, am, a, b, s = args
        flipped = wq.clone()
        flipped[wq.shape[0] // 2, 0] ^= 0x80        # one nibble flipped
        tol, why = 1e-4, "f32 sums in another order (the reference's 1e-4)"
        planted = [("one flipped nibble", qm.qlora_matmul_ref(
                        x, flipped, am, a, b, s)),
                   ("the LoRA term dropped", qm.qlora_matmul_ref(
                        x, wq, am, a, b, 0.0))]
        want = qm.qlora_matmul_ref(*args)
    elif name == "rmsnorm":
        x, scale = args
        tol, why = 2e-5, "f32 sum of squares in another order (2e-5)"
        want = rn.rmsnorm_ref(x, scale)
        unscaled = want.clone()                     # a missed ragged tail
        unscaled[..., -1] = rn.rmsnorm_ref(
            x, torch.ones_like(scale))[..., -1]
        planted = [("the last value left unscaled", unscaled)]
    else:
        q, k, v, causal = args
        S = q.shape[2]
        tol, why = 2e-5, "f32 sums and exp in another order (2e-5)"
        want = fa.flash_attention_ref(q.float(), k.float(), v.float(), causal)
        keep = torch.ones((S, S), dtype=torch.bool, device=q.device)
        if causal:
            fault = "one key too many under the causal mask"
            keep = keep.tril(diagonal=1)
        else:
            fault = "the last key dropped"
            keep[:, -1] = False
        planted = [(fault, _attention_plain(q, k, v, keep))]
    rel = (2.0 ** -8 if name == "flash_attention" else 2.0 ** -7) if bf16 \
        else 0.0
    return want, (tol, tol + rel), why, planted


def _over(got, want, atol, rtol) -> float:
    """max(|got - want| - (atol + rtol |want|)): <= 0 within the limit."""
    g, w = got.float(), want.float()
    return float(((g - w).abs() - atol - rtol * w.abs()).max())


def _ops_bound(name, args, out):
    """(bound ms, bound by, MB moved) of one call: each input read once and
    the output written once; operations at the rate for the inputs' type
    (bf16 products on the tensor cores, f32 on the CUDA cores)."""
    rate = BF16_FLOPS if args[0].dtype == torch.bfloat16 else F32_FLOPS
    tensors = [t for t in args if isinstance(t, torch.Tensor)]
    nbytes = (sum(t.numel() * t.element_size() for t in tensors)
              + out.numel() * out.element_size())
    if name == "qlora_matmul":
        (M, K), r, N = args[0].shape, args[3].shape[1], out.shape[1]
        flops = 2 * M * K * N + 2 * M * K * r + 2 * M * r * N
    elif name == "rmsnorm":
        flops = 4 * args[0].numel()
    else:
        B, H, S, D = args[0].shape
        pairs = S * (S + 1) // 2 if args[3] else S * S
        flops = 4 * B * H * D * pairs
    t, by = _bound_ms(nbytes, flops, rate)
    return t, by, nbytes / 1e6


def _ops_library(name, args):
    """One PyTorch call that computes the same function, as a yardstick:
    ``F.rms_norm``, ``scaled_dot_product_attention``, and for qlora the
    port's own dense path (``nf4_dequant``, ``torch.matmul``, the LoRA
    products).  The port's ops never call these."""
    F = torch.nn.functional
    if name == "rmsnorm":
        x, scale = args
        w = scale.to(x.dtype)
        return lambda: F.rms_norm(x, (x.shape[-1],), weight=w, eps=1e-6)
    if name == "flash_attention":
        q, k, v, causal = args
        return lambda: F.scaled_dot_product_attention(q, k, v,
                                                      is_causal=causal)
    from repro_torch.models.layers.linear import dense
    x, wq, am, a, b, s = args
    p = {"w_nf4": wq, "absmax": am.reshape(-1), "lora_a": a, "lora_b": b,
         "lora_scale": torch.full((), s, device=x.device)}
    return lambda: dense(p, x)


def phase_ops_kernels(card: str, timer: Timer):
    """``repro_torch.kernels.ops``' qlora_matmul, rmsnorm and
    flash_attention on the card.  Their main path is the ops entries
    themselves, as in the reference (no model path calls them): every case
    is driven through them once, with the launch counts set to 0 just
    before and read just after.  Then each call's output is held against
    the plain version beside a planted fault's reading, and the case is
    timed.  Returns (the JSON rows, from the fit's shapes; the launches)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import qlora_matmul as qm
    from repro_torch.kernels import rmsnorm as rn
    mods = {"qlora_matmul": qm, "rmsnorm": rn, "flash_attention": fa}
    launchers = {"qlora_matmul": qm.qlora_matmul_launcher,
                 "rmsnorm": rn.rmsnorm_launcher,
                 "flash_attention": fa.flash_attention_launcher}
    g = torch.Generator(device="cuda").manual_seed(7)
    cases = [(name, label, make(g))
             for name, label, make in _ops_cases(get_config(
                 "fedtime-llama2-7b"))]
    for mod in mods.values():
        mod.reset_launches()
    outs = [_ops_call(name, args) for name, _, args in cases]
    torch.cuda.synchronize()
    launches = {name: mod.LAUNCHES[name] for name, mod in mods.items()}
    for name, n in launches.items():
        want = sum(c[0] == name for c in cases)
        _check(n == want, f"ops phase: {name} launched {n} times, not {want}")
    print(f"[{card}] ops phase: every call through repro_torch.kernels.ops, "
          f"launches {launches}")
    rows = {}
    for (name, label, args), got in zip(cases, outs):
        want, (atol, rtol), why, planted = _ops_plain(name, args)
        _check(bool(torch.isfinite(got).all()), f"{name} {label}: non-finite")
        _check(got.shape == want.shape and got.dtype == args[0].dtype,
               f"{name} {label}: shape or type")
        err = float((got.float() - want.float()).abs().max())
        over = _over(got, want, atol, rtol)
        _check(over <= 0.0, f"{name} {label}: max_abs_err {err} exceeds the "
               f"limit (atol {atol}, rtol {rtol}) by {over}")
        readings = []
        for fault, bad in planted:
            p_err = float((got.float() - bad.float()).abs().max())
            _check(_over(got, bad, atol, rtol) > 0.0,
                   f"{name} {label}: planted '{fault}' reads {p_err}, "
                   f"inside the limit")
            readings.append(f"{fault} reads {p_err:.3g}")
        print(f"  {name} {label}: max_abs_err {err:.3g} within atol {atol} "
              f"+ rtol {rtol:.4g} |want| ({why}); {'; '.join(readings)}")
        bound, by, mb = _ops_bound(name, args, got)
        heavy = name == "qlora_matmul" and args[0].numel() > 10 ** 6
        ms = timer.ms(lambda: _ops_call(name, args), 20)
        launch, _ = launchers[name](*args)
        kernel_ms = timer.ms(launch, 20)
        plain_fn = getattr(mods[name], f"{name}_ref")
        plain = timer.ms(lambda: plain_fn(*args), 3 if heavy else 10)
        lib = timer.ms(_ops_library(name, args), 20)
        print(f"[{card}] kernel {name} {label}: wrapper {ms:.4f} ms, kernel "
              f"alone {kernel_ms:.4f} ms, plain {plain:.4f} ms, bound "
              f"{bound:.4f} ms ({by}, {mb:.2f} MB), library {lib:.4f} ms")
        if label.startswith("fit"):               # the rows the JSON keeps
            rows[name] = dict(max_abs_err=err, ms=ms, kernel_ms=kernel_ms,
                              plain_ms=plain, bound_ms=bound, bound_by=by,
                              library_ms=lib, shape=label)
    return rows, launches


# ---------------------------------------------------------------------------
# phases 3-4: the main path at full width
# ---------------------------------------------------------------------------

def _engine_trace(cfg):
    """Eight Poisson requests from the launcher's trace maker plus a
    shared-prefix cluster: a donor, a divergent tail and two identical
    replays of a 40-token core.  The core ends inside its third 16-slot
    block, so a replay's first own token lands in a shared block and
    copy-on-write fires."""
    from repro_torch.launch.serve import make_trace
    gen = 16
    trace = make_trace(cfg, 8, gen=gen, max_prompt=96, rate=1.0, seed=0)
    rng = np.random.default_rng(1)
    core = rng.integers(0, cfg.vocab_size, 40).tolist()
    tail = rng.integers(0, cfg.vocab_size, 8).tolist()
    for rid, prompt, arrival in (("cd", core, 0), ("ct", core + tail, 2),
                                 ("cu0", core, 3), ("cu1", core, 4)):
        trace.append({"id": rid, "prompt": prompt, "max_new_tokens": gen,
                      "arrival_step": arrival})
    return sorted(trace, key=lambda r: r["arrival_step"])


class _CallRecorder:
    """Wraps the flash-decode wrapper during the main path and keeps a copy
    of the inputs and output of every ``every``-th call of each layout (at
    most ``keep`` each), to be held against the plain version after the run.
    The wrapped call itself is unchanged, so is its launch count."""

    def __init__(self, fd, every: int = 500, keep: int = 4):
        self.fd, self.real = fd, fd.flash_decode_cuda
        self.every, self.keep = every, keep
        self.seen = {"ring": 0, "paged": 0}
        self.calls = []

    def __enter__(self):
        self.fd.flash_decode_cuda = self
        return self

    def __exit__(self, *exc):
        self.fd.flash_decode_cuda = self.real

    def __call__(self, *args, **kw):
        out = self.real(*args, **kw)
        layout = "ring" if kw.get("block_tables") is None else "paged"
        n = self.seen[layout]
        self.seen[layout] += 1
        if n % self.every == 0 and n // self.every < self.keep:
            copy = lambda x: x.clone() if torch.is_tensor(x) else x
            self.calls.append((f"{layout} call {n}",
                               tuple(copy(a) for a in args),
                               {k: copy(v) for k, v in kw.items()},
                               out.clone()))
        return out


def phase_main_path(card: str, cfg, params) -> dict:
    from repro_torch.kernels import flash_decode as fd
    with _CallRecorder(fd) as recorder:
        launches = _run_main_path(card, cfg, params)
    print(f"[{card}] the main path's own flash-decode calls, held against "
          f"the plain version on copies of their inputs:")
    for label, args, kw, out in recorder.calls:
        _hold_to_plain(f"{label}, q {tuple(args[0].shape)}, k "
                       f"{tuple(args[1].shape)}", args, kw, got=out)
    _check({l.split()[0] for l, *_ in recorder.calls} == {"ring", "paged"},
           "no main-path call of each layout was recorded")
    return launches


def _run_main_path(card: str, cfg, params) -> dict:
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.launch.serve import run_engine, run_fixed_batch
    from repro_torch.models import transformer

    fd.reset_launches()
    t0 = time.perf_counter()
    res = run_fixed_batch(cfg, params, device="cuda", quiet=True, **FIXED)
    wall = time.perf_counter() - t0
    _check(res["finite"], "fixed batch: non-finite logits")
    _check(res["tokens"].shape == (4, 65), "fixed batch: token shape")
    fixed_launches = dict(fd.LAUNCHES)
    _check(fixed_launches["flash_decode"] == 64 * cfg.num_layers,
           f"fixed batch: {fixed_launches} contiguous launches")
    print(f"[{card}] fixed batch qwen3-0.6b full width: prefill 4x512 "
          f"{res['prefill_tok_per_s']:.0f} tok/s, decode first step "
          f"{res['first_step_s']:.3f} s, steady "
          f"{res['decode_tok_per_s']:.1f} tok/s (63 steps x 4), "
          f"wall {wall:.1f} s, launches {fixed_launches}")

    finite = []
    logits_fn = transformer.logits_fn

    def checked_logits(*a, **k):              # every logits tensor the
        lg = logits_fn(*a, **k)                # engine computes
        finite.append(torch.isfinite(lg).all())
        return lg

    trace = _engine_trace(cfg)
    transformer.logits_fn = checked_logits
    try:
        t0 = time.perf_counter()
        done, summ, engine = run_engine(cfg, params, trace, device="cuda",
                                        quiet=True, **ENGINE)
        wall = time.perf_counter() - t0
    finally:
        transformer.logits_fn = logits_fn
    launches = dict(fd.LAUNCHES)
    _check(len(done) == len(trace), "engine: not every request finished")
    for r in trace:
        _check(len(done[r["id"]].tokens) == r["max_new_tokens"],
               f"engine: {r['id']} stopped short")
    _check(all(bool(f) for f in finite), "engine: non-finite logits")
    _check(summ["cow_copies"] >= 1, "engine: copy-on-write never fired")
    _check(summ["full_prompt_hits"] >= 1, "engine: no full-prompt hit")
    engine.pool.assert_partition()
    _check(engine.pool.blocks_in_use == 0, "engine: blocks leaked")
    _check(engine.pool.pool_blocks == ENGINE_POOL_BLOCKS,
           "engine: pool geometry differs from the one phase 2 checks")
    for name in ("flash_decode", "flash_decode_paged", "paged_block_copy"):
        _check(launches[name] > 0, f"main path never launched {name}")
    print(f"[{card}] engine qwen3-0.6b full width, paged + prefix sharing: "
          f"{summ['requests']} requests, {summ['decode_tokens']} decode "
          f"tokens in {summ['decode_steps']} steps, "
          f"{summ['steady_tok_per_s']:.1f} tok/s steady, itl p50 "
          f"{summ['itl_p50_s'] * 1e3:.2f} ms, ttft p50 "
          f"{summ['ttft_p50_s'] * 1e3:.1f} ms, share hits "
          f"{summ['share_hits']} ({summ['full_prompt_hits']} full), cow "
          f"{summ['cow_copies']}, {len(finite)} logits tensors finite, "
          f"wall {wall:.1f} s")
    print(f"[{card}] main-path launches (fixed batch + engine): {launches}")
    return launches


# ---------------------------------------------------------------------------
# phase 5: the federated fit at full width
# ---------------------------------------------------------------------------

class _HopRecorder:
    """Wraps the hop wrapper during the fit and keeps a copy of the inputs
    and outputs of the first ``keep`` calls of each wire, to be held
    against the plain version after the run.  The wrapped call itself is
    unchanged, so is its launch count."""

    def __init__(self, wh, keep: int = 2):
        self.wh, self.real, self.keep = wh, wh.fused_hop_cuda, keep
        self.calls = []

    def __enter__(self):
        self.wh.fused_hop_cuda = self
        return self

    def __exit__(self, *exc):
        self.wh.fused_hop_cuda = self.real

    def __call__(self, acc, codes, scales, res, *, wire, qblock):
        copy = lambda x: None if x is None else x.clone()  # noqa: E731
        args = tuple(copy(a) for a in (acc, codes, scales, res))
        out = self.real(acc, codes, scales, res, wire=wire, qblock=qblock)
        if sum(w == wire for w, *_ in self.calls) < self.keep:
            self.calls.append((wire, qblock, args,
                               tuple(copy(o) for o in out)))
        return out


class _Stopwatch:
    """Wraps ``module.name`` during a run and sums the wall time of its
    calls, each closed by ``torch.cuda.synchronize()`` so that the device
    work they queued is inside; ``first`` is when the first call began."""

    def __init__(self, module, name: str):
        self.module, self.name = module, name
        self.real = getattr(module, name)
        self.seconds, self.calls, self.first = 0.0, 0, None

    def __enter__(self):
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)

    def __call__(self, *args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if self.first is None:
            self.first = t0
        out = self.real(*args, **kw)
        torch.cuda.synchronize()
        self.seconds += time.perf_counter() - t0
        self.calls += 1
        return out


def _fit_config():
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config("fedtime-llama2-7b")
    return cfg.replace(fedtime=dataclasses.replace(cfg.fedtime,
                                                   **FIT_SCHEDULE))


def _fit_data(ft):
    from repro_torch.data.federated import client_windows, partition_clients
    from repro_torch.data.timeseries import (DATASETS, generate,
                                             make_windows, train_test_split)
    train, test = train_test_split(generate(DATASETS["etth1"]))
    clients = partition_clients(train, ft.num_clients, seed=0,
                                channels_per_client=FIT_CHANNELS)
    cdata = client_windows(clients, ft.lookback, ft.horizon, max_windows=64)
    xte, yte = make_windows(test, ft.lookback, ft.horizon, stride=8)
    return cdata, xte[..., :FIT_CHANNELS], yte[..., :FIT_CHANNELS]


def phase_fit(card: str) -> dict:
    """``federated_fit`` at fedtime-llama2-7b's widths (bf16, QLoRA on,
    synthetic ETTh1) once on the int8 wire and once on bf16, then
    ``evaluate_forecaster`` on the test windows.  Each run is one main
    path: the hop launch counts are set to 0 just before it and read just
    after."""
    from repro_torch.core import comm, fedtime
    from repro_torch.core.lora import count_params, lora_tree
    from repro_torch.dist import fedcomm
    from repro_torch.kernels import wire_hop as wh
    from repro_torch.train import fed_trainer
    from repro_torch.train.trainer import evaluate_forecaster
    cfg = _fit_config()
    ft = cfg.fedtime
    cdata, xte, yte = _fit_data(ft)
    print(f"[{card}] fit {cfg.name}: widths as published ({cfg.num_layers} "
          f"layers, d_model {cfg.d_model}, {cfg.num_heads}/"
          f"{cfg.num_kv_heads} heads of {cfg.head_dim}, d_ff {cfg.d_ff}, "
          f"lookback {ft.lookback}, horizon {ft.horizon}, patches "
          f"{ft.patch_len}/{ft.patch_stride}, LoRA rank {ft.lora_rank} on "
          f"wq/wk/wv/wo, NF4 qblock {ft.qlora_block}, {cfg.compute_dtype}); "
          f"cut: clients 555 -> {ft.num_clients} of {FIT_CHANNELS} "
          f"channels, clusters 8 -> {ft.num_clusters}, clients a round 16 "
          f"-> {ft.clients_per_round}, local steps 40 -> {ft.local_steps}, "
          f"{FIT['rounds']} rounds, batch {FIT['batch_size']}; "
          f"{len(xte)} test windows")
    launches = {}
    for wire in ("int8", "bf16"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        wh.reset_launches()
        t0 = time.perf_counter()
        with _HopRecorder(wh) as recorder, \
                _Stopwatch(fed_trainer, "local_update") as fits, \
                _Stopwatch(fedcomm, "quantize_update") as wires:
            res = fed_trainer.federated_fit(cfg, cdata, wire=wire, seed=0,
                                            device="cuda", **FIT)
            torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        setup_s = fits.first - t0
        n = dict(wh.LAUNCHES)
        launches[f"wire_hop_{wire}"] = n[f"wire_hop_{wire}"]
        _check(n[f"wire_hop_{wire}"] > 0, f"fit {wire}: no hop launched")
        other = "bf16" if wire == "int8" else "int8"
        _check(n[f"wire_hop_{other}"] == 0, f"fit {wire}: {other} hop ran")
        n_elems = count_params(lora_tree(res.base_params))
        _check(n_elems == HOP_ELEMS, f"fit: {n_elems} adapter elements, "
               f"not {HOP_ELEMS}")
        up = sum(l.comm.bytes_up for l in res.logs)
        want_up = comm.wire_payload_bytes(n_elems, wire) * n[
            f"wire_hop_{wire}"]
        _check(up == want_up, f"fit {wire}: {up} bytes up, the wire prices "
               f"{want_up}")
        losses = [l.train_loss for l in res.logs]
        _check(len(losses) > 0 and all(np.isfinite(losses)),
               f"fit {wire}: round losses {losses}")
        t0 = time.perf_counter()
        metrics = evaluate_forecaster(
            lambda p, x: fedtime.forward(p, cfg, x),
            res.params_for_cluster(0), xte, yte)
        eval_s = time.perf_counter() - t0
        _check(all(np.isfinite(v) for v in metrics.values()),
               f"fit {wire}: metrics {metrics}")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"[{card}] fit {wire} wire: {len(res.logs)} cluster rounds, "
              f"{n[f'wire_hop_{wire}']} uploads of {n_elems} adapter "
              f"elements, {up} bytes up (= wire_payload_bytes x uploads), "
              f"round losses {[round(l, 4) for l in losses]}, trainable "
              f"{res.trainable_frac:.4%}, test MSE {metrics['mse']:.4f} "
              f"MAE {metrics['mae']:.4f}, peak device memory {peak:.2f} GiB")
        print(f"[{card}] fit {wire} wire, host clock: {fit_s:.2f} s in all: "
              f"set-up (init, NF4 quantization, clustering) {setup_s:.2f} s, "
              f"{fits.calls} client fits {fits.seconds:.2f} s "
              f"({fits.seconds / (fits.calls * cfg.fedtime.local_steps):.3f}"
              f" s a local step), {wires.calls} uploads through the wire "
              f"{wires.seconds:.3f} s, the rest (deltas, screen, FedAdam) "
              f"{fit_s - setup_s - fits.seconds - wires.seconds:.2f} s; "
              f"evaluation of {len(xte)} windows {eval_s:.2f} s")
        for w, qblock, args, out in recorder.calls:
            _check(qblock == HOP_QBLOCK, f"fit: hop qblock {qblock}")
            _hold_hop(f"main-path wire_hop_{w} call, {args[0].numel()} "
                      f"elements", args, w, got=out)
        _check(len(recorder.calls) > 0, f"fit {wire}: no hop recorded")
        del res, recorder
    return launches


def _fit_reference(card: str) -> None:
    """The smoke config in f32 on the int8 wire: the fit on the card (the
    hop kernel) against the fit on the CPU (its plain version), same seed:
    the same clusters and bytes, round losses within TOL_FIT_LOSS."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import fedtime
    from repro_torch.core.lora import lora_tree
    from repro_torch.data.federated import client_windows, partition_clients
    from repro_torch.data.timeseries import (DATASETS, generate,
                                             train_test_split)
    from repro_torch.train.fed_trainer import federated_fit
    cfg = get_smoke_config("fedtime-llama2-7b")
    ft = cfg.fedtime
    train, _ = train_test_split(generate(DATASETS["etth1"], timesteps=1000))
    cdata = client_windows(partition_clients(train, ft.num_clients, seed=0,
                                             channels_per_client=2),
                           ft.lookback, ft.horizon, max_windows=16)
    base = fedtime.init(cfg, torch.Generator().manual_seed(0),
                        num_channels=2, device="cpu")
    kw = dict(rounds=2, batch_size=4, wire="int8", kmeans_first=0)
    out = {"cpu": federated_fit(cfg, cdata, base_params=base, device="cpu",
                                **kw)}
    # the card's generator draws other A matrices: hand it the CPU's
    ad0 = lora_tree(out["cpu"].base_params)
    out["cuda"] = federated_fit(cfg, cdata, base_params=_to(base, "cuda"),
                                init_adapters=_to(ad0, "cuda"),
                                device="cuda", **kw)
    a, b = out["cuda"], out["cpu"]
    _check(np.array_equal(a.assignments, b.assignments),
           "fit reference: clusters differ")
    _check([l.comm.bytes_up for l in a.logs] ==
           [l.comm.bytes_up for l in b.logs], "fit reference: bytes differ")
    err = max(abs(x.train_loss - y.train_loss) / abs(y.train_loss)
              for x, y in zip(a.logs, b.logs))
    _check(err <= TOL_FIT_LOSS, f"fit reference: card vs CPU round losses "
           f"differ by {err} (relative) > {TOL_FIT_LOSS}")
    print(f"[{card}] reference smoke fit f32 int8 wire: card vs CPU round "
          f"losses max rel err {err:.3g} (tol {TOL_FIT_LOSS}), "
          f"{len(a.logs)} cluster rounds, clusters and bytes equal")


# ---------------------------------------------------------------------------
# phase 6: small-input reference
# ---------------------------------------------------------------------------

def _to(tree, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


def phase_reference(card: str) -> None:
    """Smoke config in f32: the card (kernels) against the CPU (plain
    versions), same weights, teacher-forced tokens; ring and paged."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.registry import get_model
    cfg = get_smoke_config("qwen3-0.6b")
    api = get_model(cfg)
    params = api.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(0)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (3, 20)))
    teacher = torch.as_tensor(rng.integers(0, cfg.vocab_size, (8, 3, 1)))
    ring, bs = 32, 8
    table = torch.tensor([[3, 9, 0, 6], [1, 11, 4, -1], [10, 2, 7, 5]],
                         dtype=torch.int32)
    outs = {}
    for dev in ("cpu", "cuda"):
        p = _to(params, dev)
        for layout in ("ring", "paged"):
            cache, lg = api.prefill(p, cfg, {"tokens": prompt.to(dev)},
                                    cache_len=ring)
            steps = [lg]
            batch = {}
            if layout == "paged":
                pool = {}
                for name, leaf in cache.items():
                    fill = -1 if leaf.dtype == torch.int32 else 0
                    shape = (leaf.shape[0], 12, bs) + tuple(leaf.shape[3:])
                    pl = torch.full(shape, fill, dtype=leaf.dtype, device=dev)
                    for b in range(3):
                        for j in range(4):
                            if table[b, j] >= 0:
                                pl[:, int(table[b, j])] = \
                                    leaf[:, b, j * bs:(j + 1) * bs]
                    pool[name] = pl
                cache = pool
                batch = {"block_tbl": table.to(dev), "ring_len": ring}
            for i in range(8):
                pos = torch.tensor([20 + i, 20 + i, -1 if i % 2 else 20 + i],
                                   device=dev)
                if layout == "ring":
                    pos = 20 + i
                lg, cache = api.decode_step(
                    p, cfg, cache,
                    {"token": teacher[i].to(dev), "pos": pos, **batch})
                steps.append(lg)
            outs[(dev, layout)] = torch.cat([s.cpu() for s in steps], 1)
    for layout in ("ring", "paged"):
        a, b = outs[("cuda", layout)], outs[("cpu", layout)]
        _check(a.shape == (3, 9, cfg.vocab_size), "reference: logits shape")
        _check(bool(torch.isfinite(a).all()), "reference: non-finite")
        err = float((a - b).abs().max())
        _check(err <= TOL_F32_MODEL, f"reference {layout}: card vs CPU "
               f"logits max err {err} > {TOL_F32_MODEL}")
        print(f"[{card}] reference smoke f32 {layout}: card vs CPU logits "
              f"max_abs_err {err:.3g} (tol {TOL_F32_MODEL}), 9 steps x 3 "
              f"rows")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs on "
                         "the card only")
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(root, "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models.registry import get_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = _card()
    print(f"card: {card}; torch {torch.__version__}, cuda "
          f"{torch.version.cuda}")

    t0 = time.perf_counter()
    logs = build.build()
    build_s = time.perf_counter() - t0
    print(f"[{card}] build: {build_s:.1f} s for {sorted(logs) or 'nothing'} "
          f"(one nvcc per source, in parallel)")
    for name, log in sorted(logs.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    timer = Timer()
    rows = phase_kernels(card, timer)
    rows.update(phase_hop_kernels(card, timer))
    ops_rows, ops_launches = phase_ops_kernels(card, timer)
    rows.update(ops_rows)
    del timer
    torch.cuda.empty_cache()

    cfg = get_config("qwen3-0.6b")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = get_model(cfg).init(cfg, gen, device="cuda")
    launches = phase_main_path(card, cfg, params)
    del params
    torch.cuda.empty_cache()

    launches.update(phase_fit(card))
    launches.update(ops_launches)
    torch.cuda.empty_cache()

    phase_reference(card)
    _fit_reference(card)

    src = {"flash_decode": ("src/repro_torch/csrc/flash_decode.cu",
                            "src/repro/kernels/flash_decode.py:299"),
           "flash_decode_paged": ("src/repro_torch/csrc/flash_decode.cu",
                                  "src/repro/kernels/flash_decode.py:377"),
           "paged_block_copy": ("src/repro_torch/csrc/block_copy.cu",
                                "src/repro/kernels/flash_decode.py:437"),
           "wire_hop_int8": ("src/repro_torch/csrc/wire_hop.cu",
                             "src/repro/kernels/ring_allreduce.py:118"),
           "wire_hop_bf16": ("src/repro_torch/csrc/wire_hop.cu",
                             "src/repro/kernels/ring_allreduce.py:150"),
           "qlora_matmul": ("src/repro_torch/csrc/qlora_matmul.cu",
                            "src/repro/kernels/qlora_matmul.py:73"),
           "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                               "src/repro/kernels/flash_attention.py:64"),
           "rmsnorm": ("src/repro_torch/csrc/rmsnorm.cu",
                       "src/repro/kernels/rmsnorm.py:25")}
    kernels = [{"name": name, "route": "cuda", "source": src[name][0],
                "replaces": src[name][1], "launches": launches[name],
                **rows[name]} for name in src]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
