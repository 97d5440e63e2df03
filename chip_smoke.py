"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its numbers beside the card's name and power limit:

  1. build the CUDA kernels from src/repro_torch/csrc (one nvcc per source,
     all at once) and print ptxas's register / spill report;
  2. hold every kernel against its plain PyTorch version:
     - flash-decode and the block copy at the main path's own call shapes,
       for each served config: qwen3-0.6b (Hk=8, G=2, D=128) and
       fedtime-llama2-7b (Hk=32, G=1, D=128): the fixed batch's 4 x
       576-slot ring; the engine's 12 lanes over its 96-block pool of 16
       slots, with idle lanes, shared blocks and -1 table entries; a CoW
       event's block copy over the pool's K, V and kv_pos leaves in one
       launch (beside one launch a leaf); and, at qwen3-0.6b's heads,
       longer caches (B=4, S in {1024, 4096}, bf16 and int8, ring and
       paged);
     - the wire hop, int8 and bf16, full and quantize-only, at the fit's
       upload size (8,388,608 adapter elements in rows of 128) and at a
       ragged 1001 rows, equal bit for bit;
     - zamba2-2.7b's (Hk=32, G=1, D=80) at the fixed batch's ring in
       bf16, f32 and int8, and the engine's pool (built, though its
       contiguous lanes never run one);
     - phase 12's new flash-decode instances at its call shapes:
       smollm-360m (Hk=5, G=3, D=64) and mixtral-8x7b (Hk=8, G=4,
       D=128) at the fixed batch's ring and the engine's pool (and
       mixtral's ring in int8, whose instance spills), gemma2-27b's
       local layer (Hk=16, G=2, D=128, softcap 50, window 4096) over a
       4096-slot ring that wrapped, one row a lap behind on a quarter of
       its slots; a CoW event of each new paged engine's pool;
     with the wrapper's time, the kernel's alone, the plain version's, the
     least time the card could take (bound) and one library call's time as
     a yardstick where one exists, and the timer's floor (a one-element
     ``fill_``); for each flash-decode case its grid
     (splits, blocks, cluster size) and the device operations one wrapper
     call makes (``torch.profiler``; a call, ring or paged, must be
     exactly one);
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
     request finishes, all logits are finite, copy-on-write fired (one
     block-copy launch an event), no block
     leaked, and that phases 3-4 launched every serving kernel (launch
     counters set to 0 before phase 3, read after phase 4); a few of the
     main path's own flash-decode calls are copied as they run and held
     against the plain version afterwards;
  4c. qwen3-0.6b's fault-tolerant engine at phase 4's geometry: its 12
     requests plus 4 under the reference's chaos plan (a malformed prompt,
     a NaN-poisoned lane, a deadline, a burst; 25%), a queue of 3 with
     shed-and-retry, a virtual clock and a request journal, held bit for
     bit against a fault-free run of the same geometry (run with tracing
     on and off: tok/s of each); quarantines by reason, the deadline
     window, no leaked block (and no live lane on a free block after any
     tick), block-copy launches equal to copy-on-write events, one
     lifecycle span per finished request; then an engine dropped mid-trace
     with its journal open, replayed into a fresh one, every request's
     tokens equal to the fault-free run's (launch counters set to 0 before
     the chaos run, read after);
  3b. qwen3-0.6b, one 8192-token prompt (B = 1): the prefill takes the
     blockwise attention path (at 4096 tokens and over), held against the
     naive path forced on the same prompt beside a planted fault's reading
     (the prompt's second quarter dropped from every softmax), with both
     paths' peak device memory; then 16 greedy ``generate`` steps from its
     cache, each token its logits' argmax;
  3c. ``generate`` at phase 3's fixed batch: greedy equals the fixed-batch
     launcher bit for bit; sampled (temperature 0.8, top-k 50) twice with
     one seed gives the same tokens, each in its row's top 50 (ring
     flash-decode launches of 3b-3c counted and checked);
  4d. the host swap tier: phase 4's engine geometry and trace with 32 new
     tokens a request on a pool cut from 96 to 32 blocks, so lanes park
     and swap out: at least 2 swap-outs, as many swap-ins, no eviction and
     no recompute prefill, tokens equal to the full pool's and to the cut
     pool's with the tier off (which evicts), block-copy launches equal to
     copy-on-write events; swap bytes and the host time of a swap-out and
     a swap-in (launch counters set to 0 before the swapping run, read
     after);
  4b. phases 3-4 again with fedtime-llama2-7b at full width (32 layers,
     d_model 4096, 32/32 heads of 128: G = 1, vocab 32,000, bf16), the same
     geometry and checks, its own launch counts; then its weights and caches
     are freed;
  5. fit fedtime-llama2-7b at full width (32 layers, d_model 4096, bf16,
     NF4 base, LoRA rank 8; the schedule cut to 8 clients, 2 clusters, 2
     clients a round, 2 local steps, 2 rounds, batch 4) with
     ``federated_fit``, once on the int8 wire and once on bf16, and score it
     with ``evaluate_forecaster``: each run's hop kernel launched (its count
     set to 0 before the run, read after), losses and metrics finite, the
     bytes up equal to the wire's price times the uploads, peak device
     memory printed, and the run's first hop calls held against the plain
     version;
  5b. ``two_phase_fit`` at the same widths and cut schedule, one SFT round,
     4 DPO steps, one forecasting round, batch 4, the int8 wire: the first
     DPO loss (policy = reference) within 1e-6 of ln 2, every loss finite,
     test MSE/MAE finite, hop launches equal to uploads (counted from 0),
     peak device memory under 80 GB, the wall time of each phase;
  5c. ``federated_fit`` with its fault options at the same widths (4
     clients a round, 3 rounds, the first K-means centre fixed at client 0
     for a 4/4 split): run A on the int8 wire under a plan of one client
     each of crash, hang, transient retry, corrupt, byzantine and a delay
     past a 2 s deadline (virtual), with snapshots and ``fleet_out``: the
     ledger exactly as the plan dictates, no corrupt or byzantine upload
     aggregated, the late upload buffered and applied a round later,
     fleet.json's per-cluster bytes = uploads x the wire's price, hop
     launches = uploads through the wire; a resume from the snapshot after
     round 1, cluster 0 equal to run A bit for bit (adapters, losses,
     ledger); run B, secure int8 aggregation with a crash dropout, each
     unmasked code sum equal to the survivors' plain code sum; the wall
     time of each round, the host ms of encode, mask and unmask, snapshot
     bytes and ms, peak device memory under 80 GB;
  7. the centralized path and the paper's comparisons (no kernel lies on
     it; every launch count, set to 0 before, must read 0 after):
     a. Fig. 3's centralized fine-tune: ``trainer.fit`` (AdamW under the
        cosine schedule, every float leaf trained, no LoRA, no NF4) of
        fedtime-llama2-7b at published widths, horizon 96, depth cut to
        16 layers (full fine-tune state of 32 would not fit the card), 8
        steps at batch 4 x 2 channels on pooled ETTh1 windows: losses,
        parameters and test MSE/MAE finite, each step's wall, the peak
        device memory beside the 12 B a parameter arithmetic (under 80
        GB), one step profiled;
     b. Table 2's models on ETTh1 at lookback 512, horizon 720, each
        trained by ``trainer.fit`` at the reference's --full settings
        (DLinear 400 steps, PatchTST d_model 128 x 3 layers x 16 heads of
        8, 200 steps; FSLSTM at Table 3's width, 20 steps) and scored by
        ``evaluate_forecaster`` beside persistence: losses finite, DLinear
        and PatchTST lower their loss, each fit's wall;
     c. Fig. 5's three strategies on phase 5's tree (its shapes rebuilt on
        the meta device): ``fedtime_round`` on each wire,
        ``fed_full_round`` and ``centralized_epoch``, each equal to its
        closed form, FedTime's int8 and bf16 uploads equal to phase 5's
        measured bytes per upload;
  8. the mesh path (after 7, before 6), every rank a process on the one
     card, joined by ``launch.mesh.spawn_local`` over gloo (NCCL refuses
     two ranks on one GPU; ``dist.collectives`` stages sends and gathers
     through the host):
     a. 8 ranks: ``fedcomm.ring_aggregate`` over fedtime-llama2-7b's
        adapter payload (8,388,608 f32 elements a member, its LoRA tree's
        shapes), 16 members, on (data 8, model 1) and (pod 2, data 2,
        model 2), each wire one-shot and two rounds with state: the ring
        on the card equal bit for bit to the same ring on host tensors in
        the same ranks (the plain hop), outputs and residuals; within the
        reference's tolerances of the exact weighted sum, unit weights
        exact; bytes a rank per axis = the chunk plan =
        ``fed.expected_collective_bytes`` = ``collective_bytes_per_round``;
        2·n hop launches a rank per axis a round on the quantized wires;
        8 int8 rounds carrying state debiased under 0.35x the one-shot
        bias, beside a planted fault (the residual dropped); the wall of a
        round and each rank's peak memory;
     b. 4 ranks on (data 1, model 4): ``dist.decode.sharded_flash_decode``
        with each served config's heads (B 4, S 4096; bf16 and int8;
        causal, window, prefix; a striped pool with shared blocks, -1
        entries and an inactive lane) against the whole cache through the
        kernel, beside a planted fault (one stripe dropped); one
        flash-decode launch a rank a call;
     c. the same 4 ranks: three steps of ``adamw_update_zero1`` on
        qwen3-0.6b's whole tree at published widths and on
        fedtime-llama2-7b's adapter tree, on (data 4) and (data 2, model
        2), equal to ``adamw_update`` bit for bit;
  9. sharded serving (after 8, before 6), 4 ranks of one world on the one
     card over gloo, the same weights drawn from one seed on every rank
     (checked by a checksum); each rank holds only its rows and its
     stripe of the cache (``launch.steps.make_prefill_step`` and
     ``make_serve_step`` under ``dist.sharding.use_mesh``):
     a. qwen3-0.6b at full width and depth on (data 2, model 2): B 4, a
        992-token prompt, a 1024-slot ring (512 slots a model rank, 2 rows
        a data rank), 32 greedy steps that fill it; bf16, int8
        (``REPRO_KV_INT8=1``) and ragged (lane 1 inactive from step 10);
     b. a paged pool of its width striped over (data 1, model 4): a
        shared block, a -1 entry, lane 1 inactive from step 5, 16 steps;
     c. fedtime-llama2-7b's backbone at full width and depth (Hk 32, G 1,
        D 128) on (data 1, model 4), 16 steps;
     each held at every step to the unsharded run of the whole batch fed
     the same tokens (logits within SHARD_LOGIT_TOL, each differing
     greedy choice printed with both runs' leads), beside a planted fault
     (the first stripe's partials dropped); cache bytes a rank = the whole
     cache's / (batch ways x model ways); one flash-decode launch a rank a
     layer a step; the inactive lane's attention output exactly 0; prefill
     and decode walls and each rank's peak memory;
  10. the training launcher (after 9, before 6), which reaches no kernel
     (every launch count, set to 0 before, reads 0 after, in each rank of
     10c too), at ``launch.train``'s defaults (batch 8 x 256, lr 3e-4,
     Markov tokens):
     a. ``launch.train.run`` of a full fine-tune of qwen3-0.6b at published
        widths and depth (bf16), 20 steps: every loss finite, the mean of
        the last 5 under the first; each step's wall, tok/s, peak memory;
        then qwen3-0.6b's f32 smoke config, 3 steps on the card against
        the same weights and batches on the CPU, beside a planted fault
        (a quarter of one row's labels dropped);
     b. ``--fed`` on fedtime-llama2-7b at published widths and depth
        (bf16, LoRA rank 4), 10 steps: every base leaf's checksum
        unchanged, every adapter leaf moved, the moments exactly twice
        the adapters' f32 bytes; walls, tok/s, peak memory;
     c. 4 ranks on the one card over gloo: ``make_train_step`` on (data 2,
        model 2) and ``make_fed_train_step`` on (data 4, model 1) at
        qwen3-0.6b's width in f32, 4 layers, 3 steps with -1 labels on
        data rank 0's rows, each held to the one-rank step on the global
        batch beside a planted fault (per-rank means averaged); a rank's
        moments exactly the whole's / data ways; the federated step's
        psum the adapter payload (+ count and loss) and its gather the
        payload; every rank alike;
     d. 2 ranks on the one card: one MoE ``make_train_step`` on (data 2,
        model 1) at qwen2-moe-a2.7b's published widths in f32, depth cut
        from 24 to 1 layer (TRAIN_MOE), 512 tokens a rank (one expert
        group), held to the one-rank step with 10c's limits beside a
        planted fault (the router's top-1 counts not psummed);
  11. the dry run against the card (after 10, before 6):
     a. ``launch.dryrun.run_one`` in fake worlds of the installed
        PyTorch: qwen3-0.6b at decode_32k and long_500k on the single mesh
        (256 ranks) and at train_4k with ``--fed`` on the multi-pod mesh
        (512 ranks): rank 0's FLOPs (equal to the committed record's in
        ``experiments/dryrun_torch/``), bytes, collective bytes, argument
        + temp bytes beside the card's memory, each dry run's wall;
     b. one rank's steps, each predicted on fakes at its shapes
        (``launch.specs.step_args``, ``launch.dryrun.measure``) and then
        run on the card under the same counter after a warm-up call:
        qwen3-0.6b's ``make_train_step`` at 2 x 4096 (the blockwise path),
        fedtime-llama2-7b's ``make_fed_train_step`` at 8 x 256 (LoRA rank
        8, NF4 base), qwen3-0.6b's ``make_prefill_step`` at one 8192-token
        row and its ``make_serve_step`` over a 32,768-slot ring at the
        largest B the dry run fits in 70 GB: the counted FLOPs on the card
        equal to the prediction's, the peak above the arguments
        (``max_memory_allocated`` less what was allocated before) within
        5% or 256 MiB of the predicted ``temp_bytes``, the arguments'
        bytes equal, one flash-decode launch a layer a serve call; each
        kernel's shape rule against the kernel's outputs on fakes of the
        same inputs; each step's time (CUDA events), its counted FLOPs
        over that time and that rate's share of 989 TFLOP/s;
  12. the rest of the dense family and the MoE family (after 11, before
     6), each at its published width with random bf16 weights drawn on
     the card a layer slice at a time: gemma2-27b (46 layers, 54.4 GB;
     local/global alternation, post-block norms, softcaps), smollm-360m
     (G = 3), qwen2-moe-a2.7b (24 layers, 60 experts top-4 + 4 shared)
     and mixtral-8x7b (16 of its 32 layers, 47 GB; 8 experts top-2,
     G = 4): the fixed batch (4 x 512, 64 steps) over the ring, then the
     engine (phase 4's trace and geometry; the paged pool with prefix
     sharing and copy-on-write, contiguous local/global lanes for
     gemma2), then for gemma2 and mixtral one 4608-token row past the
     4096 window (gemma2 through the fixed-batch launcher, its blockwise
     prefill wrapping the local rings; mixtral through the paged
     engine); each model's init peak, run peak and launches (set to 0 at
     its start), a few of its own flash-decode calls held to the plain
     version (the long rows' first local and global calls among them);
  12b. xlstm-350m (family ssm: 20 mLSTM and 4 sLSTM blocks, d_model 1024,
     vocab 50,304, bf16, no cut), which launches no kernel of the port
     (every count, set to 0 before, reads 0 after): the fixed batch (4 x
     512, 64 steps), one 500-token row (the padded chunk path), prefill +
     3 decode steps against a prefill of those 515 tokens in f32 (a
     planted wrong token and two prefills at batch 4 and 2 beside), the
     engine on contiguous lanes (12 requests, 12 slots, Poisson arrivals)
     with its greedy tokens equal to the fixed-batch path's on the same
     prompts and each retired lane's state equal bit for bit at the end;
     weights, init and run peaks, tok/s, ITL, TTFT, the sLSTM prefill
     loops' wall;
  12c. zamba2-2.7b (family hybrid: 54 Mamba2 layers and 2 weight-shared
     attention blocks applied 9 times, d_model 2560, bf16, no cut) through
     phase 12b's geometry, every decode step launching exactly 9 ring
     flash-decodes of the (G, D) = (1, 80) instance and no paged one (the
     counts set to 0 at its start, checked against its decode steps),
     three of its own calls held to the plain version, the f32 hold at
     HYBRID_LOGIT_TOL, the engine's tokens and retired lanes (states and
     rings) as 12b's;
  6. check the model path on the card against the plain path on the CPU at
     the smoke configs in f32: prefill + teacher-forced decode (ring and
     paged) of qwen3-0.6b and of fedtime-llama2-7b (G = 1), of
     qwen3-1.7b, gemma2-27b (ring only: its two ring lengths keep
     contiguous lanes), smollm-360m (G = 3), mixtral-8x7b and
     qwen2-moe-a2.7b (at head_dim 128: its smoke heads have no
     instance), xlstm-350m (its contiguous states), zamba2-2.7b (ring
     only, at head_dim 80: its smoke heads have no instance), a 2-round fit
     on the int8 wire, and 4 steps of ``trainer.fit`` of FedTime's smoke
     config and of each Table 2 model at a small width (step losses within
     TOL_FIT_LOSS).

Any failed check raises, so the script exits non-zero and prints no result.
The last three lines are the kernels' JSON summary, the card's name and
power limit, and {"ok": true, "device": {...}}; before them, the script's
wall time.  Without a CUDA device, or
without the repository beside it, it fails.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
F32_FLOPS = 67e12                # f32 outside the tensor cores
BF16_FLOPS = 989e12              # bf16 products on the tensor cores
# f32 matrix products as 3xTF32 on the tensor cores, which keeps the f32
# limit: three TF32 products (494.7 TFLOP/s) for each f32 one.  The least
# time for f32 attention and qlora_matmul is taken at this rate.
F32_MATMUL_FLOPS = 494.7e12 / 3
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
# flex_attention (the library call beside the softcapped decode) rounds its
# probabilities to bf16 before their product with V: outputs under 0.5 then
# sit within 1e-3 of the plain version's beyond the outputs' own rounding
FLEX_TOL = 1e-3
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
# The configs served on the main path, each at full width: the JSON line's
# rows are qwen3-0.6b's (G = 2); fedtime-llama2-7b's (G = 1) are nested
# under its name in each serving kernel's row.
SERVED = ("qwen3-0.6b", "fedtime-llama2-7b")
# Phase 12: the rest of the dense family and the MoE family, each at its
# published width and random bf16 weights drawn on the card; (arch, layers)
# with 0 for the published depth.  mixtral-8x7b is cut from 32 layers to
# 16 (about 47 GB of bf16 weights; 32 would be 93 GB).
PHASE12 = (("gemma2-27b", 0), ("smollm-360m", 0), ("qwen2-moe-a2.7b", 0),
           ("mixtral-8x7b", 16))
# One row past the 4096-slot window (gemma2's local layers, mixtral's every
# layer): 9 MoE groups of 512 tokens, as the reference's group rule asks.
LONG_ROW = dict(prompt=4608, gen=16)
PHASE12_WINDOW, PHASE12_SOFTCAP = 4096, 50.0       # gemma2-27b's


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _ptxas_report(log: str):
    """[(kernel, "Used N registers, ...")] from nvcc's ``-Xptxas -v``
    output, each kernel's name demangled by ``c++filt`` where there is one
    (else left mangled)."""
    report = {}
    entry = "?"
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
        elif "registers" in line or "spill" in line:
            report.setdefault(entry, []).append(
                line.split(":", 1)[-1].strip())
    pairs = [(e, "; ".join(r)) for e, r in report.items()]
    names = [e for e, _ in pairs]
    if shutil.which("c++filt") and names:
        out = subprocess.run(["c++filt"], input="\n".join(names),
                             capture_output=True, text=True, timeout=60)
        if out.returncode == 0 and len(out.stdout.splitlines()) == len(names):
            names = [n.replace("(anonymous namespace)::", "")
                     .removeprefix("void ").split("(")[0]
                     for n in out.stdout.splitlines()]
    return [(n, r) for n, (_, r) in zip(names, pairs)]


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


def _cost_rule(label: str, rule, nbytes: float) -> None:
    """Print the kernel's cost rule (``obs.cost``: its product FLOPs and
    the bytes of each input read once and each output written once, from
    shapes alone) at a call whose bound counted ``nbytes``, beside it."""
    flops, rbytes = rule
    print(f"  cost rule {label}: {flops / 1e9:.4f} GFLOP of products, "
          f"{rbytes / 1e6:.4f} MB (the bound counts {nbytes / 1e6:.4f} MB, "
          f"{(rbytes - nbytes) / max(nbytes, 1):+.2%})")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def _quant(x):
    amax = x.abs().amax(-1, keepdim=True)
    scale = (torch.clamp(amax, min=1e-6) / 127.0).to(torch.bfloat16)
    q = torch.clamp(torch.round(x / scale.float()), -127, 127)
    return q.to(torch.int8), scale


def _decode_case(rows, S: int, int8: bool, paged: bool, *, n_blocks=0,
                 Hk=8, G=2, D=128, bs=16, seed=0, device="cuda",
                 wrap=False, f32=False, cross=False):
    """Inputs of one decode call with Hk KV heads of D and G queries each:
    one row per entry of ``rows`` (its position; -1 is an idle lane, which
    must come out 0).
    The ring holds positions 0..q_pos of each row; with ``wrap`` (rows past
    the ring) it holds the last S positions of each row, slot p mod S, and
    row 1's first quarter of slots one lap older (positions a window of S
    drops).  With ``cross`` the ring is an encoder-decoder's memory: every
    slot 0..S-1 valid, read with ``kind="full"`` at q position 0 (``rows``
    then only counts the rows).  The paged pool
    (``n_blocks`` blocks of ``bs``) shares its first two blocks between all
    active rows, and leaves the table entries past each row's position,
    and every entry of an idle lane, ungranted (-1).  The cache and q are
    bf16, or with ``int8`` codes and a bf16 q, or with ``f32`` f32
    throughout (an f32 model's decode)."""
    dev = device
    B = len(rows)
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, 1, Hk * G, D), generator=g, device=dev)
    q_pos = torch.tensor(rows, dtype=torch.int32, device=dev)
    if cross:
        q_pos = torch.zeros_like(q_pos)
    if cross:
        kv_shape = (B, S, Hk, D)
        kv_pos = torch.arange(S, dtype=torch.int32, device=dev).expand(
            B, S).contiguous()
        tbl = None
    elif paged:
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
    elif wrap:
        kv_shape = (B, S, Hk, D)
        ar = torch.arange(S, device=dev, dtype=torch.int32)
        kv_pos = q_pos[:, None] - torch.remainder(q_pos[:, None] - ar[None],
                                                  S)
        if B > 1:
            kv_pos[1, :S // 4] -= S              # a lap behind the window
        kv_pos = torch.where(kv_pos >= 0, kv_pos,
                             torch.full_like(kv_pos, -1)).contiguous()
        tbl = None
    else:
        kv_shape = (B, S, Hk, D)
        ar = torch.arange(S, device=dev, dtype=torch.int32)
        kv_pos = torch.where(ar[None] <= q_pos[:, None], ar[None],
                             torch.full_like(ar[None], -1)).contiguous()
        tbl = None
    k = torch.randn(kv_shape, generator=g, device=dev)
    v = torch.randn(kv_shape, generator=g, device=dev)
    kw = {"kind": "full"} if cross else {}
    if f32:
        if tbl is not None:
            kw["block_tables"] = tbl
        return (q, k, v, kv_pos, q_pos), kw
    if int8:
        k, ks = _quant(k)
        v, vs = _quant(v)
    else:
        k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
    q = q.to(torch.bfloat16)
    if int8:
        kw.update(k_scale=ks, v_scale=vs)
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
    window = kw.get("window", 0)
    kind = kw.get("kind", "causal")
    if tbl is None:
        keep = fd._slot_mask(kv_pos, q_pos[:, None], 0, kind=kind,
                             window=window)
        return int(keep.sum())
    bs = k.shape[1]
    T = tbl.shape[1]
    _, _, gpos, _, _ = fd.paged_gather(k, v, kv_pos, None, None, tbl)
    keep = fd._slot_mask(gpos, q_pos[:, None], 0, kind=kind,
                         window=window)
    phys = (tbl.clamp(min=0).long()[:, :, None] * bs
            + torch.arange(bs, device=tbl.device)).reshape(B, T * bs)
    return int(torch.unique(phys[keep]).numel())


def _sdpa_inputs(args, kw):
    """The library yardstick's inputs: the gathered, dequantized cache in
    bf16 and a boolean mask (window included), laid out for
    scaled_dot_product_attention, which has no softcap."""
    from repro_torch.kernels import flash_decode as fd
    q, k, v, kv_pos, q_pos = args
    ks, vs = kw.get("k_scale"), kw.get("v_scale")
    if kw.get("block_tables") is not None:
        k, v, kv_pos, ks, vs = fd.paged_gather(k, v, kv_pos, ks, vs,
                                               kw["block_tables"])
    if ks is not None:
        k = (k.float() * ks.float()).to(torch.bfloat16)
        v = (v.float() * vs.float()).to(torch.bfloat16)
    mask = fd._slot_mask(kv_pos, q_pos[:, None], 0,
                         kind=kw.get("kind", "causal"),
                         window=kw.get("window", 0))
    return (q.transpose(1, 2), k.transpose(1, 2).contiguous(),
            v.transpose(1, 2).contiguous(), mask[:, None, None, :])


def _input_sums(args) -> list:
    return [float(t.double().sum()) for t in args[:4]]


def _flex_library_ms(label: str, args, case: dict) -> float:
    """``_flex_library``'s call timed in a child process on the same
    inputs (``case`` rebuilds them from their seed; their sums are held
    equal to the parent's), which keeps torch.compile out of this
    process.  On the card's machine a ``torch.profiler`` profile taken
    after a compile here, or after any other process has used the card,
    misses device operations (0-3 of 5 seen), so phase 2 times this last,
    after its profiles.  Returns the child's mean device time, ms."""
    root = os.path.dirname(os.path.abspath(__file__))
    code = (f"import json, sys; sys.path[:0] = [{root!r}, "
            f"{os.path.join(root, 'src')!r}]; import chip_smoke; "
            f"print(json.dumps(chip_smoke._flex_child({label!r}, "
            f"{case!r})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    for line in out.stdout.splitlines()[:-1]:
        print(line)
    _check(out.returncode == 0, f"{label}: the flex_attention child "
           f"failed ({out.returncode}): {out.stderr[-2000:]}")
    res = json.loads(out.stdout.splitlines()[-1])
    _check(res["sums"] == _input_sums(args), f"{label}: the flex_attention "
           f"child built other inputs")
    return res["ms"]


def _flex_child(label: str, case: dict) -> dict:
    """In the child: rebuild the case, hold flex_attention to the plain
    version and time it."""
    case = dict(case)
    rows, S, wrap = case.pop("rows"), case.pop("S"), case.pop("wrap")
    kw_extra = {k: case.pop(k) for k in ("window", "softcap")}
    args, kw = _decode_case(rows, S, False, False, wrap=wrap, **case)
    kw.update(kw_extra)
    call = _flex_library(label, args, kw)
    return {"ms": Timer().ms(call, 50), "sums": _input_sums(args)}


def _flex_library(label: str, args, kw):
    """The one PyTorch call that computes a softcapped, windowed decode:
    ``flex_attention``, compiled, with the softcap as its score_mod and the
    empty-slot, causal and window mask read from kv_pos and q_pos as its
    block mask, built here once and outside the timed call (one mask
    serves every local layer of a decode step).  Its output is held
    against the plain version's within bf16 rounding and FLEX_TOL.
    Returns the call."""
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)
    from repro_torch.kernels import flash_decode as fd
    q, k, v, kv_pos, q_pos = args
    _check(kw.get("block_tables") is None and kw.get("k_scale") is None,
           f"{label}: flex_attention is timed on a bf16 ring only")
    B, S = kv_pos.shape
    W, cap = kw.get("window", 0), kw["softcap"]
    qp = fd._rows(q_pos, B, q.device)

    def keep(b, h, q_idx, kv_idx):
        kp = kv_pos[b, kv_idx]
        m = (kp >= 0) & (kp <= qp[b])
        return m & (qp[b] - kp < W) if W else m

    def softcap(score, b, h, q_idx, kv_idx):
        return cap * torch.tanh(score / cap)

    mask = create_block_mask(keep, B, None, 1, S, device=q.device)
    flex = torch.compile(flex_attention)
    qt, kt, vt = (q.transpose(1, 2), k.transpose(1, 2).contiguous(),
                  v.transpose(1, 2).contiguous())

    def call():
        return flex(qt, kt, vt, score_mod=softcap, block_mask=mask,
                    enable_gqa=True)

    got = call().transpose(1, 2).float()
    want = fd.flash_decode_ref(*args, **kw).float()
    over = float(((got - want).abs() - BF16_HALF_STEP * (got.abs()
                                                         + want.abs())
                  - FLEX_TOL).max())
    _check(over <= 0.0, f"{label}: flex_attention disagrees with the plain "
           f"version ({over} over bf16 rounding and {FLEX_TOL})")
    print(f"  {label}: flex_attention max_abs_err "
          f"{float((got - want).abs().max()):.3g} (within bf16 rounding and "
          f"{FLEX_TOL})")
    return call


def _f32_outs(args, kw):
    """The f32 outputs before the cast, (B, Hk, G, D): the kernel's (a
    comparison launch, not counted: its own merged sums through
    ``return_partials``) and the plain version's."""
    from repro_torch.kernels import flash_decode as fd
    launch, (m, l, acc) = fd.flash_decode_launcher(
        *args, return_partials=True, **kw)
    launch()
    got = acc / torch.clamp(l, min=1e-30)
    m, l, acc = fd.flash_decode_ref(*args, return_partials=True, **kw)
    return got, acc / torch.clamp(l, min=1e-30)


def _device_ops_per_call(fn, calls: int = 4, tries: int = 3) -> float:
    """Kernels (and copies or fills) one call of ``fn`` puts on the device,
    counted by ``torch.profiler`` over ``calls`` calls after a warm one.
    Now and then the profiler hands back no device activity at all (seen
    once on the card, in a profile of one of a run's many calls): a fill
    of a marker tensor beside the calls tells such a profile apart from a
    wrapper that launched nothing, and the profile is taken again."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    marker = torch.zeros(1, device="cuda")
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            marker.fill_(1.0)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        ops = sum(e.count for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA)
        if ops:                                   # the marker's fill seen
            return (ops - 1) / calls
    raise SystemExit(f"chip_smoke: FAILED: {tries} profiles saw no device "
                     f"activity, not even the marker's fill")


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
        bs = args[1].shape[1]
        ring = tbl.shape[1] * bs
        kv_pos[int(tbl[b0, int(q_pos[b0]) % ring // bs])] = -1
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


def _phase12_heads():
    """{config name: (layers, Hk, G, D)} of phase 12's configs, at the
    depths it serves them."""
    out = {}
    for arch, layers in PHASE12:
        cfg = _phase12_config(arch, layers)
        out[arch] = (cfg.num_layers, cfg.num_kv_heads,
                     cfg.num_heads // cfg.num_kv_heads, cfg.head_dim)
    return out


def _phase12_config(arch: str, layers: int):
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return cfg.replace(num_layers=layers) if layers else cfg


def _served_heads():
    """{config name: (layers, Hk, G, D)} of the configs the main path
    serves."""
    from repro_torch.configs import get_config
    out = {}
    for arch in SERVED:
        cfg = get_config(arch)
        out[arch] = (cfg.num_layers, cfg.num_kv_heads,
                     cfg.num_heads // cfg.num_kv_heads, cfg.head_dim)
    return out


def phase_kernels(card: str, timer: Timer) -> dict:
    """Every kernel against its plain version at the main path's own call
    shapes (for each served config: the fixed batch's ring and the engine's
    pool, bf16; the rows the JSON line keeps; for qwen3-0.6b also phase
    3b's one-row ring of 8208 slots and phase 4d's 32-block pool), at phase
    12's new instances (smollm-360m's G 3 and mixtral-8x7b's G 4, ring and
    pool, and qwen2-moe-a2.7b's; gemma2-27b's local layer with its softcap
    and window over a ring that wrapped, its library call flex_attention),
    at phase 12c's (1, 80) instance (zamba2-2.7b's ring in bf16, f32 and
    int8, and a pool, built though its contiguous lanes never run one),
    at phase 12d's (1, 64) instance (seamless-m4t-medium's self ring in
    bf16, f32 and int8, a pool, and its cross calls over a 512- and a
    4096-slot memory)
    and at longer caches (S = 1024, 4096; bf16 and int8;
    qwen3-0.6b's heads); a copy-on-write event of each paged engine's pool.
    Returns the JSON rows: qwen3-0.6b's, with the other configs' nested
    under their names."""
    from repro_torch.kernels import flash_decode as fd
    F = torch.nn.functional
    P, gen = FIXED["prompt_len"], FIXED["gen"]
    S_eng = ENGINE["cache_len"]
    engine_rows = [S_eng - 1, 100, -1, 64, 17, -1, 90, 40, 3, -1, 111, 56]
    heads = _served_heads()
    cases = []
    for arch, (_, Hk, G, D) in heads.items():
        hw = dict(Hk=Hk, G=G, D=D)
        cases += [(arch, f"main path {arch}: fixed batch ring",
                   [P + gen - 1] * FIXED["batch"], P + gen, False, False, 0,
                   hw),
                  (arch, f"main path {arch}: engine pool", engine_rows,
                   S_eng, False, True, ENGINE_POOL_BLOCKS, hw)]
    # phase 12's calls at its own shapes: smollm-360m (G 3), mixtral-8x7b
    # (G 4) and qwen2-moe-a2.7b (G 1, 16 KV heads) at the fixed batch's ring
    # and the engine's pool; gemma2-27b's local layer (G 2, softcap 50) over a 4096-slot
    # ring that wrapped, one row a lap behind on a quarter of its slots,
    # which the 4096 window drops
    for arch, (_, Hk, G, D) in _phase12_heads().items():
        hw = dict(Hk=Hk, G=G, D=D)
        if arch == "gemma2-27b":
            W = PHASE12_WINDOW
            cases.append((f"{arch} local layer", f"phase 12 {arch}: local "
                          f"layer's wrapped ring, window {W}, softcap "
                          f"{PHASE12_SOFTCAP:g}",
                          [LONG_ROW["prompt"] + i for i in range(4)], W,
                          False, False, 0,
                          dict(hw, wrap=True, window=W,
                               softcap=PHASE12_SOFTCAP)))
            continue
        cases += [(arch, f"phase 12 {arch}: fixed batch ring",
                   [P + gen - 1] * FIXED["batch"], P + gen, False, False, 0,
                   hw),
                  (arch, f"phase 12 {arch}: engine pool", engine_rows,
                   S_eng, False, True, ENGINE_POOL_BLOCKS, hw)]
        if G == 4:          # the int8 instances, which spill (ptxas, phase 1)
            cases.append((None, f"phase 12 {arch}: fixed batch ring, int8",
                          [P + gen - 1] * FIXED["batch"], P + gen, True,
                          False, 0, hw))
    # phase 12c's calls: zamba2-2.7b's shared attention (G 1, D 80, 32 KV
    # heads) at the fixed batch's ring in bf16, f32 (phase 12c's f32 hold)
    # and int8, and the engine's pool, which its contiguous lanes never run
    # but the (1, 80) instance builds
    _, Hk, G, D = _hybrid_heads()
    hw = dict(Hk=Hk, G=G, D=D)
    for kv in ("bf16", "f32", "int8"):
        cases.append((HYBRID if kv == "bf16" else f"{HYBRID} {kv}",
                      f"phase 12c {HYBRID}: fixed batch ring, {kv}",
                      [P + gen - 1] * FIXED["batch"], P + gen, kv == "int8",
                      False, 0, dict(hw, f32=kv == "f32")))
    cases.append((HYBRID, f"phase 12c {HYBRID}: engine pool (built, off "
                  f"its contiguous path)", engine_rows, S_eng, False, True,
                  ENGINE_POOL_BLOCKS, hw))
    # phase 12d's calls: seamless-m4t-medium (G 1, D 64, 16 KV heads): its
    # self ring at the fixed batch's shape in bf16, f32 (phase 12d's f32
    # hold) and int8, a pool (built, off its path: the family is served
    # on contiguous lanes), and its cross calls over the memory: the fixed
    # batch's 512 frames at B 4 and the long source's 4096 at B 1
    _, Hk, G, D = _encdec_heads()
    hw = dict(Hk=Hk, G=G, D=D)
    for kv in ("bf16", "f32", "int8"):
        cases.append((ENCDEC if kv == "bf16" else f"{ENCDEC} {kv}",
                      f"phase 12d {ENCDEC}: fixed batch self ring, {kv}",
                      [P + gen - 1] * FIXED["batch"], P + gen, kv == "int8",
                      False, 0, dict(hw, f32=kv == "f32")))
    cases.append((ENCDEC, f"phase 12d {ENCDEC}: engine pool (built, off "
                  f"its path)", engine_rows, S_eng, False, True,
                  ENGINE_POOL_BLOCKS, hw))
    for rows_n, F_src in ((FIXED["batch"], P),
                          (ENCDEC_LONG["batch"], ENCDEC_LONG["frames"])):
        cases.append((f"{ENCDEC} cross {F_src}", f"phase 12d {ENCDEC}: "
                      f"cross attention over {F_src} memory slots",
                      [0] * rows_n, F_src, False, False, 0,
                      dict(hw, cross=True)))
    _, Hk, G, D = heads[SERVED[0]]
    hw = dict(Hk=Hk, G=G, D=D)
    cases += [(None, f"main path {SERVED[0]}: phase 3b's generate ring",
               [LONG_PROMPT], LONG_PROMPT + LONG_GEN, False, False, 0, hw),
              (None, f"main path {SERVED[0]}: phase 4d's cut pool",
               engine_rows, S_eng, False, True, SWAP["pool_blocks"], hw)]
    for S in (1024, 4096):
        rows4 = [S - 1, S - 100, 3 * S // 4, S // 2 + 5]
        for int8 in (False, True):
            for paged in (False, True):
                cases.append((None, f"S={S} {'int8' if int8 else 'bf16'}",
                              rows4, S, int8, paged, 0,
                              dict(Hk=Hk, G=G, D=D)))
    rows, flex_cases = {}, []
    for arch, label, q_rows, S, int8, paged, n_blocks, opts in cases:
        name = "flash_decode_paged" if paged else "flash_decode"
        hw = {k: opts[k] for k in ("Hk", "G", "D")}
        args, kw = _decode_case(q_rows, S, int8, paged, n_blocks=n_blocks,
                                wrap=opts.get("wrap", False),
                                f32=opts.get("f32", False),
                                cross=opts.get("cross", False), **hw)
        for k in ("window", "softcap"):
            if opts.get(k):
                kw[k] = opts[k]
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
        nbytes = (q.numel() * q.element_size() + slots * row_bytes + meta
                  + B * H * D * q.element_size())
        flops = 4 * (H // Hk) * D * Hk * slots
        bound, by = _bound_ms(nbytes, flops)
        _cost_rule(f"{name} {label}", fd.flash_decode_cost(*args, **kw),
                   nbytes)
        launch, _ = fd.flash_decode_launcher(*args, **kw)
        per_call = _device_ops_per_call(
            lambda: fd.flash_decode_cuda(*args, **kw))
        grid = launch.grid
        layout = "paged" if paged else "ring"
        print(f"  {name} {label}: G = {H // Hk}, D = {D}, grid "
              f"{grid['splits']} splits x {Hk} heads x {B} rows = "
              f"{grid['blocks']} blocks, cluster {grid['cluster']} "
              f"({grid['resident_clusters']} such clusters fit the card at "
              f"once); the wrapper puts {per_call:g} kernels (and copies or "
              f"fills) on the device a call")
        _check(per_call == 1, f"{name} {label}: the {layout} wrapper ran "
               f"{per_call} device operations a call, not 1")
        resident = fd._max_clusters(layout, q.device, fd._KV_TYPES[k.dtype],
                                    H // Hk, D)
        _check(grid["resident_clusters"] == resident[grid["splits"] - 1],
               f"{name} {label}: splits not sized by this kernel's "
               f"occupancy")
        if arch is not None:
            print(f"  the occupancy query of this call's {layout} kernel "
                  f"({str(k.dtype)[6:]} cache, G = {H // Hk}, D = {D}): "
                  f"clusters of 1..8 blocks resident at once {resident}")
        ms = timer.ms(lambda: fd.flash_decode_cuda(*args, **kw), 50)
        kernel_ms = timer.ms(launch, 50)
        plain = timer.ms(lambda: fd.flash_decode_ref(*args, **kw), 5)
        sq, sk, sv, smask = _sdpa_inputs(args, kw)
        sdpa = timer.ms(lambda: F.scaled_dot_product_attention(
            sq, sk, sv, attn_mask=smask, enable_gqa=True), 50)
        capped = bool(kw.get("softcap"))
        print(f"[{card}] kernel {name} {label} (B={B}, S={S}): wrapper "
              f"{ms:.4f} ms, kernel alone {kernel_ms:.4f} ms, plain "
              f"{plain:.4f} ms, bound {bound:.4f} ms ({by}, "
              f"{nbytes / 1e6:.2f} MB, {slots} slots kept), sdpa "
              f"{'without the softcap ' if capped else ''}{sdpa:.4f} ms")
        if arch is not None:                      # the rows the JSON keeps
            row = dict(max_abs_err=err, ms=ms, kernel_ms=kernel_ms,
                       plain_ms=plain, bound_ms=bound, bound_by=by,
                       library_ms=sdpa, shape=f"{label}, G = {H // Hk}",
                       grid=grid)
            _keep_row(rows, name, arch, row)
            # SDPA has no softcap: with one, flex_attention is the library
            # call that computes the same function, timed below
            if capped:
                flex_cases.append((f"{name} {label}", args, dict(
                    rows=q_rows, S=S, wrap=opts.get("wrap", False),
                    window=kw.get("window", 0), softcap=kw["softcap"],
                    **hw), row))
    floor = timer.ms(lambda: timer.flush[:1].fill_(1.0), 50)
    print(f"[{card}] timer floor: a one-element fill_ reads {floor:.4f} ms "
          f"in this harness (a kernel's gap to its bound reads against it)")
    g = torch.Generator(device="cuda").manual_seed(1)
    paged_heads = dict(heads)
    paged_heads.update({a: h for a, h in _phase12_heads().items()
                        if a != "gemma2-27b"})     # gemma2: contiguous lanes
    for arch, (L, Hk, _, D) in paged_heads.items():
        _keep_row(rows, "paged_block_copy", arch,
                  _cow_event(card, timer, g, arch, L, Hk, D))
    # after every profile of this phase: a profile taken after another
    # process has used the card misses device operations (see
    # ``_flex_library_ms``)
    for label, args, case, row in flex_cases:
        lib = _flex_library_ms(label, args, case)
        print(f"[{card}] kernel {label}: flex_attention {lib:.4f} ms (the "
              f"library call; the kernel {row['ms']:.4f} ms, sdpa without "
              f"the softcap {row['library_ms']:.4f} ms)")
        row.update(library_ms=lib, library="flex_attention",
                   sdpa_without_softcap_ms=row["library_ms"])
    return rows


def _cow_event(card: str, timer: Timer, g, arch: str, L: int, Hk: int,
               D: int) -> dict:
    """One copy-on-write event of the engine's pool (its K, V and kv_pos
    leaves, bf16 and int32) through the kernel: one launch over every leaf,
    held bit for bit against the plain copy; timed beside the three
    one-leaf launches it replaces, the plain version and
    ``torch._foreach_copy_`` (one PyTorch call over the leaves).  Returns
    the event's JSON row."""
    from repro_torch.kernels import flash_decode as fd
    n_blocks, bs = ENGINE_POOL_BLOCKS, ENGINE["block_size"]
    shapes = (("k", (L, n_blocks, bs, Hk, D), torch.bfloat16),
              ("v", (L, n_blocks, bs, Hk, D), torch.bfloat16),
              ("kv_pos", (L, n_blocks, bs), torch.int32))
    leaves = [torch.randint(-1000, 1000, shape, generator=g, device="cuda",
                            dtype=torch.int32).to(dtype)
              for _, shape, dtype in shapes]
    wants = [leaf.clone() for leaf in leaves]
    fd.paged_block_copy_leaves_ref(wants, 5, 40)
    fd.paged_block_copy_leaves_cuda(leaves, 5, 40)
    torch.cuda.synchronize()
    for (name, _, _), leaf, want in zip(shapes, leaves, wants):
        _check(torch.equal(leaf, want), f"block copy {arch} {name} not "
               f"exact")
    del wants
    nbytes = sum(2 * leaf.shape[0] * leaf[0, 0].numel() * leaf.element_size()
                 for leaf in leaves)
    bound, by = _bound_ms(nbytes, 0.0)
    _cost_rule(f"paged_block_copy {arch}", fd.paged_block_copy_cost(leaves),
               nbytes)
    ms = timer.ms(lambda: fd.paged_block_copy_leaves_cuda(leaves, 5, 40), 50)

    def one_leaf_each():
        for leaf in leaves:
            fd.paged_block_copy_cuda(leaf, 5, 40)

    per_leaf = timer.ms(one_leaf_each, 50)
    k_alone = timer.ms(lambda: fd.paged_block_copy_cuda(leaves[0], 5, 40),
                       50)
    plain = timer.ms(lambda: fd.paged_block_copy_leaves_ref(leaves, 5, 40),
                     50)
    lib = timer.ms(lambda: torch._foreach_copy_(
        [leaf[:, 40] for leaf in leaves], [leaf[:, 5] for leaf in leaves]),
        50)
    shown = ", ".join(f"{name} {tuple(shape)} {str(dtype)[6:]}"
                      for name, shape, dtype in shapes)
    print(f"[{card}] kernel paged_block_copy {arch} CoW event ({shown}): "
          f"max_abs_err 0 (exact), one launch {ms:.4f} ms, one launch a "
          f"leaf {per_leaf:.4f} ms (k alone {k_alone:.4f}), plain "
          f"{plain:.4f} ms, bound {bound:.4f} ms ({by}, "
          f"{nbytes / 1e6:.2f} MB), _foreach_copy_ {lib:.4f} ms")
    return dict(max_abs_err=0.0, ms=ms, kernel_ms=ms, plain_ms=plain,
                bound_ms=bound, bound_by=by, library_ms=lib,
                one_leaf_launches_ms=per_leaf, k_leaf_ms=k_alone,
                shape=f"{arch} engine pool CoW event: {shown}")


def _keep_row(rows: dict, name: str, arch: str, row: dict) -> None:
    """The JSON row of ``name``: the first served config's at the top,
    the others' nested under their names."""
    if arch == SERVED[0]:
        rows[name] = {**row, **rows.get(name, {})}
    else:
        rows.setdefault(name, {})[arch] = row


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
            _cost_rule(f"wire_hop_{wire} {form}",
                       wh.wire_hop_cost(*args, **kw), nbytes)
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
    (bf16 products on the tensor cores; f32 matrix products as 3xTF32 on
    them; rmsnorm's f32 arithmetic on the CUDA cores)."""
    if args[0].dtype == torch.bfloat16:
        rate = BF16_FLOPS
    else:
        rate = F32_FLOPS if name == "rmsnorm" else F32_MATMUL_FLOPS
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
        _cost_rule(f"{name} {label}",
                   getattr(mods[name], f"{name}_cost")(*args), mb * 1e6)
        heavy = name == "qlora_matmul" and args[0].numel() > 10 ** 6
        ms = timer.ms(lambda: _ops_call(name, args), 20)
        launch, _ = launchers[name](*args)
        kernel_ms = timer.ms(launch, 20)
        plain_fn = getattr(mods[name], f"{name}_ref")
        plain = timer.ms(lambda: plain_fn(*args), 3 if heavy else 10)
        lib = timer.ms(_ops_library(name, args), 20)
        layout = ""
        if name == "rmsnorm":
            x = args[0]
            layout = ", layout " + str(tuple(rn.rmsnorm_layout(
                x.numel() // x.shape[-1], x.shape[-1], x.element_size(),
                torch.cuda.get_device_properties(0).multi_processor_count)))
        print(f"[{card}] kernel {name} {label}: wrapper {ms:.4f} ms, kernel "
              f"alone {kernel_ms:.4f} ms, plain {plain:.4f} ms, bound "
              f"{bound:.4f} ms ({by}, {mb:.2f} MB), library {lib:.4f} ms"
              f"{layout}")
        if label.startswith("fit"):               # the rows the JSON keeps
            rows[name] = dict(max_abs_err=err, ms=ms, kernel_ms=kernel_ms,
                              plain_ms=plain, bound_ms=bound, bound_by=by,
                              library_ms=lib, shape=label)
    return rows, launches


# ---------------------------------------------------------------------------
# phases 3-4: the main path at full width
# ---------------------------------------------------------------------------

def _engine_trace(cfg, gen: int = 16):
    """Eight Poisson requests from the launcher's trace maker plus a
    shared-prefix cluster: a donor, a divergent tail and two identical
    replays of a 40-token core, each ``gen`` new tokens.  The core ends
    inside its third 16-slot block, so a replay's first own token lands in
    a shared block and copy-on-write fires."""
    from repro_torch.launch.serve import make_trace
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


def phase_main_path(card: str, arch: str) -> dict:
    """Serve ``arch`` at full width with random bf16 weights drawn on the
    card (phases 3-4, or 4b): the fixed batch over the ring, then the
    engine over the paged pool.  The launch counts are set to 0 just before
    and read just after; a few of the run's own flash-decode calls are held
    against the plain version; the weights and caches are freed on
    return."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.models.registry import get_model
    cfg = get_config(arch)
    G = cfg.num_heads // cfg.num_kv_heads
    print(f"[{card}] serve {cfg.name}: {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads of "
          f"{cfg.head_dim} (G = {G}), vocab {cfg.vocab_size}, "
          f"{cfg.param_dtype}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = get_model(cfg).init(cfg, gen, device="cuda")
    with _CallRecorder(fd) as recorder:
        launches = _run_main_path(card, cfg, params)
    del params
    print(f"[{card}] serve {cfg.name}: {time.perf_counter() - t0:.1f} s "
          f"with the weights' init, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    print(f"[{card}] {cfg.name}: the main path's own flash-decode calls "
          f"(G = {G}), held against the plain version on copies of their "
          f"inputs:")
    for label, args, kw, out in recorder.calls:
        _check(args[0].shape[2] == G * args[1].shape[2],
               f"{label}: a call of another head geometry")
        _hold_to_plain(f"{label}, q {tuple(args[0].shape)}, k "
                       f"{tuple(args[1].shape)}", args, kw, got=out)
    _check({l.split()[0] for l, *_ in recorder.calls} == {"ring", "paged"},
           "no main-path call of each layout was recorded")
    del recorder
    torch.cuda.empty_cache()
    return launches


@contextlib.contextmanager
def _checked_logits(module=None):
    """Keeps a finiteness flag of every logits tensor the model computes
    while it is open (a list, yielded): the trunk's, or ``module``'s (a
    model module that imported ``logits_fn``)."""
    from repro_torch.models import transformer
    module = module or transformer
    finite = []
    real = module.logits_fn

    def checked_logits(*a, **k):
        lg = real(*a, **k)
        finite.append(torch.isfinite(lg).all())
        return lg

    module.logits_fn = checked_logits
    try:
        yield finite
    finally:
        module.logits_fn = real


def _run_main_path(card: str, cfg, params) -> dict:
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.launch.serve import run_engine, run_fixed_batch

    fd.reset_launches()
    t0 = time.perf_counter()
    res = run_fixed_batch(cfg, params, device="cuda", quiet=True, **FIXED)
    wall = time.perf_counter() - t0
    _check(res["finite"], "fixed batch: non-finite logits")
    _check(res["tokens"].shape == (4, 65), "fixed batch: token shape")
    fixed_launches = dict(fd.LAUNCHES)
    _check(fixed_launches["flash_decode"] == 64 * cfg.num_layers,
           f"fixed batch: {fixed_launches} contiguous launches")
    print(f"[{card}] fixed batch {cfg.name} full width: prefill 4x512 "
          f"{res['prefill_tok_per_s']:.0f} tok/s, decode first step "
          f"{res['first_step_s']:.3f} s, steady "
          f"{res['decode_tok_per_s']:.1f} tok/s (63 steps x 4), "
          f"wall {wall:.1f} s, launches {fixed_launches}")

    trace = _engine_trace(cfg)
    with _checked_logits() as finite:
        t0 = time.perf_counter()
        done, summ, engine = run_engine(cfg, params, trace, device="cuda",
                                        quiet=True, **ENGINE)
        wall = time.perf_counter() - t0
    launches = dict(fd.LAUNCHES)
    _check(len(done) == len(trace), "engine: not every request finished")
    for r in trace:
        _check(len(done[r["id"]].tokens) == r["max_new_tokens"],
               f"engine: {r['id']} stopped short")
    _check(finite and all(bool(f) for f in finite),
           "engine: non-finite logits")
    _check(summ["cow_copies"] >= 1, "engine: copy-on-write never fired")
    _check(summ["full_prompt_hits"] >= 1, "engine: no full-prompt hit")
    engine.pool.assert_partition()
    _check(engine.pool.blocks_in_use == 0, "engine: blocks leaked")
    _check(engine.pool.pool_blocks == ENGINE_POOL_BLOCKS,
           "engine: pool geometry differs from the one phase 2 checks")
    for name in ("flash_decode", "flash_decode_paged", "paged_block_copy"):
        _check(launches[name] > 0,
               f"main path never launched {name}")
    _check(launches["paged_block_copy"] == summ["cow_copies"],
           f"engine: {launches['paged_block_copy']} block-copy launches for "
           f"{summ['cow_copies']} copy-on-write events, not one each")
    print(f"[{card}] engine {cfg.name} full width, paged + prefix sharing: "
          f"{summ['requests']} requests, {summ['decode_tokens']} decode "
          f"tokens in {summ['decode_steps']} steps, "
          f"{summ['steady_tok_per_s']:.1f} tok/s steady, itl p50 "
          f"{summ['itl_p50_s'] * 1e3:.2f} ms, ttft p50 "
          f"{summ['ttft_p50_s'] * 1e3:.1f} ms, share hits "
          f"{summ['share_hits']} ({summ['full_prompt_hits']} full), cow "
          f"{summ['cow_copies']}, {len(finite)} logits tensors finite, "
          f"wall {wall:.1f} s")
    print(f"[{card}] {cfg.name} main-path launches (fixed batch + engine): "
          f"{launches}")
    return launches


# ---------------------------------------------------------------------------
# phase 12: the rest of the dense family and the MoE family at full width
# ---------------------------------------------------------------------------

def _gib(n: float) -> float:
    return n / 2 ** 30


def _hold_recorded(label: str, recorder, G: int) -> int:
    """Hold a recorder's calls against the plain version on copies of
    their inputs; returns how many."""
    for what, args, kw, out in recorder.calls:
        _check(args[0].shape[2] == G * args[1].shape[2],
               f"{label} {what}: a call of another head geometry")
        _hold_to_plain(f"{label} {what}, q {tuple(args[0].shape)}, k "
                       f"{tuple(args[1].shape)}, window "
                       f"{kw.get('window', 0)}, softcap "
                       f"{kw.get('softcap', 0.0):g}", args, kw, got=out)
    return len(recorder.calls)


def _run_contiguous_path(card: str, cfg, params) -> dict:
    """An alternating config (gemma2-27b) through the fixed-batch launcher
    and then the engine, which keeps contiguous lanes for its local and
    global rings (as the reference's does): every request finished, every
    logits tensor finite, no paged launch.  Returns the launch counts,
    set to 0 at the start."""
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.launch.serve import run_engine, run_fixed_batch
    fd.reset_launches()
    t0 = time.perf_counter()
    res = run_fixed_batch(cfg, params, device="cuda", quiet=True, **FIXED)
    wall = time.perf_counter() - t0
    _check(res["finite"], f"{cfg.name} fixed batch: non-finite logits")
    _check(res["tokens"].shape == (FIXED["batch"], FIXED["gen"] + 1),
           f"{cfg.name} fixed batch: token shape")
    fixed = dict(fd.LAUNCHES)
    _check(fixed["flash_decode"] == FIXED["gen"] * cfg.num_layers,
           f"{cfg.name} fixed batch: {fixed} launches")
    print(f"[{card}] fixed batch {cfg.name}: prefill 4x512 "
          f"{res['prefill_tok_per_s']:.0f} tok/s, decode first step "
          f"{res['first_step_s']:.3f} s, steady "
          f"{res['decode_tok_per_s']:.1f} tok/s (63 steps x 4), wall "
          f"{wall:.1f} s, launches {fixed}")
    trace = _engine_trace(cfg)
    with _checked_logits() as finite:
        t0 = time.perf_counter()
        done, summ, engine = run_engine(
            cfg, params, trace, device="cuda", quiet=True,
            slots=ENGINE["slots"], cache_len=ENGINE["cache_len"])
        wall = time.perf_counter() - t0
    launches = dict(fd.LAUNCHES)
    _check(not engine.paged and set(engine.pool.cache) == {"local",
                                                           "global"},
           f"{cfg.name} engine: not on contiguous local/global lanes")
    _check(len(done) == len(trace), f"{cfg.name} engine: not every request "
           f"finished")
    for r in trace:
        _check(len(done[r["id"]].tokens) == r["max_new_tokens"],
               f"{cfg.name} engine: {r['id']} stopped short")
    _check(finite and all(bool(f) for f in finite),
           f"{cfg.name} engine: non-finite logits")
    _check(launches["flash_decode"] > fixed["flash_decode"]
           and launches["flash_decode_paged"] == 0
           and launches["paged_block_copy"] == 0,
           f"{cfg.name} engine: launches {launches}")
    print(f"[{card}] engine {cfg.name}, contiguous local/global lanes: "
          f"{summ['requests']} requests, {summ['decode_tokens']} decode "
          f"tokens in {summ['decode_steps']} steps, "
          f"{summ['steady_tok_per_s']:.1f} tok/s steady, itl p50 "
          f"{summ['itl_p50_s'] * 1e3:.2f} ms, ttft p50 "
          f"{summ['ttft_p50_s'] * 1e3:.1f} ms, {len(finite)} logits "
          f"tensors finite, wall {wall:.1f} s")
    return launches


def _long_row(card: str, cfg, params) -> int:
    """One row whose 4608-token prompt runs past the 4096 window: gemma2
    through the fixed-batch launcher (a blockwise prefill; the local rings
    wrap, the global rings hold the whole row), mixtral through the paged
    engine (its every ring wraps).  The first step's first two
    flash-decode calls are held against the plain version.  Returns the
    number held."""
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.launch.serve import run_engine, run_fixed_batch
    P, gen = LONG_ROW["prompt"], LONG_ROW["gen"]
    G = cfg.num_heads // cfg.num_kv_heads
    W = cfg.sliding_window
    t0 = time.perf_counter()
    with _CallRecorder(fd, every=1, keep=2) as rec:
        if cfg.local_global_alternating:
            res = run_fixed_batch(cfg, params, batch=1, prompt_len=P,
                                  gen=gen, device="cuda", quiet=True)
            _check(res["finite"] and res["tokens"].shape == (1, gen + 1),
                   f"{cfg.name} long row: non-finite logits or short")
        else:
            rng = np.random.default_rng(2)
            trace = [{"id": "long", "prompt": rng.integers(
                0, cfg.vocab_size, P).tolist(), "max_new_tokens": gen,
                "arrival_step": 0}]
            with _checked_logits() as finite:
                done, summ, engine = run_engine(
                    cfg, params, trace, device="cuda", quiet=True, slots=2,
                    cache_len=P + gen)
            _check(engine.paged and engine.pool.ring_len == W,
                   f"{cfg.name} long row: not a paged ring of the window")
            _check(len(done["long"].tokens) == gen and finite
                   and all(bool(f) for f in finite),
                   f"{cfg.name} long row: short or non-finite")
            engine.pool.assert_partition()
    wall = time.perf_counter() - t0
    layouts = {w.split()[0] for w, *_ in rec.calls}
    _check(len(rec.calls) == 2,
           f"{cfg.name} long row: {len(rec.calls)} calls recorded")
    for what, args, kw, _ in rec.calls:
        q_pos = int(fd._rows(args[4], args[0].shape[0], args[0].device)[0])
        kvp = args[3][0] if kw.get("block_tables") is None else \
            fd.paged_gather(args[1], args[2], args[3], None, None,
                            kw["block_tables"])[2][0]
        valid = kvp[kvp >= 0]
        print(f"  {cfg.name} long row {what}: q_pos {q_pos}, ring "
              f"{kvp.numel()} slots, positions {int(valid.min())}.."
              f"{int(valid.max())}, window {kw.get('window', 0)}")
        if kw.get("window"):
            _check(kvp.numel() == W and int(valid.min()) > 0
                   and int(valid.max()) == q_pos,
                   f"{cfg.name} long row {what}: the windowed ring did not "
                   f"wrap")
    print(f"[{card}] {cfg.name} long row ({P}-token prompt, {gen} steps, "
          f"{'/'.join(sorted(layouts))}): wall {wall:.1f} s")
    return _hold_recorded(f"{cfg.name} long row", rec, G)


def phase_families(card: str) -> dict:
    """Serve each of PHASE12's configs at its published width (mixtral at
    16 of 32 layers) with random bf16 weights drawn on the card: the fixed
    batch (4 x 512, 64 steps) over the ring, then the engine (the paged
    pool with prefix sharing and copy-on-write; gemma2 on contiguous
    lanes), and for gemma2 and mixtral one row past the window.  Prints
    each model's init peak and run peak; returns each model's launch
    counts, set to 0 at its start and read at its end."""
    from repro_torch import tree as tree_util
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.models.registry import get_model
    out = {}
    t_all = time.perf_counter()
    for arch, layers in PHASE12:
        cfg = _phase12_config(arch, layers)
        G = cfg.num_heads // cfg.num_kv_heads
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = get_model(cfg).init(
            cfg, torch.Generator(device="cuda").manual_seed(0),
            device="cuda")
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        init_peak = torch.cuda.max_memory_allocated() - base
        weights = sum(t.numel() * t.element_size()
                      for t in tree_util.leaves(params))
        cut = (f" (cut from {_phase12_config(arch, 0).num_layers})"
               if layers else "")
        print(f"[{card}] phase 12 {cfg.name}: {cfg.num_layers} layers"
              f"{cut}, d_model {cfg.d_model}, {cfg.num_heads}/"
              f"{cfg.num_kv_heads} heads of {cfg.head_dim} (G = {G}), "
              f"vocab {cfg.vocab_size}"
              + (f", {cfg.moe.num_experts} experts top-{cfg.moe.top_k}"
                 f" (+{cfg.moe.num_shared_experts} shared)"
                 if cfg.moe else "")
              + f": weights {_gib(weights):.2f} GiB ({weights / 1e9:.2f} "
              f"GB) drawn in {init_s:.1f} s, init peak "
              f"{_gib(init_peak):.2f} GiB over what was held before")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with _CallRecorder(fd, every=500, keep=3) as rec:
            if cfg.local_global_alternating:
                _run_contiguous_path(card, cfg, params)
            else:
                _run_main_path(card, cfg, params)
        held = _hold_recorded(f"phase 12 {cfg.name}", rec, G)
        if cfg.sliding_window:
            held += _long_row(card, cfg, params)
        launches = dict(fd.LAUNCHES)
        _check(launches["flash_decode"] > 0,
               f"phase 12 {cfg.name}: no ring flash-decode launch")
        if not cfg.local_global_alternating:
            _check(launches["flash_decode_paged"] > 0
                   and launches["paged_block_copy"] > 0,
                   f"phase 12 {cfg.name}: paged launches {launches}")
        _check(held >= 3, f"phase 12 {cfg.name}: only {held} of its calls "
               f"held to the plain version")
        peak = torch.cuda.max_memory_allocated() - base
        print(f"[{card}] phase 12 {cfg.name}: {time.perf_counter() - t0:.1f}"
              f" s served, peak device memory {_gib(peak):.2f} GiB "
              f"(weights {_gib(weights):.2f}), {held} of its own "
              f"flash-decode calls held to the plain version, launches "
              f"{launches}")
        out[arch] = launches
        del params, rec
        torch.cuda.empty_cache()
    print(f"[{card}] phase 12 wall {time.perf_counter() - t_all:.1f} s "
          f"(host clock)")
    return out


# ---------------------------------------------------------------------------
# phase 12b: the recurrent family (xlstm-350m) at full width
# ---------------------------------------------------------------------------

# The recurrent families' traffic (phases 12b and 12c): the fixed batch
# is FIXED (4 x 512, 64 steps); then one 500-token row (padded to four
# 128-token chunks; 16 steps); prefill of a 512-token prompt (a chunk
# multiple) + RECURRENT_K decode steps against a prefill of the prompt and
# those tokens; the engine on contiguous lanes: RECURRENT_ENGINE's Poisson
# trace, one request a slot.
RECURRENT_SHORT = dict(batch=1, prompt_len=500, gen=16)
RECURRENT_K = 3
RECURRENT_ENGINE = dict(requests=12, slots=12, gen=32, max_prompt=512,
                        rate=1.0)
# Prefill + RECURRENT_K decode steps against one longer prefill, in f32 at
# the published widths: the chunkwise and the recurrent forms round in
# another order, and xlstm-350m at random weights amplifies a rounding
# through its 24 blocks (``tools/xlstm_sensitivity.py``: 1e-6 of
# relative noise on the embeddings moves position 511's f32 logits by
# tenths; in bf16 one prompt at batch 4 and at batch 2 gives logits units
# apart), so the check is made in f32, beside two prefills whose GEMMs
# round apart and a planted wrong token (read: 0.0299, the two prefills
# 0.0672, planted 6.25; bf16 3.85).
XLSTM_LOGIT_TOL = 0.2


@contextlib.contextmanager
def _slstm_walls():
    """The wall of every ``slstm_block_forward`` call while it is open (a
    list of seconds, yielded; the card synchronised around each)."""
    from repro_torch.models import xlstm_model
    walls = []
    real = xlstm_model.slstm_block_forward

    def timed(*a, **k):
        out, wall = _timed("cuda", real, *a, **k)
        walls.append(wall)
        return out

    xlstm_model.slstm_block_forward = timed
    try:
        yield walls
    finally:
        xlstm_model.slstm_block_forward = real


@contextlib.contextmanager
def _retired_lanes():
    """Snapshots of each lane's state as its request retires (a list of
    ``(slot, engine step, leaves)``, yielded)."""
    from repro_torch import tree as tree_util
    from repro_torch.serve.engine import ForecastEngine
    real = ForecastEngine._retire
    snaps = []

    def retire(self, st, reason):
        axes = tree_util.leaves(self.pool.batch_axes)
        snaps.append((st.slot, self.step_count, [
            leaf.select(ax, st.slot).clone() for leaf, ax in
            zip(tree_util.leaves(self.pool.cache), axes)]))
        return real(self, st, reason)

    ForecastEngine._retire = retire
    try:
        yield snaps
    finally:
        ForecastEngine._retire = real


def _lanes_path_tokens(cfg, params, trace, slots: int,
                       cache_len: int) -> dict:
    """The fixed-batch path fed the engine's prompts: each prompt
    prefilled alone (batch 1, as the engine prefills it) into lane i of a
    pool of ``slots`` lanes of ``cache_len``, then synchronous greedy
    decode steps of every lane at once, each at its own position (a decode
    computes each row alone, so a lane's tokens do not depend on the
    others')."""
    from repro_torch.models.registry import get_model
    from repro_torch.serve.cache_pool import CachePool
    api = get_model(cfg)
    pool = CachePool(cfg, slots, cache_len, device="cuda")
    first = torch.zeros((slots, 1), dtype=torch.int64, device="cuda")
    pos = torch.zeros((slots,), dtype=torch.int32, device="cuda")
    for i, r in enumerate(trace):
        c1, lg = api.prefill(params, cfg, {"tokens": torch.tensor(
            [r["prompt"]], device="cuda")}, cache_len=cache_len)
        pool.insert(c1, i)
        first[i, 0] = lg[0, -1].argmax()
        pos[i] = len(r["prompt"])
        del c1
    tok, out = first, [first]
    for t in range(max(r["max_new_tokens"] for r in trace) - 1):
        lg, new = api.decode_step(params, cfg, pool.cache,
                                  {"token": tok, "pos": pos + t})
        pool.cache = new
        tok = lg[:, -1].argmax(dim=-1)[:, None]
        out.append(tok)
    toks = torch.cat(out, 1).cpu().numpy()
    return {r["id"]: toks[i, :r["max_new_tokens"]].tolist()
            for i, r in enumerate(trace)}


def _decode_vs_prefill(cfg, api, params=None) -> tuple:
    """(logits max error of prefill + RECURRENT_K decode steps against a
    prefill of the prompt and those tokens; the gap between that prefill
    at batch 4 and at batch 2 on its first two rows; the error with the
    first decode step fed a wrong token), at the published widths in f32
    (``params`` None: drawn here) or with ``params``.  The prefill's rings
    (a hybrid's, an encoder-decoder's) hold the decode steps too; an
    encoder-decoder's prefills read one source, ``_seeded_frames``."""
    if params is None:
        cfg = cfg.replace(param_dtype="float32", compute_dtype="float32")
        params = api.init(cfg, torch.Generator(device="cuda").manual_seed(
            0), device="cuda")
    P, k, B = FIXED["prompt_len"], RECURRENT_K, FIXED["batch"]
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (B, P + k)), device="cuda")
    # an encoder-decoder's source: P seeded frames a row, the same for
    # every prefill (zero frames would make the memory degenerate)
    src = ({"frames": _seeded_frames(cfg, B, P, 4)}
           if cfg.family == "encdec" else {})

    def rows(n):
        return {name: x[:n] for name, x in src.items()}

    def decoded(first):
        cache, lg = api.prefill(params, cfg, {"tokens": toks[:, :P],
                                              **src}, cache_len=P + k)
        for i in range(k):
            tok = toks[:, P + i:P + i + 1]
            lg, cache = api.decode_step(params, cfg, cache, {
                "token": tok if i else first(tok), "pos": P + i})
        return lg.float()

    def gap(a, b):
        return float((a.float() - b.float()).abs().max())

    _, want = api.prefill(params, cfg, {"tokens": toks, **src})
    _, half = api.prefill(params, cfg, {"tokens": toks[:2], **rows(2)})
    return (gap(decoded(lambda t: t), want), gap(want[:2], half),
            gap(decoded(lambda t: (t + 1) % cfg.vocab_size), want))


def phase_recurrent(card: str) -> None:
    """Phase 12b: serve xlstm-350m at its published widths (24 layers:
    20 mLSTM and 4 sLSTM blocks, d_model 1024, 4 heads, vocab 50,304, bf16)
    with random weights drawn on the card from a seed: the fixed batch, a
    500-token row on the padded chunk path, prefill + decode against a
    longer prefill, then the engine on contiguous lanes, its greedy tokens
    against the fixed-batch path fed the same prompts and a retired lane's
    state held bit for bit.  xLSTM launches no kernel of the port: every
    launch count, set to 0 before, reads 0 after."""
    from repro_torch import tree as tree_util
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import make_trace, run_engine, \
        run_fixed_batch
    from repro_torch.models import xlstm_model
    from repro_torch.models.registry import get_model
    t_all = time.perf_counter()
    for mod in _kernel_modules():
        mod.reset_launches()
    cfg = get_config("xlstm-350m")
    api = get_model(cfg)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = api.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                      device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights = sum(t.numel() * t.element_size()
                  for t in tree_util.leaves(params))
    print(f"[{card}] phase 12b {cfg.name}: {cfg.num_layers} layers (sLSTM "
          f"every {cfg.xlstm.slstm_every}th), d_model {cfg.d_model}, "
          f"{cfg.num_heads} heads, mLSTM proj {cfg.xlstm.mlstm_proj_factor}"
          f", conv {cfg.xlstm.conv_width}, chunk {cfg.xlstm.chunk_size}, "
          f"vocab {cfg.vocab_size}, {cfg.param_dtype}: weights "
          f"{_gib(weights):.2f} GiB ({weights / 1e9:.3f} GB) drawn in "
          f"{init_s:.1f} s, init peak "
          f"{_gib(torch.cuda.max_memory_allocated() - base):.2f} GiB")
    torch.cuda.reset_peak_memory_stats()

    # the fixed batch, and one row on the padded chunk path
    with _slstm_walls() as walls:
        t0 = time.perf_counter()
        res = run_fixed_batch(cfg, params, device="cuda", quiet=True,
                              **FIXED)
        wall = time.perf_counter() - t0
    _check(res["finite"], "phase 12b fixed batch: non-finite logits")
    _check(res["tokens"].shape == (FIXED["batch"], FIXED["gen"] + 1),
           "phase 12b fixed batch: token shape")
    print(f"[{card}] phase 12b fixed batch {cfg.name}: prefill "
          f"{FIXED['batch']}x{FIXED['prompt_len']} "
          f"{res['prefill_tok_per_s']:.0f} tok/s (its 4 sLSTM blocks' "
          f"one-position-a-step loops {sum(walls):.3f} s: "
          + ", ".join(f"{w:.3f}" for w in walls) + " s), decode first step "
          f"{res['first_step_s']:.3f} s, steady {res['decode_tok_per_s']:.1f}"
          f" tok/s ({FIXED['gen'] - 1} steps x {FIXED['batch']}), wall "
          f"{wall:.1f} s")
    short = run_fixed_batch(cfg, params, device="cuda", quiet=True,
                            **RECURRENT_SHORT)
    _check(short["finite"] and short["tokens"].shape == (
        1, RECURRENT_SHORT["gen"] + 1), "phase 12b: the 500-token row is "
        "non-finite or short")
    chunk = cfg.xlstm.chunk_size
    print(f"[{card}] phase 12b one {RECURRENT_SHORT['prompt_len']}-token "
          f"row (padded to "
          f"{-(-RECURRENT_SHORT['prompt_len'] // chunk) * chunk}): prefill"
          f" {short['prefill_tok_per_s']:.0f} tok/s, steady "
          f"{short['decode_tok_per_s']:.1f} tok/s, finite")

    # prefill + k decode steps against the longer prefill, held in f32
    err, noise, planted = _decode_vs_prefill(cfg, api)
    bf16 = _decode_vs_prefill(cfg, api, params)[0]
    _check(err <= XLSTM_LOGIT_TOL and planted > XLSTM_LOGIT_TOL,
           f"phase 12b: prefill + {RECURRENT_K} decode steps vs the "
           f"longer prefill (f32): logits max err {err}, planted {planted}, "
           f"tol "
           f"{XLSTM_LOGIT_TOL}")
    print(f"[{card}] phase 12b prefill {FIXED['batch']}x"
          f"{FIXED['prompt_len']} + {RECURRENT_K} decode steps vs a prefill "
          f"of {FIXED['prompt_len'] + RECURRENT_K} tokens, at full width in "
          f"f32: "
          f"logits max_abs_err {err:.4g} (tol {XLSTM_LOGIT_TOL}); two "
          f"prefills of those tokens at batch 4 and 2 (their GEMMs round "
          f"apart) {noise:.4g}; planted (decode fed one wrong token) "
          f"{planted:.4g}; the same comparison in bf16 {bf16:.4g} (random "
          f"weights amplify a rounding through 24 blocks)")

    # the engine on contiguous lanes
    E = RECURRENT_ENGINE
    trace = make_trace(cfg, E["requests"], gen=E["gen"],
                       max_prompt=E["max_prompt"], rate=E["rate"], seed=0)
    cache_len = max(len(r["prompt"]) for r in trace) + E["gen"]
    with _retired_lanes() as snaps, \
            _checked_logits(xlstm_model) as finite:
        t0 = time.perf_counter()
        done, summ, engine = run_engine(cfg, params, trace, device="cuda",
                                        quiet=True, slots=E["slots"],
                                        cache_len=cache_len)
        wall = time.perf_counter() - t0
    _check(not engine.paged, "phase 12b engine: not on contiguous lanes")
    _check(len(done) == len(trace), "phase 12b engine: not every request "
           "finished")
    for r in trace:
        _check(len(done[r["id"]].tokens) == r["max_new_tokens"],
               f"phase 12b engine: {r['id']} stopped short")
    _check(finite and all(bool(f) for f in finite),
           "phase 12b engine: non-finite logits")
    last = engine.step_count
    frozen = [(slot, at) for slot, at, leaves in snaps if at < last]
    for slot, at, leaves in snaps:
        now = [leaf.select(ax, slot) for leaf, ax in zip(
            tree_util.leaves(engine.pool.cache),
            tree_util.leaves(engine.pool.batch_axes))]
        _check(all(_bits_equal(a, b) for a, b in zip(now, leaves)),
               f"phase 12b engine: retired lane {slot} (step {at}) drifted "
               f"by step {last}")
    _check(len(frozen) >= 1, "phase 12b engine: no lane retired before the "
           "last step")
    got = {r["id"]: done[r["id"]].tokens.tolist() for r in trace}
    want = _lanes_path_tokens(cfg, params, trace, E["slots"], cache_len)
    _check(got == want, "phase 12b engine: greedy tokens differ from the "
           "fixed-batch path's on the same prompts: " + str(
               [i for i in got if got[i] != want[i]]))
    lens = sorted(len(r["prompt"]) for r in trace)
    print(f"[{card}] phase 12b engine {cfg.name}, contiguous lanes: "
          f"{summ['requests']} requests (prompts {lens[0]}-{lens[-1]} "
          f"tokens, {sum(n % chunk != 0 for n in lens)} padded), "
          f"{summ['decode_tokens']} decode tokens in {summ['decode_steps']} "
          f"steps, {summ['steady_tok_per_s']:.1f} tok/s steady, itl p50 "
          f"{summ['itl_p50_s'] * 1e3:.2f} ms, ttft p50 "
          f"{summ['ttft_p50_s'] * 1e3:.1f} ms, {len(finite)} logits tensors "
          f"finite, greedy tokens equal to the fixed-batch path's on the "
          f"same prompts, {len(frozen)} retired lanes held bit for bit "
          f"through up to {max(last - at for _, at in frozen)} later steps; "
          f"wall {wall:.1f} s")
    launches = {k: v for mod in _kernel_modules()
                for k, v in mod.LAUNCHES.items()}
    _check(not any(launches.values()), f"phase 12b: a kernel launched on "
           f"the xLSTM path, which reaches none: {launches}")
    peak = torch.cuda.max_memory_allocated() - base
    print(f"[{card}] phase 12b {cfg.name}: run peak {_gib(peak):.2f} GiB "
          f"(weights {_gib(weights):.2f}); kernel launches {launches}; "
          f"phase 12b wall {time.perf_counter() - t_all:.1f} s (host clock)")
    del params, engine
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 12c: the hybrid family (zamba2-2.7b) at full width
# ---------------------------------------------------------------------------

# zamba2-2.7b at its published widths and depth, no cut: 54 Mamba2 layers
# and 9 applications of 2 weight-shared attention blocks (32 heads of 80,
# G 1: flash-decode's (1, 80) instance), through the recurrent families'
# traffic (RECURRENT_SHORT, RECURRENT_K, RECURRENT_ENGINE), so the two are
# read at one geometry.
HYBRID = "zamba2-2.7b"
# Prefill + RECURRENT_K decode steps against one longer prefill, in f32 at the
# published widths: the chunked and the recurrent SSD forms and the
# flash-decode kernel against the prefill's attention round in another
# order, so the hold is made in f32 beside two prefills whose GEMMs round
# apart and a planted wrong token, as phase 12b's (read: 1.06e-4, the two
# prefills 9.2e-5, planted 4.93; bf16 0.242: Mamba2's decays are at most
# 1, and zamba2 does not amplify a rounding as xlstm-350m does).
HYBRID_LOGIT_TOL = 0.01


def _hybrid_heads():
    """(layers, Hk, G, D) of phase 12c's shared attention: one ring a
    group, 9 at the published depth."""
    from repro_torch.configs import get_config
    cfg = get_config(HYBRID)
    return (cfg.num_layers // cfg.hybrid.shared_attn_every,
            cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads,
            cfg.head_dim)


@contextlib.contextmanager
def _counted_calls(module, name: str):
    """How many times ``module.name`` is called while it is open (a
    one-element list, yielded)."""
    real = getattr(module, name)
    calls = [0]

    def counted(*a, **k):
        calls[0] += 1
        return real(*a, **k)

    setattr(module, name, counted)
    try:
        yield calls
    finally:
        setattr(module, name, real)


def _launch_delta(before: dict, label: str, steps: int,
                  per_step: int, phase: str = "12c") -> dict:
    """The flash-decode launches since ``before``, checked to be exactly
    ``per_step`` ring launches a decode step and no paged launch or block
    copy.  Returns the counts now."""
    from repro_torch.kernels import flash_decode as fd
    now = dict(fd.LAUNCHES)
    delta = {k: now[k] - before[k] for k in now}
    _check(delta == {"flash_decode": per_step * steps,
                     "flash_decode_paged": 0, "paged_block_copy": 0},
           f"phase {phase} {label}: launches {delta} for {steps} decode "
           f"steps, not {per_step} ring launches each")
    return now


def phase_hybrid(card: str) -> dict:
    """Phase 12c: serve zamba2-2.7b at its published widths (54 Mamba2
    layers, d_model 2560, 80 SSM heads of 64, state 64; 2 shared blocks
    applied 9 times, 32 heads of 80; vocab 32,000; bf16) with random
    weights drawn on the card from a seed: the fixed batch, a 500-token
    row on the padded chunk path, prefill + decode against a longer
    prefill in f32, then the engine on contiguous lanes, its greedy tokens
    against the fixed-batch path fed the same prompts and a retired lane's
    state held bit for bit.  Every decode step launches one ring
    flash-decode (the (1, 80) instance) a shared-block application and
    nothing else; a few of those calls are held to the plain version.
    Returns the launch counts, set to 0 at the start and read at the end."""
    from repro_torch import tree as tree_util
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.launch.serve import make_trace, run_engine, \
        run_fixed_batch
    from repro_torch.models import zamba2
    from repro_torch.models.registry import get_model
    t_all = time.perf_counter()
    for mod in _kernel_modules():
        mod.reset_launches()
    cfg = get_config(HYBRID)
    api = get_model(cfg)
    nG = cfg.num_layers // cfg.hybrid.shared_attn_every
    G = cfg.num_heads // cfg.num_kv_heads
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = api.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                      device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights = sum(t.numel() * t.element_size()
                  for t in tree_util.leaves(params))
    init_peak = _gib(torch.cuda.max_memory_allocated() - base)
    print(f"[{card}] phase 12c {cfg.name}: {cfg.num_layers} Mamba2 layers "
          f"(d_inner {cfg.ssm.expand * cfg.d_model}, "
          f"{cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim} SSM heads of "
          f"{cfg.ssm.head_dim}, state {cfg.ssm.state_dim}, conv "
          f"{cfg.ssm.conv_width}, chunk {cfg.ssm.chunk_size}) and "
          f"{cfg.hybrid.num_shared_blocks} shared blocks applied {nG} times "
          f"({cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.head_dim}, G = "
          f"{G}; {cfg.activation} d_ff {cfg.d_ff}), d_model {cfg.d_model}, "
          f"vocab {cfg.vocab_size}, {cfg.param_dtype}: weights "
          f"{_gib(weights):.2f} GiB ({weights / 1e9:.3f} GB, "
          f"{sum(t.numel() for t in tree_util.leaves(params)) / 1e9:.3f} B "
          f"parameters) drawn in {init_s:.1f} s, init peak {init_peak:.2f} "
          f"GiB")
    torch.cuda.reset_peak_memory_stats()

    # the fixed batch and one row on the padded chunk path, then the
    # engine, under one recorder of the run's own flash-decode calls
    counts = dict(fd.LAUNCHES)
    # every 360th call: the fixed batch's first and 361st (of 64 x 9), the
    # engine's first (after the padded row's 16 x 9)
    with _CallRecorder(fd, every=360, keep=3) as rec:
        with _counted_calls(zamba2, "decode_step") as steps:
            t0 = time.perf_counter()
            res = run_fixed_batch(cfg, params, device="cuda", quiet=True,
                                  **FIXED)
            wall = time.perf_counter() - t0
        counts = _launch_delta(counts, "fixed batch", steps[0], nG)
        _check(res["finite"], "phase 12c fixed batch: non-finite logits")
        _check(res["tokens"].shape == (FIXED["batch"], FIXED["gen"] + 1),
               "phase 12c fixed batch: token shape")
        _check(steps[0] == FIXED["gen"], f"phase 12c fixed batch: "
               f"{steps[0]} decode steps")
        print(f"[{card}] phase 12c fixed batch {cfg.name}: prefill "
              f"{FIXED['batch']}x{FIXED['prompt_len']} "
              f"{res['prefill_tok_per_s']:.0f} tok/s, decode first step "
              f"{res['first_step_s']:.3f} s, steady "
              f"{res['decode_tok_per_s']:.1f} tok/s ({FIXED['gen'] - 1} "
              f"steps x {FIXED['batch']}), {nG} ring flash-decode launches "
              f"a step, wall {wall:.1f} s")
        with _counted_calls(zamba2, "decode_step") as steps:
            short = run_fixed_batch(cfg, params, device="cuda", quiet=True,
                                    **RECURRENT_SHORT)
        counts = _launch_delta(counts, "the 500-token row", steps[0], nG)
        _check(short["finite"] and short["tokens"].shape == (
            1, RECURRENT_SHORT["gen"] + 1), "phase 12c: the 500-token row is "
               "non-finite or short")
        chunk = cfg.ssm.chunk_size
        print(f"[{card}] phase 12c one {RECURRENT_SHORT['prompt_len']}-token "
              f"row (padded to "
              f"{-(-RECURRENT_SHORT['prompt_len'] // chunk) * chunk}): "
              f"prefill {short['prefill_tok_per_s']:.0f} tok/s, steady "
              f"{short['decode_tok_per_s']:.1f} tok/s, finite")

        # the engine on contiguous lanes
        E = RECURRENT_ENGINE
        trace = make_trace(cfg, E["requests"], gen=E["gen"],
                           max_prompt=E["max_prompt"], rate=E["rate"],
                           seed=0)
        cache_len = max(len(r["prompt"]) for r in trace) + E["gen"]
        with _retired_lanes() as snaps, \
                _checked_logits(zamba2) as finite, \
                _counted_calls(zamba2, "decode_step") as steps:
            t0 = time.perf_counter()
            done, summ, engine = run_engine(
                cfg, params, trace, device="cuda", quiet=True,
                slots=E["slots"], cache_len=cache_len)
            wall = time.perf_counter() - t0
        counts = _launch_delta(counts, "engine", steps[0], nG)
    _check(not engine.paged and set(engine.pool.cache) == {"mamba", "attn"},
           "phase 12c engine: not on contiguous lanes")
    _check(len(done) == len(trace), "phase 12c engine: not every request "
           "finished")
    for r in trace:
        _check(len(done[r["id"]].tokens) == r["max_new_tokens"],
               f"phase 12c engine: {r['id']} stopped short")
    _check(finite and all(bool(f) for f in finite),
           "phase 12c engine: non-finite logits")
    _check(steps[0] == summ["decode_steps"], f"phase 12c engine: "
           f"{steps[0]} decode calls for {summ['decode_steps']} steps")
    last = engine.step_count
    frozen = [(slot, at) for slot, at, leaves in snaps if at < last]
    for slot, at, leaves in snaps:
        now = [leaf.select(ax, slot) for leaf, ax in zip(
            tree_util.leaves(engine.pool.cache),
            tree_util.leaves(engine.pool.batch_axes))]
        _check(all(_bits_equal(a, b) for a, b in zip(now, leaves)),
               f"phase 12c engine: retired lane {slot} (step {at}) drifted "
               f"by step {last}")
    _check(len(frozen) >= 1, "phase 12c engine: no lane retired before the "
           "last step")
    got = {r["id"]: done[r["id"]].tokens.tolist() for r in trace}
    want = _lanes_path_tokens(cfg, params, trace, E["slots"], cache_len)
    _check(got == want, "phase 12c engine: greedy tokens differ from the "
           "fixed-batch path's on the same prompts: " + str(
               [i for i in got if got[i] != want[i]]))
    lens = sorted(len(r["prompt"]) for r in trace)
    print(f"[{card}] phase 12c engine {cfg.name}, contiguous lanes: "
          f"{summ['requests']} requests (prompts {lens[0]}-{lens[-1]} "
          f"tokens, {sum(n % chunk != 0 for n in lens)} padded), "
          f"{summ['decode_tokens']} decode tokens in {summ['decode_steps']} "
          f"steps, {summ['steady_tok_per_s']:.1f} tok/s steady, itl p50 "
          f"{summ['itl_p50_s'] * 1e3:.2f} ms (p99 "
          f"{summ['itl_p99_s'] * 1e3:.2f}), ttft p50 "
          f"{summ['ttft_p50_s'] * 1e3:.1f} ms (p99 "
          f"{summ['ttft_p99_s'] * 1e3:.1f}), {len(finite)} logits tensors "
          f"finite, greedy tokens equal to the fixed-batch path's on the "
          f"same prompts, {len(frozen)} retired lanes held bit for bit "
          f"(states and rings) through up to "
          f"{max(last - at for _, at in frozen)} later steps; wall "
          f"{wall:.1f} s")
    held = _hold_recorded("phase 12c", rec, G)
    _check(held >= 3, f"phase 12c: only {held} of its own flash-decode "
           f"calls held to the plain version")
    peak = _gib(torch.cuda.max_memory_allocated() - base)
    print(f"[{card}] phase 12c {cfg.name}: run peak {peak:.2f} GiB "
          f"(weights {_gib(weights):.2f}); {held} of its own flash-decode "
          f"calls held to the plain version; main-path launches {counts}")
    launches = counts

    # prefill + k decode steps against the longer prefill, held in f32
    # (after the main path's counts are read: its launches are the check's)
    err, noise, planted = _decode_vs_prefill(cfg, api)
    bf16 = _decode_vs_prefill(cfg, api, params)[0]
    _check(err <= HYBRID_LOGIT_TOL and planted > HYBRID_LOGIT_TOL,
           f"phase 12c: prefill + {RECURRENT_K} decode steps vs the longer "
           f"prefill (f32): logits max err {err}, planted {planted}, tol "
           f"{HYBRID_LOGIT_TOL}")
    print(f"[{card}] phase 12c prefill {FIXED['batch']}x"
          f"{FIXED['prompt_len']} + {RECURRENT_K} decode steps vs a prefill "
          f"of {FIXED['prompt_len'] + RECURRENT_K} tokens, at full width in "
          f"f32: "
          f"logits max_abs_err {err:.4g} (tol {HYBRID_LOGIT_TOL}); two "
          f"prefills of those tokens at batch 4 and 2 (their GEMMs round "
          f"apart) {noise:.4g}; planted (decode fed one wrong token) "
          f"{planted:.4g}; the same comparison in bf16 {bf16:.4g}")
    print(f"[{card}] phase 12c wall {time.perf_counter() - t_all:.1f} s "
          f"(host clock)")
    del params, engine
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 12d: the encoder-decoder family (seamless-m4t-medium) at full width
# ---------------------------------------------------------------------------

# seamless-m4t-medium at its published widths and depth, no cut: 12
# bidirectional encoder layers over stub frame embeddings and 12 decoder
# layers with self- and cross-attention (16/16 heads of 64, G 1:
# flash-decode's (1, 64) instance for both), vocab 256,206, tied.  The
# fixed batch is FIXED (4 rows of 512 frames and 512-token prompts, 64
# steps; a ring of 576 slots); the long source is one row of 4096 frames
# (the encoder's blockwise path at its threshold) with a 64-token prompt
# and 16 steps, its cross decode over 4096 memory slots.  Frames are drawn
# from numpy with a seed: zero frames make the memory degenerate.
ENCDEC = "seamless-m4t-medium"
ENCDEC_LONG = dict(batch=1, frames=4096, prompt_len=64, gen=16)
# Prefill + RECURRENT_K decode steps against one longer prefill over the
# same frames, in f32 at the published widths: the flash-decode kernel
# (self ring and cross memory) against the prefill's sdpa rounds in
# another order; beside it two prefills whose GEMMs round apart and a
# planted wrong token, as phases 12b and 12c.  The tied embedding (std
# 0.02) keeps the logits small, and one wrong token among 515 moves the
# last logits little (read on an H100: the hold 2.56e-6, planted 5.36e-3,
# which phase 12c's 0.01 would not tell apart).
ENCDEC_LOGIT_TOL = 1e-3


def _encdec_heads():
    """(decoder layers, Hk, G, D) of phase 12d's attention."""
    from repro_torch.configs import get_config
    cfg = get_config(ENCDEC)
    return (cfg.num_layers, cfg.num_kv_heads,
            cfg.num_heads // cfg.num_kv_heads, cfg.head_dim)


def _seeded_frames(cfg, rows: int, frames: int, seed: int,
                   device="cuda") -> torch.Tensor:
    """``rows`` x ``frames`` stub frame embeddings of ``cfg``'s width,
    standard normal from numpy with ``seed``, in bf16 (the batch's type)."""
    x = np.random.default_rng(seed).standard_normal(
        (rows, frames, cfg.d_model)).astype(np.float32)
    return torch.from_numpy(x).to(device=device, dtype=torch.bfloat16)


def phase_encdec(card: str) -> dict:
    """Phase 12d: serve seamless-m4t-medium at its published widths (12
    encoder and 12 decoder layers, d_model 1024, 16/16 heads of 64, GELU
    d_ff 4096, vocab 256,206, tied, bf16) with random weights drawn on the
    card from a seed, through the fixed-batch launcher over seeded frames:
    the fixed batch, then one row of 4096 frames (the encoder's blockwise
    path), then prefill + decode against a longer prefill in f32.  Every
    decode step launches exactly 24 ring flash-decodes (the (1, 64)
    instance): 12 self-ring calls and 12 cross calls over the memory, no
    paged launch; a few of those calls (self and cross) are held to the
    plain version.  Returns the launch counts, set to 0 at the start and
    read at the end of the main path."""
    from repro_torch import tree as tree_util
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.launch.serve import run_fixed_batch
    from repro_torch.models import encdec
    from repro_torch.models.layers import attention
    from repro_torch.models.registry import get_model
    t_all = time.perf_counter()
    for mod in _kernel_modules():
        mod.reset_launches()
    cfg = get_config(ENCDEC)
    api = get_model(cfg)
    L = cfg.num_layers
    G = cfg.num_heads // cfg.num_kv_heads
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = api.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                      device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights = sum(t.numel() * t.element_size()
                  for t in tree_util.leaves(params))
    init_peak = _gib(torch.cuda.max_memory_allocated() - base)
    print(f"[{card}] phase 12d {cfg.name}: {cfg.encdec.encoder_layers} "
          f"encoder and {L} decoder layers ({cfg.num_heads}/"
          f"{cfg.num_kv_heads} heads of {cfg.head_dim}, G = {G}; "
          f"{cfg.activation} d_ff {cfg.d_ff}), d_model {cfg.d_model}, vocab "
          f"{cfg.vocab_size} (tied), {cfg.encdec.max_source_len} source "
          f"slots, {cfg.param_dtype}: weights {_gib(weights):.2f} GiB "
          f"({weights / 1e9:.3f} GB, "
          f"{sum(t.numel() for t in tree_util.leaves(params)) / 1e9:.3f} B "
          f"parameters) drawn in {init_s:.1f} s, init peak {init_peak:.2f} "
          f"GiB")
    torch.cuda.reset_peak_memory_stats()

    counts = dict(fd.LAUNCHES)
    per_step = 2 * L                       # a self ring and a cross call
    runs = ((f"fixed batch {FIXED['batch']} x {FIXED['prompt_len']} frames "
             f"and tokens", FIXED, _seeded_frames(
                 cfg, FIXED["batch"], FIXED["prompt_len"], 1), 0),
            (f"long source: {ENCDEC_LONG['frames']} frames, "
             f"{ENCDEC_LONG['prompt_len']}-token prompt",
             {k: ENCDEC_LONG[k] for k in ("batch", "prompt_len", "gen")},
             _seeded_frames(cfg, ENCDEC_LONG["batch"],
                            ENCDEC_LONG["frames"], 2),
             cfg.encdec.encoder_layers))
    # every 501st ring call: the fixed batch's first (layer 0's self
    # ring), 502nd (a cross call) and 1003rd (a self ring), of 64 x 24
    with _CallRecorder(fd, every=501, keep=3) as rec:
        for label, shape, frames, blockwise in runs:
            with _counted_calls(encdec, "decode_step") as steps, \
                    _counted_calls(encdec, "attn_cross_decode") as cross, \
                    _counted_calls(attention, "_sdpa_blockwise") as blocks:
                t0 = time.perf_counter()
                res = run_fixed_batch(cfg, params, device="cuda",
                                      quiet=True, inputs={"frames": frames},
                                      **shape)
                wall = time.perf_counter() - t0
            counts = _launch_delta(counts, label, steps[0], per_step, "12d")
            _check(res["finite"], f"phase 12d {label}: non-finite logits")
            _check(res["tokens"].shape == (shape["batch"], shape["gen"] + 1),
                   f"phase 12d {label}: token shape")
            _check(steps[0] == shape["gen"] and cross[0] == L * steps[0],
                   f"phase 12d {label}: {steps[0]} decode steps, "
                   f"{cross[0]} cross decodes")
            _check(blocks[0] == blockwise, f"phase 12d {label}: "
                   f"{blocks[0]} blockwise attention calls, not {blockwise}"
                   f" (the encoder's layers at F >= 4096)")
            print(f"[{card}] phase 12d {label}: prefill (encode + decoder) "
                  f"{res['prefill_tok_per_s']:.0f} tok/s, decode first step "
                  f"{res['first_step_s']:.3f} s, steady "
                  f"{res['decode_tok_per_s']:.1f} tok/s ({shape['gen'] - 1} "
                  f"steps x {shape['batch']}), {per_step} ring flash-decode "
                  f"launches a step ({L} self, {L} cross over "
                  f"{frames.shape[1]} memory slots), {blocks[0]} blockwise "
                  f"encoder attention calls, wall {wall:.1f} s")
    held = _hold_recorded("phase 12d", rec, G)
    crossed = sum(kw.get("kind") == "full" for _, _, kw, _ in rec.calls)
    _check(held >= 3 and crossed >= 1, f"phase 12d: {held} of its own "
           f"flash-decode calls held to the plain version, {crossed} of "
           f"them cross calls")
    peak = _gib(torch.cuda.max_memory_allocated() - base)
    print(f"[{card}] phase 12d {cfg.name}: run peak {peak:.2f} GiB (weights "
          f"{_gib(weights):.2f}); {held} of its own flash-decode calls held "
          f"to the plain version ({crossed} cross); main-path launches "
          f"{counts}")
    launches = counts

    # prefill + k decode steps against the longer prefill, held in f32
    # (after the main path's counts are read: its launches are the check's)
    err, noise, planted = _decode_vs_prefill(cfg, api)
    bf16 = _decode_vs_prefill(cfg, api, params)[0]
    _check(err <= ENCDEC_LOGIT_TOL and planted > ENCDEC_LOGIT_TOL,
           f"phase 12d: prefill + {RECURRENT_K} decode steps vs the longer "
           f"prefill (f32): logits max err {err}, planted {planted}, tol "
           f"{ENCDEC_LOGIT_TOL}")
    print(f"[{card}] phase 12d prefill {FIXED['batch']}x"
          f"{FIXED['prompt_len']} (frames and tokens) + {RECURRENT_K} "
          f"decode steps vs a prefill of {FIXED['prompt_len'] + RECURRENT_K}"
          f" tokens over the same frames, at full width in f32: logits "
          f"max_abs_err {err:.4g} (tol {ENCDEC_LOGIT_TOL}); two prefills "
          f"at batch 4 and 2 (their GEMMs round apart) {noise:.4g}; planted "
          f"(decode fed one wrong token) {planted:.4g}; the same comparison "
          f"in bf16 {bf16:.4g}")
    print(f"[{card}] phase 12d wall {time.perf_counter() - t_all:.1f} s "
          f"(host clock)")
    del params
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 4c: the fault-tolerant engine at full width
# ---------------------------------------------------------------------------

# The reference's serving chaos acceptance plan
# (tests/test_serving_chaos.py::test_serving_chaos_acceptance): 25% of 16
# requests faulted, a bounded queue with shed-and-retry, the virtual clock.
CHAOS_PLAN = ({2: "malformed", 5: "poison", 9: "deadline", 12: "burst"}, 5)
CHAOS = dict(max_queue=3, step_time_s=0.1, deadline_s=0.15, per_tick=4,
             crash_tick=6)


def _chaos_trace(cfg):
    """Phase 4's 12 requests (in arrival order, so its shared-prefix
    cluster lands at indices 1, 6, 8 and 10, none faulted) plus 4 more
    from the launcher's trace maker; arrival is the harness's."""
    from repro_torch.launch.serve import make_trace
    extra = make_trace(cfg, 4, gen=16, max_prompt=96, rate=1.0, seed=2)
    reqs = _engine_trace(cfg) + [{**r, "id": f"x{i}"}
                                 for i, r in enumerate(extra)]
    return [{**r, "arrival_step": 0} for r in reqs]


def _drive_chaos(engine, trace, plan, *, faults: bool, vocab: int,
                 stop_at: int = 0, submitted=None):
    """Submit ``trace`` as the reference's acceptance harness does, four
    requests a tick (two there, which leaves the queue of 3 unfilled at 12
    lanes), the burst request at tick 0; a shed request, or a queued
    victim it displaced, resubmits after its retry-after hint; and
    step the engine until it drains, or until tick ``stop_at``.  With
    ``faults`` the plan's faults are injected: a malformed prompt, an
    armed poison, a deadline of CHAOS["deadline_s"].  After every tick no
    live lane's table may point at a free block.  Returns the submit
    events and the ticks run; ``submitted`` (a set) collects the ids
    submitted."""
    from repro_torch.serve.request import Request
    step_s = CHAOS["step_time_s"]
    pending = sorted((0 if plan.kind_for(i) == "burst"
                      else i // CHAOS["per_tick"], i)
                     for i in range(len(trace)))
    events, t = [], 0
    pool = engine.pool
    while pending or engine.scheduler.pending or engine.active_requests:
        _check(t < 1000, "phase 4c: the trace did not drain")
        if stop_at and t == stop_at:
            break
        still = []
        for due, i in pending:
            if due > t:
                still.append((due, i))
                continue
            r = trace[i]
            kind = plan.kind_for(i) if faults else None
            prompt = np.asarray(r["prompt"], np.int32)
            if kind == "malformed":
                prompt = plan.malform_prompt(i, prompt, vocab)
            v = engine.submit(Request(
                id=r["id"], prompt=prompt,
                max_new_tokens=r["max_new_tokens"],
                deadline_s=CHAOS["deadline_s"] if kind == "deadline"
                else None))
            if submitted is not None:
                submitted.add(r["id"])
            events.append((t, r["id"], v.verdict, v.shed_id))
            if kind == "poison" and v.ok:
                engine.poison(r["id"])
            if v.verdict == "shed":
                still.append((t + int(v.retry_after_s / step_s) + 1, i))
            elif v.shed_id is not None:
                j = next(k for k, q in enumerate(trace)
                         if q["id"] == v.shed_id)
                still.append(
                    (t + int(engine.shed_log[v.shed_id] / step_s) + 1, j))
        pending = sorted(still)
        engine.step()
        t += 1
        free = set(pool.allocator._free)
        for i, st in enumerate(engine.slots):
            if st is not None:
                row = pool.table[i]
                _check(not free & {int(b) for b in row[row >= 0]},
                       f"phase 4c: live lane {st.request.id} maps a free "
                       f"block at tick {t}")
    return events, t


def phase_chaos(card: str) -> dict:
    """qwen3-0.6b at published widths through the fault-tolerant engine
    (phase 4c), random bf16 weights drawn on the card from phase 4's seed;
    returns the launch counts of its chaos run."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import get_model
    cfg = get_config("qwen3-0.6b")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = get_model(cfg).init(cfg, gen, device="cuda")
    launches = _chaos_checks(card, cfg, params, "cuda")
    del params
    torch.cuda.empty_cache()
    return launches


def _chaos_checks(card: str, cfg, params, device) -> dict:
    """Phase 4's engine geometry, 16 requests under the reference's chaos
    plan, max_queue 3, a virtual clock and a journal.  Checks it against a
    fault-free run of the same geometry on the same device (run four
    times, tracing on, off, off, on: tok/s of each), then drops an engine mid-trace
    without closing its journal and replays the journal into a fresh one.
    The launch counts are set to 0 just before the chaos run and read just
    after.  Returns them."""
    import tempfile

    from repro_torch import obs
    from repro_torch.fault.clock import VirtualClock
    from repro_torch.fault.plan import ServingFaultPlan
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.serve.engine import ForecastEngine
    from repro_torch.serve.journal import replay_journal

    plan = ServingFaultPlan(*CHAOS_PLAN)
    trace = _chaos_trace(cfg)
    geometry = dict(num_slots=ENGINE["slots"], cache_len=ENGINE["cache_len"],
                    block_size=ENGINE["block_size"], device=device)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_journal_")
    env_trace = os.environ.get("REPRO_TRACE")

    def engine(**kw):
        return ForecastEngine(cfg, params, **geometry, **kw)

    try:
        # fault-free runs, tracing on, off, off, on (host clock: the order
        # is balanced so a drift over the runs cancels)
        runs = []
        for flag in ("1", "0", "0", "1"):
            os.environ["REPRO_TRACE"] = flag
            eng = engine()
            _drive_chaos(eng, trace, plan, faults=False,
                         vocab=cfg.vocab_size)
            runs.append((flag, {k: v.tokens.tolist()
                                for k, v in eng.finished.items()},
                         eng.metrics.summary()["steady_tok_per_s"]))
            del eng
        want = runs[0][1]
        _check(all(r[1] == want for r in runs),
               "phase 4c: the fault-free runs differ with tracing on/off")
        _check(len(want) == len(trace) and all(
            len(want[r["id"]]) == r["max_new_tokens"] for r in trace),
            "phase 4c: the fault-free run did not finish every request")
        rate = {f: [r[2] for r in runs if r[0] == f] for f in ("1", "0")}
        print(f"[{card}] engine {cfg.name} fault-free, 16 requests, steady "
              f"tok/s: REPRO_TRACE=1 "
              f"{', '.join(f'{x:.1f}' for x in rate['1'])} (mean "
              f"{np.mean(rate['1']):.1f}), REPRO_TRACE=0 "
              f"{', '.join(f'{x:.1f}' for x in rate['0'])} (mean "
              f"{np.mean(rate['0']):.1f}); the four runs' tokens equal")

        # the chaos run, traced
        os.environ["REPRO_TRACE"] = "1"
        obs.reset()
        fd.reset_launches()
        eng = engine(clock=VirtualClock(), step_time_s=CHAOS["step_time_s"],
                     max_queue=CHAOS["max_queue"],
                     journal=os.path.join(tmp, "chaos.jrnl"))
        t0 = time.perf_counter()
        events, ticks = _drive_chaos(eng, trace, plan, faults=True,
                                     vocab=cfg.vocab_size)
        wall = time.perf_counter() - t0
        launches = dict(fd.LAUNCHES)
        summ = eng.metrics.summary()
        ids = [r["id"] for r in trace]
        faulted = {ids[i]: k for i, k in plan.faults.items()}
        quarantined = {k: q.reason for k, q in eng.quarantined.items()}
        _check(quarantined == {ids[2]: "malformed_prompt",
                               ids[5]: "nonfinite_logits"},
               f"phase 4c: quarantines {quarantined} differ from the plan")
        done = eng.finished
        _check(set(done) | set(quarantined) == set(ids)
               and not set(done) & set(quarantined),
               "phase 4c: a request neither finished nor quarantined")
        miss = done[ids[9]]
        _check(miss.reason == "deadline"
               and miss.tokens.tolist() == want[ids[9]][:len(miss.tokens)],
               f"phase 4c: the deadline request ended {miss.reason} or its "
               f"partial tokens differ")
        # on the virtual clock: the first sweep past 0.15 s after its
        # accepted submit (a shed retry starts a fresh window), two ticks on
        submit_tick = max(t for t, rid, v, _ in events
                          if rid == ids[9] and v == "ok")
        _check(miss.finished_step - submit_tick
               <= int(CHAOS["deadline_s"] / CHAOS["step_time_s"]) + 1,
               "phase 4c: the deadline window did not hold")
        survivors = sorted(set(ids) - {ids[2], ids[5], ids[9]})
        for rid in survivors:
            _check(done[rid].reason == "length", f"phase 4c: {rid} ended "
                   f"{done[rid].reason}")
            _check(done[rid].tokens.tolist() == want[rid],
                   f"phase 4c: {rid}'s tokens differ from the fault-free "
                   f"run's")
        q_step = eng.quarantined[ids[5]].step
        neighbours = [rid for rid in survivors
                      if done[rid].admitted_step <= q_step
                      <= done[rid].finished_step]
        _check(len(neighbours) >= 2, "phase 4c: the poisoned lane had no "
               "neighbours in its decode tick")
        eng.pool.assert_partition()
        _check(eng.pool.blocks_in_use == 0, "phase 4c: blocks leaked")
        _check(launches["flash_decode_paged"] > 0,
               "phase 4c: the paged flash-decode never launched")
        _check(summ["cow_copies"] >= 1
               and launches["paged_block_copy"] == summ["cow_copies"],
               f"phase 4c: {launches['paged_block_copy']} block-copy "
               f"launches for {summ['cow_copies']} copy-on-write events")
        spans = obs.span_count("req.lifecycle")
        _check(spans == summ["requests"],
               f"phase 4c: {spans} lifecycle spans for {summ['requests']} "
               f"finished requests")
        shed = sum(1 for e in events if e[2] == "shed" or e[3] is not None)
        _check(summ["shed"] == shed, "phase 4c: shed count")
        eng.journal.close()
        _check(replay_journal(eng.journal.path).unfinished_ids == [],
               "phase 4c: the chaos journal replays unfinished requests")
        print(f"[{card}] phase 4c {cfg.name} chaos, 16 requests ({faulted}): "
              f"{ticks} ticks, {summ['decode_tokens']} decode tokens, "
              f"{summ['steady_tok_per_s']:.1f} tok/s steady, wall "
              f"{wall:.1f} s; quarantined {quarantined}; {summ['shed']} shed "
              f"(then retried), {summ['deadline_misses']} deadline miss "
              f"({len(miss.tokens)} tokens); {len(survivors)} survivors and "
              f"the poisoned lane's {len(neighbours)} neighbours bit for bit "
              f"with the fault-free run; cow {summ['cow_copies']} = block "
              f"copies {launches['paged_block_copy']}; {spans} lifecycle "
              f"spans; launches {launches}")
        del eng

        # a crash: an engine dropped at a tick with its journal open, the
        # journal replayed into a fresh engine
        path = os.path.join(tmp, "crash.jrnl")
        eng = engine(journal=path)
        submitted = set()
        _drive_chaos(eng, trace, plan, faults=False, vocab=cfg.vocab_size,
                     stop_at=CHAOS["crash_tick"], submitted=submitted)
        del eng                                # no close: a crash
        st = replay_journal(path)
        eng = engine(journal=path)
        resumed = st.unfinished_requests()
        for r in resumed:
            _check(eng.submit(r).ok, "phase 4c: a replayed submit refused")
        rest = [r for r in trace if r["id"] not in submitted]
        _drive_chaos(eng, rest, ServingFaultPlan({}), faults=False,
                     vocab=cfg.vocab_size)
        got = {rid: st.tokens[rid] for rid in st.finished}
        got.update({k: v.tokens.tolist() for k, v in eng.finished.items()})
        eng.journal.close()
        _check(set(got) == set(ids), "phase 4c: the replay lost a request")
        bad = sorted(rid for rid in ids if got[rid] != want[rid])
        _check(not bad, f"phase 4c: after the replay {bad} differ from the "
               f"fault-free run")
        mid = sum(1 for r in resumed if r.resume)
        print(f"[{card}] phase 4c crash at tick {CHAOS['crash_tick']}: "
              f"{len(st.finished)} finished before it, {mid} resumed "
              f"mid-decode and {len(resumed) - mid} before their first "
              f"token from the journal, {len(rest)} not yet submitted; "
              f"every request's tokens equal the fault-free run's")
        del eng
    finally:
        if env_trace is None:
            os.environ.pop("REPRO_TRACE", None)
        else:
            os.environ["REPRO_TRACE"] = env_trace
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


# ---------------------------------------------------------------------------
# phases 3b, 3c, 4d: a long prompt, generate, the swap tier
# ---------------------------------------------------------------------------

# Phase 3b: one prompt past the blockwise threshold (4096), B = 1, then
# LONG_GEN greedy steps of ``generate`` from its cache.
LONG_PROMPT, LONG_GEN = 8192, 16
# Blockwise against naive last-token logits, both bf16 through 28 layers:
# max |difference| over max |naive logit|.  The two paths round p to bf16
# at different points (the blockwise path before it is normalized, a KV
# block at a time), so they differ by bf16 rounding carried through the
# layers; the planted fault (one KV block of 2048 positions dropped from
# every query's softmax) must read outside the limit.
TOL_BLOCKWISE = 0.05
# Phase 4d: phase 4's trace with longer generations on a cut pool, so that
# lanes park and leave through the swap tier (3 swap-outs: picked by
# running the engine's block accounting at these lengths on the CPU).
SWAP = dict(pool_blocks=32, gen=32)


class _Recorder:
    """A model API whose ``decode_step`` keeps each step's last-position
    logits (f32) for the checks of ``generate``'s tokens."""

    def __init__(self, api):
        self.api, self.logits = api, []

    def decode_step(self, *args, **kw):
        lg, cache = self.api.decode_step(*args, **kw)
        self.logits.append(lg[:, -1].float())
        return lg, cache


def phase_serving_extras(card: str) -> dict:
    """qwen3-0.6b at published widths, random bf16 weights drawn on the
    card from phase 4's seed: the blockwise prefill (3b), ``generate``
    (3c) and the swap tier (4d).  The launch counts are set to 0 before
    3b and read after 3c, then set to 0 before 4d's swapping run and read
    after it; returns both."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.models.registry import get_model
    cfg = get_config("qwen3-0.6b")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = get_model(cfg).init(cfg, gen, device="cuda")
    fd.reset_launches()
    _phase_blockwise(card, cfg, params)
    _phase_generate(card, cfg, params)
    out = {"generate": dict(fd.LAUNCHES)}
    steps = LONG_GEN + 4 * FIXED["gen"]        # 3b, then 3c's four loops
    _check(out["generate"]["flash_decode"] == steps * cfg.num_layers,
           f"phases 3b-3c: {out['generate']['flash_decode']} ring "
           f"flash-decode launches, not {steps * cfg.num_layers}")
    out["swap_tier_engine"] = _phase_swap(card, cfg, params)
    del params
    torch.cuda.empty_cache()
    return out


def _prefill_measured(api, params, cfg, tokens, cache_len):
    """(cache, last-token logits (V,) f32, wall s, peak GiB over what was
    allocated before the call) of one prefill."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cache, lg = api.prefill(params, cfg, {"tokens": tokens},
                            cache_len=cache_len)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    return cache, lg[0, -1].float(), wall, peak


def _phase_blockwise(card: str, cfg, params, device="cuda") -> None:
    from repro_torch.models import transformer
    from repro_torch.models.layers import attention
    from repro_torch.models.registry import get_model
    from repro_torch.serve.sampling import generate
    api = get_model(cfg)
    tokens = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (1, LONG_PROMPT)), device=device)
    ring = LONG_PROMPT + LONG_GEN
    _check(LONG_PROMPT >= transformer.BLOCKWISE_THRESHOLD,
           "phase 3b: the prompt is under the blockwise threshold")
    cache, blk, wall_b, peak_b = _prefill_measured(api, params, cfg, tokens,
                                                   ring)
    saved = transformer.BLOCK_Q, transformer.BLOCK_KV
    transformer.BLOCK_Q = transformer.BLOCK_KV = 0      # the naive path
    try:
        _, naive, wall_n, peak_n = _prefill_measured(api, params, cfg,
                                                     tokens, ring)
    finally:
        transformer.BLOCK_Q, transformer.BLOCK_KV = saved
    # the planted fault: the prompt's second quarter (a KV block of 2048
    # at 8192 tokens) dropped from every softmax
    real_mask = attention._mask
    lo, hi = LONG_PROMPT // 4, LONG_PROMPT // 2

    def dropped(q_pos, kv_pos, *rest):
        kp = kv_pos[:, None, None, None, :]
        return real_mask(q_pos, kv_pos, *rest) & ~((kp >= lo) & (kp < hi))

    attention._mask = dropped
    try:
        _, fault, _, _ = _prefill_measured(api, params, cfg, tokens, ring)
    finally:
        attention._mask = real_mask
    scale = float(naive.abs().max())
    err = float((blk - naive).abs().max()) / scale
    fault_err = float((fault - naive).abs().max()) / scale
    _check(bool(torch.isfinite(blk).all()) and bool(
        torch.isfinite(naive).all()), "phase 3b: non-finite logits")
    print(f"[{card}] phase 3b {cfg.name} full width, one {LONG_PROMPT}-token "
          f"prompt: blockwise (Q {saved[0]} x KV {saved[1]}) prefill "
          f"{wall_b:.3f} s, peak {peak_b:.2f} GiB over the weights; naive "
          f"{wall_n:.3f} s, peak {peak_n:.2f} GiB; last-token logits "
          f"max|blockwise - naive| / max|naive| = {err:.3g} (limit "
          f"{TOL_BLOCKWISE}; planted fault, KV {lo}-{hi - 1} dropped: "
          f"{fault_err:.3g})")
    _check(err <= TOL_BLOCKWISE, f"phase 3b: blockwise logits off the naive "
           f"path's by {err} > {TOL_BLOCKWISE}")
    _check(fault_err > TOL_BLOCKWISE, "phase 3b: the limit does not catch "
           "the planted fault")
    rec = _Recorder(api)
    first = blk.argmax().to(torch.int32).reshape(1, 1)
    toks, _ = generate(rec, params, cfg, cache, first, steps=LONG_GEN,
                       start_pos=LONG_PROMPT)
    toks = toks.cpu()
    _check(toks.shape == (1, LONG_GEN) and len(rec.logits) == LONG_GEN,
           "phase 3b: generate's shape")
    for i, lg in enumerate(rec.logits):
        _check(bool(torch.isfinite(lg).all()), "phase 3b: non-finite "
               "logits in generate")
        _check(int(toks[0, i]) == int(lg[0].argmax()),
               f"phase 3b: greedy token {i} is not its logits' argmax")
    print(f"[{card}] phase 3b: {LONG_GEN} greedy generate steps from the "
          f"blockwise prefill at positions {LONG_PROMPT}-"
          f"{LONG_PROMPT + LONG_GEN - 1}: finite, each token its logits' "
          f"argmax")


def _phase_generate(card: str, cfg, params, device="cuda") -> None:
    from repro_torch.launch.serve import run_fixed_batch
    from repro_torch.models.registry import get_model
    from repro_torch.serve.sampling import generate
    api = get_model(cfg)
    B, P, n = FIXED["batch"], FIXED["prompt_len"], FIXED["gen"]
    fixed = run_fixed_batch(cfg, params, device=device, quiet=True,
                            **FIXED)["tokens"]
    # run_fixed_batch's prompts (its seed 0)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, P)), device=device)

    def start():
        cache, lg = api.prefill(params, cfg, {"tokens": tokens},
                                cache_len=P + n)
        return cache, lg[:, -1].argmax(-1).to(torch.int32)[:, None]

    cache, first = start()
    _check(first.cpu().numpy().tolist() == fixed[:, :1].tolist(),
           "phase 3c: the prefill's first tokens differ")
    t0 = time.perf_counter()
    greedy, _ = generate(api, params, cfg, cache, first, steps=n,
                         start_pos=P)
    greedy = greedy.cpu().numpy()
    wall = time.perf_counter() - t0
    _check(np.array_equal(greedy, fixed[:, 1:]), "phase 3c: greedy "
           "generate differs from the fixed-batch launcher")
    runs = []
    for _ in range(2):
        cache, first = start()
        rec = _Recorder(api)
        toks, _ = generate(rec, params, cfg, cache, first, steps=n,
                           start_pos=P, temperature=0.8, top_k=50,
                           generator=torch.Generator(
                               device=device).manual_seed(5))
        runs.append((toks.cpu(), rec.logits))
    (a, logits), (b, _) = runs
    _check(torch.equal(a, b), "phase 3c: seeded sampling did not repeat")
    for i, lg in enumerate(logits):
        scaled = lg / np.float32(0.8)
        kth = scaled.sort(dim=-1, descending=True).values[:, 49].cpu()
        got = scaled.gather(1, a[:, i:i + 1].to(device).long())[:, 0].cpu()
        _check(bool((got >= kth).all()), f"phase 3c: sampled token {i} "
               f"outside its row's top 50")
    distinct = len(set(a.flatten().tolist()))
    greedy_share = float((a.numpy() == greedy).mean())
    print(f"[{card}] phase 3c {cfg.name} {B}x{P} prompt: greedy generate of "
          f"{n} steps equals the fixed-batch launcher bit for bit "
          f"({wall:.2f} s); sampled (temperature 0.8, top-k 50) twice with "
          f"one seed: equal, every token in its row's top 50 "
          f"({distinct} distinct tokens, {greedy_share:.2f} of them the "
          f"greedy one)")


def _phase_swap(card: str, cfg, params, device="cuda") -> dict:
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.launch.serve import _to_request
    from repro_torch.serve.engine import ForecastEngine
    trace = _engine_trace(cfg, gen=SWAP["gen"])

    def serve(pool_blocks: int, swap_tier: bool, timed: bool = False):
        eng = ForecastEngine(cfg, params, num_slots=ENGINE["slots"],
                             cache_len=ENGINE["cache_len"],
                             block_size=ENGINE["block_size"],
                             pool_blocks=pool_blocks, swap_tier=swap_tier,
                             device=device)
        prefills = []
        real_prefill = eng._prefill

        def counted(*a, **k):
            prefills.append(1)
            return real_prefill(*a, **k)

        eng._prefill = counted
        for r in trace:
            _check(eng.submit(_to_request(r)).ok, "phase 4d: a submit refused")
        watches = [_Stopwatch(eng, n) for n in
                   ("_swap_out", "_drain_swaps", "_swap_in")] if timed else []
        t0 = time.perf_counter()
        with contextlib.ExitStack() as stack:
            for w in watches:
                stack.enter_context(w)
            eng.run(max_steps=2000)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        eng.pool.assert_partition()
        _check(eng.pool.blocks_in_use == 0, "phase 4d: blocks leaked")
        _check(not eng.swap, "phase 4d: a swap handle outlived its request")
        toks = {k: v.tokens.tolist() for k, v in eng.finished.items()}
        _check(len(toks) == len(trace) and all(
            len(toks[r["id"]]) == r["max_new_tokens"] for r in trace),
            "phase 4d: a request did not finish")
        return eng, toks, len(prefills), wall, watches

    torch.cuda.reset_peak_memory_stats()
    fd.reset_launches()
    eng, toks, n_prefill, wall, watches = serve(SWAP["pool_blocks"], True,
                                                timed=True)
    launches = dict(fd.LAUNCHES)
    summ = eng.metrics.summary()
    _, want, _, wall_full, _ = serve(ENGINE_POOL_BLOCKS, True)
    off, evicted, _, wall_off, _ = serve(SWAP["pool_blocks"], False)
    off_summ = off.metrics.summary()
    _check(summ["swap_outs"] >= 2, f"phase 4d: {summ['swap_outs']} "
           f"swap-outs, fewer than 2")
    _check(summ["swap_ins"] == summ["swap_outs"],
           "phase 4d: swap-ins differ from swap-outs")
    _check(summ["evictions"] == 0, "phase 4d: the tier on evicted")
    fresh = len(trace) - summ["full_prompt_hits"]
    _check(n_prefill == fresh, f"phase 4d: {n_prefill} prefills for "
           f"{fresh} fresh admissions: a resume recomputed")
    _check(toks == want, "phase 4d: tokens differ from the full pool's")
    _check(off_summ["evictions"] >= 1, "phase 4d: the tier off never "
           "evicted")
    _check(evicted == want, "phase 4d: the tier-off tokens differ")
    _check(launches["paged_block_copy"] == summ["cow_copies"],
           f"phase 4d: {launches['paged_block_copy']} block-copy launches "
           f"for {summ['cow_copies']} copy-on-write events")
    _check(launches["flash_decode_paged"] > 0,
           "phase 4d: the paged flash-decode never launched")
    out_s, drain_s, in_s = (w.seconds for w in watches)
    n_out = summ["swap_outs"]
    print(f"[{card}] phase 4d {cfg.name} full width, swap tier: phase 4's "
          f"geometry ({ENGINE['slots']} slots, cache {ENGINE['cache_len']}, "
          f"blocks of {ENGINE['block_size']}) and 12-request trace with "
          f"{SWAP['gen']} new tokens each, the pool cut "
          f"{ENGINE_POOL_BLOCKS} -> {SWAP['pool_blocks']} blocks: "
          f"{summ['parked_events']} parks, {n_out} swap-outs "
          f"({summ['swap_out_bytes']} B), {summ['swap_ins']} swap-ins "
          f"({summ['swap_in_bytes']} B), 0 evictions, {n_prefill} prefills "
          f"for {fresh} fresh admissions; tokens equal the "
          f"{ENGINE_POOL_BLOCKS}-block pool's and, with the tier off "
          f"({off_summ['evictions']} evictions), the cut pool's; cow "
          f"{summ['cow_copies']} = block copies "
          f"{launches['paged_block_copy']}; paged flash-decode launches "
          f"{launches['flash_decode_paged']}")
    print(f"[{card}] phase 4d host clock (synchronized): swap-out "
          f"{out_s / n_out * 1e3:.2f} ms a lane (gather + release) + drain "
          f"{drain_s / n_out * 1e3:.2f} ms (copy to pinned host), swap-in "
          f"{in_s / summ['swap_ins'] * 1e3:.2f} ms (grant + insert); runs "
          f"{wall:.1f} s (cut, tier on, timed), {wall_full:.1f} s (full "
          f"pool), {wall_off:.1f} s (cut, tier off, "
          f"{off_summ['decode_steps']} decode steps against "
          f"{summ['decode_steps']}); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    return {k: launches[k] for k in ("flash_decode_paged",
                                     "paged_block_copy")}


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
    work they queued is inside; ``first`` is when the first call began,
    ``laps`` each call's (start, end).  ``keep(args, kwargs, result)``, if
    given, sees every call."""

    def __init__(self, module, name: str, keep=None):
        self.module, self.name = module, name
        self.real = getattr(module, name)
        self.seconds, self.calls, self.first = 0.0, 0, None
        self.laps, self.keep = [], keep

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
        self.laps.append((t0, time.perf_counter()))
        self.seconds += self.laps[-1][1] - t0
        self.calls += 1
        if self.keep is not None:
            self.keep(args, kw, out)
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


def phase_fit(card: str) -> tuple:
    """``federated_fit`` at fedtime-llama2-7b's widths (bf16, QLoRA on,
    synthetic ETTh1) once on the int8 wire and once on bf16, then
    ``evaluate_forecaster`` on the test windows.  Each run is one main
    path: the hop launch counts are set to 0 just before it and read just
    after.  Returns those counts and each wire's measured bytes up per
    upload."""
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
    launches, per_upload = {}, {}
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
        per_upload[wire] = up // n[f"wire_hop_{wire}"]
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
    return launches, per_upload


# Phase 5b: the paper's two-phase pipeline on phase 5's cut schedule.
TWO_PHASE = dict(rounds_sft=1, rounds_forecast=1, dpo_steps=4, batch_size=4)


def phase_two_phase(card: str, device="cuda") -> dict:
    """``two_phase_fit`` (SFT rounds, DPO alignment, forecasting rounds) at
    fedtime-llama2-7b's widths on the int8 wire, then
    ``evaluate_forecaster``.  The hop launch counts are set to 0 just
    before it and read just after; returns them."""
    from repro_torch import tree as tree_util
    from repro_torch.core import dpo, fedtime
    from repro_torch.dist import fedcomm
    from repro_torch.kernels import wire_hop as wh
    from repro_torch.train import fed_trainer
    from repro_torch.train.trainer import evaluate_forecaster
    cfg = _fit_config()
    cdata, xte, yte = _fit_data(cfg.fedtime)
    losses, aligned = [], []
    real_loss, real_update = dpo.dpo_loss, fed_trainer.local_update

    def recorded(*a, **k):
        loss = real_loss(*a, **k)
        losses.append(loss.detach())
        return loss

    def update(loss_fn, base, adapters, batches, **k):
        """The DPO stage's call (its batch holds preference pairs) keeps
        the adapters it started from (the SFT fedavg) and those it ends
        with."""
        if "y_w" not in batches:
            return real_update(loss_fn, base, adapters, batches, **k)
        before = tree_util.map_(torch.clone, adapters)
        out = real_update(loss_fn, base, adapters, batches, **k)
        aligned.append((before, out[0]))
        return out

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    wh.reset_launches()
    dpo.dpo_loss, fed_trainer.local_update = recorded, update
    t0 = time.perf_counter()
    try:
        with _Stopwatch(fed_trainer, "federated_fit") as fits, \
                _Stopwatch(fedcomm, "quantize_update") as wires:
            res = fed_trainer.two_phase_fit(cfg, cdata, wire="int8", seed=0,
                                            device=device, **TWO_PHASE)
            torch.cuda.synchronize()
    finally:
        dpo.dpo_loss, fed_trainer.local_update = real_loss, real_update
    wall = time.perf_counter() - t0
    n = dict(wh.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    _check(len(fits.laps) == 2, "phase 5b: not two federated fits")
    (s0, s1), (f0, f1) = fits.laps
    dpo_l = [float(l) for l in losses]
    _check(len(dpo_l) == TWO_PHASE["dpo_steps"], "phase 5b: DPO steps")
    first_err = abs(dpo_l[0] - float(np.log(2.0)))
    _check(first_err <= 1e-6, f"phase 5b: dpo_loss(p, p) before the first "
           f"DPO step is {dpo_l[0]}, {first_err} from ln 2")
    round_l = [l.train_loss for l in res.logs]
    _check(all(np.isfinite(round_l + dpo_l)), f"phase 5b: losses "
           f"{round_l}, DPO {dpo_l}")
    # a step left undone reads ln 2 again, a wrong-signed one more than it
    _check(dpo_l[1] < dpo_l[0], f"phase 5b: the first DPO step did not "
           f"lower the loss ({dpo_l[0]} -> {dpo_l[1]})")
    _check(len(aligned) == 1, f"phase 5b: {len(aligned)} DPO stages")
    before, after = aligned[0]
    moved = max(float((a.float() - b.float()).abs().max()) for a, b in
                zip(tree_util.leaves(after), tree_util.leaves(before)))
    _check(moved > 0, "phase 5b: the aligned adapters equal the SFT "
           "fedavg")
    _check(len(res.logs) == 2 * cfg.fedtime.num_clusters,
           "phase 5b: round logs")
    _check(n["wire_hop_int8"] == wires.calls > 0 and n["wire_hop_bf16"] == 0,
           f"phase 5b: {n} hop launches for {wires.calls} uploads")
    metrics = evaluate_forecaster(lambda p, x: fedtime.forward(p, cfg, x),
                                  res.params_for_cluster(0), xte, yte)
    _check(all(np.isfinite(v) for v in metrics.values()),
           f"phase 5b: metrics {metrics}")
    _check(peak < 80, f"phase 5b: peak device memory {peak:.2f} GiB")
    print(f"[{card}] phase 5b two_phase_fit {cfg.name} full width, phase "
          f"5's cut schedule, {TWO_PHASE}, int8 wire: SFT round losses "
          f"{[round(l, 4) for l in round_l[:len(round_l) // 2]]}, DPO "
          f"losses {[round(l, 6) for l in dpo_l]} (the first "
          f"{first_err:.2g} from ln 2; the aligned adapters moved up to "
          f"{moved:.3g} off the SFT fedavg), forecast round losses "
          f"{[round(l, 4) for l in round_l[len(round_l) // 2:]]}; "
          f"{wires.calls} uploads = {n['wire_hop_int8']} hop launches; test "
          f"MSE {metrics['mse']:.4f} MAE {metrics['mae']:.4f}; peak device "
          f"memory {peak:.2f} GiB")
    print(f"[{card}] phase 5b host clock (synchronized): SFT fit "
          f"{s1 - s0:.2f} s, fedavg + merge + {TWO_PHASE['dpo_steps']} DPO "
          f"steps {f0 - s1:.2f} s, forecast fit {f1 - f0:.2f} s, "
          f"{wall:.2f} s in all")
    del res
    torch.cuda.empty_cache()
    return {"wire_hop_int8": n["wire_hop_int8"]}


# Phase 5c: the fault-tolerant fit on phase 5's widths.  The schedule is
# phase 5's cut raised as far as the faults need room: 4 clients a round
# (every member of a cluster: the first K-means centre is fixed at client 0,
# which splits the 8 clients 4/4 as {0, 2, 3, 6} and {1, 4, 5, 7}) and 3
# rounds, so that a late upload can be buffered in round 0 and drained in
# round 1, and each cluster keeps a majority of honest on-time uploads (the
# byzantine screen compares a norm with the cohort's median).
FAULT_FIT_SCHEDULE = dict(FIT_SCHEDULE, clients_per_round=4)
FAULT_FIT = dict(rounds=3, batch_size=4, kmeans_first=0)
FAULT_DEADLINE_S = 2.0
FAULT_BASE_S = 0.5
# client -> its fault in run A (cluster 0: crash, transient, corrupt, late;
# cluster 1: byzantine, hang, two honest)
FAULT_CLIENTS = dict(crash=0, transient=2, corrupt=3, delay=6, byzantine=1,
                     hang=4)


def _fault_plan():
    from repro_torch.fault import Fault, FaultPlan
    c = FAULT_CLIENTS
    return FaultPlan({
        c["crash"]: [Fault("crash")], c["hang"]: [Fault("hang")],
        c["transient"]: [Fault("transient", fails=1, backoff_s=0.25)],
        c["corrupt"]: [Fault("corrupt", mode="nan")],
        c["byzantine"]: [Fault("byzantine", scale=1e3)],
        # arrives at 4.0 s, past round 0's window [0, 2]; cluster 0's round
        # 1 window [4, 6] drains it, 1 round stale
        c["delay"]: [Fault("delay", delay_s=3.5, rounds=frozenset({0}))],
    }, base_fit_s=FAULT_BASE_S)


def _expected_fault_ledger():
    """(round, client, participated, reason or extras) of run A's ledger,
    as the plan dictates, sorted."""
    c = FAULT_CLIENTS
    rows = []
    for r in range(FAULT_FIT["rounds"]):
        for s in range(8):
            if s in (c["crash"], c["hang"], c["corrupt"], c["byzantine"]):
                kind = next(k for k, v in c.items() if v == s)
                rows.append((r, s, False, kind))
            elif s == c["delay"] and r == 0:
                rows.append((r, s, False, "deadline"))
            else:
                rows.append((r, s, True, None))
    rows.append((1, c["delay"], True, "buffered_staleness=1"))
    return sorted(rows, key=repr)


def _ledger_rows(led):
    out = []
    for rec in led.records:
        extra = dict(rec.extra or {})
        why = extra.pop("reason", None)
        if "buffered_staleness" in extra:
            why = f"buffered_staleness={extra['buffered_staleness']}"
        out.append((rec.round, rec.client, rec.participated, why))
    return sorted(out, key=repr)


def phase_fault_fit(card: str, cfg=None, cdata=None, device="cuda") -> dict:
    """``federated_fit`` with its fault options at fedtime-llama2-7b's
    widths (phase 5c): run A on the int8 wire under a fault plan, a
    deadline, snapshots and ``fleet_out``; a resume from run A's snapshot
    after round 1, cluster 0; run B, secure int8 aggregation with a crash
    dropout.  The hop launch counts are set to 0 just before run A and
    before the resume, and read just after each; returns their sum.  The
    CPU rehearsal passes a smoke ``cfg`` and its ``cdata``."""
    import dataclasses
    import shutil
    import tempfile
    from repro_torch import tree as tree_util
    from repro_torch.core import comm, secure_agg
    from repro_torch.core.lora import count_params, lora_tree
    from repro_torch.dist import fedcomm
    from repro_torch.fault import Fault, FaultPlan
    from repro_torch.kernels import wire_hop as wh
    from repro_torch.train import checkpoint, fed_trainer
    if cfg is None:
        cfg = _fit_config()
        cfg = cfg.replace(fedtime=dataclasses.replace(
            cfg.fedtime, **FAULT_FIT_SCHEDULE))
        cdata = _fit_data(cfg.fedtime)[0]
    ft = cfg.fedtime
    print(f"[{card}] phase 5c {cfg.name} ({cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads of "
          f"{cfg.head_dim}, d_ff {cfg.d_ff}, NF4 qblock {ft.qlora_block}, "
          f"LoRA rank {ft.lora_rank}, {cfg.compute_dtype}); cut: clients 555 "
          f"-> {ft.num_clients}, clusters 8 -> {ft.num_clusters}, clients a "
          f"round 16 -> {ft.clients_per_round}, local steps 40 -> "
          f"{ft.local_steps}, {FAULT_FIT['rounds']} rounds, batch "
          f"{FAULT_FIT['batch_size']}, first K-means centre client 0; "
          f"deadline {FAULT_DEADLINE_S} s, fits {FAULT_BASE_S} s (virtual); "
          f"faults {FAULT_CLIENTS}")
    work = tempfile.mkdtemp(prefix="fault_fit_")
    snap, kept = os.path.join(work, "snap.ckpt"), os.path.join(work,
                                                               "kept.ckpt")
    fleet_path = os.path.join(work, "fleet.json")
    windows = []

    def progress(msg):
        torch.cuda.synchronize()
        windows.append((msg, time.perf_counter()))
        if msg.startswith("round 1 cluster 0:"):
            # a snapshot is its file and the directory of its parts
            shutil.copy(snap, kept)
            shutil.copytree(snap + ".d", kept + ".d")

    snaps = []
    kw = dict(FAULT_FIT, wire="int8", seed=0, device=device,
              deadline_s=FAULT_DEADLINE_S, staleness_limit=2)
    launches = 0
    try:
        # -- run A ------------------------------------------------------
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        wh.reset_launches()
        t0 = time.perf_counter()
        with _Stopwatch(fed_trainer, "_write_snapshot",
                        keep=lambda a, k, n: snaps.append(n)) as writes, \
                _Stopwatch(checkpoint, "_host_bytes") as to_host, \
                _Stopwatch(fedcomm, "quantize_update") as wires:
            res_a = fed_trainer.federated_fit(
                cfg, cdata, fault_plan=_fault_plan(), snapshot_path=snap,
                fleet_out=fleet_path, progress=progress, **kw)
            torch.cuda.synchronize()
        wall_a = time.perf_counter() - t0
        n_a = dict(wh.LAUNCHES)
        peak_a = torch.cuda.max_memory_allocated() / 2 ** 30
        led = res_a.fleet
        got, want = _ledger_rows(led), _expected_fault_ledger()
        _check(got == want, f"phase 5c run A: the ledger {got} is not what "
               f"the plan dictates: {want}")
        c = FAULT_CLIENTS
        bad = [r for r in led.records if r.participated
               and r.client in (c["corrupt"], c["byzantine"])]
        _check(not bad, f"phase 5c run A: corrupt/byzantine aggregated {bad}")
        finite = all(bool(torch.isfinite(l).all())
                     for ad in res_a.adapters_per_cluster
                     for l in tree_util.leaves(ad))
        _check(finite, "phase 5c run A: non-finite adapters")
        late = [r for r in led.records
                if (r.extra or {}).get("buffered_staleness")
                or (r.extra or {}).get("staleness_rejected")]
        _check(len(late) >= 1, "phase 5c run A: no late upload was drained")
        n_elems = count_params(lora_tree(res_a.base_params))
        per_upload = comm.wire_payload_bytes(n_elems, "int8")
        fleet = json.load(open(fleet_path))
        for cl, info in fleet["clusters"].items():
            ups = sum(1 for r in led.records
                      if r.cluster == int(cl) and r.participated)
            logged = sum(l.comm.bytes_up for l in res_a.logs
                         if l.cluster == int(cl))
            _check(info["wire_bytes"] == ups * per_upload == logged,
                   f"phase 5c run A: cluster {cl} wire bytes "
                   f"{info['wire_bytes']}, {ups} uploads x {per_upload}, "
                   f"logs {logged}")
        # every fit that reached the wire: all but crash/hang, the drained
        # record of a buffered upload not counted twice
        encoded = sum(1 for r in led.records
                      if (r.extra or {}).get("reason") not in (
                          "crash", "hang", "stale")
                      and not (r.extra or {}).get("buffered_staleness"))
        on_card = device == "cuda"       # a CPU rehearsal launches nothing
        _check(wires.calls == encoded and n_a["wire_hop_bf16"] == 0
               and n_a["wire_hop_int8"] == (encoded if on_card else 0),
               f"phase 5c run A: {n_a} hop launches, {wires.calls} uploads "
               f"through the wire, {encoded} fits encoded")
        launches += n_a["wire_hop_int8"]
        losses_a = [l.train_loss for l in res_a.logs]
        _check(all(np.isfinite(losses_a)), f"phase 5c: losses {losses_a}")
        _check(peak_a < 80, f"phase 5c run A: peak {peak_a:.2f} GiB")
        state_b = os.path.getsize(snap) + sum(
            os.path.getsize(os.path.join(snap + ".d", f))
            for f in os.listdir(snap + ".d"))
        per_round, prev = {}, t0
        for msg, t in windows:
            rnd = int(msg.split()[1])
            per_round[rnd] = per_round.get(rnd, 0.0) + (t - prev)
            prev = t
        print(f"[{card}] phase 5c run A (int8 wire, plan, deadline, "
              f"snapshots, fleet_out): ledger as planned "
              f"({led.rejections_by_reason()}; client {c['delay']} "
              f"buffered in round 0 and applied in round 1), round losses "
              f"{[round(l, 4) for l in losses_a]}, adapters finite; "
              f"fleet.json wire bytes "
              f"{[v['wire_bytes'] for v in fleet['clusters'].values()]} = "
              f"uploads x {per_upload}; {wires.calls} uploads = "
              f"{n_a['wire_hop_int8']} hop launches; peak device memory "
              f"{peak_a:.2f} GiB")
        print(f"[{card}] phase 5c run A host clock: {wall_a:.2f} s in all, "
              f"rounds (set-up in round 0) "
              f"{[round(per_round[r], 2) for r in sorted(per_round)]} s; "
              f"{len(snaps)} snapshots of {min(snaps)}-{max(snaps)} B "
              f"(the round state and the parts the window changed: its "
              f"server, its uploads' EF residuals; {to_host.calls} files in "
              f"all; the whole state after the last is {state_b} B), "
              f"{1e3 * writes.seconds / max(writes.calls, 1):.1f} ms each, "
              f"of which the device-to-host copies "
              f"{1e3 * to_host.seconds / max(writes.calls, 1):.1f} ms "
              f"(the rest: CRC32, write, fsync, rename)")

        # -- resume from the snapshot after round 1, cluster 0 -----------
        _check(os.path.exists(kept), "phase 5c: no snapshot after (1, 0)")
        wh.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res_r = fed_trainer.federated_fit(
            cfg, cdata, fault_plan=_fault_plan(), snapshot_path=kept,
            resume=True, **kw)
        torch.cuda.synchronize()
        wall_r = time.perf_counter() - t0
        n_r = dict(wh.LAUNCHES)
        same = all(torch.equal(a, b) for x, y in zip(
            res_a.adapters_per_cluster, res_r.adapters_per_cluster)
            for a, b in zip(tree_util.leaves(x), tree_util.leaves(y)))
        _check(same, "phase 5c: the resumed adapters differ from run A's")
        _check([l.train_loss for l in res_r.logs] == losses_a,
               "phase 5c: the resumed round losses differ from run A's")
        _check([r.to_dict() for r in res_r.fleet.records]
               == [r.to_dict() for r in led.records],
               "phase 5c: the resumed ledger differs from run A's")
        launches += n_r["wire_hop_int8"]
        peak_r = torch.cuda.max_memory_allocated() / 2 ** 30
        _check(peak_r < 80, f"phase 5c resume: peak {peak_r:.2f} GiB")
        print(f"[{card}] phase 5c resume from the snapshot after round 1 "
              f"cluster 0: adapters, round losses and ledger equal to run "
              f"A's bit for bit; {n_r['wire_hop_int8']} hop launches, "
              f"{wall_r:.2f} s, peak {peak_r:.2f} GiB")
        del res_r

        # -- run B: secure int8 aggregation with a crash dropout -----------
        pending, sums = [], []

        def keep_codes(args, kw_, out):
            pending.append(out[0].copy())

        def check_sum(args, kw_, out):
            masked, survivors = args[0], args[1]
            codes, pending[:] = pending[:], []
            _check(len(codes) == len(survivors), "phase 5c run B: encodes "
                   f"{len(codes)} for {len(survivors)} survivors")
            plain = np.sum(np.stack(codes), axis=0, dtype=np.int64)
            _check(np.array_equal(out.astype(np.int64), plain),
                   "phase 5c run B: unmasked code sum differs from the "
                   "survivors' plain sum")
            sums.append((list(survivors), len(kw_["participants"])))

        plan_b = FaultPlan({c["corrupt"]: [Fault("crash",
                                                 rounds=frozenset({1}))]},
                           base_fit_s=FAULT_BASE_S)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with _Stopwatch(secure_agg, "secure_encode",
                        keep=keep_codes) as enc, \
                _Stopwatch(secure_agg, "mask_codes") as mask, \
                _Stopwatch(secure_agg, "unmask_sum", keep=check_sum) as unm:
            res_b = fed_trainer.federated_fit(
                cfg, cdata, **dict(kw, rounds=2), fault_plan=plan_b,
                secure_aggregation=True)
            torch.cuda.synchronize()
        wall_b = time.perf_counter() - t0
        peak_b = torch.cuda.max_memory_allocated() / 2 ** 30
        _check(len(sums) == 2 * ft.num_clusters, f"phase 5c run B: {sums}")
        dropped = [(s, n) for s, n in sums if len(s) < n]
        _check(len(dropped) == 1, f"phase 5c run B: dropouts {sums}")
        _check(res_b.fleet.rejections_by_reason() == {"crash": 1},
               f"phase 5c run B: {res_b.fleet.rejections_by_reason()}")
        _check(all(bool(torch.isfinite(l).all())
                   for ad in res_b.adapters_per_cluster
                   for l in tree_util.leaves(ad)),
               "phase 5c run B: non-finite adapters")
        _check(peak_b < 80, f"phase 5c run B: peak {peak_b:.2f} GiB")
        print(f"[{card}] phase 5c run B (secure int8, client "
              f"{c['corrupt']} crashes in round 1): {len(sums)} unmasked code "
              f"sums equal to the survivors' plain sums bit for bit (one "
              f"with {dropped[0][1] - len(dropped[0][0])} dropout "
              f"recovered), adapters finite, round losses "
              f"{[round(l.train_loss, 4) for l in res_b.logs]}; host: "
              f"{enc.calls} encodes {1e3 * enc.seconds:.1f} ms, {mask.calls} "
              f"masks {1e3 * mask.seconds:.1f} ms, {unm.calls} unmasks "
              f"{1e3 * unm.seconds:.1f} ms ({n_elems} elements each); "
              f"{wall_b:.2f} s in all, peak {peak_b:.2f} GiB")
        del res_a, res_b
    finally:
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 7: the centralized path and the paper's comparisons at full width
# ---------------------------------------------------------------------------

# Phase 7a: Fig. 3's centralized arm (benchmarks/fig3_convergence.py:42-58):
# FedTime's backbone on the pooled client windows, every float leaf trained
# (no LoRA, no NF4), at fedtime-llama2-7b's published widths with the
# benchmark's lookback 512 and horizon 96.  Depth cut 32 -> 16: full
# fine-tune state is 12 B a parameter (bf16 weight 2, bf16 gradient 2, f32
# moments 8), 78 GB for 32 layers before any activation, which does not fit
# an 80 GB card; 16 layers hold 3.26e9 parameters, about 39 GB.  Steps cut
# from the benchmark's 12 rounds x 64 to 8.
CENTRAL = dict(layers=16, horizon=96, channels=2, batch=4, steps=8, lr=1e-3,
               timesteps=8000)
CARD_BYTES = 80e9
# Phase 7b: Table 2's comparison models at the reference's --full settings
# (benchmarks/table2_forecasting.py:27-70) on ETTh1 at its longest horizon,
# data made as benchmarks/common.forecast_data makes it (train windows at
# stride 2, test at stride 8).  FSLSTM at Table 3's width
# (benchmarks/table3_federated.py:109); its steps cut from Table 3's 320
# local steps to 20, since its Python loop over time runs 2 x 512 steps a
# forward.
TABLE2 = dict(dataset="etth1", timesteps=8000, lookback=512, horizon=720,
              batch=64)
TABLE2_FITS = {"dlinear": dict(steps=400, lr=5e-3),
               "patchtst": dict(steps=200, lr=1e-3),
               "fslstm": dict(steps=20, lr=1e-3)}
PATCHTST_FULL = dict(d_model=128, num_layers=3, num_heads=16, d_ff=256,
                     patch_len=8, stride=4)
FSLSTM_WIDTH = dict(d_hidden=32, layers=2)


def _kernel_modules():
    """The kernels' wrapper modules, each with its ``LAUNCHES`` counts."""
    from repro_torch.kernels import (flash_attention, flash_decode,
                                     qlora_matmul, rmsnorm, wire_hop)
    return flash_decode, wire_hop, qlora_matmul, flash_attention, rmsnorm


def _central_config(layers: int = CENTRAL["layers"]):
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config("fedtime-llama2-7b")
    return cfg.replace(num_layers=layers, fedtime=dataclasses.replace(
        cfg.fedtime, horizon=CENTRAL["horizon"]))


def _pooled_windows(ft, timesteps: int, channels: int):
    """fig3_convergence's data: 8 clients of ``channels`` channels, their
    windows pooled; the test windows of the same series."""
    from repro_torch.data.federated import client_windows, partition_clients
    from repro_torch.data.timeseries import (DATASETS, generate,
                                             make_windows, train_test_split)
    tr, te = train_test_split(generate(DATASETS["etth1"],
                                       timesteps=timesteps))
    cdata = client_windows(partition_clients(tr, 8, seed=0,
                                             channels_per_client=channels),
                           ft.lookback, ft.horizon, max_windows=64)
    xte, yte = make_windows(te, ft.lookback, ft.horizon, stride=8)
    return (np.concatenate([x for x, _ in cdata]),
            np.concatenate([y for _, y in cdata]),
            xte[..., :channels], yte[..., :channels])


def _draws(x, y, batch: int, seed: int = 0):
    """Batches of ``batch`` windows drawn with replacement, as the
    reference's benchmarks draw them; ``x``/``y`` may live on the card."""
    rng = np.random.default_rng(seed)
    while True:
        s = rng.integers(0, len(x), batch)
        if isinstance(x, torch.Tensor):
            s = torch.from_numpy(s).to(x.device)
        yield {"x": x[s], "y": y[s]}


def _step_walls(logs) -> list:
    """Each step's wall time from ``TrainLog.seconds`` (cumulative, read
    after ``float(loss)``, which waits for the step's device work)."""
    secs = [l.seconds for l in logs]
    return [b - a for a, b in zip([0.0] + secs, secs)]


def _profile_one_step(loss_fn, params, batches, top: int = 8):
    """``tools/profile_fit.py``'s method on one step of ``fit`` (a fresh
    fit: its moments are made inside): the step's wall, the device time of
    its kernels, the busy share, kernel launches and the top operators."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.train.trainer import fit
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fit(loss_fn, params, batches, steps=1)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    del out
    events = prof.key_averages()
    dev_us = sum(e.self_device_time_total for e in events
                 if e.device_type == DeviceType.CUDA)
    launches = sum(e.count for e in events
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                "cudaLaunchKernelExC"))
    ops = sorted((e for e in events if e.device_type != DeviceType.CUDA
                  and e.self_device_time_total > 0),
                 key=lambda e: -e.self_device_time_total)[:top]
    return wall, dev_us / 1e3, launches, [
        (e.key, e.self_device_time_total / 1e3, e.count) for e in ops]


def phase_centralized(card: str, cfg=None, device="cuda") -> None:
    """Phase 7a: Fig. 3's centralized fine-tune through ``trainer.fit``
    (AdamW under the cosine schedule, every float leaf trained), then
    ``evaluate_forecaster`` on the test windows and one profiled step.
    The CPU rehearsal passes a smoke ``cfg``."""
    from repro_torch import tree as tree_util
    from repro_torch.core import fedtime
    from repro_torch.core.lora import count_params, tree_nbytes
    from repro_torch.train.trainer import evaluate_forecaster, fit
    cfg = cfg or _central_config()
    ft = cfg.fedtime
    C = CENTRAL["channels"]
    x, y, xte, yte = _pooled_windows(ft, CENTRAL["timesteps"], C)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = fedtime.init(cfg, torch.Generator(device=device).manual_seed(0),
                          num_channels=C, device=device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n = count_params(params)
    N = (ft.lookback - ft.patch_len) // ft.patch_stride + 1
    d = cfg.d_model
    layer_n = 2 * d * (cfg.q_dim + cfg.kv_dim) + 3 * d * cfg.d_ff
    want_n = (cfg.num_layers * (layer_n + 2 * d) + (ft.patch_len + N) * d
              + d + N * d * ft.horizon + 2 * C)
    _check(n == want_n, f"phase 7a: {n} parameters, not {want_n}")
    state_gb = (tree_nbytes(params) * 2 + 8 * n) / 1e9
    loss_fn = lambda p, b: fedtime.loss(p, cfg, b)  # noqa: E731
    t0 = time.perf_counter()
    params, logs, _ = fit(loss_fn, params, _draws(x, y, CENTRAL["batch"]),
                          steps=CENTRAL["steps"], lr=CENTRAL["lr"])
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    losses = [l.loss for l in logs]
    _check(len(losses) == CENTRAL["steps"] and all(np.isfinite(losses)),
           f"phase 7a: losses {losses}")
    _check(all(bool(torch.isfinite(l).all())
               for l in tree_util.leaves(params)),
           "phase 7a: non-finite parameters")
    t0 = time.perf_counter()
    metrics = evaluate_forecaster(lambda p, xx: fedtime.forward(p, cfg, xx),
                                  params, xte, yte)
    eval_s = time.perf_counter() - t0
    _check(all(np.isfinite(v) for v in metrics.values()),
           f"phase 7a: metrics {metrics}")
    _check(peak < CARD_BYTES, f"phase 7a: peak {peak / 1e9:.2f} GB")
    walls = _step_walls(logs)
    print(f"[{card}] phase 7a centralized fit {cfg.name}: widths as "
          f"published (d_model {cfg.d_model}, {cfg.num_heads}/"
          f"{cfg.num_kv_heads} heads of {cfg.head_dim}, d_ff {cfg.d_ff}, "
          f"{cfg.param_dtype}, lookback {ft.lookback}, patches "
          f"{ft.patch_len}/{ft.patch_stride}, horizon {ft.horizon}); cut: "
          f"layers 32 -> {cfg.num_layers}, steps 768 -> {CENTRAL['steps']};"
          f" every float leaf trained, batch {CENTRAL['batch']} x {C} "
          f"channels, lr {CENTRAL['lr']}, {len(x)} pooled windows")
    print(f"[{card}] phase 7a memory: {n} parameters (= {cfg.num_layers} x "
          f"{layer_n} + norms, patch and head) x 12 B (bf16 weight 2, "
          f"bf16 gradient 2, f32 moments 8) = {state_gb:.2f} GB of state; "
          f"peak device memory {peak / 1e9:.2f} GB ({peak / 2 ** 30:.2f} "
          f"GiB), under the card's 80 GB")
    print(f"[{card}] phase 7a losses {[round(l, 4) for l in losses]}; test "
          f"MSE {metrics['mse']:.4f} MAE {metrics['mae']:.4f} over "
          f"{len(xte)} windows; host clock (synchronized): init "
          f"{init_s:.2f} s, step walls "
          f"{[round(w, 4) for w in walls]} s (median of steps 2+ "
          f"{float(np.median(walls[1:])):.4f} s), fit {fit_s:.2f} s, "
          f"evaluation {eval_s:.2f} s")
    if device == "cuda":
        wall, dev_ms, launches, ops = _profile_one_step(
            loss_fn, params, _draws(x, y, CENTRAL["batch"], seed=1))
        step = float(np.median(walls[1:]))
        print(f"[{card}] phase 7a one profiled step (a fresh fit, its "
              f"moments made inside): device {dev_ms:.1f} ms, busy share "
              f"{dev_ms / 1e3 / step:.3f} of the profiler-off step wall "
              f"({wall:.2f} s under the profiler, its start-up included), "
              f"{launches} kernel launches; top operators by device time: "
              + "; ".join(f"{k} {ms:.1f} ms x{c}" for k, ms, c in ops))
    del params
    torch.cuda.empty_cache()


def _table2_models(device, lookback, horizon, channels, patchtst_kw,
                   fslstm_kw):
    """name -> (params, loss_fn, forward_fn), each drawn from its own
    seeded generator."""
    from repro_torch.baselines import dlinear, fslstm, patchtst
    g = lambda s: torch.Generator(device=device).manual_seed(s)  # noqa
    pcfg = patchtst.make_config(lookback=lookback, horizon=horizon,
                                **patchtst_kw)
    return {
        "dlinear": (dlinear.init(g(0), lookback, horizon, device=device),
                    dlinear.loss, dlinear.forward),
        "patchtst": (patchtst.init(pcfg, g(1), num_channels=channels,
                                   device=device),
                     lambda p, b: patchtst.loss(p, pcfg, b),
                     lambda p, x: patchtst.forward(p, pcfg, x)),
        "fslstm": (fslstm.init(g(2), channels=channels, horizon=horizon,
                               device=device, **fslstm_kw),
                   fslstm.loss, fslstm.forward),
    }


def phase_table2(card: str, device="cuda", fits=None) -> None:
    """Phase 7b: persistence, DLinear, PatchTST and FSLSTM on ETTh1 at
    lookback 512 and horizon 720, each trained by ``trainer.fit`` and
    scored by ``evaluate_forecaster``.  No ranking is asked for: Table 2's
    rests on pretrained weights the repository does not have."""
    from repro_torch.data.timeseries import (DATASETS, generate,
                                             make_windows, train_test_split)
    from repro_torch.train.trainer import evaluate_forecaster, fit
    fits = fits or TABLE2_FITS
    L, T = TABLE2["lookback"], TABLE2["horizon"]
    tr, te = train_test_split(generate(DATASETS[TABLE2["dataset"]],
                                       timesteps=TABLE2["timesteps"]))
    xtr, ytr = make_windows(tr, L, T, stride=2)
    xte, yte = make_windows(te, L, T, stride=8)
    M = xtr.shape[-1]
    x_dev = torch.from_numpy(xtr).to(device)
    y_dev = torch.from_numpy(ytr).to(device)
    persist = np.repeat(xte[:, -1:, :], T, axis=1)
    rows = {"persistence": {"mse": float(np.mean((persist - yte) ** 2)),
                            "mae": float(np.mean(np.abs(persist - yte)))}}
    print(f"[{card}] phase 7b Table 2 on {TABLE2['dataset']} "
          f"({TABLE2['timesteps']} steps, {M} channels), lookback {L}, "
          f"horizon {T}: {len(xtr)} train windows (stride 2), {len(xte)} "
          f"test windows (stride 8), batch {TABLE2['batch']}; PatchTST "
          f"{PATCHTST_FULL} (head dim "
          f"{PATCHTST_FULL['d_model'] // PATCHTST_FULL['num_heads']}), "
          f"FSLSTM {FSLSTM_WIDTH}; steps {fits} (FSLSTM cut from Table 3's "
          f"320)")
    models = _table2_models(device, L, T, M, PATCHTST_FULL, FSLSTM_WIDTH)
    for name, (params, loss_fn, fwd) in models.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, logs, _ = fit(loss_fn, params,
                              _draws(x_dev, y_dev, TABLE2["batch"]),
                              **fits[name])
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        losses = [l.loss for l in logs]
        _check(all(np.isfinite(losses)), f"phase 7b {name}: losses "
               f"{losses}")
        first, last = np.mean(losses[:10]), np.mean(losses[-10:])
        if name != "fslstm":
            _check(last < first, f"phase 7b {name}: the loss did not fall "
                   f"(first 10 steps {first:.4f}, last 10 {last:.4f})")
        m = evaluate_forecaster(fwd, params, xte, yte)
        _check(all(np.isfinite(v) for v in m.values()),
               f"phase 7b {name}: metrics {m}")
        walls = _step_walls(logs)
        rows[name] = m
        print(f"[{card}] phase 7b {name}: {len(losses)} steps, loss "
              f"{first:.4f} over the first 10 -> {last:.4f} over the last "
              f"10; test MSE {m['mse']:.4f} MAE {m['mae']:.4f}; fit "
              f"{fit_s:.2f} s (host clock, synchronized), median step "
              f"{float(np.median(walls[1:])) * 1e3:.2f} ms")
    print(f"[{card}] phase 7b test MSE / MAE: " + "; ".join(
        f"{k} {v['mse']:.4f} / {v['mae']:.4f}" for k, v in rows.items()))


def phase_fig5(card: str, up_per_upload: dict) -> None:
    """Phase 7c: Fig. 5's three strategies on phase 5's tree
    (fedtime-llama2-7b, 32 layers, NF4 base, LoRA rank 8), its shapes
    rebuilt on the meta device: ``fedtime_round`` on each wire,
    ``fed_full_round`` and ``centralized_epoch`` for phase 5's client
    windows, each held to its closed form; FedTime's upload on the int8
    and bf16 wires held to phase 5's measured bytes up per upload."""
    import math
    from repro_torch.core import comm, fedtime
    from repro_torch.core.lora import (attach_lora, count_params, lora_tree,
                                       quantize_base)
    cfg = _fit_config()
    ft = cfg.fedtime
    g = torch.Generator()
    tree = quantize_base(attach_lora(
        fedtime.init(cfg, g, num_channels=FIT_CHANNELS, device="meta"), g,
        rank=ft.lora_rank, alpha=ft.lora_alpha), qblock=ft.qlora_block)
    cdata, _, _ = _fit_data(ft)
    L, d, dff, r = cfg.num_layers, cfg.d_model, cfg.d_ff, ft.lora_rank
    N = (ft.lookback - ft.patch_len) // ft.patch_stride + 1
    E = L * 4 * (d * r + r * d)
    _check(count_params(lora_tree(tree)) == E == HOP_ELEMS,
           "phase 7c: adapter elements")
    cpr, k = ft.clients_per_round, ft.num_clusters
    code = {"f32": 4, "bf16": 2, "int8": 1}
    rounds = {}
    for wire in ("f32", "bf16", "int8"):
        st = comm.fedtime_round(tree, clients_per_round=cpr, num_clusters=k,
                                wire=wire)
        pay = E * code[wire] + (4 * math.ceil(E / HOP_QBLOCK)
                                if wire == "int8" else 0)
        _check((st.bytes_up, st.bytes_down, st.messages) ==
               (pay * cpr, pay * cpr, 2 * cpr + k),
               f"phase 7c: fedtime_round {wire} {st}")
        if wire in up_per_upload:
            _check(pay == up_per_upload[wire], f"phase 7c: {wire} upload "
                   f"priced {pay} B, phase 5 measured "
                   f"{up_per_upload[wire]} B")
        rounds[f"fedtime {wire}"] = st
    # every leaf in its dtype: NF4 attention (codes + one f32 scale a block
    # of 64), f32 adapters and scales, bf16 MLP, patch and head, f32 norms
    layer = (4 * (d * d // 2 + d * d // ft.qlora_block * 4 + 2 * d * r * 4
                  + 4) + 3 * d * dff * 2 + 2 * d * 4)
    full_bytes = (L * layer + (ft.patch_len + N) * d * 2 + N * d *
                  ft.horizon * 2 + d * 4 + 2 * FIT_CHANNELS * 4)
    st = comm.fed_full_round(tree, clients_per_round=cpr, num_clusters=k)
    _check((st.bytes_up, st.bytes_down, st.messages) ==
           (full_bytes * cpr, full_bytes * cpr, 2 * cpr + k),
           f"phase 7c: fed_full_round {st}, closed form {full_bytes} B a "
           f"payload")
    rounds["fed_full"] = st
    samples = sum(len(x) for x, _ in cdata)
    st = comm.centralized_epoch(samples, ft.lookback, ft.horizon,
                                FIT_CHANNELS, num_clients=ft.num_clients)
    _check((st.bytes_up, st.bytes_down, st.messages) ==
           (samples * (ft.lookback + ft.horizon) * FIT_CHANNELS * 4, 0,
            ft.num_clients), f"phase 7c: centralized_epoch {st}")
    rounds["centralized"] = st
    print(f"[{card}] phase 7c Fig. 5 on phase 5's tree ({L} layers, NF4 "
          f"base, LoRA rank {r}: {E} adapter elements, {full_bytes} B of "
          f"weights), {cpr} clients a round, {k} clusters, {samples} pooled "
          f"windows of {ft.lookback}+{ft.horizon} steps x {FIT_CHANNELS} "
          f"channels; each count equal to its closed form, the int8 and "
          f"bf16 uploads to phase 5's measured bytes: " + "; ".join(
              f"{name} {s.bytes_up + s.bytes_down} B ({s.megabytes:.2f} MB, "
              f"{s.messages} messages, {s.time_s:.2f} s modelled)"
              for name, s in rounds.items()))
    full = rounds["fed_full"].bytes_up
    print(f"[{card}] phase 7c full / FedTime bytes a round: "
          f"{full / rounds['fedtime f32'].bytes_up:.1f}x on the f32 wire, "
          f"{full / rounds['fedtime int8'].bytes_up:.1f}x on int8")


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


def _centralized_reference(card: str, device="cuda") -> None:
    """Phase 6's check of phase 7's path: ``trainer.fit`` on the card
    against the CPU at small sizes in f32, the same weights and batches:
    FedTime's smoke config (Fig. 3's centralized arm) and each Table 2
    model at a small width, 4 steps each, every step's loss within
    TOL_FIT_LOSS (relative)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import fedtime
    from repro_torch.data.timeseries import (DATASETS, generate,
                                             make_windows)
    from repro_torch.train.trainer import fit
    cfg = get_smoke_config("fedtime-llama2-7b")
    x, y, _, _ = _pooled_windows(cfg.fedtime, 1200, 2)
    xb, yb = make_windows(generate(DATASETS["etth1"], timesteps=400)[:, :3],
                          32, 8, stride=4)
    cases = {"fedtime smoke": (
        fedtime.init(cfg, torch.Generator().manual_seed(0), num_channels=2,
                     device="cpu"),
        lambda p, b: fedtime.loss(p, cfg, b), x, y, 1e-3)}
    small = _table2_models("cpu", 32, 8, 3, dict(
        d_model=16, num_layers=2, num_heads=4, d_ff=32, patch_len=8,
        stride=4), dict(d_hidden=8))
    for name, (params, loss_fn, _) in small.items():
        cases[name] = (params, loss_fn, xb, yb, TABLE2_FITS[name]["lr"])
    errs = {}
    for name, (params, loss_fn, xs, ys, lr) in cases.items():
        losses = {}
        for dev in ("cpu", device):
            _, logs, _ = fit(loss_fn, _to(params, dev), _draws(xs, ys, 4),
                             steps=4, lr=lr)
            losses[dev] = [l.loss for l in logs]
        err = max(abs(a - b) / abs(b)
                  for a, b in zip(losses[device], losses["cpu"]))
        _check(err <= TOL_FIT_LOSS, f"reference centralized {name}: card "
               f"vs CPU step losses differ by {err} (relative) > "
               f"{TOL_FIT_LOSS}")
        errs[name] = err
    print(f"[{card}] reference centralized fits f32, 4 steps of "
          f"trainer.fit: card vs CPU step losses max rel err " + ", ".join(
              f"{k} {v:.3g}" for k, v in errs.items()) +
          f" (tol {TOL_FIT_LOSS})")


# ---------------------------------------------------------------------------
# phase 8: the mesh path, 8 and 4 ranks on the one card over gloo
# ---------------------------------------------------------------------------

# 8a: the ring over fedtime-llama2-7b's adapter payload (HOP_ELEMS a member,
# its LoRA tree's shapes), 16 members, on both meshes and every wire.
MESH_RING = dict(members=16, state_rounds=2, ef_rounds=8, seed=0,
                 meshes=(((8, 1), ("data", "model")),
                         ((2, 2, 2), ("pod", "data", "model"))))
MESH_WIRES = ("f32", "bf16", "int8")
# the reference's tolerances against the exact weighted sum
# (tests/test_ring_collective.py); error feedback's limit on the
# time-average's bias as a share of the one-shot bias
MESH_TOL = {"f32": 1e-6, "bf16": 5e-2, "int8": 0.3}
EF_LIMIT = 0.35
# bytes a device a round of an n-way ring over HOP_ELEMS (the chunk plan)
MESH_RING_BYTES = {
    8: {"f32": 58_720_256, "bf16": 29_360_128, "int8": 15_138_816},
    2: {"f32": 33_554_432, "bf16": 16_777_216, "int8": 8_650_752}}
# 8b: the sequence-sharded decode on (data 1, model 4), each served
# config's heads; 8c: ZeRO-1 on (data 4) and (data 2, model 2)
MESH_DECODE = dict(mesh=((1, 4), ("data", "model")), B=4, S=4096,
                   window=1000, int8_tol=3e-2)
MESH_ZERO1 = dict(meshes=(((4,), ("data",)), ((2, 2), ("data", "model"))),
                  steps=3, lr=1e-3, weight_decay=0.01)
MESH_TIMEOUT_S = 300


def _adapter_shapes(cfg=None):
    """{path: shape} of one member's federated payload: fedtime-llama2-7b's
    LoRA tree at full width (phase 5's), its shapes from the meta device."""
    from repro_torch.core import fedtime
    from repro_torch.core.lora import attach_lora, lora_tree
    cfg = cfg or _fit_config()
    ft = cfg.fedtime
    g = torch.Generator()
    tree = lora_tree(attach_lora(fedtime.init(
        cfg, g, num_channels=FIT_CHANNELS, device="meta"), g,
        rank=ft.lora_rank, alpha=ft.lora_alpha))

    def shapes(node):
        if isinstance(node, dict):
            return {k: shapes(v) for k, v in node.items()}
        return tuple(node.shape)
    return shapes(tree)


def _tree_of(shapes, make):
    if isinstance(shapes, dict):
        return {k: _tree_of(shapes[k], make) for k in sorted(shapes)}
    return make(shapes)


def _sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def _timed(device: str, fn, *args, **kw):
    _sync(device)
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    _sync(device)
    return out, time.perf_counter() - t0


def _peak_gib(device: str) -> float:
    return (torch.cuda.max_memory_allocated() / 2 ** 30
            if device == "cuda" else 0.0)


def _bits_equal(a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


def _mesh_ring_rank(shapes, device="cuda"):
    """8a in one rank: the ring on each mesh and wire, on the device (the
    hop kernel) and on the host (its plain version) in the same rank."""
    import torch.distributed as dist
    from repro_torch import tree as tree_util
    from repro_torch.core import comm
    from repro_torch.dist import collectives, fed, fedcomm
    from repro_torch.kernels import wire_hop as wh
    from repro_torch.launch.mesh import make_mesh
    for k in ("REPRO_FED_WIRE", "REPRO_FED_QBLOCK", "REPRO_FED_RING"):
        os.environ.pop(k, None)
    cuda = device == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    n = MESH_RING["members"]
    g = torch.Generator(device=device).manual_seed(MESH_RING["seed"])
    # integers in eighths, |x| <= 1 (the reference test's -8..8, over 8):
    # a sum of them is exact in f32 in any order, and the f32 rounding of
    # a weighted sum stays well under 1e-6 over 8.4M elements (at -8..8 it
    # reaches 9.4e-7)
    members = _tree_of(shapes, lambda s: torch.randint(
        -8, 9, (n,) + s, generator=g, device=device).float() / 8)
    host = tree_util.map_(lambda t: t.cpu(), members)
    wf = torch.rand(n, generator=torch.Generator().manual_seed(1))
    wf = wf / wf.sum()
    ones = torch.ones(n)
    like = _tree_of(shapes, lambda s: torch.empty(s, device="meta"))
    elems = sum(t.numel() for t in tree_util.leaves(like))

    def exact(w):
        w = w.double().to(device)
        return torch.cat([torch.tensordot(w, t.double(), dims=1).reshape(-1)
                          for t in tree_util.leaves(members)])

    exact_w, exact_1 = exact(wf), exact(ones)
    wh.reset_launches()
    out = {"rank": dist.get_rank(), "meshes": {}}
    meshes = []
    with _HopRecorder(wh, keep=3) as rec:
        for shape, names in MESH_RING["meshes"]:
            mesh = make_mesh(shape, names, device_type=device)
            meshes.append(mesh)
            sizes = {ax: collectives.axis_size(mesh, ax)
                     for ax in fed.aggregation_axes(mesh)}
            label = " x ".join(f"{a} {s}" for a, s in zip(names, shape))
            o, _ = _timed(device, fedcomm.ring_aggregate, members, ones,
                          mesh, wire="f32")
            _check(torch.equal(tree_util.ravel(o).double(), exact_1),
                   f"8a {label}: the f32 ring of integer payloads is not the "
                   f"exact sum bit for bit")
            got = {"sizes": sizes}
            for wire in MESH_WIRES:
                before = sum(wh.LAUNCHES.values())
                ledger = []
                o, wall = _timed(device, fedcomm.ring_aggregate, members, wf,
                                 mesh, wire=wire, byte_ledger=ledger)
                hops = sum(wh.LAUNCHES.values()) - before
                per_axis = {}
                for ax, nbytes in ledger:
                    per_axis[ax] = per_axis.get(ax, 0) + nbytes
                expected = fed.expected_collective_bytes(like, mesh, wire)
                accounted = comm.collective_bytes_per_round(like, mesh, wire)
                for ax, size in sizes.items():
                    want = comm.ring_wire_plan(elems, size,
                                               wire).per_device_bytes
                    _check(per_axis[ax] == want == expected[ax] ==
                           accounted[ax], f"8a {label} {wire}: {ax} bytes "
                           f"{per_axis[ax]}, plan {want}, expected "
                           f"{expected[ax]}, accounted {accounted[ax]}")
                    if elems == HOP_ELEMS:
                        _check(per_axis[ax] == MESH_RING_BYTES[size][wire],
                               f"8a {label} {wire}: {ax} bytes "
                               f"{per_axis[ax]}")
                want_hops = (0 if wire == "f32" or not cuda
                             else sum(2 * s for s in sizes.values()))
                _check(hops == want_hops, f"8a {label} {wire}: {hops} hop "
                       f"launches a round, not {want_hops}")
                flat = tree_util.ravel(o)
                err = float((flat.double() - exact_w).abs().max())
                _check(err <= MESH_TOL[wire], f"8a {label} {wire}: max err "
                       f"{err} against the exact sum > {MESH_TOL[wire]}")
                st = fedcomm.init_state(members, mesh, wire=wire)
                outs = [flat]
                for _ in range(MESH_RING["state_rounds"]):
                    (o, st), _ = _timed(device, fedcomm.ring_aggregate,
                                        members, wf, mesh, wire=wire,
                                        state=st)
                    outs.append(tree_util.ravel(o))
                # the same ring on the host in this rank: the plain hop
                plain = [tree_util.ravel(fedcomm.ring_aggregate(
                    host, wf, mesh, wire=wire))]
                sth = fedcomm.init_state(host, mesh, wire=wire)
                for _ in range(MESH_RING["state_rounds"]):
                    o, sth = fedcomm.ring_aggregate(host, wf, mesh,
                                                    wire=wire, state=sth)
                    plain.append(tree_util.ravel(o))
                for i, (a, b) in enumerate(zip(outs, plain)):
                    _check(_bits_equal(a.cpu(), b), f"8a {label} {wire}: "
                           f"round {i} on the device differs from the "
                           f"host's ring")
                for ax in st:
                    _check(_bits_equal(st[ax].cpu(), sth[ax]),
                           f"8a {label} {wire}: {ax} residual differs from "
                           f"the host's ring")
                got[wire] = dict(bytes=per_axis, hops=hops, err=err,
                                 wall=wall, transfers=len(ledger),
                                 fingerprint=int(flat.view(torch.int32)
                                                 .long().sum()))
            out["meshes"][label] = got
        mesh = meshes[0]
        one, _ = _timed(device, fedcomm.ring_aggregate, members, wf, mesh,
                        wire="int8")
        bias_one = float((tree_util.ravel(one).double() - exact_w).abs()
                         .mean())
        rounds = MESH_RING["ef_rounds"]
        for carry in (True, False):
            st = fedcomm.init_state(members, mesh, wire="int8")
            total = torch.zeros_like(exact_w)
            for _ in range(rounds):
                if not carry:            # the planted fault: residual dropped
                    st = fedcomm.init_state(members, mesh, wire="int8")
                (o, st), _ = _timed(device, fedcomm.ring_aggregate, members,
                                    wf, mesh, wire="int8", state=st)
                total += tree_util.ravel(o).double()
            bias = float((total / rounds - exact_w).abs().mean())
            out["ef" if carry else "ef_fault"] = bias / bias_one
        out["bias_one"] = bias_one
        _check(out["ef"] < EF_LIMIT, f"8a error feedback: {rounds} int8 "
               f"rounds' bias {out['ef']:.3g}x the one-shot, not under "
               f"{EF_LIMIT}")
        _check(out["ef_fault"] >= EF_LIMIT, f"8a error feedback: the "
               f"residual dropped between rounds reads {out['ef_fault']:.3g}"
               f"x, inside the limit {EF_LIMIT}")
    for wire, qblock, args, outs in rec.calls:
        want = wh.fused_hop_ref(*(None if a is None else a
                                  for a in args), wire=wire, qblock=qblock)
        for a, b in zip(outs, want):
            _check((a is None) == (b is None) and
                   (a is None or _bits_equal(a, b)),
                   f"8a: a {wire} hop of the ring differs from the plain hop")
    out["held_hops"] = len(rec.calls)
    out["launches"] = dict(wh.LAUNCHES)
    out["peak_gib"] = _peak_gib(device)
    return out


def _decode_kinds(args, kw, S: int, device: str):
    """The ring's three kinds on one case: (name, args, kw)."""
    q, k, v, kv_pos, q_pos = args
    full = torch.arange(S, dtype=torch.int32, device=device).expand(
        q.shape[0], S).contiguous()
    plen = torch.tensor([S, 3 * S // 4 + 300, S // 40, S // 2 + 600],
                        dtype=torch.int32, device=device)[:q.shape[0]]
    return (("causal", args, dict(kw)),
            ("window", args, dict(kw, window=MESH_DECODE["window"])),
            ("prefix", (q, k, v, full, q_pos),
             dict(kw, kind="prefix", prefix_len=plen)))


def _unsharded(args, kw, device: str):
    """The whole cache through the kernel (a comparison launch, not
    counted) or, on the CPU, the plain version."""
    from repro_torch.kernels import flash_decode as fd
    if device != "cuda":
        return fd.flash_decode_ref(*args, **kw)
    launch, out = fd.flash_decode_launcher(*args, **kw)
    launch()
    return out


def _drop_last_stripe(args, kw, ways: int):
    """The planted fault: the last model rank's stripe masked out (its
    partials would then weigh 0 in the combine).  The last stripe holds
    the newest slots of the longest rows, which every kind attends to."""
    q, k, v, kv_pos, q_pos = args
    kv_pos = kv_pos.clone()
    if kw.get("block_tables") is None:
        kv_pos[:, -(kv_pos.shape[1] // ways):] = -1
    else:
        kv_pos[-(kv_pos.shape[0] // ways):] = -1
    return (q, k, v, kv_pos, q_pos)


def _mesh_decode(mesh, geoms, S: int, device: str) -> dict:
    """8b in one rank: every case through ``sharded_flash_decode`` against
    the whole cache through the kernel."""
    from repro_torch.dist.collectives import axis_size
    from repro_torch.dist.decode import sharded_flash_decode
    from repro_torch.kernels import flash_decode as fd
    B, ways = MESH_DECODE["B"], axis_size(mesh, "model")
    rows = [S - 1, S - 100, 3 * S // 4, S // 2 + 5][:B]
    paged_rows = [S - 1, S - 100, -1, S // 2 + 5][:B]
    n_blocks = B * S // 16 + 8
    kept, calls, got = [], {"ring": 0, "paged": 0}, {}
    fd.reset_launches()

    def keep(a, kw, o):
        if len(kept) < 4:
            kept.append((tuple(x.clone() if torch.is_tensor(x) else x
                               for x in a),
                         {k: x.clone() if torch.is_tensor(x) else x
                          for k, x in kw.items()},
                         tuple(x.clone() for x in o)))

    spy = (_Stopwatch(fd, "flash_decode_cuda", keep=keep)
           if device == "cuda" else contextlib.nullcontext())
    with spy:
        for arch, hw in geoms.items():
            for int8 in (False, True):
                tol = MESH_DECODE["int8_tol"] if int8 else TOL_F32_OUT
                dtype = "int8" if int8 else "bf16"
                args, kw = _decode_case(rows, S, int8, False, device=device,
                                        **hw)
                q32 = args[0].float()
                for kind, a, k in _decode_kinds(args, kw, S, device):
                    a = (q32,) + a[1:]
                    o = sharded_flash_decode(*a, mesh, **k)
                    calls["ring"] += 1
                    want = _unsharded(a, k, device)
                    fault = _unsharded(_drop_last_stripe(a, k, ways), k,
                                       device)
                    err = float((o - want).abs().max())
                    planted = float((fault - want).abs().max())
                    _check(err <= tol and planted > tol, f"8b {arch} ring "
                           f"{dtype} {kind}: max err {err} (tol {tol}), a "
                           f"dropped stripe reads {planted}")
                    got[f"{arch} ring {dtype} {kind}"] = (err, planted, tol)
                # the main path's own type: bf16 queries and output
                o = sharded_flash_decode(*args, mesh, **kw)
                calls["ring"] += 1
                want = _unsharded(args, kw, device)
                g, w = o.float(), want.float()
                over = float(((g - w).abs() - BF16_HALF_STEP *
                              (g.abs() + w.abs()) - TOL_F32_OUT).max())
                _check(over <= 0, f"8b {arch} ring {dtype} bf16 queries: "
                       f"off by more than bf16 rounding ({over} over)")
                args, kw = _decode_case(paged_rows, S, int8, True,
                                        n_blocks=n_blocks, device=device,
                                        **hw)
                a = (args[0].float(),) + args[1:]
                o = sharded_flash_decode(*a, mesh, **kw)
                calls["paged"] += 1
                want = _unsharded(a, kw, device)
                fault = _unsharded(_drop_last_stripe(a, kw, ways), kw,
                                   device)
                err = float((o - want).abs().max())
                planted = float((fault - want).abs().max())
                _check(err <= tol and planted > tol, f"8b {arch} paged "
                       f"{dtype}: max err {err} (tol {tol}), a dropped "
                       f"stripe reads {planted}")
                idle = [b for b, p in enumerate(paged_rows) if p < 0]
                _check(torch.count_nonzero(o[idle]) == 0,
                       f"8b {arch} paged {dtype}: the inactive lane is not "
                       f"exactly 0")
                got[f"{arch} paged {dtype}"] = (err, planted, tol)
    launches = dict(fd.LAUNCHES)
    if device == "cuda":
        _check(launches["flash_decode"] == calls["ring"] and
               launches["flash_decode_paged"] == calls["paged"],
               f"8b: {launches} flash-decode launches for {calls} sharded "
               f"calls: not one a call")
        for a, k, o in kept:             # the path's own calls, held
            m, l, acc = fd.flash_decode_ref(*a, **k)
            err = float((o[2] / torch.clamp(o[1], min=1e-30)
                         - acc / torch.clamp(l, min=1e-30)).abs().max())
            _check(err <= TOL_F32_OUT, f"8b: a stripe's partials off the "
                   f"plain version's by {err}")
    return {"cases": got, "calls": calls, "launches": launches,
            "held_stripes": len(kept)}


def _zero1_trees(qwen_cfg, adapter_shapes, device: str):
    """(name, params, gather): qwen3-0.6b's whole tree and
    fedtime-llama2-7b's adapter tree, every leaf trained; ``gather`` says
    whether the moments are also gathered whole to be held (the adapters';
    qwen3's are held block by block on every rank, which covers every
    block)."""
    from repro_torch.models.registry import get_model
    g = torch.Generator(device=device).manual_seed(3)
    qwen = get_model(qwen_cfg).init(qwen_cfg, g, device=device)
    adapters = _tree_of(adapter_shapes, lambda s: torch.randn(
        s, generator=g, device=device) * 0.01)
    return (("qwen3-0.6b", qwen, False),
            ("fedtime-llama2-7b adapters", adapters, True))


def _grad_leaf(p, step: int, i: int, device: str):
    """Leaf ``i``'s gradient at ``step``: its own seeded draw, so that one
    leaf's gradients can be drawn without the rest of the tree's."""
    g = torch.Generator(device=device).manual_seed(100_000 * step + i)
    return (torch.randn(p.shape, generator=g, device=device) * 0.01).to(
        p.dtype)


def _grads(params, step: int, device: str):
    from repro_torch import tree as tree_util
    return tree_util.unflatten(params, [
        _grad_leaf(p, step, i, device)
        for i, p in enumerate(tree_util.leaves(params))])


def _mesh_zero1(meshes, trees, device: str) -> dict:
    """8c in one rank: three steps of ``adamw_update_zero1`` against three
    of ``adamw_update`` on the same gradients.  ``adamw_update`` runs one
    leaf at a time (AdamW updates each leaf alone, so this is the whole
    tree's update), which keeps one leaf's whole moments on the card at
    once instead of the tree's, four ranks over."""
    from repro_torch import tree as tree_util
    from repro_torch.optim import adamw
    hp = dict(lr=MESH_ZERO1["lr"], weight_decay=MESH_ZERO1["weight_decay"])
    steps = range(1, MESH_ZERO1["steps"] + 1)
    got = {}
    for name, params, gather in trees:
        for (shape, names), mesh in meshes:
            label = f"{name} on " + " x ".join(
                f"{a} {s}" for a, s in zip(names, shape))
            p, st = params, adamw.zero1_init(params, mesh)
            walls = []
            for step in steps:
                g = _grads(params, step, device)
                (p, st), wall = _timed(device, adamw.adamw_update_zero1, p,
                                       g, st, step, mesh=mesh, **hp)
                walls.append(wall)
                del g
            plan = adamw._zero1_plan(params, mesh)
            whole = {"mu": [], "nu": []}
            for i, (x, xz, wi) in enumerate(zip(
                    tree_util.leaves(params), tree_util.leaves(p), plan)):
                lp, lst = {"w": x}, adamw.adamw_init({"w": x})
                for step in steps:
                    lp, lst = adamw.adamw_update(
                        lp, {"w": _grad_leaf(x, step, i, device)}, lst, step,
                        **hp)
                _check(_bits_equal(xz, lp["w"]), f"8c {label}: leaf {i}'s "
                       f"parameters differ from adamw_update")
                for m in ("mu", "nu"):
                    _check(_bits_equal(tree_util.leaves(st[m])[i],
                                       adamw._block(lst[m]["w"], wi, mesh)),
                           f"8c {label}: this rank's block of leaf {i}'s "
                           f"{m} differs from adamw_update's")
                    if gather:
                        whole[m].append(lst[m]["w"])
                del lp, lst
            if gather:
                full = adamw.zero1_gather(st, params, mesh)
                _check(all(_bits_equal(a, b) for m in ("mu", "nu") for a, b
                           in zip(tree_util.leaves(full[m]), whole[m])),
                       f"8c {label}: the gathered moments differ from "
                       f"adamw_update's")
            got[label] = dict(
                moment_bytes=sum(x.numel() * 4 for x in
                                 tree_util.leaves(st)),
                whole_bytes=2 * sum(x.numel() * 4 for x in
                                    tree_util.leaves(params)),
                walls=walls)
            del p, st, whole
            if device == "cuda":
                torch.cuda.empty_cache()
    return got


def _mesh_rest_rank(geoms, S, qwen_cfg, adapter_shapes, device="cuda"):
    """8b and 8c in one rank of the 4-rank world."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    os.environ.pop("REPRO_ZERO1_SCATTER", None)
    os.environ.pop("REPRO_CACHE_SHARD", None)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mesh = make_mesh(*MESH_DECODE["mesh"], device_type=device)
    out = {"rank": dist.get_rank(),
           "decode": _mesh_decode(mesh, geoms, S, device)}
    out["decode_s"] = time.perf_counter() - t0
    out["decode_peak_gib"] = _peak_gib(device)
    _sync(device)
    if device == "cuda":          # four ranks share the card: hand back
        torch.cuda.empty_cache()  # what 8b cached
    t0 = time.perf_counter()
    meshes = [((shape, names), make_mesh(shape, names, device_type=device))
              for shape, names in MESH_ZERO1["meshes"]]
    out["zero1"] = _mesh_zero1(
        meshes, _zero1_trees(qwen_cfg, adapter_shapes, device), device)
    out["zero1_s"] = time.perf_counter() - t0
    out["peak_gib"] = _peak_gib(device)
    return out


def phase_mesh(card: str, device="cuda", shapes=None, geoms=None, S=None,
               qwen_cfg=None) -> dict:
    """Phase 8: the mesh path through ``launch.mesh.spawn_local``, every
    rank on the one card over gloo: 8a the ring (8 ranks), 8b the
    sequence-sharded decode and 8c ZeRO-1 (4 ranks).  The other arguments
    cut it to a rehearsal's size on the CPU.  Returns each mesh path's
    kernel launches, summed over the ranks."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import spawn_local
    t_start = time.perf_counter()
    shapes = shapes or _adapter_shapes()
    if geoms is None:
        geoms = {arch: dict(Hk=Hk, G=G, D=D)
                 for arch, (_, Hk, G, D) in _served_heads().items()}
    S = S or MESH_DECODE["S"]
    qwen_cfg = qwen_cfg or get_config(SERVED[0])
    ring = spawn_local(8, _mesh_ring_rank, shapes, device, device_type=device,
                       timeout_s=MESH_TIMEOUT_S)
    t_ring = time.perf_counter() - t_start
    first = ring[0]
    print(f"[{card}] phase 8a ring over fedtime-llama2-7b's adapter payload "
          f"({HOP_ELEMS} f32 elements a member, {MESH_RING['members']} "
          f"members, integers in eighths), 8 ranks on one card over gloo; "
          f"device ring == host ring (plain hop) bit for bit in every rank, "
          f"f32 ring of unit weights == exact sum bit for bit; "
          f"{first['held_hops']} of its hop calls held to the plain hop bit "
          f"for bit in each rank")
    for label, got in first["meshes"].items():
        for wire in MESH_WIRES:
            r = got[wire]
            prints = {rk["meshes"][label][wire]["fingerprint"]
                      for rk in ring}
            _check(len(prints) == 1, f"8a {label} {wire}: ranks hold "
                   f"different outputs")
            wall = max(rk["meshes"][label][wire]["wall"] for rk in ring)
            print(f"  {label} {wire}: bytes a rank a round "
                  + ", ".join(f"{ax} {b}" for ax, b in r["bytes"].items())
                  + f" (= plan = expected = accounted), {r['transfers']} "
                  f"transfers, {r['hops']} hop launches a rank, max err "
                  f"{r['err']:.3g} vs exact (tol {MESH_TOL[wire]}); round "
                  f"wall {wall * 1e3:.1f} ms (host clock, slowest rank; "
                  f"gloo through the host on one card, not a collective's "
                  f"speed)")
    print(f"[{card}] phase 8a error feedback, {MESH_RING['ef_rounds']} int8 "
          f"rounds on data 8: time-average bias {first['ef']:.4f}x the "
          f"one-shot's ({first['bias_one']:.4g}; limit {EF_LIMIT}); planted "
          f"fault, the residual dropped between rounds: "
          f"{first['ef_fault']:.4f}x")
    print(f"[{card}] phase 8a peak device memory a rank (GiB): "
          + ", ".join(f"{rk['peak_gib']:.2f}" for rk in ring)
          + f"; wall {t_ring:.1f} s with the world's start")
    rest = spawn_local(4, _mesh_rest_rank, geoms, S, qwen_cfg, shapes,
                       device, device_type=device, timeout_s=MESH_TIMEOUT_S)
    first = rest[0]
    dec = first["decode"]
    print(f"[{card}] phase 8b sequence-sharded flash-decode, 4 ranks on "
          f"(data 1, model 4), B {MESH_DECODE['B']}, S {S}; sharded vs the "
          f"whole cache through the kernel (f32 queries), a dropped stripe "
          f"beside; {dec['calls']} sharded calls a rank, flash-decode "
          f"launches {dec['launches']} a rank, {dec['held_stripes']} "
          f"stripes' partials held to the plain version:")
    for case, (err, planted, tol) in dec["cases"].items():
        worst = max(rk["decode"]["cases"][case][0] for rk in rest)
        print(f"  {case}: max_abs_err {worst:.3g} (tol {tol}); dropped "
              f"stripe {planted:.3g}")
    print(f"[{card}] phase 8b wall {first['decode_s']:.1f} s, peak device "
          f"memory a rank (GiB): "
          + ", ".join(f"{rk['decode_peak_gib']:.2f}" for rk in rest))
    for label, z in first["zero1"].items():
        walls = [max(rk["zero1"][label]["walls"][i] for rk in rest)
                 for i in range(MESH_ZERO1["steps"])]
        print(f"[{card}] phase 8c ZeRO-1 {label}: {MESH_ZERO1['steps']} "
              f"steps == adamw_update bit for bit (parameters; moment "
              f"blocks); moments a rank {z['moment_bytes'] / 1e9:.3f} GB of "
              f"{z['whole_bytes'] / 1e9:.3f}; step walls "
              + ", ".join(f"{w:.2f}" for w in walls)
              + " s (host clock, slowest rank; the gather goes through the "
              "host)")
    print(f"[{card}] phase 8c wall {first['zero1_s']:.1f} s; peak device "
          f"memory a rank (GiB): "
          + ", ".join(f"{rk['peak_gib']:.2f}" for rk in rest))
    launches = {
        "wire_hop_int8": sum(rk["launches"]["wire_hop_int8"] for rk in ring),
        "wire_hop_bf16": sum(rk["launches"]["wire_hop_bf16"] for rk in ring),
        "flash_decode": sum(rk["decode"]["launches"]["flash_decode"]
                            for rk in rest),
        "flash_decode_paged": sum(
            rk["decode"]["launches"]["flash_decode_paged"] for rk in rest)}
    if device == "cuda":
        _check(all(launches.values()), f"phase 8: a kernel of the mesh path "
               f"was never launched: {launches}")
    print(f"[{card}] phase 8 kernel launches on the mesh paths (all ranks): "
          f"{launches}; wall {time.perf_counter() - t_start:.1f} s (host "
          f"clock)")
    return launches


# ---------------------------------------------------------------------------
# phase 9: sharded serving, 4 ranks on the one card over gloo
# ---------------------------------------------------------------------------

# 9a: qwen3-0.6b on (data 2, model 2): B 4, a 992-token prompt, a ring of
# 1024 slots (512 a model rank, 2 rows a data rank) that its 32 steps fill
# to the last slot; bf16, int8 and ragged (lane 1 inactive from step 10).
# 9b: a paged pool of qwen3-0.6b's width striped over (data 1, model 4).
# 9c: fedtime-llama2-7b's backbone at full width on (data 1, model 4).
SHARD = dict(B=4, prompt=992, ring=1024, seed=0, idle_lane=1, idle_from=10,
             block=16, paged_idle_from=5, shared=(2, 0, 10), ungranted=(3, 20))
# Steps cut from 64 / 32 / 32 (after a 960-token prompt) to keep the whole
# script well inside its time limit as it grows: with them it took 1050.1 s
# of its 1200 on an H100 host.
SHARD_RUNS = {
    "9a": dict(arch="qwen3-0.6b", mesh=((2, 2), ("data", "model")),
               steps=32, runs=("bf16", "int8", "ragged")),
    "9b": dict(arch="qwen3-0.6b", mesh=((1, 4), ("data", "model")),
               steps=16, runs=("paged",)),
    "9c": dict(arch="fedtime-llama2-7b", mesh=((1, 4), ("data", "model")),
               steps=16, runs=("bf16",)),
}
SHARD_WORLD = 4
SHARD_TIMEOUT_S = 420
# Logits, sharded vs the unsharded run fed the same tokens, at every step
# (bf16 logits): the combine rounds in f32 in another order than the
# kernel's own split merge (and 9a's GEMMs run at half the rows), so a bf16
# attention output or activation can land one step away and ride on
# through the layers: a few bf16 steps of the logits, 2**-5 at |logits|
# 4-8.  The limit is four such steps; a dropped stripe reads far over it.
# Greedy tokens cannot be held bit for bit: with random weights the
# unsharded logits hold exact bf16 ties at top-1 (6-22 row-steps a run),
# which any change in the last bit decides.  A choice may differ only at
# a near-tie: where each run's choice leads the other's by at most
# SHARD_TIE_STEPS bf16 steps at the two logits' magnitude, the same four
# steps a logit may drift by under SHARD_LOGIT_TOL; each is printed with
# both runs' leads.
SHARD_LOGIT_TOL = 0.125
SHARD_TIE_STEPS = 4


def _shard_positions(run: str, i: int, B: int, P: int, device: str):
    """Step ``i``'s positions: an int for the synchronous runs, (B,) int32
    for ragged and paged (the idle lane -1 from its step on)."""
    if run in ("bf16", "int8"):
        return P + i
    idle_from = SHARD["idle_from" if run == "ragged" else "paged_idle_from"]
    pos = torch.full((B,), P + i, dtype=torch.int32, device=device)
    if i >= idle_from:
        pos[SHARD["idle_lane"]] = -1
    return pos


def _shard_pool(ring, B: int, device: str):
    """A paged pool of ``ring``'s rows (layer-stacked leaves (L, B, R,
    ...)): its blocks shuffled over the pool, row ``shared[0]``'s entry
    ``shared[2]`` pointing at row ``shared[1]``'s block (copy-on-write
    sharing: both rows read that one tile), row ``ungranted[0]``'s entry
    ``ungranted[1]`` -1.  Returns (pool, table)."""
    bs = SHARD["block"]
    R = ring["k"].shape[2]
    T = R // bs
    n_blocks = B * T
    g = torch.Generator().manual_seed(SHARD["seed"])
    table = torch.randperm(n_blocks, generator=g).reshape(B, T).to(
        torch.int32)
    pool = {}
    for name, leaf in ring.items():
        tiles = leaf.reshape((leaf.shape[0], B * T, bs) + leaf.shape[3:])
        out = torch.empty_like(tiles)
        out[:, table.reshape(-1).long().to(device)] = tiles
        pool[name] = out
    a, b, j = SHARD["shared"]
    table[a, j] = table[b, j]
    r, j = SHARD["ungranted"]
    table[r, j] = -1
    return pool, table.to(device)


@contextlib.contextmanager
def _wrapping(module, name: str, fn):
    """Inside, ``module.name`` is ``fn(real, *args, **kw)``, where ``real``
    is what it was before."""
    real = getattr(module, name)
    setattr(module, name, lambda *a, **kw: fn(real, *a, **kw))
    try:
        yield
    finally:
        setattr(module, name, real)


def _drop_first_stripe(mesh):
    """The planted fault, for ``_wrapping`` the flash-decode entry that
    ``dist.decode.stripe_flash_decode`` calls: on the first model rank (the
    oldest slots, the prompt's start) the kernel's partials come back as a
    stripe with nothing in it (m -1e30, l and acc 0), so the real combine
    weighs that stripe 0."""
    from repro_torch.dist import collectives
    first = collectives.axis_index(mesh, "model") == 0

    def faulty(real, *args, **kw):
        m, l, acc = real(*args, **kw)
        if first:
            m = torch.full_like(m, -1e30)
            l, acc = torch.zeros_like(l), torch.zeros_like(acc)
        return m, l, acc
    return faulty


def _drop_tile(args, kw):
    """The planted fault of a held stripe call: ``args`` with 128 valid
    slots (a ring) or one granted block (a pool) of its first active row
    masked out, or None where no active row holds anything."""
    q, k, v, kv_pos, q_pos = args
    kv_pos = kv_pos.clone()
    tbl = kw.get("block_tables")
    for b in (q_pos >= 0).nonzero().flatten().tolist():
        if tbl is None:
            valid = (kv_pos[b] >= 0).nonzero().flatten()[:128]
            if len(valid):
                kv_pos[b, valid] = -1
                return (q, k, v, kv_pos, q_pos)
            continue
        for pb in tbl[b].tolist():
            if pb >= 0 and bool((kv_pos[pb] >= 0).any()):
                kv_pos[pb] = -1
                return (q, k, v, kv_pos, q_pos)
    return None


def _hold_stripes(held, mesh) -> list:
    """Hold the kernel calls recorded on the sharded path (a copy of each
    one's inputs and its (m, l, acc) partials) against the plain version's
    partials of the same inputs, on every rank at once: each stripe's own
    output acc / l, both sets of partials combined over ``model`` as
    ``stripe_flash_decode`` combines them, the stripe's empty lanes (l 0:
    an inactive row, or no valid slot on the stripe) exactly 0 in l and acc
    for the kernel too, and a planted fault (the plain partials with one
    tile of an active row dropped).  Returns one reading a call."""
    from repro_torch.dist import collectives
    from repro_torch.kernels import flash_decode as fd

    def out(m, l, acc, combine):
        if combine:
            m_g = collectives.pmax(m, mesh, "model")
            w = torch.exp(m - m_g)
            l = collectives.psum(l * w, mesh, "model")
            acc = collectives.psum(acc * w, mesh, "model")
        return acc / torch.clamp(l, min=1e-30)

    readings = []
    for label, args, kw, (m, l, acc) in held:
        rm, rl, racc = fd.flash_decode_ref(*args, **kw)
        empty = rl == 0
        planted = None
        cut = _drop_tile(args, kw)
        if cut is not None:
            planted = float((out(*fd.flash_decode_ref(*cut, **kw), False)
                             - out(rm, rl, racc, False)).abs().max())
        readings.append(dict(
            call=label,
            shapes=f"q {tuple(args[0].shape)} {args[0].dtype}, k "
                   f"{tuple(args[1].shape)} {args[1].dtype}"
                   + (", a localized table" if kw.get("block_tables")
                      is not None else ""),
            err=float((out(m, l, acc, False)
                       - out(rm, rl, racc, False)).abs().max()),
            combined=float((out(m, l, acc, True)
                            - out(rm, rl, racc, True)).abs().max()),
            empty=int(empty.sum()),
            empty_exact=bool(torch.count_nonzero(l[empty]) == 0 and
                             torch.count_nonzero(acc[empty[..., 0]]) == 0),
            planted=planted))
    return readings


def _leaf_checksum(t) -> tuple:
    """(integer sum of the bit patterns, f64 sum) of one leaf, in chunks
    of 2**24 elements (a whole 7B leaf widened to 64 bits would not fit
    beside the weights)."""
    bits = {2: torch.int16, 4: torch.int32}
    isum = fsum = 0
    for part in t.contiguous().reshape(-1).split(1 << 24):
        isum += int(part.view(bits[part.element_size()]).sum(
            dtype=torch.int64))
        fsum += float(part.sum(dtype=torch.float64))
    return isum, fsum


def _checksum(params) -> tuple:
    """``_leaf_checksum`` summed over every leaf: equal on every rank that
    drew the same weights."""
    from repro_torch import tree as tree_util
    sums = [_leaf_checksum(t) for t in tree_util.leaves(params)]
    return sum(i for i, _ in sums), sum(f for _, f in sums)


def _shard_run(cfg, params, tokens, run: str, steps: int, mesh, device,
               forced=None) -> dict:
    """One serving run: ``make_prefill_step`` then ``steps`` greedy steps
    of ``make_serve_step``; under ``mesh`` on this rank's rows and stripe
    (the whole batch and cache without one).  With ``forced`` ((B, steps +
    1) tokens) each step is fed the forced token instead of its own
    (teacher forcing).  Returns this rank's rows' tokens (and the whole
    batch's, gathered), each step's last-position logits (a device tensor,
    (steps + 1, B_loc, V), the prefill's first), the cache's bytes after
    the prefill, the walls, the flash-decode launches of the steps, the
    idle lane's attention outputs and, under ``mesh``, three of the steps'
    own kernel calls held against the plain version (``_hold_stripes``)
    and a planted fault's reading: one more step with the first model
    rank's partials dropped (``_drop_first_stripe``), against the same
    step whole."""
    from repro_torch.dist import collectives, sharding
    from repro_torch.dist import decode as dist_decode
    from repro_torch.dist.decode import pool_specs
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import transformer
    from repro_torch.models.layers import attention
    from repro_torch.models.registry import get_model
    B, P = tokens.shape
    os.environ["REPRO_KV_INT8"] = "1" if run == "int8" else "0"
    ctx = ((lambda: sharding.use_mesh(mesh)) if mesh is not None
           else contextlib.nullcontext)
    batch = {"tokens": tokens}
    rows = torch.arange(B, device=device)
    bax = None
    if mesh is not None:
        specs = sharding.data_specs(batch, mesh)
        bax = specs["tokens"][0] if specs["tokens"] else None
        rows = sharding.local_shard(rows, specs["tokens"][:1], mesh)
        if run != "paged":
            batch = sharding.local_shard(batch, specs, mesh)
    prefill = make_prefill_step(cfg, cache_len=SHARD["ring"])
    step = make_serve_step(cfg)
    extra = {}
    _sync(device)
    t0 = time.perf_counter()
    if run == "paged":
        ring, lg = prefill(params, batch)         # the whole batch's rings
        cache, table = _shard_pool(ring, B, device)
        del ring
        if mesh is not None:
            cache = sharding.local_shard(cache, pool_specs(cache, mesh),
                                         mesh)
        lg = lg[rows]
        extra = {"block_tbl": table[rows].contiguous(),
                 "ring_len": SHARD["ring"]}
    else:
        with ctx():
            cache, lg = prefill(params, batch)
    _sync(device)
    prefill_s = time.perf_counter() - t0
    cache_bytes = sum(t.nbytes for t in cache.values())
    idle, real = [], attention.stripe_flash_decode
    logits, real_logits = [lg[:, -1].clone()], transformer.logits_fn

    def spy(q, k, v, kv_pos, q_pos, mesh, **kw):
        o = real(q, k, v, kv_pos, q_pos, mesh, **kw)
        if torch.is_tensor(q_pos) and q_pos.ndim == 1:
            idle.append(torch.where(q_pos[:, None, None, None] < 0, o.abs(),
                                    torch.zeros_like(o)).amax())
        return o

    def logits_spy(*args):
        out = real_logits(*args)
        logits.append(out[:, -1].clone())
        return out
    attention.stripe_flash_decode = spy
    transformer.logits_fn = logits_spy
    tok = lg[:, -1].argmax(-1).to(torch.int32)[:, None]
    toks = [tok]
    if forced is not None:
        forced = torch.as_tensor(forced, device=device)[rows]
    # the sharded path's own kernel calls kept (inputs and partials
    # copied): the first, one mid-run, the last
    n_calls, held = [0], []
    keep_at = {0, (steps // 2) * cfg.num_layers + cfg.num_layers // 2,
               steps * cfg.num_layers - 1}

    def record(real_fd, *args, **kw):
        out = real_fd(*args, **kw)
        if n_calls[0] in keep_at:
            copy = lambda x: x.clone() if torch.is_tensor(x) else x
            step_i, layer_i = divmod(n_calls[0], cfg.num_layers)
            held.append((f"call {n_calls[0]} (step {step_i}, layer "
                         f"{layer_i})", tuple(copy(a) for a in args),
                         {k: copy(a) for k, a in kw.items()},
                         tuple(copy(o) for o in out)))
        n_calls[0] += 1
        return out
    recorder = (_wrapping(dist_decode.ops, "flash_decode", record)
                if mesh is not None else contextlib.nullcontext())
    fd.reset_launches()
    _sync(device)
    t0 = time.perf_counter()
    try:
        with recorder:
            for i in range(steps):
                pos = _shard_positions(run, i, B, P, device)
                if torch.is_tensor(pos):
                    pos = pos[rows]
                feed = tok if forced is None else forced[:, i:i + 1]
                with ctx():
                    tok, cache = step(params, cache,
                                      {"token": feed, "pos": pos, **extra})
                toks.append(tok)
            _sync(device)
        step_s = (time.perf_counter() - t0) / steps
        launches = dict(fd.LAUNCHES)
        planted = None
        if mesh is not None:
            transformer.logits_fn = real_logits
            pos = _shard_positions(run, steps, B, P, device)
            if torch.is_tensor(pos):
                pos = pos[rows]
            b = {"token": tok, "pos": pos, **extra}
            saved = {n: t.clone() for n, t in cache.items()}
            with ctx():
                last, _ = get_model(cfg).decode_step(params, cfg, cache, b)
            with ctx(), _wrapping(dist_decode.ops, "flash_decode",
                                  _drop_first_stripe(mesh)):
                bad, _ = get_model(cfg).decode_step(params, cfg, saved, b)
            planted = float((bad.float() - last.float()).abs().max())
            del saved
    finally:
        attention.stripe_flash_decode = real
        transformer.logits_fn = real_logits
    stripes = _hold_stripes(held, mesh) if mesh is not None else []
    del held
    out_toks = torch.cat(toks, 1)
    gathered = out_toks
    if bax is not None:
        gathered = collectives.all_gather(out_toks, mesh, bax, dim=0)
    idle_max = (float(torch.stack(idle).max()) if idle else None)
    # numpy, not tensors, for what goes back to the parent: a tensor a rank
    # returns would be shared memory that dies with the rank
    return {"tokens": out_toks.cpu().numpy(),
            "gathered": gathered.cpu().numpy(), "rows": rows.cpu().numpy(),
            "logits": torch.stack(logits[:steps + 1]),
            "cache_bytes": cache_bytes, "prefill_s": prefill_s,
            "step_s": step_s, "launches": launches, "idle": idle_max,
            "idle_calls": len(idle), "planted": planted,
            "stripes": stripes}


def _bf16_step(x: float) -> float:
    """The spacing of bf16 numbers at magnitude ``x`` (8 significant
    bits)."""
    return math.ldexp(1.0, math.frexp(x)[1] - 8) if x else 0.0


def _teacher_check(cfg, params, tokens, run: str, steps: int, sharded: dict,
                   device) -> dict:
    """The unsharded run of the whole batch fed the sharded run's gathered
    tokens (teacher forcing), held step by step to the sharded logits of
    this rank's rows: the largest difference, and each row-step where the
    two greedy choices differ, with the lead each run's choice has over
    the other's in that run's logits."""
    plain = _shard_run(cfg, params, tokens, run, steps, None, device,
                       forced=sharded["gathered"])
    rows = torch.as_tensor(sharded["rows"], device=device)
    a = sharded["logits"].float()                    # (steps + 1, B_loc, V)
    b = plain["logits"][:, rows].float()
    err = float((a - b).abs().max())
    want = plain["tokens"][sharded["rows"]]          # unsharded choices
    got = sharded["tokens"]
    flips = []
    for r, s in np.argwhere(got != want):
        t_s, t_u = int(got[r, s]), int(want[r, s])
        mag = max(abs(float(x[s, r, t])) for x in (a, b) for t in (t_u, t_s))
        flips.append(dict(
            row=int(sharded["rows"][r]), step=int(s), logit=mag,
            bf16_step=_bf16_step(mag),
            plain_lead=float(b[s, r, t_u] - b[s, r, t_s]),
            sharded_lead=float(a[s, r, t_s] - a[s, r, t_u])))
    top = b.topk(2, dim=-1).values
    return {"err": err, "flips": flips, "row_steps": int(got.size),
            "ties": int(((top[..., 0] - top[..., 1]) == 0).sum()),
            "logit_max": float(b.abs().max()),
            "cache_bytes": plain["cache_bytes"],
            "prefill_s": plain["prefill_s"], "step_s": plain["step_s"]}


def _shard_rank(device="cuda", cfgs=None, prompt=None):
    """Phase 9 in one rank of the 4-rank world: 9a, 9b and 9c, each run
    sharded on its mesh by every rank; then the first model rank of each
    data group holds its rows to the unsharded run (the whole batch and
    cache, no mesh) fed the same tokens.  ``cfgs`` ({sub-phase: config})
    and ``prompt`` cut a rehearsal: only those sub-phases, with those
    configs."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.registry import get_model
    for k in ("REPRO_CACHE_SHARD", "REPRO_KV_INT8"):
        os.environ.pop(k, None)
    rank = dist.get_rank()
    meshes = {}
    for name, spec in SHARD_RUNS.items():
        if spec["mesh"] not in meshes:
            meshes[spec["mesh"]] = make_mesh(*spec["mesh"],
                                             device_type=device)
    out = {"rank": rank, "phases": {}}
    params, arch = None, None
    for name, spec in SHARD_RUNS.items():
        t_phase = time.perf_counter()
        if cfgs is not None and name not in cfgs:
            continue
        if spec["arch"] != arch:
            params = None
            if device == "cuda":
                torch.cuda.empty_cache()
            cfg = cfgs[name] if cfgs else get_config(spec["arch"])
            if device == "cuda":
                torch.cuda.reset_peak_memory_stats()
            for r in range(SHARD_WORLD):         # one rank draws at a time
                if r == rank:
                    params = get_model(cfg).init(
                        cfg, torch.Generator(device=device).manual_seed(
                            SHARD["seed"]), device=device)
                    _sync(device)
                    if device == "cuda":         # the draw's f32 transients
                        torch.cuda.empty_cache()
                dist.barrier()
            arch = spec["arch"]
            init_peak = _peak_gib(device)
        mesh = meshes[spec["mesh"]]
        g = torch.Generator().manual_seed(SHARD["seed"] + 1)
        tokens = torch.randint(0, cfg.vocab_size,
                               (SHARD["B"], prompt or SHARD["prompt"]),
                               generator=g).to(device)
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        got = {"checksum": _checksum(params), "init_peak_gib": init_peak,
               "layers": cfg.num_layers, "runs": {}, "teacher": {}}
        kept = {}
        for run in spec["runs"]:
            r = _shard_run(cfg, params, tokens, run, spec["steps"], mesh,
                           device)
            kept[run] = r
            got["runs"][run] = {k: v for k, v in r.items() if k != "logits"}
        got["peak_gib"] = _peak_gib(device)
        if mesh.get_local_rank("model") == 0:
            for run in spec["runs"]:
                got["teacher"][run] = _teacher_check(
                    cfg, params, tokens, run, spec["steps"], kept[run],
                    device)
        del kept
        dist.barrier()
        got["wall_s"] = time.perf_counter() - t_phase
        os.environ.pop("REPRO_KV_INT8", None)
        out["phases"][name] = got
        if device == "cuda":
            torch.cuda.empty_cache()
    return out


def phase_sharded_serve(card: str, device="cuda", cfgs=None,
                        prompt=None) -> dict:
    """Phase 9: sharded serving through ``launch.mesh.spawn_local``, four
    ranks on the one card over gloo (9a qwen3-0.6b on (data 2, model 2),
    9b its paged pool and 9c fedtime-llama2-7b's backbone on (data 1,
    model 4)), each run held step by step to the unsharded run fed the
    same tokens.  ``cfgs`` ({sub-phase: config}) and ``prompt`` cut it to
    a rehearsal's size on the CPU.  Returns the flash-decode launches of
    the sharded steps, summed over the ranks."""
    from repro_torch.launch.mesh import spawn_local
    t_start = time.perf_counter()
    failures = []

    def fail(msg):
        print(f"  FAILED: {msg}")
        failures.append(msg)
    ranks = spawn_local(SHARD_WORLD, _shard_rank, device, cfgs, prompt,
                        device_type=device, timeout_s=SHARD_TIMEOUT_S)
    launches = {"flash_decode": 0, "flash_decode_paged": 0}
    first = ranks[0]["phases"]
    for name, spec in SHARD_RUNS.items():
        if name not in first:
            continue
        shape, names = spec["mesh"]
        label = " x ".join(f"{a} {s}" for a, s in zip(names, shape))
        ph = [rk["phases"][name] for rk in ranks]
        L = ph[0]["layers"]
        if len({p["checksum"] for p in ph}) != 1:
            fail(f"{name}: the ranks' weights differ: "
                 f"{[p['checksum'] for p in ph]}")
        B, P = SHARD["B"], prompt or SHARD["prompt"]
        print(f"[{card}] phase {name} {spec['arch']} ({L} layers), 4 ranks "
              f"on ({label}) over gloo, B {B}, a {P}-token prompt, a ring "
              f"of {SHARD['ring']} slots, {spec['steps']} greedy steps; "
              f"weights checksum equal on every rank (bit patterns summed: "
              f"{ph[0]['checksum'][0]}); drawn one rank at a time, peak "
              f"{max(p['init_peak_gib'] for p in ph):.2f} GiB a rank while "
              f"drawing")
        for run in spec["runs"]:
            rs = [p["runs"][run] for p in ph]
            tf = [p["teacher"][run] for p in ph if run in p["teacher"]]
            if len({r["gathered"].tobytes() for r in rs}) != 1:
                fail(f"{name} {run}: the ranks gathered different tokens")
            err = max(t["err"] for t in tf)
            if err > SHARD_LOGIT_TOL:
                fail(f"{name} {run}: logits {err} off the unsharded run's "
                     f"fed the same tokens (tol {SHARD_LOGIT_TOL})")
            flips = [f for t in tf for f in t["flips"]]
            in_steps = [sorted({f[k] / f["bf16_step"] for f in flips
                                if f["bf16_step"]})
                        for k in ("plain_lead", "sharded_lead")]
            n = sum(t["row_steps"] for t in tf)
            wide = [f for f in flips
                    if max(f["plain_lead"], f["sharded_lead"])
                    > SHARD_TIE_STEPS * f["bf16_step"]]
            if wide:
                fail(f"{name} {run}: greedy choices differ where one run's "
                     f"choice leads by more than {SHARD_TIE_STEPS} bf16 "
                     f"steps: {wide}")
            ways = B // len(rs[0]["rows"]) * shape[1]
            if run == "paged":                  # replicated over data
                ways = shape[1]
            whole = tf[0]["cache_bytes"]
            for r in rs:
                if r["cache_bytes"] * ways != whole:
                    fail(f"{name} {run}: a rank holds {r['cache_bytes']} "
                         f"cache bytes, not the whole cache's {whole} / "
                         f"{ways}")
            kind = "flash_decode_paged" if run == "paged" else "flash_decode"
            for r in rs:
                k = r["launches"][kind]
                if device == "cuda" and k != L * spec["steps"]:
                    fail(f"{name} {run}: {k} {kind} launches a rank, not "
                         f"one a layer a step ({L * spec['steps']})")
                launches[kind] += k
            if run in ("ragged", "paged") and not all(
                    r["idle_calls"] > 0 and r["idle"] == 0.0 for r in rs):
                fail(f"{name} {run}: the inactive lane's attention output "
                     f"is {[r['idle'] for r in rs]}, not exactly 0")
            planted = [r["planted"] for r in rs]
            least = min((p for p in planted if p is not None),
                        default=float("nan"))
            if None in planted or min(planted) <= SHARD_LOGIT_TOL:
                fail(f"{name} {run}: the logit limit does not catch a "
                     f"dropped stripe ({planted})")
            held = [h for r in rs for h in r["stripes"]]
            bad = [h for h in held
                   if not (h["err"] <= TOL_F32_OUT and
                           h["combined"] <= TOL_F32_OUT and h["empty_exact"]
                           and h["planted"] is not None and
                           h["planted"] > TOL_F32_OUT)]
            if len(held) != 3 * len(rs) or bad:
                fail(f"{name} {run}: {len(held)} of the path's own kernel "
                     f"calls held, off the plain version's partials: {bad}")
            print(f"  {run}: logits vs the unsharded run fed the same "
                  f"tokens, every step: max_abs_err {err:.4g} (tol "
                  f"{SHARD_LOGIT_TOL}; |logits| up to "
                  f"{max(t['logit_max'] for t in tf):.3g})"
                  + f"; planted fault (the first model rank's partials "
                  f"dropped from one step's combine) "
                  f"{least:.4g} or more"
                  + f"; greedy choices equal at {n - len(flips)} of {n} "
                  f"row-steps; {sum(t['ties'] for t in tf)} row-steps are "
                  f"exact bf16 ties in the unsharded logits"
                  + (f"; where they differ the unsharded choice leads by "
                     f"{sorted({f['plain_lead'] for f in flips})} and the "
                     f"sharded by {sorted({f['sharded_lead'] for f in flips})}"
                     f", in bf16 steps at the logits' magnitude "
                     f"{in_steps[0]} and {in_steps[1]}"
                     f" (limit {SHARD_TIE_STEPS}; |logits| "
                     f"{min(f['logit'] for f in flips):.3g}-"
                     f"{max(f['logit'] for f in flips):.3g})"
                     if flips else ""))
            if held:
                print(f"  {run}: the path's own kernel calls, 3 a rank "
                      f"({'; '.join(sorted({h['shapes'] for h in held}))})"
                      f", held against the plain version's partials: a "
                      f"stripe's acc / l max_abs_err "
                      f"{max(h['err'] for h in held):.3g}, combined over "
                      f"model {max(h['combined'] for h in held):.3g} (tol "
                      f"{TOL_F32_OUT}); one tile dropped reads "
                      f"{min(h['planted'] or 0 for h in held):.3g} or more; "
                      f"{sum(h['empty'] for h in held)} empty (row, head) "
                      f"lanes exactly 0 in l and acc")
            print(f"  {run}: cache a rank {rs[0]['cache_bytes']} B = whole "
                  f"{whole} B / {ways}; {rs[0]['launches'][kind]} {kind} "
                  f"launches a rank (= {L} layers x {spec['steps']} steps)"
                  + (f"; idle lane's attention output exactly 0 in "
                     f"{rs[0]['idle_calls']} calls"
                     if run in ("ragged", "paged") else ""))
            print(f"  {run} host clock (gloo through the host on one card, "
                  f"not a collective's speed): prefill "
                  f"{max(r['prefill_s'] for r in rs):.3f} s sharded "
                  f"(slowest rank), {tf[0]['prefill_s']:.3f} s unsharded; "
                  f"decode {max(r['step_s'] for r in rs) * 1e3:.1f} ms a "
                  f"step sharded, {tf[0]['step_s'] * 1e3:.1f} ms "
                  f"unsharded")
        print(f"[{card}] phase {name} peak device memory a rank (GiB): "
              + ", ".join(f"{p['peak_gib']:.2f}" for p in ph)
              + f"; wall {max(p['wall_s'] for p in ph):.1f} s")
    _check(not failures, "phase 9: " + "; ".join(failures))
    if device == "cuda":
        _check(all(launches.values()), f"phase 9: a kernel of the sharded "
               f"path was never launched: {launches}")
    print(f"[{card}] phase 9 flash-decode launches on the sharded serve "
          f"steps (all ranks): {launches}; wall "
          f"{time.perf_counter() - t_start:.1f} s (host clock, with the "
          f"world's start)")
    return launches


# ---------------------------------------------------------------------------
# phase 6: small-input reference
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# phase 10: the training launcher (no kernel lies on its path)
# ---------------------------------------------------------------------------

# 10a and 10b run ``launch.train`` at its own defaults: batch 8 x 256, lr
# 3e-4, Markov tokens.  10a: a full fine-tune of qwen3-0.6b, 20 steps;
# 10b: ``--fed`` on fedtime-llama2-7b (LoRA rank 4 on wq, wk, wv, wo), 10
# steps.  Widths and depth as published; nothing cut.
TRAIN = dict(batch=8, seq=256, lr=3e-4, full_steps=20, fed_steps=10)
# 10a's card-vs-CPU check: qwen3-0.6b's smoke config in f32, the same
# weights (drawn on the CPU) and batches, 3 steps of ``make_train_step``.
# Losses within TOL_TRAIN_LOSS relative; moments within TOL_TRAIN_MOMENT
# of their leaf's largest magnitude.  Parameters: every element within 2
# lr a step (the most two AdamW steps can differ), and at most
# TRAIN_PARAM_SHARE of a leaf's elements beyond TOL_TRAIN_PARAM of its
# largest magnitude and beyond TRAIN_PARAM_FLOOR lr, leaving out the
# elements whose first gradient (the reference run's) is under 1e-4 of
# its leaf's largest.  (A leaf that starts at 0, as LoRA's B does, is a
# few steps large after 3 steps, where TOL_TRAIN_PARAM of it is 3e-4 of a
# step, the f32 rounding of the updates themselves; chip run: 6 of a
# lora_b's 32,768 elements at up to 1e-3 lr.)  AdamW moves an
# element by m / (sqrt(v) + eps), which shows the f32 noise of a gradient
# that small in full, and steps 2-3 take their gradients at parameters
# that differ there, which moves a few more elements whose gradients stay
# small (chip run: 51 of the 155,582,464 elements of 10c's embedding
# table, 1 of wq's 4,194,304, at up to 2.6e-4 and 0.1 lr, against a
# tenth of every matrix's elements in the planted fault).  The planted
# fault: the card's run fed labels with the last quarter of row 0
# dropped (-1).
TRAIN_CHECK = dict(steps=3, batch=4, seq=64)
TOL_TRAIN_LOSS = 1e-5
TOL_TRAIN_PARAM = 1e-4
TRAIN_PARAM_SHARE = 1e-5
TRAIN_PARAM_FLOOR = 1e-2
TOL_TRAIN_MOMENT = 1e-3
# 10c: 4 ranks on the one card over gloo, make_train_step on (data 2,
# model 2) and make_fed_train_step on (data 4, model 1), at qwen3-0.6b's
# published width (d_model 1024, 16/8 heads of 128, d_ff 3072, vocab
# 151,936) in f32, depth cut from 28 to 4 layers (each rank holds the
# whole model, its gradients and a gathered copy, rank 0 the one-rank run
# beside, four ranks on one card; gloo stages each step's gradient psum
# and parameter gather through the host), 2 steps each at batch 8 x 256
# with -1 labels on every other position of data rank 0's rows (3 steps
# before PR 34's cut: the second step already takes its gradient at
# parameters and moments the first updated).  Each is
# held to the one-rank step on the same global batch with the limits
# above; planted beside: one step with each rank's own count in place of
# the count's psum, times the data ways (a per-rank mean averaged over the
# ranks, what the reference's global count rules out).
TRAIN_MESH = dict(layers=4, steps=2, world=4, timeout_s=420,
                  runs={"train": ((2, 2), ("data", "model")),
                        "fed": ((4, 1), ("data", "model"))})


# 10d: the MoE step on a 2-rank data mesh of the one card, at
# qwen2-moe-a2.7b's published widths (d_model 2048, 16/16 heads of 128, 60
# experts top-4 of 1408 plus 4 shared, vocab 151,936) in f32, depth cut from
# 24 to 1 layer (1.19 B parameters; rank 0 holds the mesh run, the
# gathered moments and the one-rank run beside it, ~40 GB, while the other
# rank shares the card); one step at batch 4 x 256, so each rank holds 512
# tokens, one of the reference's 512-token expert groups (its capacity and
# drops are the reference's); -1 labels on every other position of data
# rank 0's rows.  Held to the one-rank step on the global batch with phase
# 10's limits; planted beside: the router's top-1 counts not psummed (each
# rank's aux of its own counts, the rule the psum replaced), read as the
# loss of the step's own loss path (a full planted step until PR 34).
TRAIN_MOE = dict(arch="qwen2-moe-a2.7b", layers=1, world=2, batch=4,
                 seq=256, timeout_s=600)


def _train_errors(got, want, mu1, lr: float) -> tuple:
    """Parameters against a reference run, each leaf against its largest
    |want|: (the largest share of a leaf's elements beyond
    TOL_TRAIN_PARAM of it and beyond TRAIN_PARAM_FLOOR lr, leaving out the
    elements whose first moment
    ``mu1`` (0.1 x the first gradient) is under 1e-4 of its leaf's
    largest; the worst such element outside those, as a share of its
    leaf's largest; the worst element of all, in lr)."""
    from repro_torch import tree as tree_util
    share = worst = in_lr = 0.0
    for g, w, mu in zip(tree_util.leaves(got), tree_util.leaves(want),
                        tree_util.leaves(mu1)):
        d = (g.float() - w.float()).abs()
        in_lr = max(in_lr, float(d.max()) / lr)
        m = (mu.abs() < 1e-4 * mu.abs().max()).to(d.device)
        top = float(w.float().abs().max()) or 1e-30
        d = d.masked_fill(m, 0.0)
        off = max(TOL_TRAIN_PARAM * top, TRAIN_PARAM_FLOOR * lr)
        share = max(share, float((d > off).sum()) / d.numel())
        worst = max(worst, float(d.max()) / top)
    return share, worst, in_lr


def _train_within(loss_err, params, moments, steps: int) -> bool:
    """A run against its reference within phase 10's limits."""
    share, _, in_lr = params
    return (loss_err <= TOL_TRAIN_LOSS and share <= TRAIN_PARAM_SHARE and
            in_lr <= 2 * steps and moments <= TOL_TRAIN_MOMENT)


def _train_reading(loss_err, params, moments, steps: int) -> str:
    share, worst, in_lr = params
    return (f"losses {loss_err:.3g} relative (tol {TOL_TRAIN_LOSS}); "
            f"parameters: {share:.3g} of a leaf's elements beyond "
            f"{TOL_TRAIN_PARAM} of its largest and {TRAIN_PARAM_FLOOR} lr "
            f"(limit {TRAIN_PARAM_SHARE}),"
            f" worst {worst:.3g}, worst element {in_lr:.3g} lr (limit "
            f"{2 * steps}); moments {moments:.3g} (tol {TOL_TRAIN_MOMENT})")


def _moment_error(got, want) -> float:
    from repro_torch import tree as tree_util
    return max(float((g - w.to(g.device)).abs().max())
               / (float(w.abs().max()) or 1e-30)
               for name in ("mu", "nu")
               for g, w in zip(tree_util.leaves(got[name]),
                               tree_util.leaves(want[name])))


def _loss_error(got, want) -> float:
    return max(abs(a - b) / abs(b) for a, b in zip(got, want))


def _train_batches(cfg, n: int, batch: int, seq: int, device: str):
    """``n`` of ``launch.train``'s batches (the same Markov stream)."""
    from repro_torch.data.tokens import lm_batches, markov_tokens
    from repro_torch.launch import train as launch_train
    it = lm_batches(markov_tokens(launch_train.TOKENS, cfg.vocab_size,
                                  seed=0), batch, seq + 1, seed=0)
    return [launch_train.synth_batch(cfg, batch, seq, it, device)
            for _ in range(n)]


def _train_card_vs_cpu(card: str, device: str) -> None:
    """10a's check: the f32 smoke config, the card against the CPU."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim.adamw import adamw_init
    cfg = get_smoke_config("qwen3-0.6b")
    n, B, S = (TRAIN_CHECK[k] for k in ("steps", "batch", "seq"))
    params, _, _ = launch_train.setup(cfg, fed=False, lr=TRAIN["lr"],
                                      device="cpu")
    batches = _train_batches(cfg, n, B, S, "cpu")
    runs = {}
    for name, dev in (("cpu", "cpu"), ("card", device),
                      ("planted", device)):
        p, st = _to(params, dev), adamw_init(_to(params, dev))
        step, losses, mu1 = make_train_step(cfg, lr=TRAIN["lr"]), [], None
        for i, b in enumerate(batches):
            b = _to(b, dev)
            if name == "planted":
                b["labels"] = b["labels"].clone()
                b["labels"][0, -S // 4:] = -1
            p, st, loss = step(p, st, b, i)
            losses.append(float(loss))
            if i == 0:
                mu1 = _to(st["mu"], "cpu")
        runs[name] = (_to(p, "cpu"), _to(st, "cpu"), losses, mu1)
    cp, cst, cl, mu1 = runs["cpu"]
    read = {}
    for name in ("card", "planted"):
        p, st, losses, _ = runs[name]
        read[name] = (_loss_error(losses, cl),
                      _train_errors(p, cp, mu1, TRAIN["lr"]),
                      _moment_error(st, cst))
    _check(_train_within(*read["card"], n),
           f"phase 10a: card vs CPU over the limits: {read['card']}")
    _check(not _train_within(*read["planted"], n),
           f"phase 10a: the planted fault passes the limits: "
           f"{read['planted']}")
    print(f"[{card}] phase 10a card vs CPU, {cfg.name} (f32), {n} steps at "
          f"{B} x {S}, the same weights and batches: "
          f"{_train_reading(*read['card'], n)}; planted fault (row 0's "
          f"last quarter of labels dropped): "
          f"{_train_reading(*read['planted'], n)}")


def _counting(collectives, rec):
    """Wrap ``collectives.psum`` / ``all_gather`` to record the bytes a
    rank hands to a psum and gets back from a gather; returns the undo."""
    psum, gather = collectives.psum, collectives.all_gather

    def counted_psum(x, mesh, axes):
        rec.append(("psum", tuple(x.shape), x.numel() * x.element_size()))
        return psum(x, mesh, axes)

    def counted_gather(x, mesh, axes, dim=0):
        y = gather(x, mesh, axes, dim)
        rec.append(("all_gather", tuple(y.shape),
                    y.numel() * y.element_size()))
        return y

    collectives.psum, collectives.all_gather = counted_psum, counted_gather

    def undo():
        collectives.psum, collectives.all_gather = psum, gather
    return undo


def _train_mesh_rank(cfg, batch: int, seq: int, device="cuda"):
    """10c in one rank of the 4-rank world: each run's mesh steps, their
    bytes and walls; rank 0 also runs the one-rank steps on the global
    batch and the planted fault, and holds the mesh run to them."""
    import torch.distributed as dist
    from repro_torch import tree as tree_util
    from repro_torch.core.lora import lora_mask, lora_tree, tree_nbytes
    from repro_torch.dist import collectives
    from repro_torch.dist.sharding import data_specs, local_shard, use_mesh
    from repro_torch.launch import steps
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim.adamw import adamw_init, zero1_gather
    rank = dist.get_rank()
    meshes = {name: make_mesh(shape, names, device_type=device)
              for name, (shape, names) in TRAIN_MESH["runs"].items()}
    out = {"rank": rank, "runs": {}}
    lr, n = TRAIN["lr"], TRAIN_MESH["steps"]
    for name, mesh in meshes.items():
        fed, ways = name == "fed", TRAIN_MESH["runs"][name][0][0]
        if device == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        params, opt, step = launch_train.setup(cfg, fed=fed, lr=lr,
                                               device=device, mesh=mesh)
        trained = lora_tree(params) if fed else params
        batches = _train_batches(cfg, n, batch, seq, device)
        for b in batches:
            b["labels"][:batch // ways, ::2] = -1
        mine = [local_shard(b, data_specs(b, mesh), mesh) for b in batches]
        rec, walls, losses = [], [], []
        p, st = params, opt
        with use_mesh(mesh):
            undo = _counting(collectives, rec)
            try:
                for i, b in enumerate(mine):
                    (p, st, loss), wall = _timed(device, step, p, st, b, i)
                    walls.append(wall)
                    losses.append(float(loss))
            finally:
                undo()
            # planted: each rank's own count, times the ways (a per-rank
            # mean, averaged over the ranks)
            psum = collectives.psum
            collectives.psum = lambda x, m, axes: (
                x * ways if x.dtype == torch.int64 else psum(x, m, axes))
            try:
                pf, stf, lf = step(params, opt, mine[0], 0)
            finally:
                collectives.psum = psum
        got = lora_tree(p) if fed else p
        whole = zero1_gather(st, trained, mesh)
        stf = zero1_gather(stf, trained, mesh)
        r = dict(losses=losses, walls=walls, checksum=_checksum(got),
                 moment_bytes=tree_nbytes(st),
                 whole_moment_bytes=2 * 4 * sum(
                     x.numel() for x in tree_util.leaves(trained)),
                 psum_bytes=sum(x[2] for x in rec if x[0] == "psum") / n,
                 gathered_bytes=sum(x[2] for x in rec
                                    if x[0] == "all_gather") / n,
                 payload=tree_nbytes(trained), peak_gib=_peak_gib(device))
        if fed:
            r["base_kept"] = all(
                a is b for a, b, m in zip(tree_util.leaves(p),
                                          tree_util.leaves(params),
                                          tree_util.leaves(lora_mask(params)))
                if m is False)
        if rank == 0:       # the one-rank step on the global batch
            one = (steps.make_fed_train_step(cfg, lr=lr) if fed
                   else steps.make_train_step(cfg, lr=lr))
            p1, st1, l1 = params, adamw_init(trained), []
            for i, b in enumerate(batches):
                p1, st1, loss = one(p1, st1, b, i)
                l1.append(float(loss))
                if i == 0:
                    mu1, first = st1["mu"], (lora_tree(p1) if fed else p1)
                    first_st = st1
            want = lora_tree(p1) if fed else p1
            r["one_rank"] = dict(
                losses=l1,
                read=(_loss_error(losses, l1),
                      _train_errors(got, want, mu1, lr),
                      _moment_error(whole, st1)),
                planted=(abs(float(lf) - l1[0]) / l1[0], _train_errors(
                    lora_tree(pf) if fed else pf, first, mu1, lr),
                    _moment_error(stf, first_st)))
            del p1, st1, first, first_st, want
        out["runs"][name] = r
        del params, opt, p, st, pf, stf, whole, batches, mine
        dist.barrier()
    out["launches"] = {k: v for mod in _kernel_modules()
                       for k, v in mod.LAUNCHES.items()}
    return out


def _train_moe_rank(cfg, device="cuda"):
    """10d in one rank of the 2-rank world: the mesh step and the planted
    loss; rank 0 also runs the one-rank step on the global batch and holds
    the mesh step to it.  Rank 1 frees the card before rank 0's one-rank
    run (a barrier).  The planted reading is a loss, so it runs the step's
    own loss path (``steps._value_and_grad``) differentiated for the final
    norm alone: no backward through the trunk and no psum of the whole
    gradient (4.8 GB through the host).  The same path without the plant
    must read the mesh step's loss."""
    import torch.distributed as dist
    from repro_torch.dist import collectives
    from repro_torch.dist.sharding import data_specs, local_shard, use_mesh
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.registry import get_model
    from repro_torch.optim.adamw import adamw_init, zero1_gather, zero1_init
    rank, ways = dist.get_rank(), TRAIN_MOE["world"]
    batch, lr = TRAIN_MOE["batch"], TRAIN["lr"]
    mesh = make_mesh((ways, 1), ("data", "model"), device_type=device)
    params = get_model(cfg).init(
        cfg, torch.Generator(device=device).manual_seed(0), device=device)
    b = _train_batches(cfg, 1, batch, TRAIN_MOE["seq"], device)[0]
    b["labels"][:batch // ways, ::2] = -1
    mine = local_shard(b, data_specs(b, mesh), mesh)
    step = steps.make_train_step(cfg, lr=lr)
    counts = (cfg.num_layers, cfg.moe.num_experts)
    api = get_model(cfg)

    def loss_only():
        return float(steps._value_and_grad(
            lambda t, mb: api.loss_parts(dict(params, final_norm=t), cfg,
                                         mb),
            [params["final_norm"]["scale"]], params["final_norm"], mine, 1,
            cfg)[0])

    with use_mesh(mesh):
        psum = collectives.psum          # planted: the counts not psummed
        collectives.psum = lambda x, m, axes: (
            x.clone() if tuple(x.shape) == counts else psum(x, m, axes))
        try:
            planted = loss_only()
        finally:
            collectives.psum = psum
        unplanted = loss_only()
        _sync(device)
        (p, st, loss), wall = _timed(device, step, params,
                                     zero1_init(params, mesh), mine, 0)
    whole = zero1_gather(st, params, mesh)
    del st
    r = dict(loss=float(loss), planted=planted, unplanted=unplanted,
             wall=wall, checksum=_checksum(p), peak_gib=_peak_gib(device))
    if rank:
        del p, whole, params
        if device == "cuda":
            torch.cuda.empty_cache()
    dist.barrier()
    if rank == 0:
        p1, st1, l1 = steps.make_train_step(cfg, lr=lr)(
            params, adamw_init(params), b, 0)
        r["one_rank"] = dict(loss=float(l1), read=(
            _loss_error([float(loss)], [float(l1)]),
            _train_errors(p, p1, st1["mu"], lr), _moment_error(whole, st1)))
        r["peak_gib"] = _peak_gib(device)
        del p1, st1, p, whole, params
    r["launches"] = {k: v for mod in _kernel_modules()
                     for k, v in mod.LAUNCHES.items()}
    dist.barrier()
    return r


def _phase_train_moe(card: str, device: str) -> dict:
    """10d: returns each rank's kernel launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import spawn_local
    cfg = get_config(TRAIN_MOE["arch"]).replace(
        num_layers=TRAIN_MOE["layers"], param_dtype="float32",
        compute_dtype="float32")
    t0 = time.perf_counter()
    ranks = spawn_local(TRAIN_MOE["world"], _train_moe_rank, cfg, device,
                        device_type=device, timeout_s=TRAIN_MOE["timeout_s"])
    wall = time.perf_counter() - t0
    one = ranks[0]["one_rank"]
    _check(len({r["checksum"] for r in ranks}) == 1,
           "phase 10d: the ranks' parameters differ")
    _check(_train_within(*one["read"], 1),
           f"phase 10d: mesh vs one rank over the limits: {one}")
    planted = abs(ranks[0]["planted"] - one["loss"]) / one["loss"]
    _check(planted > TOL_TRAIN_LOSS, f"phase 10d: the planted fault's loss "
           f"is within {TOL_TRAIN_LOSS} of the one-rank loss: {planted}")
    path = max(abs(r["unplanted"] - r["loss"]) / r["loss"] for r in ranks)
    _check(path <= TOL_TRAIN_LOSS, f"phase 10d: the planted reading's loss "
           f"path without the plant reads {path} relative of the mesh "
           f"step's loss")
    print(f"[{card}] phase 10d make_train_step on (data 2, model 1), 2 ranks"
          f" on one card over gloo, {cfg.name} at published widths (d_model"
          f" {cfg.d_model}, {cfg.moe.num_experts} experts top-"
          f"{cfg.moe.top_k} + {cfg.moe.num_shared_experts} shared, vocab "
          f"{cfg.vocab_size}, f32), {cfg.num_layers} of its 24 layers, one "
          f"step at {TRAIN_MOE['batch']} x {TRAIN_MOE['seq']} (512 tokens a "
          f"rank, one expert group), -1 labels on data rank 0's rows: loss "
          f"{ranks[0]['loss']:.6f} vs one rank {one['loss']:.6f}; "
          f"{_train_reading(*one['read'], 1)}; planted (router counts not "
          f"psummed): loss {ranks[0]['planted']:.6f}, {planted:.3g} "
          f"relative (the same loss path unplanted {path:.3g} of the step's)"
          f"; step wall {max(r['wall'] for r in ranks):.2f} s (host "
          f"clock, slowest rank, gloo staging through the host); peak a "
          f"rank " + ", ".join(f"{r['peak_gib']:.2f}" for r in ranks)
          + f" GiB; 10d wall {wall:.1f} s with the world's start")
    return [r["launches"] for r in ranks]


def phase_train(card: str, device="cuda", full: bool = True,
                batch: int = None, seq: int = None) -> None:
    """Phase 10: the training launcher, which reaches no kernel (every
    launch count, set to 0 before, must read 0 after, in every rank too):
    10a a full fine-tune of qwen3-0.6b through ``launch.train.run``, and
    the f32 smoke config on the card against the CPU; 10b ``--fed`` on
    fedtime-llama2-7b, base weights unchanged by checksum; 10c 4 ranks on
    the one card, each step held to the one-rank step.  ``full=False``,
    ``batch`` and ``seq`` cut it to smoke configs for a rehearsal on the
    CPU."""
    from repro_torch import tree as tree_util
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core.lora import lora_mask, lora_tree, tree_nbytes
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.mesh import spawn_local
    t_start = time.perf_counter()
    batch, seq = batch or TRAIN["batch"], seq or TRAIN["seq"]
    for mod in _kernel_modules():
        mod.reset_launches()
    size = ["--full-config"] if full else []
    common = ["--batch", str(batch), "--seq", str(seq), "--lr",
              str(TRAIN["lr"]), "--device", device]

    parts = {}                                # host-clock walls, s

    # 10a: a full fine-tune through the launcher
    if device == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run = launch_train.run(launch_train.parse_args(
        ["--arch", "qwen3-0.6b", "--steps", str(TRAIN["full_steps"])]
        + size + common))
    wall = time.perf_counter() - t0
    losses = run.losses
    _check(all(np.isfinite(losses)), f"phase 10a: losses {losses}")
    _check(float(np.mean(losses[-5:])) < losses[0],
           f"phase 10a: the Markov loss did not fall: {losses}")
    n = sum(x.numel() for x in tree_util.leaves(run.params))
    print(f"[{card}] phase 10a launch.train --arch qwen3-0.6b "
          f"{'--full-config ' if full else ''}({run.cfg.num_layers} "
          f"layers, d_model {run.cfg.d_model}, vocab {run.cfg.vocab_size}, "
          f"{run.cfg.param_dtype}, {n} parameters), full fine-tune, "
          f"{TRAIN['full_steps']} steps at {batch} x {seq}, lr "
          f"{TRAIN['lr']}: losses {[round(l, 4) for l in losses]} (mean of "
          f"the last 5 {float(np.mean(losses[-5:])):.4f} < first "
          f"{losses[0]:.4f}); step walls (host clock, each ending with its "
          f"loss read back) {[round(w, 4) for w in run.walls]} s, median "
          f"of steps 2+ {float(np.median(run.walls[1:])):.4f} s, "
          f"{batch * seq / float(np.median(run.walls[1:])):.0f} tok/s "
          f"steady, {run.tokens_per_s:.0f} tok/s over the loop; peak "
          f"device memory {_peak_gib(device):.2f} GiB; wall {wall:.1f} s")
    del run
    parts["10a launcher"] = wall
    t0 = time.perf_counter()
    _train_card_vs_cpu(card, device)
    parts["10a card vs CPU"] = time.perf_counter() - t0

    # 10b: the federated step on the paper's backbone
    cfg = (get_config if full else get_smoke_config)("fedtime-llama2-7b")
    if device == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    t_10b = t0
    params, opt, step = launch_train.setup(cfg, fed=True, lr=TRAIN["lr"],
                                           device=device)
    _sync(device)
    init_s = time.perf_counter() - t0
    mask = tree_util.leaves(lora_mask(params))
    before = [_leaf_checksum(x) for x, m in
              zip(tree_util.leaves(params), mask) if m is False]
    adapters0 = [x.clone() for x in tree_util.leaves(lora_tree(params))]
    payload, moments = tree_nbytes(lora_tree(params)), tree_nbytes(opt)
    base_bytes = sum(x.numel() * x.element_size() for x, m in
                     zip(tree_util.leaves(params), mask) if m is False)
    run = launch_train.train(cfg, params, opt, step,
                             steps=TRAIN["fed_steps"], batch=batch, seq=seq,
                             device=device, log=None)
    after = [_leaf_checksum(x) for x, m in
             zip(tree_util.leaves(run.params), mask) if m is False]
    _check(after == before, "phase 10b: a base leaf changed")
    moved = sum(not torch.equal(a, b) for a, b in zip(
        adapters0, tree_util.leaves(lora_tree(run.params))))
    _check(moved == len(adapters0), f"phase 10b: {moved} of "
           f"{len(adapters0)} adapter leaves moved")
    _check(moments == 2 * payload and
           tree_nbytes(run.opt_state) == moments,
           f"phase 10b: moments {moments} B for an adapter payload of "
           f"{payload} B")
    _check(all(np.isfinite(run.losses)), f"phase 10b: losses {run.losses}")
    print(f"[{card}] phase 10b launch.train --fed --arch fedtime-llama2-7b "
          f"{'--full-config ' if full else ''}({cfg.num_layers} layers, "
          f"d_model {cfg.d_model}, vocab {cfg.vocab_size}, "
          f"{cfg.param_dtype}, LoRA rank 4 on wq/wk/wv/wo), "
          f"{TRAIN['fed_steps']} steps at {batch} x {seq}: {len(before)} "
          f"base leaves ({base_bytes / 1e9:.2f} GB) unchanged by checksum, "
          f"all {moved} adapter leaves moved; adapter payload {payload} B, "
          f"moments {moments} B (= 2 x the adapters' f32 bytes); losses "
          f"{[round(l, 4) for l in run.losses]}; step walls "
          f"{[round(w, 4) for w in run.walls]} s (median of steps 2+ "
          f"{float(np.median(run.walls[1:])):.4f} s, "
          f"{batch * seq / float(np.median(run.walls[1:])):.0f} tok/s); "
          f"init {init_s:.1f} s; peak device memory "
          f"{_peak_gib(device):.2f} GiB")
    del params, opt, run, adapters0
    if device == "cuda":
        torch.cuda.empty_cache()
    parts["10b"] = time.perf_counter() - t_10b

    # 10c: the steps on a mesh of 4 ranks
    mcfg = (get_config("qwen3-0.6b").replace(
        num_layers=TRAIN_MESH["layers"], param_dtype="float32",
        compute_dtype="float32") if full
        else get_smoke_config("qwen3-0.6b"))
    t0 = time.perf_counter()
    ranks = spawn_local(TRAIN_MESH["world"], _train_mesh_rank, mcfg, batch,
                        seq, device, device_type=device,
                        timeout_s=TRAIN_MESH["timeout_s"])
    mesh_s = time.perf_counter() - t0
    parts["10c"] = mesh_s
    n = TRAIN_MESH["steps"]
    for name, (shape, names) in TRAIN_MESH["runs"].items():
        rs = [rk["runs"][name] for rk in ranks]
        one = rs[0]["one_rank"]
        label = " x ".join(f"{a} {s}" for a, s in zip(names, shape))
        _check(len({r["checksum"] for r in rs}) == 1,
               f"phase 10c {name}: the ranks' trained leaves differ")
        _check(all(r["losses"] == rs[0]["losses"] for r in rs),
               f"phase 10c {name}: the ranks' losses differ")
        _check(_train_within(*one["read"], n),
               f"phase 10c {name}: mesh vs one rank over the limits: {one}")
        _check(not _train_within(*one["planted"], 1),
               f"phase 10c {name}: the planted fault passes the limits: "
               f"{one['planted']}")
        _check(all(r["moment_bytes"] * shape[0] == r["whole_moment_bytes"]
                   for r in rs), f"phase 10c {name}: a rank's moments are "
               f"not the whole's / {shape[0]}")
        if name == "fed":
            _check(all(r["base_kept"] for r in rs),
                   "phase 10c fed: a base leaf was replaced")
            _check(all(r["psum_bytes"] == r["payload"] + 12 and
                       r["gathered_bytes"] == r["payload"] for r in rs),
                   f"phase 10c fed: collective bytes a step "
                   f"{[(r['psum_bytes'], r['gathered_bytes']) for r in rs]}"
                   f" for an adapter payload of {rs[0]['payload']} B")
        walls = [max(r["walls"][i] for r in rs) for i in range(n)]
        print(f"[{card}] phase 10c {'make_fed_train_step' if name == 'fed' else 'make_train_step'} "
              f"on ({label}), 4 ranks on one card over gloo, "
              f"{mcfg.name} ({mcfg.num_layers} layers, d_model "
              f"{mcfg.d_model}, vocab {mcfg.vocab_size}, f32), {n} steps at "
              f"{batch} x {seq}, -1 labels on data rank 0's rows: losses "
              f"{[round(l, 5) for l in rs[0]['losses']]} vs one rank "
              f"{[round(l, 5) for l in one['losses']]}; "
              f"{_train_reading(*one['read'], n)}; planted (per-rank means "
              f"averaged, one step): {_train_reading(*one['planted'], 1)}; "
              f"moments a rank "
              f"{rs[0]['moment_bytes']} B = {rs[0]['whole_moment_bytes']} / "
              f"{shape[0]}; psum {rs[0]['psum_bytes']:.0f} B and gather "
              f"{rs[0]['gathered_bytes']:.0f} B a rank a step (trained "
              f"leaves {rs[0]['payload']} B); step walls "
              + ", ".join(f"{w:.2f}" for w in walls)
              + " s (host clock, slowest rank; gloo staging through the "
              f"host on one card, not a link's speed); peak a rank "
              + ", ".join(f"{r['peak_gib']:.2f}" for r in rs) + " GiB")
    if full:
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        moe_launches = _phase_train_moe(card, device)
        parts["10d"] = time.perf_counter() - t0
    launches = {k: v for mod in _kernel_modules()
                for k, v in mod.LAUNCHES.items()}
    rank_launches = [rk["launches"] for rk in ranks]
    if full:
        rank_launches += moe_launches
    _check(not any(launches.values()) and
           not any(v for rl in rank_launches for v in rl.values()),
           f"phase 10: a kernel launched on the train path, which reaches "
           f"none: {launches}, ranks {rank_launches}")
    print(f"[{card}] phase 10 kernel launches on the train path: "
          f"{launches}, in each rank of 10c {rank_launches[0]}; 10c wall "
          f"{mesh_s:.1f} s with the world's start; phase 10 wall "
          f"{time.perf_counter() - t_start:.1f} s (host clock; parts "
          + ", ".join(f"{k} {v:.1f} s" for k, v in parts.items()) + ")")


# ---------------------------------------------------------------------------
# phase 11: the dry run against the card
# ---------------------------------------------------------------------------

# 11a: a dry run of the production world on the installed PyTorch, held
# to its committed record: (arch, shape, multi_pod, fed).  One pair: the
# long_500k and the multi-pod train_4k --fed pairs that ran here until PR
# 34 are pinned by their committed records and by tests/test_torch_dryrun.py
# (the fed step's collectives in a fake world, its FLOPs against the
# reference).
DRYRUN_PAIRS = (("qwen3-0.6b", "decode_32k", False, False),)
# 11b: one rank's steps, predicted on fakes and run on the card: (name,
# arch, kind, batch, seq, fed, layers; 0 = published depth).  The train,
# fed_train and prefill steps run 8 of their 28 / 32 layers (since PR 34:
# the prediction dispatches every layer's ops on fakes, ~3,000 a second,
# and a layer repeats the one before); serve runs at published depth.
DRYRUN_STEPS = (("train", "qwen3-0.6b", "train", 2, 4096, False, 8),
                ("fed_train", "fedtime-llama2-7b", "train", 8, 256, True, 8),
                ("prefill", "qwen3-0.6b", "prefill", 1, 8192, False, 8),
                ("serve", "qwen3-0.6b", "decode", 0, 32768, False, 0))
SERVE_BUDGET = 70e9               # bytes the serve step's B must fit in
# measured peak above the arguments vs the prediction: 5% or 256 MiB
PEAK_TOL = (0.05, 256 * 2 ** 20)


def _dry_committed(tag: str):
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "experiments", "dryrun_torch", tag + ".json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def _phase_dry_world(card: str, total_bytes: float, pairs) -> None:
    """11a: ``launch.dryrun.run_one`` of each pair in a fake world of 256
    or 512 ranks on the installed PyTorch; FLOPs held equal to the
    committed record of the pair where there is one."""
    import tempfile
    from repro_torch.launch import dryrun
    with tempfile.TemporaryDirectory(prefix="dryrun_") as tmp:
        for arch, shape, multi, fed in pairs:
            t0 = time.perf_counter()
            r = dryrun.run_one(arch, shape, multi_pod=multi, fed=fed,
                               outdir=tmp)
            wall = time.perf_counter() - t0
            mem = r["memory"]
            need = mem["argument_bytes"] + mem["temp_bytes"]
            tag = (f"{arch}__{shape}__{r['mesh']}" + ("__fed" if fed
                                                        else ""))
            old = _dry_committed(tag)
            if old is not None:
                _check(old["flops_per_device"] == r["flops_per_device"],
                       f"phase 11a {tag}: {r['flops_per_device']} FLOPs, "
                       f"the committed record {old['flops_per_device']}")
            same = ("no committed record" if old is None else
                    "FLOPs equal to the committed record's, bytes "
                    + ("equal" if old["bytes_accessed_per_device"]
                       == r["bytes_accessed_per_device"] else
                       f"{old['bytes_accessed_per_device']:.6e} there")
                    + f" (torch {old.get('torch')})")
            print(f"[{card}] phase 11a dry run {tag} ({r['num_devices']} "
                  f"ranks, torch {torch.__version__}): rank 0 FLOPs "
                  f"{r['flops_per_device']:.6e}, bytes "
                  f"{r['bytes_accessed_per_device']:.6e}, collective bytes "
                  f"{ {k: v for k, v in r['collectives']['bytes'].items() if v} }"
                  f", argument + temp {need / 2 ** 30:.3f} GiB of the card's "
                  f"{total_bytes / 2 ** 30:.1f} GiB; {same}; wall "
                  f"{wall:.1f} s (host clock)")


def _real_args(cfg, kind: str, batch: int, seq: int, fed: bool, device):
    """The real counterparts of ``launch.specs.step_args``' fakes on
    ``device``: weights drawn from seed 0 (adapters and NF4 as
    ``param_shapes``), zero moments, random tokens, and for decode a full
    ring (every slot valid, K and V random)."""
    from repro_torch.core.lora import (FAMILY_TARGETS, attach_lora,
                                       lora_tree, quantize_base)
    from repro_torch.launch.steps import decode_force_window
    from repro_torch.models.registry import get_model
    from repro_torch.optim.adamw import adamw_init
    api = get_model(cfg)
    g = torch.Generator(device=device).manual_seed(0)
    params = api.init(cfg, g, device=device)
    if fed:
        ft = cfg.fedtime
        targets = FAMILY_TARGETS[cfg.family]
        params = attach_lora(params, g, rank=ft.lora_rank,
                             alpha=ft.lora_alpha, targets=targets)
        if ft.qlora:
            params = quantize_base(params, qblock=ft.qlora_block,
                                   targets=targets)
    tok = lambda shape: torch.randint(  # noqa: E731
        0, cfg.vocab_size, shape, generator=g, device=device,
        dtype=torch.int32)
    if kind == "train":
        opt = adamw_init(lora_tree(params) if fed else params)
        return (params, opt, {"tokens": tok((batch, seq)),
                              "labels": tok((batch, seq))}, 0)
    if kind == "prefill":
        return params, {"tokens": tok((batch, seq))}
    fw = decode_force_window(cfg, seq)
    cache = api.init_cache(cfg, batch, seq, force_window=fw,
                           dtype=torch.bfloat16, device=device)
    ring = cache["k"].shape[2]
    for i in range(cfg.num_layers):
        cache["k"][i].normal_(generator=g)
        cache["v"][i].normal_(generator=g)
    cache["kv_pos"].copy_(torch.arange(ring, dtype=torch.int32,
                                       device=device).expand_as(
                                           cache["kv_pos"]))
    return params, cache, {"token": tok((batch, 1)),
                           "pos": torch.tensor(ring, dtype=torch.int32,
                                               device=device)}


def _serve_batch_that_fits(cfg, seq: int, budget: float) -> tuple:
    """The largest B whose predicted argument + temp bytes fit ``budget``
    (the dry run is linear in B: two predictions give its slope), and that
    B's prediction ``(counter, memory)``."""
    from repro_torch.launch import dryrun, specs
    from repro_torch.launch.steps import make_serve_step, decode_force_window
    step = make_serve_step(cfg, force_window=decode_force_window(cfg, seq))

    def need(b):
        _, args, _, _ = specs.step_args(cfg, "decode", b, seq)
        counter, mem = dryrun.measure(step, args)
        return counter, mem, mem["argument_bytes"] + mem["temp_bytes"]

    n1, n2 = need(1)[2], need(2)[2]
    b = max(1, int((budget - (n1 - (n2 - n1))) // (n2 - n1)))
    while True:
        counter, mem, n = need(b)
        if n <= budget or b == 1:
            return b, counter, mem
        b -= 1


def _shape_rules_vs_kernels(card: str, device) -> int:
    """Each kernel's shape rule, on fakes of real inputs, gives the
    kernel's outputs' shapes and types (ring and paged flash-decode, with
    and without partials; the block copy; rmsnorm; qlora_matmul;
    flash_attention; the wire hop).  Returns the cases held."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.core.quant import nf4_quantize
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import qlora_matmul as qm
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import wire_hop as wh
    g = torch.Generator(device=device).manual_seed(3)
    r = lambda *s, dt=torch.bfloat16: torch.randn(  # noqa: E731
        s, generator=g, device=device).to(dt)
    B, S, Hk, D = 2, 256, 8, 128
    q, k, v = r(B, 1, 2 * Hk, D), r(B, S, Hk, D), r(B, S, Hk, D)
    kvp = torch.arange(S, dtype=torch.int32, device=device).expand(
        B, S).contiguous()
    pool_k, pool_v = r(8, 16, Hk, D), r(8, 16, Hk, D)
    pool_pos = torch.arange(128, dtype=torch.int32,
                            device=device).reshape(8, 16)
    tbl = torch.tensor([[0, 1, 2, -1], [3, 4, 5, 6]], dtype=torch.int32,
                       device=device)
    qpos = torch.tensor([200, 60], dtype=torch.int32, device=device)
    w = r(256, 512, dt=torch.float32)
    codes, absmax = nf4_quantize(w, 64)
    cases = [
        ("flash_decode ring", fd.flash_decode_cuda, fd.flash_decode_shape,
         (q, k, v, kvp, qpos), {}),
        ("flash_decode ring partials", fd.flash_decode_cuda,
         fd.flash_decode_shape, (q, k, v, kvp, qpos),
         {"return_partials": True}),
        ("flash_decode paged", fd.flash_decode_cuda, fd.flash_decode_shape,
         (q, pool_k, pool_v, pool_pos, qpos), {"block_tables": tbl}),
        ("paged_block_copy", fd.paged_block_copy_leaves_cuda,
         fd.paged_block_copy_leaves_shape,
         ([r(2, 8, 16, Hk, D)], 1, 4), {}),
        ("rmsnorm", rn.rmsnorm_cuda, rn.rmsnorm_shape,
         (r(3, 5, 1024), r(1024)), {}),
        ("qlora_matmul", qm.qlora_matmul_cuda, qm.qlora_matmul_shape,
         (r(7, 256), codes, absmax.reshape(256, -1),
          r(256, 8, dt=torch.float32), r(8, 512, dt=torch.float32), 2.0),
         {}),
        ("flash_attention", fa.flash_attention_cuda, fa.flash_attention_shape,
         (r(1, 4, 100, 64), r(1, 4, 100, 64), r(1, 4, 100, 64)), {}),
        ("wire_hop int8", wh.fused_hop_cuda, wh.wire_hop_shape,
         (r(1024, dt=torch.float32), None, None,
          r(1024, dt=torch.float32)), {"wire": "int8", "qblock": 128}),
    ]

    def sig(x):
        if isinstance(x, torch.Tensor):
            return (tuple(x.shape), x.dtype, x.device.type)
        if isinstance(x, (list, tuple)):
            return [sig(y) for y in x]
        return x

    for label, kernel, shape_rule, args, kw in cases:
        got = sig(kernel(*args, **kw))
        mode = FakeTensorMode(allow_non_fake_inputs=True)
        fake = lambda x: (mode.from_tensor(x)  # noqa: E731
                          if isinstance(x, torch.Tensor) else
                          [fake(y) for y in x] if isinstance(x, list)
                          else x)
        with mode:
            want = sig(shape_rule(*[fake(a) for a in args], **kw))
        _check(got == want, f"phase 11b shape rule {label}: {want}, the "
               f"kernel's outputs {got}")
    _sync(device)
    print(f"[{card}] phase 11b shape rules: {len(cases)} kernel calls' "
          f"outputs equal in shape, type and device to their shape rule's "
          f"on fakes of the same inputs")
    return len(cases)


def phase_dryrun(card: str, device="cuda", pairs=DRYRUN_PAIRS,
                 steps=DRYRUN_STEPS, configs=None,
                 serve_budget: float = SERVE_BUDGET) -> dict:
    """Phase 11: the dry run against the card.  11a: ``pairs`` through
    ``launch.dryrun.run_one`` in fake worlds of 256 / 512 ranks.  11b:
    each of ``steps`` predicted on fakes at one rank
    (``launch.specs.step_args``, ``launch.dryrun.measure``), then run on
    the card under the same counter, after a warm-up call: the counter's
    FLOPs on the card equal to the prediction's, the peak above the
    arguments (``max_memory_allocated`` less what was allocated before)
    within 5% or 256 MiB of the predicted ``temp_bytes``, each kernel's
    shape rule against the kernel; each step timed with CUDA events, its
    counted FLOPs over that time and that rate's share of 989 TFLOP/s.
    ``configs`` (arch -> config) and ``device="cpu"`` cut it to a
    rehearsal on the CPU (the measured peak then reads the counter's own
    real-run peak).  Returns the flash-decode launches of 11b's serve
    step."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.launch import dryrun, specs
    from repro_torch.launch.hlo_cost import analyze
    from repro_torch.launch.steps import (decode_force_window,
                                          make_fed_train_step,
                                          make_prefill_step, make_serve_step,
                                          make_train_step)
    t_start = time.perf_counter()
    cuda = device == "cuda"
    total = (torch.cuda.get_device_properties(0).total_memory if cuda
             else CARD_BYTES)
    _phase_dry_world(card, total, pairs)
    t_a = time.perf_counter() - t_start
    parts = []                       # (step, predict s, card run s)
    cfg_of = (configs or {}).get
    launches = 0
    for name, arch, kind, batch, seq, fed, layers in steps:
        cfg = cfg_of(arch) or get_config(arch)
        if layers:
            cfg = cfg.replace(num_layers=min(layers, cfg.num_layers))
        t0 = time.perf_counter()
        if kind == "decode":
            batch, c_f, m_f = _serve_batch_that_fits(cfg, seq, serve_budget)
            step = make_serve_step(
                cfg, force_window=decode_force_window(cfg, seq))
        else:
            step = {"train": make_fed_train_step(cfg) if fed
                    else make_train_step(cfg),
                    "prefill": make_prefill_step(cfg)}[kind]
            _, fargs, _, _ = specs.step_args(cfg, kind, batch, seq, fed=fed)
            c_f, m_f = dryrun.measure(step, fargs)
            del fargs
        predict_s = time.perf_counter() - t0
        pred = analyze(c_f)
        t_run = time.perf_counter()
        if cuda:
            torch.cuda.empty_cache()
        args = _real_args(cfg, kind, batch, seq, fed, device)
        fd.reset_launches()
        out = step(*args)                     # warm-up: handles, workspace
        del out
        _sync(device)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
        c_r, m_r = dryrun.measure(step, args)
        _sync(device)
        peak = (torch.cuda.max_memory_allocated() - before if cuda
                else c_r.peak_bytes)
        got = analyze(c_r)
        times = []
        for _ in range(2):
            if cuda:
                e0, e1 = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
                e0.record()
            t1 = time.perf_counter()
            out = step(*args)
            if cuda:
                e1.record()
                torch.cuda.synchronize()
                times.append(e0.elapsed_time(e1) / 1e3)
            else:
                times.append(time.perf_counter() - t1)
            del out
        if kind == "decode" and cuda:
            launches = fd.LAUNCHES["flash_decode"]
            calls = 4                       # warm-up, counted, 2 timed
            _check(launches == calls * cfg.num_layers,
                   f"phase 11b serve: {launches} flash-decode launches, "
                   f"not one a layer a call ({calls * cfg.num_layers})")
        _check(got["flops_per_device"] == pred["flops_per_device"],
               f"phase 11b {name}: {got['flops_per_device']} FLOPs counted "
               f"on the card, {pred['flops_per_device']} predicted")
        tol = max(PEAK_TOL[0] * m_f["temp_bytes"], PEAK_TOL[1])
        _check(abs(peak - m_f["temp_bytes"]) <= tol,
               f"phase 11b {name}: peak above the arguments {peak} B, "
               f"predicted {m_f['temp_bytes']} B (limit {tol:.0f} B)")
        _check(m_r["argument_bytes"] == m_f["argument_bytes"],
               f"phase 11b {name}: argument bytes {m_r['argument_bytes']}, "
               f"predicted {m_f['argument_bytes']}")
        dt = min(times)
        rate = got["flops_per_device"] / dt
        print(f"[{card}] phase 11b {name} {arch} ({cfg.num_layers} layers) "
              f"B {batch} x S {seq}{' [fed]' if fed else ''}: FLOPs "
              f"{got['flops_per_device']:.6e} counted on the card = "
              f"predicted; bytes {got['bytes_per_device']:.6e} (predicted "
              f"{pred['bytes_per_device']:.6e}); arguments "
              f"{m_f['argument_bytes'] / 2 ** 30:.3f} GiB; peak above them "
              f"{peak / 2 ** 30:.4f} GiB measured, "
              f"{m_f['temp_bytes'] / 2 ** 30:.4f} GiB predicted "
              f"({(peak - m_f['temp_bytes']) / 2 ** 20:+.1f} MiB); step "
              f"{dt * 1e3:.2f} ms ({'CUDA events' if cuda else 'host clock'}"
              f", best of {len(times)}), {rate / 1e12:.2f} TFLOP/s counted, "
              f"{rate / BF16_FLOPS:.1%} of 989 TFLOP/s bf16; prediction "
              f"{predict_s:.1f} s (host clock)")
        del args, c_r, c_f
        if cuda:
            torch.cuda.empty_cache()
        parts.append((name, predict_s, time.perf_counter() - t_run))
    t0 = time.perf_counter()
    if cuda:
        _shape_rules_vs_kernels(card, device)
    print(f"[{card}] phase 11 wall {time.perf_counter() - t_start:.1f} s "
          f"(host clock; 11a {t_a:.1f} s; 11b "
          + ", ".join(f"{n} {p:.1f} s predicted on fakes + {r:.1f} s on the "
                      f"card" for n, p, r in parts)
          + f"; the shape rules vs the kernels "
          f"{time.perf_counter() - t0:.1f} s)")
    return {"flash_decode": launches}


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, dev) for v in tree)
    return tree.to(dev)


# Phase 6's smoke configs besides SERVED's: qwen3-1.7b, gemma2-27b (its
# local and global rings; no paged pool), smollm-360m (G 3, D 64),
# mixtral-8x7b (G 2, D 64), qwen2-moe-a2.7b (G 1, D 64), xlstm-350m (its
# recurrent states; no paged pool, no kernel), zamba2-2.7b (G 1, D 64;
# contiguous rings, no paged pool) and seamless-m4t-medium (G 1, D 64, its
# self rings and cross memory over seeded frames; no paged pool).
PHASE6_EXTRA = ("qwen3-1.7b", "gemma2-27b", "smollm-360m", "mixtral-8x7b",
                "qwen2-moe-a2.7b", "xlstm-350m", "zamba2-2.7b", ENCDEC)


def phase_reference(card: str, arch: str) -> None:
    """``arch``'s smoke config in f32 (qwen3-0.6b: G = 2, D 64;
    fedtime-llama2-7b: G = 1, D 32; PHASE6_EXTRA's): the card (kernels)
    against the CPU (plain versions), same weights, teacher-forced tokens
    (an encoder-decoder's over 24 seeded frames); ring and (but for an
    alternating config and the families served on contiguous lanes)
    paged."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.registry import get_model
    cfg = get_smoke_config(arch)
    api = get_model(cfg)
    params = api.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(0)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (3, 20)))
    teacher = torch.as_tensor(rng.integers(0, cfg.vocab_size, (8, 3, 1)))
    src = ({"frames": _seeded_frames(cfg, 3, 24, 0, "cpu")}
           if cfg.family == "encdec" else {})
    ring, bs = 32, 8
    table = torch.tensor([[3, 9, 0, 6], [1, 11, 4, -1], [10, 2, 7, 5]],
                         dtype=torch.int32)
    layouts = (("ring",) if cfg.local_global_alternating
               or cfg.family in ("ssm", "hybrid", "encdec")
               else ("ring", "paged"))
    outs = {}
    for dev in ("cpu", "cuda"):
        p = _to(params, dev)
        for layout in layouts:
            cache, lg = api.prefill(p, cfg, {
                "tokens": prompt.to(dev),
                **{k: x.to(dev) for k, x in src.items()}}, cache_len=ring)
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
    for layout in layouts:
        a, b = outs[("cuda", layout)], outs[("cpu", layout)]
        _check(a.shape == (3, 9, cfg.vocab_size), "reference: logits shape")
        _check(bool(torch.isfinite(a).all()), "reference: non-finite")
        err = float((a - b).abs().max())
        _check(err <= TOL_F32_MODEL, f"reference {layout}: card vs CPU "
               f"logits max err {err} > {TOL_F32_MODEL}")
        print(f"[{card}] reference {cfg.name} f32 {layout} (G = "
              f"{cfg.num_heads // cfg.num_kv_heads}, D {cfg.head_dim}): card "
              f"vs CPU logits max_abs_err {err:.3g} (tol {TOL_F32_MODEL}), "
              f"9 steps x 3 rows")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs on "
                         "the card only")
    t_start = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(root, "src"))
    from repro_torch.kernels import build

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
        for entry, report in _ptxas_report(log):
            print(f"  ptxas {name} {entry}: {report}")

    timer = Timer()
    rows = phase_kernels(card, timer)
    rows.update(phase_hop_kernels(card, timer))
    ops_rows, ops_launches = phase_ops_kernels(card, timer)
    rows.update(ops_rows)
    del timer
    torch.cuda.empty_cache()

    served = {SERVED[0]: phase_main_path(card, SERVED[0])}
    chaos_launches = phase_chaos(card)
    extras = phase_serving_extras(card)
    served.update({arch: phase_main_path(card, arch) for arch in SERVED[1:]})
    launches = dict(served[SERVED[0]])
    for name in ("flash_decode", "flash_decode_paged", "paged_block_copy"):
        for arch in SERVED[1:]:
            rows[name][arch]["launches"] = served[arch][name]
        rows[name]["fault_tolerant_engine"] = {
            "launches": chaos_launches[name]}
    rows["flash_decode"]["generate"] = {
        "launches": extras["generate"]["flash_decode"]}
    for name in ("flash_decode_paged", "paged_block_copy"):
        rows[name]["swap_tier_engine"] = {
            "launches": extras["swap_tier_engine"][name]}

    fit_launches, per_upload = phase_fit(card)
    launches.update(fit_launches)
    rows["wire_hop_int8"]["two_phase_fit"] = {
        "launches": phase_two_phase(card)["wire_hop_int8"]}
    rows["wire_hop_int8"]["fault_tolerant_fit"] = {
        "launches": phase_fault_fit(card)}
    launches.update(ops_launches)
    torch.cuda.empty_cache()

    t7 = time.perf_counter()
    for mod in _kernel_modules():
        mod.reset_launches()
    phase_centralized(card)
    phase_table2(card)
    phase_fig5(card, per_upload)
    launches_7 = {k: v for mod in _kernel_modules()
                  for k, v in mod.LAUNCHES.items()}
    _check(not any(launches_7.values()), f"phase 7: a kernel launched on "
           f"the centralized path, which reaches none: {launches_7}")
    print(f"[{card}] phase 7 wall {time.perf_counter() - t7:.1f} s "
          f"(host clock); kernel launches on its path: {launches_7}")
    torch.cuda.empty_cache()

    mesh_launches = phase_mesh(card)
    for name, path in (("wire_hop_int8", "ring_aggregate"),
                       ("wire_hop_bf16", "ring_aggregate"),
                       ("flash_decode", "sharded_flash_decode"),
                       ("flash_decode_paged", "sharded_flash_decode")):
        rows[name][path] = {"launches": mesh_launches[name]}

    torch.cuda.empty_cache()
    shard_launches = phase_sharded_serve(card)
    for name in ("flash_decode", "flash_decode_paged"):
        rows[name]["sharded_serve_step"] = {"launches": shard_launches[name]}

    torch.cuda.empty_cache()
    phase_train(card)

    torch.cuda.empty_cache()
    dry_launches = phase_dryrun(card)
    rows["flash_decode"]["dry_run_check"] = {
        "launches": dry_launches["flash_decode"]}

    torch.cuda.empty_cache()
    family_launches = phase_families(card)
    for arch, counts in family_launches.items():
        for name in ("flash_decode", "flash_decode_paged",
                     "paged_block_copy"):
            rows[name][f"phase 12 {arch}"] = {"launches": counts[name]}
    torch.cuda.empty_cache()
    phase_recurrent(card)
    hybrid_launches = phase_hybrid(card)
    for name in ("flash_decode", "flash_decode_paged", "paged_block_copy"):
        rows[name][f"phase 12c {HYBRID}"] = {
            "launches": hybrid_launches[name]}
    encdec_launches = phase_encdec(card)
    for name in ("flash_decode", "flash_decode_paged", "paged_block_copy"):
        rows[name][f"phase 12d {ENCDEC}"] = {
            "launches": encdec_launches[name]}

    for arch in SERVED + PHASE6_EXTRA:
        phase_reference(card, arch)
    _fit_reference(card)
    _centralized_reference(card)

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
    print(f"[{card}] chip_smoke wall {time.perf_counter() - t_start:.1f} s "
          f"(host clock)")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
