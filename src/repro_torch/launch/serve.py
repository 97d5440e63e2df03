"""Serving launcher: fixed-batch decode or the continuous-batching engine.

Fixed batch (one prefill, synchronous decode over the contiguous ring):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \
      --full-config --batch 4 --prompt-len 512 --gen 64

Engine (continuous batching over the paged pool with prefix sharing, or
over contiguous lanes for gemma2's local/global rings):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \
      --full-config --engine --slots 4 --trace 8 --arrival-rate 0.5 --gen 32

``--trace N`` synthesizes N requests with Poisson arrivals and mixed
prompt lengths; ``--requests FILE`` replays a JSON trace instead (a list of
objects with ``prompt`` or ``prompt_len``, and optional ``id``,
``max_new_tokens``, ``arrival_step``, ``temperature`` / ``top_k`` /
``top_p`` / ``seed``, ``deadline_s`` / ``ttft_slo_s``).

Fault tolerance (engine mode): ``--max-queue`` bounds the submit queue
with cost-aware load shedding, ``--deadline-s`` / ``--ttft-slo-s`` set
default SLOs (cancelled mid-decode on a miss), ``--journal PATH`` arms the
write-ahead request journal (the port's own format, see
``serve/journal.py``), and ``--virtual-clock`` / ``--step-time-s`` run the
SLO clock deterministically.  ``--no-swap-tier`` turns off the host swap
tier (on by default for the paged pool, as ``REPRO_SWAP_TIER=0`` does): a
displaced lane is then recomputed instead of restored.  Shed and
quarantine verdicts print a line each.  ``--trace-out PATH`` writes the
run's ``repro_torch.obs`` timeline as Chrome trace-event JSON (Perfetto,
chrome://tracing); ``--flight-out PATH`` arms the flight recorder's
post-mortem dump instead.

Weights are random, drawn from ``--seed``.  Everything runs on ``cuda``
unless ``--device cpu`` is given (plain PyTorch versions of the kernels; a
smoke-sized run only).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from repro_torch.configs import ALL_ARCHS, get_config, get_smoke_config
from repro_torch.models.registry import get_model, train_batch_shapes


def make_trace(cfg, n: int, *, gen: int, max_prompt: int, rate: float,
               seed: int = 0):
    """Synthetic Poisson request trace (arrival steps, mixed prompt
    lengths) as plain dicts; the same draws as the reference's."""
    rng = np.random.default_rng(seed)
    arrivals = np.floor(np.cumsum(rng.exponential(1.0 / max(rate, 1e-6),
                                                  n))).astype(int)
    out = []
    for i in range(n):
        plen = int(rng.integers(max(4, max_prompt // 4), max_prompt + 1))
        out.append({
            "id": f"req{i}",
            "prompt": rng.integers(0, cfg.vocab_size, plen).tolist(),
            "max_new_tokens": gen,
            "arrival_step": int(arrivals[i]),
        })
    return out


def load_trace(path: str, cfg, *, gen: int, seed: int = 0):
    """A JSON request trace as ``make_trace``'s dicts: a request without a
    ``prompt`` draws ``prompt_len`` random tokens (the reference's
    draws)."""
    rng = np.random.default_rng(seed)
    out = []
    with open(path) as f:
        records = json.load(f)
    for i, r in enumerate(records):
        prompt = r.get("prompt")
        if prompt is None:
            prompt = rng.integers(0, cfg.vocab_size,
                                  int(r["prompt_len"])).tolist()
        out.append({**r, "id": r.get("id", f"req{i}"), "prompt": prompt,
                    "max_new_tokens": int(r.get("max_new_tokens", gen)),
                    "arrival_step": int(r.get("arrival_step", 0))})
    return out


def _to_request(r: dict):
    from repro_torch.serve.request import Request, SamplingParams
    deadline = r.get("deadline_s")
    ttft_slo = r.get("ttft_slo_s")
    return Request(
        id=r["id"], prompt=np.asarray(r["prompt"], np.int32),
        max_new_tokens=r["max_new_tokens"],
        arrival_step=r.get("arrival_step", 0),
        eos_id=r.get("eos_id"),
        deadline_s=None if deadline is None else float(deadline),
        ttft_slo_s=None if ttft_slo is None else float(ttft_slo),
        sampling=SamplingParams(
            temperature=float(r.get("temperature", 0.0)),
            top_k=int(r.get("top_k", 0)),
            top_p=float(r.get("top_p", 0.0)),
            seed=int(r.get("seed", 0))))


def run_engine(cfg, params, trace, *, slots: int, cache_len: int,
               max_tokens_in_flight: int = 0, prefill_chunk: int = 0,
               prefill_bucket: int = 0, paged=None,
               block_size: int = 0, pool_blocks: int = 0,
               share_prefixes=None, swap_tier=None, max_queue=None,
               deadline_s=None, ttft_slo_s=None, journal=None, clock=None,
               step_time_s=None, device="cuda", quiet: bool = False):
    """Serve ``trace`` (dicts as ``make_trace`` gives) through one engine;
    returns (finished, metrics summary, engine)."""
    from repro_torch.serve.engine import ForecastEngine
    engine = ForecastEngine(cfg, params, num_slots=slots,
                            cache_len=cache_len,
                            max_tokens_in_flight=max_tokens_in_flight,
                            prefill_chunk=prefill_chunk,
                            prefill_bucket=prefill_bucket,
                            paged=paged, block_size=block_size,
                            pool_blocks=pool_blocks,
                            share_prefixes=share_prefixes,
                            swap_tier=swap_tier, max_queue=max_queue,
                            default_deadline_s=deadline_s,
                            default_ttft_slo_s=ttft_slo_s, journal=journal,
                            clock=clock, step_time_s=step_time_s,
                            device=device)
    for r in trace:
        verdict = engine.submit(_to_request(r))
        if not verdict.ok and not quiet:
            # a shed request should be retried after retry_after_s, a
            # quarantined one not at all
            print(f"submit {verdict.id}: {verdict.verdict}"
                  + (f" (retry after {verdict.retry_after_s:.2f}s)"
                     if verdict.verdict == "shed" else "")
                  + (f" [{verdict.reason}]" if verdict.reason else ""))
    done = engine.run()
    summ = engine.metrics.summary()
    if not quiet:
        pool_kind = (f"paged ({engine.pool.pool_blocks} blocks x "
                     f"{engine.pool.block_size})" if engine.paged
                     else "contiguous lanes")
        print(f"engine: {summ['requests']} requests, "
              f"{summ['decode_tokens']} tokens in {summ['decode_steps']} "
              f"steps ({summ['tok_per_s']:.1f} tok/s aggregate, "
              f"{summ['steady_tok_per_s']:.1f} tok/s steady decode)")
        print(f"        mean TTFT {summ['mean_ttft_s'] * 1e3:.0f}ms, "
              f"occupancy {summ['mean_occupancy']:.2f}, block util "
              f"{summ['mean_block_utilization']:.2f} [{pool_kind}], "
              f"peak in-flight {summ['peak_in_flight']}, "
              f"parked {summ['parked_events']}, "
              f"evicted {summ['evictions']}")
        if (summ["shed"] or summ["deadline_misses"] or summ["quarantined"]
                or engine.journal is not None):
            print(f"        fault tolerance: {summ['shed']} shed, "
                  f"{summ['deadline_misses']} deadline-missed "
                  f"({summ['ttft_slo_misses']} TTFT-SLO), "
                  f"{summ['quarantined']} quarantined, "
                  f"deadline miss rate {summ['deadline_miss_rate']:.3f}"
                  + (f", journal {engine.journal.path}"
                     if engine.journal is not None else ""))
        if engine.paged and (engine.share_prefixes or engine.swap_tier):
            print(f"        prefix sharing: {summ['share_hits']} hits "
                  f"({summ['full_prompt_hits']} full-prompt, "
                  f"{summ['shared_blocks']} blocks shared, "
                  f"{summ['cow_copies']} CoW copies), swap tier: "
                  f"{summ['swap_outs']} out / {summ['swap_ins']} in "
                  f"({summ['swap_out_bytes']} B out)")
    return done, summ, engine


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_fixed_batch(cfg, params, *, batch: int, prompt_len: int, gen: int,
                    device="cuda", seed: int = 0, quiet: bool = False,
                    inputs=None):
    """One prefill of ``batch`` random prompts, then ``gen`` synchronous
    decode steps.  The prefill's batch is ``train_batch_shapes`` less its
    labels, as the reference's: the tokens drawn from ``seed``, any other
    input (an encoder-decoder's frames) zeros, or the tensor ``inputs``
    gives by its name.  Returns a dict with the tokens, every step's
    logits finiteness and the prefill / steady-state decode rates."""
    api = get_model(cfg)
    B, P = batch, prompt_len
    rng = np.random.default_rng(seed)
    shapes = train_batch_shapes(cfg, B, P)
    shapes.pop("labels")
    fb = {}
    for k, (shp, dt) in shapes.items():
        if k == "tokens":
            fb[k] = torch.as_tensor(rng.integers(0, cfg.vocab_size, shp),
                                    device=device)
        elif inputs is not None and k in inputs:
            fb[k] = inputs[k].to(device)
        else:
            fb[k] = torch.zeros(shp, dtype=dt, device=device)
    t0 = time.perf_counter()
    cache, logits = api.prefill(params, cfg, fb, cache_len=P + gen)
    _sync(device)
    t_prefill = time.perf_counter() - t0
    finite = [bool(torch.isfinite(logits).all())]

    tok = logits[:, -1].argmax(dim=-1).to(torch.int32)[:, None]
    generated = [tok]

    def decode(i):
        nonlocal tok, cache
        lg, cache = api.decode_step(params, cfg, cache,
                                    {"token": tok, "pos": P + i})
        finite.append(torch.isfinite(lg).all())
        tok = lg[:, -1].argmax(dim=-1).to(torch.int32)[:, None]
        generated.append(tok)

    t0 = time.perf_counter()
    decode(0)                                  # first step: kernels load
    _sync(device)
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    for i in range(1, gen):
        decode(i)
    _sync(device)
    dt = time.perf_counter() - t0
    out = torch.cat(generated, dim=1).cpu().numpy()
    steady = B * (gen - 1) / dt if gen > 1 else 0.0
    res = {"tokens": out, "finite": all(bool(f) for f in finite),
           "prefill_tok_per_s": B * P / t_prefill,
           "first_step_s": t_first, "decode_tok_per_s": steady}
    if not quiet:
        print(f"prefill: {B}x{P} in {t_prefill:.3f}s "
              f"({res['prefill_tok_per_s']:.0f} tok/s)")
        print(f"decode: first step {t_first:.3f}s; {gen - 1} steps x {B} "
              f"seqs in {dt:.3f}s ({steady:.1f} tok/s)")
        print(f"sample continuation (seq 0): {out[0][:16].tolist()}")
    return res


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ALL_ARCHS, default="qwen3-0.6b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full-config", dest="smoke", action="store_false")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights")
    # engine mode
    ap.add_argument("--engine", action="store_true",
                    help="continuous-batching engine instead of one fixed "
                         "batch")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--cache-len", type=int, default=0,
                    help="per-slot ring length (default prompt+gen)")
    ap.add_argument("--trace", type=int, default=8,
                    help="synthesize N Poisson-arrival requests")
    ap.add_argument("--requests", default="",
                    help="JSON request trace file (see module docstring)")
    ap.add_argument("--arrival-rate", type=float, default=0.5,
                    help="mean arrivals per engine step")
    ap.add_argument("--max-tokens-in-flight", type=int, default=0)
    ap.add_argument("--prefill-chunk", type=int, default=0)
    ap.add_argument("--prefill-bucket", type=int, default=0)
    ap.add_argument("--trace-seed", type=int, default=0)
    # paged block-KV pool (default: on for uniform-ring dense/moe configs)
    ap.add_argument("--paged", dest="paged", action="store_const",
                    const=True, default=None,
                    help="force the paged block-KV pool")
    ap.add_argument("--no-paged", dest="paged", action="store_const",
                    const=False,
                    help="contiguous per-slot lanes instead of the paged "
                         "block-KV pool")
    ap.add_argument("--block-size", type=int, default=0)
    ap.add_argument("--pool-blocks", type=int, default=0)
    ap.add_argument("--no-share-prefixes", dest="share_prefixes",
                    action="store_const", const=False, default=None,
                    help="disable copy-on-write prefix sharing")
    ap.add_argument("--swap-tier", dest="swap_tier", action="store_const",
                    const=True, default=None,
                    help="host-memory swap tier for displaced lanes "
                         "(default on for paged pools; REPRO_SWAP_TIER=0 "
                         "disables)")
    ap.add_argument("--no-swap-tier", dest="swap_tier", action="store_const",
                    const=False,
                    help="disable the swap tier (displaced lanes recompute)")
    # fault tolerance (engine mode; see repro_torch.serve.engine)
    ap.add_argument("--max-queue", type=int, default=0,
                    help="bounded submit queue: backpressure sheds the "
                         "cheapest-to-retry queued request when full (0 = "
                         "unbounded; REPRO_SERVE_MAX_QUEUE)")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="default whole-request deadline in engine-clock "
                         "seconds (REPRO_SERVE_DEADLINE_S); a request's own "
                         "deadline_s in a --requests trace overrides it")
    ap.add_argument("--ttft-slo-s", type=float, default=None,
                    help="default first-token SLO in engine-clock seconds "
                         "(REPRO_SERVE_TTFT_SLO_S)")
    ap.add_argument("--journal", default="",
                    help="write-ahead request journal path: a crashed "
                         "engine's unfinished requests replay bit for bit "
                         "(REPRO_SERVE_JOURNAL)")
    ap.add_argument("--virtual-clock", action="store_true",
                    help="run SLO deadlines on fault.clock.VirtualClock "
                         "(each engine step advances --step-time-s) instead "
                         "of wall time")
    ap.add_argument("--step-time-s", type=float, default=None,
                    help="virtual seconds per engine step under "
                         "--virtual-clock (REPRO_SERVE_STEP_S, default "
                         "0.05)")
    ap.add_argument("--trace-out", default="",
                    help="write the repro_torch.obs span timeline as Chrome "
                         "trace-event JSON (Perfetto / chrome://tracing)")
    ap.add_argument("--flight-out", default="",
                    help="arm the flight recorder: write the last-N-events "
                         "ring here at exit, on an exception and on engine "
                         "distress (quarantine, park storm, eviction); "
                         "works with REPRO_TRACE=0")
    args = ap.parse_args()

    if args.flight_out:
        os.environ["REPRO_FLIGHT_OUT"] = args.flight_out

    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device (pass --device cpu for a plain "
                         "PyTorch run at smoke size)")
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    params = get_model(cfg).init(cfg, gen, device=dev)
    print(f"{cfg.name} on {dev}")

    if args.engine:
        if args.requests:
            trace = load_trace(args.requests, cfg, gen=args.gen,
                               seed=args.trace_seed)
        else:
            trace = make_trace(cfg, args.trace, gen=args.gen,
                               max_prompt=args.prompt_len,
                               rate=args.arrival_rate, seed=args.trace_seed)
        cache_len = args.cache_len or max(
            len(r["prompt"]) + r["max_new_tokens"] for r in trace)
        clock = None
        if args.virtual_clock:
            from repro_torch.fault.clock import VirtualClock
            clock = VirtualClock()
        run_engine(cfg, params, trace, slots=args.slots, cache_len=cache_len,
                   max_tokens_in_flight=args.max_tokens_in_flight,
                   prefill_chunk=args.prefill_chunk,
                   prefill_bucket=args.prefill_bucket, paged=args.paged,
                   block_size=args.block_size, pool_blocks=args.pool_blocks,
                   share_prefixes=args.share_prefixes,
                   swap_tier=args.swap_tier,
                   max_queue=args.max_queue or None,
                   deadline_s=args.deadline_s, ttft_slo_s=args.ttft_slo_s,
                   journal=args.journal or None, clock=clock,
                   step_time_s=args.step_time_s, device=dev)
    else:
        run_fixed_batch(cfg, params, batch=args.batch,
                        prompt_len=args.prompt_len, gen=args.gen, device=dev,
                        seed=args.seed)

    if args.trace_out:
        from repro_torch import obs
        path = obs.dump(args.trace_out, provenance={
            "device": str(dev), "arch": cfg.name,
            "card": (torch.cuda.get_device_name(dev)
                     if dev.type == "cuda" else None)})
        print(f"trace: wrote {path} "
              f"(open at https://ui.perfetto.dev or chrome://tracing)")


if __name__ == "__main__":
    main()
