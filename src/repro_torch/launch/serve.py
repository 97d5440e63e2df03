"""Serving launcher: fixed-batch decode or the continuous-batching engine.

Fixed batch (one prefill, synchronous decode over the contiguous ring):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \
      --full-config --batch 4 --prompt-len 512 --gen 64

Engine (continuous batching over the paged pool with prefix sharing):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \
      --full-config --engine --slots 4 --trace 8 --arrival-rate 0.5 --gen 32

Weights are random, drawn from ``--seed``.  Everything runs on ``cuda``
unless ``--device cpu`` is given (plain PyTorch versions of the kernels; a
smoke-sized run only).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ALL_ARCHS, get_config, get_smoke_config
from repro_torch.models.registry import get_model


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


def _to_request(r: dict):
    from repro_torch.serve.request import Request, SamplingParams
    return Request(
        id=r["id"], prompt=np.asarray(r["prompt"], np.int32),
        max_new_tokens=r["max_new_tokens"],
        arrival_step=r.get("arrival_step", 0),
        eos_id=r.get("eos_id"),
        sampling=SamplingParams(
            temperature=float(r.get("temperature", 0.0)),
            top_k=int(r.get("top_k", 0)),
            top_p=float(r.get("top_p", 0.0)),
            seed=int(r.get("seed", 0))))


def run_engine(cfg, params, trace, *, slots: int, cache_len: int,
               max_tokens_in_flight: int = 0, prefill_chunk: int = 0,
               prefill_bucket: int = 0, paged: bool = True,
               block_size: int = 0, pool_blocks: int = 0,
               share_prefixes=None, device="cuda", quiet: bool = False):
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
                            share_prefixes=share_prefixes, device=device)
    for r in trace:
        engine.submit(_to_request(r))
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
        if engine.share_prefixes:
            print(f"        prefix sharing: {summ['share_hits']} hits "
                  f"({summ['full_prompt_hits']} full-prompt, "
                  f"{summ['shared_blocks']} blocks shared, "
                  f"{summ['cow_copies']} CoW copies)")
    return done, summ, engine


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_fixed_batch(cfg, params, *, batch: int, prompt_len: int, gen: int,
                    device="cuda", seed: int = 0, quiet: bool = False):
    """One prefill of ``batch`` random prompts, then ``gen`` synchronous
    decode steps.  Returns a dict with the tokens, every step's logits
    finiteness and the prefill / steady-state decode rates."""
    api = get_model(cfg)
    B, P = batch, prompt_len
    rng = np.random.default_rng(seed)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, P)),
                             device=device)
    t0 = time.perf_counter()
    cache, logits = api.prefill(params, cfg, {"tokens": tokens},
                                cache_len=P + gen)
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
    ap.add_argument("--arrival-rate", type=float, default=0.5,
                    help="mean arrivals per engine step")
    ap.add_argument("--max-tokens-in-flight", type=int, default=0)
    ap.add_argument("--prefill-chunk", type=int, default=0)
    ap.add_argument("--prefill-bucket", type=int, default=0)
    ap.add_argument("--trace-seed", type=int, default=0)
    ap.add_argument("--no-paged", dest="paged", action="store_false",
                    help="contiguous per-slot lanes instead of the paged "
                         "block-KV pool")
    ap.add_argument("--block-size", type=int, default=0)
    ap.add_argument("--pool-blocks", type=int, default=0)
    ap.add_argument("--no-share-prefixes", dest="share_prefixes",
                    action="store_const", const=False, default=None,
                    help="disable copy-on-write prefix sharing")
    args = ap.parse_args()

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
        trace = make_trace(cfg, args.trace, gen=args.gen,
                           max_prompt=args.prompt_len,
                           rate=args.arrival_rate, seed=args.trace_seed)
        cache_len = args.cache_len or max(
            len(r["prompt"]) + r["max_new_tokens"] for r in trace)
        run_engine(cfg, params, trace, slots=args.slots, cache_len=cache_len,
                   max_tokens_in_flight=args.max_tokens_in_flight,
                   prefill_chunk=args.prefill_chunk,
                   prefill_bucket=args.prefill_bucket, paged=args.paged,
                   block_size=args.block_size, pool_blocks=args.pool_blocks,
                   share_prefixes=args.share_prefixes, device=dev)
    else:
        run_fixed_batch(cfg, params, batch=args.batch,
                        prompt_len=args.prompt_len, gen=args.gen, device=dev,
                        seed=args.seed)


if __name__ == "__main__":
    main()
