"""Continuous-batching serving engine.

Requests are admitted FIFO under token budgets (``scheduler``), prefilled
into a free lane of the preallocated cache pool (``cache_pool``), then
decoded together by one ragged serve step — per-slot positions, per-slot
sampling parameters, inactive lanes masked — until each request reaches
its horizon or stop token and its lane is recycled.  The per-slot batch
rows keep one fixed shape whatever the batch composition, so the step can
later be captured in a CUDA graph.

Cache layout: the paged block pool by default (one shared block pool plus
per-lane block tables; ``paged=False`` gives contiguous lanes).  Paged
decode grants blocks on demand as a request's write position crosses a
block boundary; on pool exhaustion the request parks (its lane masked
inactive) until frees arrive, and if every resident is parked the youngest
is evicted and recomputed later, so the engine never livelocks.

Prefix sharing (``share_prefixes``, default on for paged pools): a
whole-prompt hit maps every prefix block read-only and skips prefill (the
chain's stored last-token logits seed the first sample); a partial
block-aligned hit shares the matched blocks and prefills the rest.  The
first write into a block with refcount > 1 copies it first (the CoW block
copy kernel).

Not ported yet: the reference engine's deadlines and TTFT SLOs, load
shedding, poison quarantine and its in-step guard, the request journal,
the host swap tier, and the ``repro.obs`` spans.  The constructor raises
``NotImplementedError`` when asked for them.

    engine = ForecastEngine(cfg, params, num_slots=8, cache_len=256)
    engine.submit(Request(id="r0", prompt=toks, max_new_tokens=32))
    done = engine.run()              # {id: FinishedRequest}
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.steps import make_serve_step
from repro_torch.models.registry import get_model
from repro_torch.serve.cache_pool import (CachePool, PagedCachePool,
                                          PoolExhausted)
from repro_torch.serve.metrics import EngineMetrics
from repro_torch.serve.request import FinishedRequest, GenState, Request
from repro_torch.serve.sampling import row_generator, sample_vec
from repro_torch.serve.scheduler import (FIFOScheduler, SchedulerConfig,
                                         bucket_len)


class ForecastEngine:
    """Request-level serving engine: admit -> prefill-into-slot -> batched
    ragged decode -> retire."""

    def __init__(self, cfg: ModelConfig, params, *, num_slots: int = 4,
                 cache_len: int = 256, max_tokens_in_flight: int = 0,
                 prefill_chunk: int = 0, prefill_bucket: int = 0,
                 force_window: int = 0, paged: bool = True,
                 block_size: int = 0, pool_blocks: int = 0,
                 share_prefixes: Optional[bool] = None,
                 swap_tier: Optional[bool] = None, max_queue=None,
                 default_deadline_s=None, default_ttft_slo_s=None,
                 journal=None, device="cuda"):
        later = [name for name, v in (
            ("swap_tier", swap_tier), ("max_queue", max_queue),
            ("default_deadline_s", default_deadline_s),
            ("default_ttft_slo_s", default_ttft_slo_s),
            ("journal", journal)) if v]
        if later:
            raise NotImplementedError(f"engine options not ported yet: "
                                      f"{later}")
        self.cfg = cfg
        self.params = params
        self.api = get_model(cfg)
        self.device = torch.device(device)
        self.prefill_bucket = prefill_bucket
        self.force_window = force_window
        self.paged = paged
        if paged:
            self.pool = PagedCachePool(cfg, num_slots, cache_len,
                                       block_size=block_size,
                                       pool_blocks=pool_blocks,
                                       force_window=force_window,
                                       device=device)
        else:
            if block_size or pool_blocks or share_prefixes:
                raise ValueError("block_size/pool_blocks/share_prefixes "
                                 "require the paged pool")
            self.pool = CachePool(cfg, num_slots, cache_len,
                                  force_window=force_window, device=device)
        self.share_prefixes = bool(self.paged and (
            share_prefixes if share_prefixes is not None else True))
        # per-request submit sequence: multi-eviction ticks requeue in this
        # order, so FIFO survives same-tick victims (resumes keep the id)
        self._seq: Dict[str, int] = {}
        self.scheduler = FIFOScheduler(SchedulerConfig(
            max_tokens_in_flight=max_tokens_in_flight,
            prefill_chunk=prefill_chunk))
        self.metrics = EngineMetrics(num_slots,
                                     pool_blocks=self.pool.pool_blocks)
        self.step_count = 0
        self.finished: Dict[str, FinishedRequest] = {}
        self.slots: List[Optional[GenState]] = [None] * num_slots
        self._submit_time: Dict[str, float] = {}
        # global-attention rings must hold the whole sequence
        self._ring_is_global = cfg.sliding_window == 0 and not force_window

        # fixed-shape per-slot batch rows: host-side admission and eviction
        # only rewrite rows
        self._tok = np.zeros((num_slots, 1), np.int32)
        self._pos = np.full((num_slots,), -1, np.int32)
        self._temp = np.zeros((num_slots,), np.float32)
        self._topk = np.zeros((num_slots,), np.int32)
        self._topp = np.zeros((num_slots,), np.float32)
        self._seed = np.zeros((num_slots,), np.int64)
        self._t = np.zeros((num_slots,), np.int64)   # per-slot sample count

        self._step_fn = make_serve_step(cfg, force_window=force_window,
                                        sampling=True)

    # -- public surface ------------------------------------------------------

    def submit(self, request: Request) -> None:
        """Queue a request; raises for one that could never be served
        (footprint past the budget or the ring, out-of-vocab prompt)."""
        budget = self.scheduler.config.max_tokens_in_flight
        if budget > 0 and request.total_tokens > budget:
            raise ValueError(
                f"request {request.id}: total tokens "
                f"({request.total_tokens}) exceed max_tokens_in_flight "
                f"({budget}) — it could never be admitted")
        footprint = max(request.total_tokens,
                        bucket_len(request.prompt_len, self.prefill_bucket))
        if self._ring_is_global and footprint > self.pool.cache_len:
            raise ValueError(
                f"request {request.id}: prompt + horizon (bucketed: "
                f"{footprint}) exceeds cache_len ({self.pool.cache_len})")
        if self.paged:
            need = self.pool.blocks_for(footprint)
            if need > self.pool.pool_blocks:
                raise ValueError(
                    f"request {request.id}: needs {need} blocks, pool has "
                    f"{self.pool.pool_blocks}")
        prompt = np.asarray(request.prompt)
        if int(prompt.min()) < 0 or int(prompt.max()) >= self.cfg.vocab_size:
            raise ValueError(f"request {request.id}: prompt token outside "
                             f"the vocab [0, {self.cfg.vocab_size})")
        self._seq.setdefault(request.id, len(self._seq))
        self._submit_time.setdefault(request.id, time.perf_counter())
        self.scheduler.submit(request)

    @property
    def active_requests(self) -> int:
        return sum(s is not None for s in self.slots)

    @property
    def tokens_in_flight(self) -> int:
        return sum(s.request.total_tokens for s in self.slots
                   if s is not None)

    def step(self) -> None:
        """One engine tick: admit what fits, grow/park paged lanes, then one
        batched decode."""
        free_blocks = self.pool.free_blocks if self.paged else -1
        blocks_needed = self._admit_blocks if self.paged else None
        for req in self.scheduler.admit(
                now_step=self.step_count,
                free_slots=self.pool.free_slots,
                tokens_in_flight=self.tokens_in_flight,
                free_blocks=free_blocks,
                blocks_needed=blocks_needed):
            try:
                self._admit(req)
            except PoolExhausted:
                # share-aware pricing raced a chain invalidation: the
                # admission was rolled back — requeue and stop admitting
                self.scheduler.requeue_front([req])
                break
        if self.paged:
            self._grant_pass()
        self._decode()
        self.step_count += 1

    def run(self, max_steps: int = 0) -> Dict[str, FinishedRequest]:
        """Drive steps until every submitted request retires."""
        while self.scheduler.pending or self.active_requests:
            if max_steps and self.step_count >= max_steps:
                raise RuntimeError(f"engine did not drain within "
                                   f"{max_steps} steps")
            self.step()
        return self.finished

    # -- admission -----------------------------------------------------------

    def _bucketed_len(self, req: Request) -> int:
        P = req.prompt_len
        Pb = bucket_len(P, self.prefill_bucket)
        if req.resume and self._ring_is_global and Pb > self.pool.cache_len:
            return P            # resumed prompts skip bucketing on overflow
        return Pb

    def _admit_blocks(self, req: Request) -> int:
        """Paged admission price: blocks covering the prefill extent, minus
        the blocks a live prefix chain already holds (a whole-prompt hit is
        free)."""
        need = self.pool.blocks_for(self._bucketed_len(req))
        if self.share_prefixes:
            shared, full_hit, _ = self.pool.match_prefix(req.prompt)
            if full_hit:
                return 0
            need -= len(shared)
        return max(need, 0)

    def _prefill(self, tokens, true_len):
        return self.api.prefill(self.params, self.cfg, {"tokens": tokens},
                                cache_len=self.pool.cache_len,
                                force_window=self.force_window,
                                true_len=true_len)

    def _first_token(self, logits_row, sp, t: int) -> int:
        """Sample the first token from the prefill's last-token logits with
        the request's own stream (sample ``t`` of it)."""
        gen = (row_generator(sp.seed, t, self.device)
               if sp.temperature > 0 else None)
        tok = sample_vec(logits_row[None].float(),
                         temperature=[sp.temperature], top_k=[sp.top_k],
                         top_p=[sp.top_p], generators=[gen])
        return int(tok[0])

    def _admit(self, req: Request) -> None:
        res = req.resume or {}
        slot = self.pool.acquire()
        P = req.prompt_len
        Pb = self._bucketed_len(req)
        shared: List[int] = []
        full_hit, chain_logits = False, None
        if self.paged:
            if self.share_prefixes:
                shared, full_hit, chain_logits = \
                    self.pool.match_prefix(req.prompt)
            try:
                self.pool.share_map(slot, shared)
                if not full_hit:
                    self.pool.grant_tail(
                        slot, len(shared),
                        self.pool.blocks_for(Pb) - len(shared))
            except PoolExhausted:              # pool raced below the price
                self.pool.release(slot)        # decrefs any shared mapping
                raise
            if shared:
                self.metrics.record_share(len(shared), full_hit)

        if full_hit and chain_logits is not None:
            # the whole prompt lives in the pool already: no prefill, no new
            # blocks — the chain's last-token logits seed the first sample
            logits_row = chain_logits
            self.metrics.record_admit(0)
        else:
            toks = np.zeros((1, Pb), np.int64)
            toks[0, :P] = req.prompt
            true_len = ([P] if self.prefill_bucket
                        and (Pb != P or not req.resume) else None)
            cache1, logits = self._prefill(
                torch.as_tensor(toks, device=self.device), true_len)
            if self.paged:
                self.pool.insert(cache1, slot, skip_blocks=len(shared))
            else:
                self.pool.insert(cache1, slot)
            logits_row = logits[0, -1]
            self.metrics.record_admit(P)

        prior: List[int] = list(res.get("generated", []))
        sp = req.sampling
        tok0 = self._first_token(logits_row, sp, len(prior))
        if not full_hit and self.share_prefixes and req.resume is None:
            # index this prompt for future sharers (resumes carry generated
            # continuations, not reusable prompts)
            self.pool.register_prefix(slot, req.prompt, logits_row)

        now = time.perf_counter()
        st = GenState(request=req, slot=slot, pos=P, generated=prior,
                      admitted_step=self.step_count, admitted_time=now)
        done = st.remaining == 1 or tok0 == req.eos_id
        st.emit(tok0, is_last=done, now=now)
        if done:
            self._retire(st, "eos" if tok0 == req.eos_id else "length")
            return
        self.slots[slot] = st
        self._tok[slot, 0] = tok0
        self._pos[slot] = P
        self._temp[slot] = sp.temperature
        self._topk[slot] = sp.top_k
        self._topp[slot] = sp.top_p
        self._seed[slot] = sp.seed
        self._t[slot] = len(prior) + 1        # last token came from prefill

    # -- paged block lifecycle ----------------------------------------------

    def _grant_pass(self) -> None:
        """Before each paged decode: every resident lane's next write slot
        must sit in a block IT OWNS.  A write block with refcount > 1 is
        copied first (CoW; no free block for the copy parks like a failed
        grant, and a copy that fails otherwise raises); a sole
        owner whose ring wrapped back over indexed prefix content drops
        the stale chains.  Lanes that cannot be granted park.  If nothing
        is runnable, the youngest parked lane is evicted (recomputed later)
        and the pass retries; same-tick victims requeue in one batch in
        submit order."""
        victims: List[Request] = []
        while True:
            fresh: List[int] = []
            parked: List[int] = []
            # original-submit order, so frees unpark the oldest lane first
            order = sorted(
                (i for i, s in enumerate(self.slots) if s is not None),
                key=lambda i: self._seq.get(self.slots[i].request.id, 0))
            for i in order:
                st = self.slots[i]
                lb = (st.pos % self.pool.ring_len) // self.pool.block_size
                pb = int(self.pool.table[i, lb])
                if pb >= 0:
                    if self.pool.refcount(pb) > 1:
                        try:                   # shared write block: CoW
                            self.pool.cow(i, lb)
                        except PoolExhausted:  # no block for the copy
                            self._park(i)
                            parked.append(i)
                            continue
                        self.metrics.record_cow(self.pool.block_bytes)
                    elif st.pos >= self.pool.ring_len:
                        # sole owner wrapping over indexed prefix content
                        self.pool.invalidate_block(pb)
                    if self._pos[i] < 0:      # runnable now — unpark
                        self._pos[i] = st.pos
                    continue
                try:
                    fresh.append(self.pool.grant(i, lb))
                    if self._pos[i] < 0:
                        self._pos[i] = st.pos
                except PoolExhausted:         # park
                    self._park(i)
                    parked.append(i)
            self.pool.reset_blocks(fresh)
            runnable = any(s is not None and self._pos[i] >= 0
                           for i, s in enumerate(self.slots))
            if runnable or not parked:
                break
            if len(parked) == 1 and self.active_requests == 1:
                raise RuntimeError(
                    f"paged pool too small: a single resident request "
                    f"cannot grow ({self.pool.pool_blocks} blocks of "
                    f"{self.pool.block_size})")
            victim = max(parked, key=lambda i: (
                self.slots[i].admitted_step,
                self._seq.get(self.slots[i].request.id, 0)))
            victims.append(self._evict(victim))
        if victims:
            victims.sort(key=lambda r: self._seq.get(r.id, 0))
            self.scheduler.requeue_front(victims)

    def _park(self, slot: int) -> None:
        if self._pos[slot] >= 0:
            self.metrics.record_park()
        self._pos[slot] = -1

    def _resume_request(self, st: GenState) -> Request:
        """The requeued form of a displaced lane: prompt := original prompt
        + everything generated, ``max_new_tokens`` the original horizon, so
        the remaining budget, the per-token sample counter and greedy
        continuations are those of the uninterrupted run."""
        req = st.request
        res = req.resume or {}
        orig_prompt_len = int(res.get("prompt_len", req.prompt_len))
        orig_prompt = np.asarray(req.prompt, np.int32)[:orig_prompt_len]
        done = np.asarray(st.generated, np.int32)
        return Request(
            id=req.id, prompt=np.concatenate([orig_prompt, done]),
            max_new_tokens=req.max_new_tokens, sampling=req.sampling,
            eos_id=req.eos_id, arrival_step=0, stream=req.stream,
            resume={"generated": [int(t) for t in done],
                    "prompt_len": orig_prompt_len,
                    "first_token_time": res.get("first_token_time")
                    or st.first_token_time})

    def _clear_lane(self, slot: int) -> None:
        self.slots[slot] = None
        self._pos[slot] = -1
        self._tok[slot, 0] = 0
        self._temp[slot] = 0.0
        self._topk[slot] = 0
        self._topp[slot] = 0.0
        self._seed[slot] = 0
        self._t[slot] = 0
        self.pool.release(slot)

    def _evict(self, slot: int) -> Request:
        """Recompute fallback: free the lane and return the resumed
        request (the caller requeues same-tick victims in one batch)."""
        resumed = self._resume_request(self.slots[slot])
        self._clear_lane(slot)
        self.metrics.record_evict()
        return resumed

    # -- decode / retire -----------------------------------------------------

    def _decode(self) -> None:
        active = [i for i, s in enumerate(self.slots)
                  if s is not None and self._pos[i] >= 0]
        if not active:
            return
        dev = self.device
        gens = [row_generator(self._seed[i], self._t[i], dev)
                if i in active and self._temp[i] > 0 else None
                for i in range(len(self.slots))]
        batch = {
            "token": torch.as_tensor(self._tok, device=dev),
            "pos": torch.as_tensor(self._pos, device=dev),
            "temperature": torch.as_tensor(self._temp, device=dev),
            "top_k": torch.as_tensor(self._topk, device=dev),
            "top_p": torch.as_tensor(self._topp, device=dev),
            "generators": gens,
        }
        if self.paged:
            batch["block_tbl"] = torch.as_tensor(self.pool.table, device=dev)
            batch["ring_len"] = self.pool.ring_len
        t0 = time.perf_counter()
        tok, self.pool.cache = self._step_fn(self.params, self.pool.cache,
                                             batch)
        tok_np = tok.cpu().numpy()             # waits for the step
        self.metrics.record_decode_step(
            len(active), len(active), time.perf_counter() - t0,
            in_flight=self.active_requests,
            blocks_in_use=self.pool.blocks_in_use,
            fragmentation=self.pool.fragmentation)
        now = time.perf_counter()
        for i in active:
            st = self.slots[i]
            t = int(tok_np[i, 0])
            done = st.remaining == 1 or t == st.request.eos_id
            st.emit(t, is_last=done, now=now)
            st.pos += 1
            if done:
                self._retire(st, "eos" if t == st.request.eos_id
                             else "length")
            else:
                self._tok[i, 0] = t
                self._pos[i] = st.pos
                self._t[i] += 1

    def _retire(self, st: GenState, reason: str) -> None:
        self._clear_lane(st.slot)
        res = st.request.resume or {}
        first_tok = res.get("first_token_time") or st.first_token_time
        ttft = first_tok - self._submit_time.get(st.request.id,
                                                 st.admitted_time)
        self.metrics.record_finish(ttft)
        self.finished[st.request.id] = FinishedRequest(
            id=st.request.id,
            tokens=np.asarray(st.generated, np.int32),
            prompt_len=res.get("prompt_len", st.request.prompt_len),
            admitted_step=st.admitted_step,
            finished_step=self.step_count,
            ttft_s=ttft,
            reason=reason)
