"""Continuous-batching serving engine.

Requests are admitted FIFO under token budgets (``scheduler``), prefilled
into a free lane of the preallocated cache pool (``cache_pool``), then
decoded together by one ragged serve step — per-slot positions, per-slot
sampling parameters, inactive lanes masked — until each request reaches
its horizon or stop token and its lane is recycled.  The per-slot batch
rows keep one fixed shape whatever the batch composition, so the step can
later be captured in a CUDA graph.

Cache layout: the paged block pool by default where every layer has one
ring geometry (the dense and MoE families without local/global
alternation, unless ``REPRO_PAGED_KV=0``: one shared block pool plus
per-lane block tables), contiguous lanes otherwise or with
``paged=False``; gemma2's local and global rings, an xLSTM model's
recurrent states and a Zamba2 model's states and rings keep contiguous
lanes, and ``paged=True`` raises for them, as in the reference.  A purely
recurrent state is O(1) in the sequence, so no ``cache_len`` bound applies
to an xLSTM model; a Zamba2 model's global rings bound it as any global
ring does.  Paged
decode grants blocks on demand as a request's write position crosses a
block boundary; on pool exhaustion the request parks (its lane masked
inactive) until frees arrive, and if every resident is parked the youngest
leaves the pool, so the engine never livelocks.

Swap tier (``swap_tier``, default on for paged pools; ``REPRO_SWAP_TIER=0``
turns it off): the lane that leaves is snapshotted on the device
(``PagedCachePool.gather_lane``, queued before its blocks are released),
drained to pinned host memory after the tick's decode without a host wait,
and requeued; on re-admission the snapshot is re-inserted into freshly
granted blocks, in whatever slot is free, and decode continues bit for bit
where it stopped, with no prefill and no re-decode.  Evict-and-recompute
(``_evict``) remains the fallback with the tier off, or when a swapped
request's handle is gone.

Prefix sharing (``share_prefixes``, default on for paged pools): a
whole-prompt hit maps every prefix block read-only and skips prefill (the
chain's stored last-token logits seed the first sample); a partial
block-aligned hit shares the matched blocks and prefills the rest.  The
first write into a block with refcount > 1 copies it first (the CoW block
copy kernel).

    engine = ForecastEngine(cfg, params, num_slots=8, cache_len=256)
    engine.submit(Request(id="r0", prompt=toks, max_new_tokens=32))
    done = engine.run()              # {id: FinishedRequest}

Fault tolerance, as the reference's engine:

  * **SLOs** — requests may carry ``deadline_s`` (whole request) and
    ``ttft_slo_s`` (first token), measured on the engine clock from the
    first submit.  With a ``fault.clock.VirtualClock`` the engine advances
    ``step_time_s`` virtual seconds a tick; without one it reads
    ``time.perf_counter()``.  A sweep at the top of every tick cancels
    expired queued and resident requests (lane rows zeroed, blocks
    released) and finishes each with reason ``"deadline"``/``"ttft_slo"``
    and its partial tokens.
  * **Backpressure** — ``max_queue`` bounds the submit queue; on overflow
    the engine sheds the cheapest-to-retry candidate (fewest total tokens,
    newest first on ties, never a request past its first token) and
    ``submit`` returns a ``SubmitVerdict`` with a ``retry_after_s`` hint.
  * **Quarantine** — ``submit`` screens prompts against the vocab; the
    guarded serve step screens every lane's logits
    (``fault.guard.logits_finite``) and a lane that goes non-finite is
    quarantined alone: no token emitted, blocks released, neighbours
    untouched, an audit record in ``engine.quarantined``.  The chaos
    injector ``engine.poison(id)`` rides the step's ``poison`` row.  The
    screen comes back in the same device-to-host copy as the tokens, so
    the guard adds no synchronization.
  * **Journal** — ``journal=`` (a path or a ``RequestJournal``) logs
    submits, tokens and finishes ahead of time (``serve/journal.py``);
    after a crash ``replay_journal(path).unfinished_requests()`` resubmits
    every unfinished request with its tokens as resume state, and decode
    continues bit for bit.

Env knobs, each the default of its constructor argument:
``REPRO_SERVE_MAX_QUEUE`` (0 = unbounded), ``REPRO_SERVE_DEADLINE_S`` /
``REPRO_SERVE_TTFT_SLO_S`` (for requests that set none),
``REPRO_SERVE_STEP_S`` (virtual seconds a tick, default 0.05),
``REPRO_SERVE_JOURNAL`` (journal path).

Observability (``repro_torch.obs``; ``REPRO_TRACE=0`` disables): each
request has its own track with ``req.submit -> req.queued -> req.prefill
-> req.first_token -> req.decode -> req.lifecycle -> req.retire``, plus
``pool.share_hit`` / ``pool.cow_copy`` / ``req.park`` / ``req.evict`` /
``serve.shed`` / ``serve.quarantine`` / ``serve.deadline_miss`` instants;
each tick's decode is an ``engine.decode_step`` span (a
``torch.profiler.record_function`` range too) with a ``pool`` counter
track.  Exactly one ``req.lifecycle`` span goes out for each finished
request, so a trace's lifecycle count equals ``requests_finished``.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs.base import ModelConfig
from repro_torch.fault.clock import VirtualClock
from repro_torch.launch.steps import make_serve_step
from repro_torch.models.registry import get_model
from repro_torch.serve.cache_pool import (PAGED_FAMILIES, CachePool,
                                          PagedCachePool, PoolExhausted)
from repro_torch.serve.journal import RequestJournal
from repro_torch.serve.metrics import EngineMetrics
from repro_torch.serve.request import (FinishedRequest, GenState,
                                       QuarantinedRequest, Request,
                                       SubmitVerdict)
from repro_torch.serve.sampling import row_generator, sample_vec
from repro_torch.serve.scheduler import (FIFOScheduler, SchedulerConfig,
                                         bucket_len)

# families whose batch dict is {"tokens"} and whose decode takes per-slot
# ragged positions (attention rings guard their writes, recurrent states
# are frozen by the serve step): the reference's set
_SERVABLE = ("dense", "moe", "ssm", "hybrid")
# right-pad-safe prefill (causal attention only, no recurrence): the
# reference's set
_BUCKETABLE = ("dense", "moe")


class ForecastEngine:
    """Request-level serving engine: admit -> prefill-into-slot -> batched
    ragged decode -> retire."""

    def __init__(self, cfg: ModelConfig, params, *, num_slots: int = 4,
                 cache_len: int = 256, max_tokens_in_flight: int = 0,
                 prefill_chunk: int = 0, prefill_bucket: int = 0,
                 force_window: int = 0, paged: Optional[bool] = None,
                 block_size: int = 0, pool_blocks: int = 0,
                 share_prefixes: Optional[bool] = None,
                 swap_tier: Optional[bool] = None,
                 clock: Optional[VirtualClock] = None,
                 step_time_s: Optional[float] = None,
                 max_queue: Optional[int] = None,
                 default_deadline_s: Optional[float] = None,
                 default_ttft_slo_s: Optional[float] = None,
                 journal=None, device="cuda"):
        if cfg.family not in _SERVABLE:
            raise ValueError(f"family {cfg.family!r} not servable by the "
                             f"engine (supported: {_SERVABLE})")
        if prefill_bucket and cfg.family not in _BUCKETABLE:
            raise ValueError(f"prefill_bucket requires a causal-attention "
                             f"prefill (families {_BUCKETABLE}); "
                             f"{cfg.family!r} carries recurrent state "
                             f"through pad tokens")
        self.cfg = cfg
        self.params = params
        self.api = get_model(cfg)
        self.device = torch.device(device)
        self.prefill_bucket = prefill_bucket
        self.force_window = force_window
        if paged is None:                     # default on where eligible
            paged = (os.environ.get("REPRO_PAGED_KV", "1") != "0"
                     and cfg.family in PAGED_FAMILIES
                     and not cfg.local_global_alternating)
        self.paged = paged
        if paged:
            self.pool = PagedCachePool(cfg, num_slots, cache_len,
                                       block_size=block_size,
                                       pool_blocks=pool_blocks,
                                       force_window=force_window,
                                       device=device)
        else:
            if block_size or pool_blocks or share_prefixes or swap_tier:
                raise ValueError("block_size/pool_blocks/share_prefixes/"
                                 "swap_tier require the paged pool")
            self.pool = CachePool(cfg, num_slots, cache_len,
                                  force_window=force_window, device=device)
        self.share_prefixes = bool(self.paged and (
            share_prefixes if share_prefixes is not None else True))
        self.swap_tier = bool(self.paged and (
            swap_tier if swap_tier is not None
            else os.environ.get("REPRO_SWAP_TIER", "1") != "0"))
        # swapped-out lanes: request id -> {"cache": leaves, "pos", "ready"};
        # the leaves start as device gathers and are drained to pinned host
        # buffers after the tick's decode (``ready``: the event after that
        # copy)
        self.swap: Dict[str, dict] = {}
        self._swap_pending: List[str] = []
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

        # -- fault tolerance (SLOs / shedding / quarantine / journal) ----
        def _env_f(name):
            v = os.environ.get(name, "")
            return float(v) if v else None
        self.clock = clock
        # virtual seconds one tick costs on the SLO clock (only a virtual
        # clock advances by it)
        self.step_time_s = (step_time_s if step_time_s is not None
                            else _env_f("REPRO_SERVE_STEP_S") or 0.05)
        self.max_queue = (max_queue if max_queue is not None
                          else int(os.environ.get("REPRO_SERVE_MAX_QUEUE",
                                                  "0")))
        self._default_deadline_s = (default_deadline_s
                                    if default_deadline_s is not None
                                    else _env_f("REPRO_SERVE_DEADLINE_S"))
        self._default_ttft_slo_s = (default_ttft_slo_s
                                    if default_ttft_slo_s is not None
                                    else _env_f("REPRO_SERVE_TTFT_SLO_S"))
        if journal is None:
            journal = os.environ.get("REPRO_SERVE_JOURNAL") or None
        self.journal: Optional[RequestJournal] = (
            RequestJournal(os.fspath(journal))
            if isinstance(journal, (str, os.PathLike)) else journal)
        self.quarantined: Dict[str, QuarantinedRequest] = {}
        self.shed_log: Dict[str, float] = {}   # id -> retry_after_s hint
        self._poison: set = set()              # chaos: ids to NaN-inject
        self._poison_row = np.zeros((num_slots,), bool)
        # SLO windows anchor at the first submit (requeues and resumes keep
        # it); a shed request's retry starts a fresh one
        self._slo_submit: Dict[str, float] = {}
        # global-attention rings must hold the whole sequence: a uniform
        # config with no window, an alternating config, whose global rings
        # are ``cache_len`` long whatever its window (the reference admits
        # such a request there, and its global layers then wrap), and a
        # hybrid, whose shared attention is always global.  Windowed
        # configs wrap by design; an xLSTM state is O(1).
        self._ring_is_global = (cfg.family in _BUCKETABLE
                                and (cfg.local_global_alternating
                                     or (cfg.sliding_window == 0
                                         and not force_window))
                                or cfg.family == "hybrid")

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
                                        sampling=True, guard=True)

    # -- public surface ------------------------------------------------------

    def submit(self, request: Request) -> SubmitVerdict:
        """Queue a request.  One that could never be served (footprint past
        the budget or the ring) raises; traffic conditions return a
        verdict: ``"quarantined"`` for a prompt outside the vocab (audited,
        never queued) and ``"shed"`` under backpressure (``max_queue``;
        the cheapest-to-retry, newest-first victim, never one past its
        first token)."""
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
        # an out-of-vocab id would index garbage embeddings: quarantine
        # before any device work
        prompt = np.asarray(request.prompt)
        if int(prompt.min()) < 0 or int(prompt.max()) >= self.cfg.vocab_size:
            self._quarantine_submit(request, "malformed_prompt")
            return SubmitVerdict(request.id, "quarantined",
                                 reason="malformed_prompt")
        if request.deadline_s is None:
            request.deadline_s = self._default_deadline_s
        if request.ttft_slo_s is None:
            request.ttft_slo_s = self._default_ttft_slo_s
        self._seq.setdefault(request.id, len(self._seq))
        shed_id = None
        if self.max_queue > 0 and request.resume is None and \
                self.scheduler.pending >= self.max_queue:
            victim = self._shed_victim(request)
            if victim is request:
                self._record_shed(request, queued=False)
                return SubmitVerdict(request.id, "shed",
                                     retry_after_s=self._retry_after_s())
            self.scheduler.remove(victim)
            self._record_shed(victim, queued=True)
            shed_id = victim.id
        if request.resume is None:            # eviction requeues internally
            obs.instant("req.submit", track=f"req:{request.id}",
                        id=request.id, prompt_len=request.prompt_len,
                        max_new_tokens=request.max_new_tokens)
            if self.journal is not None:
                self.journal.log_submit(request)
            self.metrics.record_submit()
        self._submit_time[request.id] = time.perf_counter()
        # SLO anchor: a resume (journal replay) keeps its original window
        # where it carries one; a fresh submit, a shed retry too, starts one
        res = request.resume or {}
        if request.resume is None:
            self._slo_submit[request.id] = self._now()
        else:
            self._slo_submit.setdefault(
                request.id,
                res.get("slo_submit") if res.get("slo_submit") is not None
                else self._now())
        self.scheduler.submit(request)
        return SubmitVerdict(request.id, "ok", shed_id=shed_id)

    def poison(self, request_id: str) -> None:
        """Chaos hook: NaN-fill this request's logits row at its next
        decode step (through the step's ``poison`` row); the guard then
        quarantines the lane."""
        self._poison.add(request_id)

    @property
    def active_requests(self) -> int:
        return sum(s is not None for s in self.slots)

    @property
    def tokens_in_flight(self) -> int:
        return sum(s.request.total_tokens for s in self.slots
                   if s is not None)

    def step(self) -> None:
        """One engine tick: sweep SLOs (cancellations free capacity for
        this tick), admit what fits, grow/park paged lanes, then one
        batched decode.  The journal commits the tick's tokens at its end;
        a virtual clock advances ``step_time_s``."""
        self._slo_sweep()
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
        if self.journal is not None:
            self.journal.commit()
        if self.clock is not None:
            self.clock.advance(self.step_time_s)
        self._drain_swaps()

    def run(self, max_steps: int = 0) -> Dict[str, FinishedRequest]:
        """Drive steps until every submitted request retires."""
        while self.scheduler.pending or self.active_requests:
            if max_steps and self.step_count >= max_steps:
                raise RuntimeError(f"engine did not drain within "
                                   f"{max_steps} steps")
            self.step()
        return self.finished

    # -- SLOs / shedding / quarantine ----------------------------------------

    def _now(self) -> float:
        """The SLO clock: virtual when one was given, wall otherwise
        (distinct from the wall-clock TTFT and throughput metrics)."""
        return (self.clock.now() if self.clock is not None
                else time.perf_counter())

    def _retry_after_s(self) -> float:
        """Backoff hint for a shed request: about the engine seconds to
        drain the queue through the lanes."""
        steps = self.scheduler.pending_tokens() / max(len(self.slots), 1)
        return self.step_time_s * (steps + 1.0)

    def _shed_victim(self, incoming: Request) -> Request:
        """Cheapest to retry, newest first: fewest total tokens, ties to
        the latest submit.  Only requests with no token yet are candidates
        (a queued resume carries generated tokens), so the incoming request
        is always one."""
        cands = [incoming] + [q for q in self.scheduler.queued()
                              if q.resume is None]
        return min(cands, key=lambda r: (r.total_tokens,
                                         -self._seq.get(r.id, 0)))

    def _record_shed(self, req: Request, *, queued: bool) -> None:
        retry = self._retry_after_s()
        self.metrics.record_shed()
        self.shed_log[req.id] = retry
        self._slo_submit.pop(req.id, None)
        obs.instant("serve.shed", track=f"req:{req.id}", id=req.id,
                    queued=queued, retry_after_s=retry,
                    queue_depth=self.scheduler.pending,
                    total_tokens=req.total_tokens)
        obs.counter("serve.shed", 1)
        if queued and self.journal is not None:
            # the victim's submit is journaled: close it, so replay never
            # resurrects a request the client was told to retry
            self.journal.log_finish(req.id, "shed")

    def _quarantine_submit(self, req: Request, reason: str) -> None:
        """A request that failed the submit screen: audited, never queued,
        never on the card."""
        self.quarantined[req.id] = QuarantinedRequest(
            req.id, reason, self.step_count, req.prompt_len, 0)
        self.metrics.record_quarantine(reason)
        self._audit_quarantine(req, reason, slot=-1, generated=0)

    def _quarantine_lane(self, st: GenState, reason: str) -> None:
        """Quarantine one resident lane: no token emitted, its rows zeroed
        and its blocks released (refcounts kept, so a neighbour sharing a
        prefix block keeps it)."""
        req, slot = st.request, st.slot
        res = req.resume or {}
        self.quarantined[req.id] = QuarantinedRequest(
            req.id, reason, self.step_count,
            int(res.get("prompt_len", req.prompt_len)), len(st.generated))
        self.metrics.record_quarantine(reason)
        self._clear_lane(slot)
        self._audit_quarantine(req, reason, slot=slot,
                               generated=len(st.generated))

    def _audit_quarantine(self, req: Request, reason: str, *, slot: int,
                          generated: int) -> None:
        self._poison.discard(req.id)
        self._slo_submit.pop(req.id, None)
        sp = req.sampling
        # the instant doubles as the repro bundle in a flight dump
        obs.instant("serve.quarantine", track=f"req:{req.id}", id=req.id,
                    reason=reason, slot=slot, step=self.step_count,
                    prompt_len=req.prompt_len, generated=generated,
                    prompt_head=[int(t) for t in
                                 np.asarray(req.prompt)[:16]],
                    seed=sp.seed, temperature=sp.temperature)
        obs.counter(f"serve.quarantine.{reason}", 1)
        if self.journal is not None:
            self.journal.log_finish(req.id, f"quarantined:{reason}")
        obs.flight_maybe_dump("engine.quarantine")

    def _expiry(self, req: Request, started: bool,
                now: float) -> Optional[str]:
        """Which SLO, if any, ``req`` has missed at ``now``, measured from
        its first submit; finishing exactly at the deadline is on time."""
        t0 = self._slo_submit.get(req.id)
        if t0 is None:
            return None
        if req.deadline_s is not None and now - t0 > req.deadline_s:
            return "deadline"
        if req.ttft_slo_s is not None and not started \
                and now - t0 > req.ttft_slo_s:
            return "ttft_slo"
        return None

    def _slo_sweep(self) -> None:
        """Top of every tick: cancel expired queued and resident requests
        before admission, so what they free is grantable this tick (the
        grant pass hands it out in submit order)."""
        if not self._slo_submit:
            return
        now = self._now()

        def q_kind(req: Request) -> Optional[str]:
            started = bool((req.resume or {}).get("generated"))
            return self._expiry(req, started, now)

        for req in self.scheduler.cancel_where(
                lambda r: q_kind(r) is not None):
            self._cancel_queued(req, q_kind(req), now)
        for st in [s for s in self.slots if s is not None]:
            kind = self._expiry(st.request, bool(st.generated), now)
            if kind is not None:
                self._retire(st, kind)

    def _cancel_queued(self, req: Request, kind: str, now: float) -> None:
        """SLO-cancel a request that is not resident: drop its swap handle,
        finish it with what it generated in earlier residencies, audit the
        miss."""
        res = req.resume or {}
        if res.get("swap") in self.swap:
            self.swap.pop(res["swap"])
        gen = [int(t) for t in res.get("generated", [])]
        t0 = self._slo_submit.pop(req.id, None)
        self.metrics.record_deadline_miss(ttft=kind == "ttft_slo")
        first = res.get("first_token_time") or 0.0
        submit_t = (res.get("submitted")
                    or self._submit_time.get(req.id, time.perf_counter()))
        ttft = (first - submit_t) if first else None
        self.metrics.record_finish(ttft)
        track = f"req:{req.id}"
        obs.instant("serve.deadline_miss", track=track, id=req.id,
                    kind=kind, queued=True, generated=len(gen),
                    waited_s=now - t0 if t0 is not None else 0.0)
        obs.counter(f"serve.deadline_miss.{kind}", 1)
        obs.add_span("req.lifecycle", submit_t, time.perf_counter(),
                     track=track, id=req.id, reason=kind, tokens=len(gen),
                     ttft_s=ttft or 0.0)
        obs.instant("req.retire", track=track, id=req.id, reason=kind)
        if self.journal is not None:
            self.journal.log_finish(req.id, kind)
        self.finished[req.id] = FinishedRequest(
            id=req.id, tokens=np.asarray(gen, np.int32),
            prompt_len=int(res.get("prompt_len", req.prompt_len)),
            admitted_step=-1, finished_step=self.step_count,
            ttft_s=ttft or 0.0, reason=kind)

    # -- admission -----------------------------------------------------------

    @staticmethod
    def _prefill_prompt(req: Request) -> np.ndarray:
        """The tokens admission prefills: the original prompt, also for a
        resume (its generated tokens are re-decoded, see ``_admit``)."""
        res = req.resume or {}
        if res.get("generated"):
            return np.asarray(req.prompt)[:int(res["prompt_len"])]
        return np.asarray(req.prompt)

    def _bucketed_len(self, P: int) -> int:
        Pb = bucket_len(P, self.prefill_bucket)
        if self._ring_is_global and Pb > self.pool.cache_len:
            return P            # a prompt the bucket would overflow
        return Pb

    def _admit_blocks(self, req: Request) -> int:
        """Paged admission price: blocks covering the prefill extent, minus
        the blocks a live prefix chain already holds (a whole-prompt hit is
        free).  A swapped lane prices its saved extent."""
        res = req.resume or {}
        if self.swap_tier and res.get("swap") in self.swap:
            return self.pool.blocks_for(self.swap[res["swap"]]["pos"])
        prompt = self._prefill_prompt(req)
        need = self.pool.blocks_for(self._bucketed_len(len(prompt)))
        if self.share_prefixes:
            shared, full_hit, _ = self.pool.match_prefix(prompt)
            if full_hit:
                return 0
            need -= len(shared)
        return max(need, 0)

    def _prefill(self, tokens, true_len):
        return self.api.prefill(self.params, self.cfg, {"tokens": tokens},
                                cache_len=self.pool.cache_len,
                                force_window=self.force_window,
                                true_len=true_len)

    def _first_token(self, logits_row, sp):
        """Sample the first token from the prefill's last-token logits with
        the request's own stream (its sample 0), and screen the row as the
        decode step does.  Returns ``(token, finite)`` from one
        device-to-host copy."""
        gen = (row_generator(sp.seed, 0, self.device)
               if sp.temperature > 0 else None)
        tok = sample_vec(logits_row[None].float(),
                         temperature=[sp.temperature], top_k=[sp.top_k],
                         top_p=[sp.top_p], generators=[gen])
        ok = torch.isfinite(logits_row).all()
        tok_ok = torch.stack([tok[0].long(), ok.long()]).cpu()
        return int(tok_ok[0]), bool(tok_ok[1])

    def _admit(self, req: Request) -> None:
        """Prefill a request into a free lane and take its first token.  A
        resume (evicted, or replayed from the journal) prefills its original
        prompt and re-decodes its generated tokens through the batched step,
        fed as the step's inputs and not emitted again: the lane's cache is
        then what an uninterrupted run wrote, bit for bit, where a prefill
        of prompt + generated tokens would round differently in bf16."""
        track = f"req:{req.id}"
        t_admit = time.perf_counter()
        res = req.resume or {}
        obs.add_span("req.queued",
                     res.get("submitted")
                     or self._submit_time.get(req.id, t_admit), t_admit,
                     track=track, id=req.id)
        slot = self.pool.acquire()
        if self.swap_tier and res.get("swap") in self.swap:
            handle = self.swap.pop(res["swap"])
            try:
                self._swap_in(req, slot, handle)
            except PoolExhausted:              # pool raced below the price
                self.swap[res["swap"]] = handle
                self.pool.release(slot)
                raise
            return
        prompt = self._prefill_prompt(req)
        P = len(prompt)
        Pb = self._bucketed_len(P)
        shared: List[int] = []
        full_hit, chain_logits = False, None
        if self.paged:
            if self.share_prefixes:
                shared, full_hit, chain_logits = \
                    self.pool.match_prefix(prompt)
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
                obs.instant("pool.share_hit", track=track, id=req.id,
                            slot=slot, blocks=len(shared),
                            full_prompt=bool(full_hit),
                            bytes=len(shared) * self.pool.block_bytes)

        if full_hit and chain_logits is not None:
            # the whole prompt lives in the pool already: no prefill, no new
            # blocks — the chain's last-token logits seed the first sample
            logits_row = chain_logits
            self.metrics.record_admit(0)
        else:
            toks = np.zeros((1, Pb), np.int64)
            toks[0, :P] = prompt
            true_len = [P] if self.prefill_bucket else None
            with obs.span("req.prefill", device=True, track=track,
                          id=req.id, prompt_len=P, padded_len=Pb, slot=slot,
                          shared_blocks=len(shared),
                          resumed=req.resume is not None):
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
        if prior:                              # a resume: token 0 is known
            tok0, ok0 = prior[0], bool(torch.isfinite(logits_row).all())
        else:
            tok0, ok0 = self._first_token(logits_row, sp)
        if not ok0:
            # the prefill already went non-finite: quarantine at admission,
            # before the prompt can be indexed as a prefix donor
            self.quarantined[req.id] = QuarantinedRequest(
                req.id, "nonfinite_logits", self.step_count,
                int(res.get("prompt_len", req.prompt_len)), len(prior))
            self.metrics.record_quarantine("nonfinite_logits")
            self.pool.release(slot)
            self._audit_quarantine(req, "nonfinite_logits", slot=slot,
                                   generated=len(prior))
            return
        if not full_hit and self.share_prefixes:
            # index the prompt for future sharers
            self.pool.register_prefix(slot, prompt, logits_row)

        now = time.perf_counter()
        st = GenState(request=req, slot=slot, pos=P, generated=prior,
                      admitted_step=self.step_count, admitted_time=now,
                      forced=prior[1:])
        if prior:
            st.first_token_time = res.get("first_token_time") or now
            done = st.remaining <= 0
        else:
            done = st.remaining == 1 or tok0 == req.eos_id
            st.emit(tok0, is_last=done, now=now)
            if self.journal is not None:
                self.journal.log_token(req.id, tok0)
            obs.instant("req.first_token", track=track, id=req.id)
        if done:
            self._retire(st, "eos" if st.generated[-1] == req.eos_id
                         else "length")
            return
        self.slots[slot] = st
        self._tok[slot, 0] = tok0
        self._pos[slot] = P
        self._temp[slot] = sp.temperature
        self._topk[slot] = sp.top_k
        self._topp[slot] = sp.top_p
        self._seed[slot] = sp.seed
        self._t[slot] = 1                     # token 0 came from the prefill

    # -- paged block lifecycle ----------------------------------------------

    def _grant_pass(self) -> None:
        """Before each paged decode: every resident lane's next write slot
        must sit in a block IT OWNS.  A write block with refcount > 1 is
        copied first (CoW; no free block for the copy parks like a failed
        grant, and a copy that fails otherwise raises); a sole
        owner whose ring wrapped back over indexed prefix content drops
        the stale chains.  Lanes that cannot be granted park.  If nothing
        is runnable, the youngest parked lane leaves the pool (swapped to
        the host tier when it is on, evicted to be recomputed otherwise)
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
                            old, new = self.pool.cow(i, lb)
                        except PoolExhausted:  # no block for the copy
                            self._park(i)
                            parked.append(i)
                            continue
                        self.metrics.record_cow(self.pool.block_bytes)
                        obs.instant("pool.cow_copy",
                                    track=f"req:{st.request.id}",
                                    id=st.request.id, slot=i, src=old,
                                    dst=new, bytes=self.pool.block_bytes)
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
            # nothing runnable: snapshot the flight recorder before a lane
            # is displaced
            obs.flight_maybe_dump("engine.park_storm")
            victims.append(self._swap_out(victim) if self.swap_tier
                           else self._evict(victim))
        if victims:
            victims.sort(key=lambda r: self._seq.get(r.id, 0))
            self.scheduler.requeue_front(victims)

    def _park(self, slot: int) -> None:
        if self._pos[slot] >= 0:
            self.metrics.record_park()
            st = self.slots[slot]
            obs.instant("req.park", track=f"req:{st.request.id}",
                        id=st.request.id, slot=slot,
                        free_blocks=self.pool.free_blocks)
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
            deadline_s=req.deadline_s, ttft_slo_s=req.ttft_slo_s,
            resume={"generated": [int(t) for t in done],
                    "prompt_len": orig_prompt_len,
                    "first_token_time": res.get("first_token_time")
                    or st.first_token_time,
                    "submitted": res.get("submitted")
                    or self._submit_time.get(req.id),
                    # the SLO window keeps running across displacement
                    "slo_submit": self._slo_submit.get(req.id)})

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
        st = self.slots[slot]
        resumed = self._resume_request(st)
        self._clear_lane(slot)
        self.metrics.record_evict()
        obs.instant("req.evict", track=f"req:{st.request.id}",
                    id=st.request.id, slot=slot,
                    generated=len(st.generated))
        obs.flight_maybe_dump("engine.evict")
        return resumed

    # -- swap tier -----------------------------------------------------------

    def _swap_out(self, slot: int) -> Request:
        """Displace a parked lane without losing its cache: gather its ring
        on the device before the release (stream order keeps the snapshot
        from later writes), free the blocks, return the resumed request.
        The snapshot goes to the host in ``_drain_swaps``."""
        st = self.slots[slot]
        req = st.request
        resumed = self._resume_request(st)
        resumed.resume["swap"] = req.id
        lane = self.pool.gather_lane(slot)
        blocks = self.pool.lane_blocks(slot)
        nbytes = blocks * self.pool.block_bytes
        self.swap[req.id] = {"cache": lane, "pos": st.pos, "ready": None}
        self._swap_pending.append(req.id)
        self._clear_lane(slot)
        self.metrics.record_swap_out(nbytes)
        obs.instant("pool.swap_out", track=f"req:{req.id}", id=req.id,
                    slot=slot, blocks=blocks, bytes=nbytes,
                    generated=len(st.generated))
        return resumed

    def _drain_swaps(self) -> None:
        """After the tick's decode is queued: copy each new snapshot into
        pinned host buffers behind it on the stream and record an event
        after the copies.  Nothing is read back here; a swap-in waits on
        the event."""
        while self._swap_pending:
            handle = self.swap.get(self._swap_pending.pop())
            if handle is None or self.device.type != "cuda":
                continue                       # cancelled, or on the host
            host = {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                    for k, v in handle["cache"].items()}
            for k, v in handle["cache"].items():
                host[k].copy_(v, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record()
            handle["cache"], handle["ready"] = host, ready

    def _swap_in(self, req: Request, slot: int, handle: dict) -> None:
        """Re-admit a swapped lane: grant blocks for its saved extent,
        re-insert the snapshot (after the event that ends its host copy),
        and restore the batch rows; no prefill, no resample, and the next
        decode step continues where the lane stopped."""
        res = req.resume or {}
        track = f"req:{req.id}"
        need = self.pool.blocks_for(handle["pos"])
        self.pool.grant_tail(slot, 0, need)   # PoolExhausted: no effects
        nbytes = need * self.pool.block_bytes
        with obs.span("req.swap_in", device=True, track=track, id=req.id,
                      slot=slot, blocks=need, bytes=nbytes):
            if handle["ready"] is not None:
                handle["ready"].synchronize()
            self.pool.insert({k: v.to(self.device, non_blocking=True)
                              for k, v in handle["cache"].items()}, slot)
        prior: List[int] = list(res.get("generated", []))
        sp = req.sampling
        pos = int(handle["pos"])
        # the token fed at ``pos``; a lane swapped while it still
        # re-decoded journaled tokens keeps the rest of them forced
        k = pos - int(res["prompt_len"])
        st = GenState(request=req, slot=slot, pos=pos, generated=prior,
                      admitted_step=self.step_count,
                      admitted_time=time.perf_counter(),
                      forced=prior[k + 1:])
        st.first_token_time = res.get("first_token_time") or 0.0
        self.metrics.record_admit(0)
        self.metrics.record_swap_in(nbytes)
        obs.instant("pool.swap_in", track=track, id=req.id, slot=slot,
                    blocks=need, bytes=nbytes)
        self.slots[slot] = st
        self._tok[slot, 0] = prior[k]
        self._pos[slot] = pos
        self._temp[slot] = sp.temperature
        self._topk[slot] = sp.top_k
        self._topp[slot] = sp.top_p
        self._seed[slot] = sp.seed
        self._t[slot] = k + 1                 # the next token's sample index

    # -- decode / retire -----------------------------------------------------

    def _decode(self) -> None:
        active = [i for i, s in enumerate(self.slots)
                  if s is not None and self._pos[i] >= 0]
        if not active:
            return
        dev = self.device
        # chaos NaN injector: the poison row is always in the batch (all
        # False when disarmed)
        for i, s in enumerate(self.slots):
            self._poison_row[i] = (bool(self._poison) and s is not None
                                   and s.request.id in self._poison)
        gens = [row_generator(self._seed[i], self._t[i], dev)
                if i in active and self._temp[i] > 0 else None
                for i in range(len(self.slots))]
        # the per-slot rows go to the card in two copies, ints and floats
        ints = torch.as_tensor(np.stack(
            [self._tok[:, 0], self._pos, self._topk,
             self._poison_row.astype(np.int32)]), device=dev)
        floats = torch.as_tensor(np.stack([self._temp, self._topp]),
                                 device=dev)
        batch = {
            "token": ints[0][:, None],
            "pos": ints[1],
            "top_k": ints[2],
            "poison": ints[3] != 0,
            "temperature": floats[0],
            "top_p": floats[1],
            "generators": gens,
        }
        if self.paged:
            batch["block_tbl"] = torch.as_tensor(self.pool.table, device=dev)
            batch["ring_len"] = self.pool.ring_len
        t0 = time.perf_counter()
        with obs.span("engine.decode_step", device=True,
                      step=self.step_count, active=len(active)):
            tok, ok, self.pool.cache = self._step_fn(
                self.params, self.pool.cache, batch)
            # token and screen in one copy, which waits for the step
            out = torch.cat([tok, ok[:, None].to(tok.dtype)], 1).cpu()
        tok_np, ok_np = out[:, 0].numpy(), out[:, 1].numpy()
        self.metrics.record_decode_step(
            len(active), len(active), time.perf_counter() - t0,
            in_flight=self.active_requests,
            blocks_in_use=self.pool.blocks_in_use,
            fragmentation=self.pool.fragmentation)
        obs.counter_track("pool", blocks_in_use=self.pool.blocks_in_use,
                          active_lanes=len(active),
                          fragmentation=self.pool.fragmentation)
        if obs.enabled() and self.step_count % 16 == 0:
            obs.watermark("engine.decode", dev)    # devmem track, sampled
        now = time.perf_counter()
        for i in active:
            st = self.slots[i]
            if not ok_np[i]:
                # this lane's logits went non-finite (organic or injected):
                # no token, the lane quarantined alone; its cache row was
                # written, but its blocks go with the lane
                self._quarantine_lane(st, "nonfinite_logits")
                continue
            if st.forced:
                # a resume re-decoding a journaled token: the step wrote
                # its cache slot; feed the journaled token on, emit nothing
                t = st.forced.pop(0)
                st.pos += 1
                self._tok[i, 0] = t
                self._pos[i] = st.pos
                self._t[i] += 1
                continue
            t = int(tok_np[i])
            done = st.remaining == 1 or t == st.request.eos_id
            st.emit(t, is_last=done, now=now)
            if self.journal is not None:
                self.journal.log_token(st.request.id, t)
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
        req = st.request
        res = req.resume or {}
        track = f"req:{req.id}"
        slo_t0 = self._slo_submit.pop(req.id, None)
        self._poison.discard(req.id)
        if reason in ("deadline", "ttft_slo"):
            # resident cancel: partial tokens kept, lane already reclaimed
            self.metrics.record_deadline_miss(ttft=reason == "ttft_slo")
            obs.instant("serve.deadline_miss", track=track, id=req.id,
                        kind=reason, queued=False,
                        generated=len(st.generated),
                        waited_s=(self._now() - slo_t0
                                  if slo_t0 is not None else 0.0))
            obs.counter(f"serve.deadline_miss.{reason}", 1)
        first_tok = res.get("first_token_time") or st.first_token_time
        # a resume carries the original submit time: TTFT is the user's wait
        submit_t = (res.get("submitted")
                    or self._submit_time.get(req.id, st.admitted_time))
        ttft = first_tok - submit_t
        self.metrics.record_finish(ttft)
        now = time.perf_counter()
        obs.add_span("req.decode", first_tok, now, track=track, id=req.id,
                     tokens=len(st.generated))
        # exactly one lifecycle span per finished request (never on
        # eviction): a trace's count equals metrics.requests_finished
        obs.add_span("req.lifecycle", submit_t, now, track=track, id=req.id,
                     reason=reason, tokens=len(st.generated), ttft_s=ttft)
        obs.instant("req.retire", track=track, id=req.id, reason=reason)
        if self.journal is not None:
            self.journal.log_finish(req.id, reason)
        self.finished[req.id] = FinishedRequest(
            id=req.id,
            tokens=np.asarray(st.generated, np.int32),
            prompt_len=res.get("prompt_len", req.prompt_len),
            admitted_step=st.admitted_step,
            finished_step=self.step_count,
            ttft_s=ttft,
            reason=reason)
