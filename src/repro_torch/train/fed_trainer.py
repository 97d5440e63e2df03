"""Federated training: paper Algorithm 1, with the reference's fault
tolerance.

  0. K-means clustering of the clients on local-data statistics.
  1. Per cluster and round: sampled clients run ``local_update`` (AdamW on
     the LoRA leaves over the frozen, NF4-quantized base), upload their
     adapter delta through the wire, and the cluster's server applies
     FedAdam to the weighted average of what the wire delivered.

Only LoRA adapters cross the "network"; every round's traffic is metered by
``repro_torch.core.comm`` in the wire format (``REPRO_FED_WIRE`` or
``wire=``).  On the int8 and bf16 wires each upload goes through
``repro_torch.dist.fedcomm.quantize_update`` (the fused wire-hop kernel on
the card) with the error-feedback residual carried per client between
rounds.  Client sampling (``np.random.default_rng(7)``) and local batches
(``default_rng(1000 * round + client)``) draw as the reference draws them.

Fault tolerance, as the reference's round loop (``repro_torch.fault``):

  * ``fault_plan=`` injects deterministic faults (crash before upload,
    hang, transient failure then retry with backoff, corrupt/NaN delta,
    byzantine-scaled delta, delay) on a virtual clock, never
    ``time.sleep``; ``slow_clients={id: seconds}`` is a delay-only plan
    over the measured fit time, and ``straggler_prob`` drops sampled
    clients before they start.
  * ``deadline_s=`` closes each (round, cluster) aggregation window after
    that many virtual seconds: the server aggregates the partial cohort
    with weights renormalized over exactly the applied uploads, and a
    skipped client's EF residual carries to its next participation.
  * Late uploads wait in a ``StalenessBuffer`` and apply at the cluster's
    next window, down-weighted by ``staleness_decay**s``; at or beyond
    ``staleness_limit`` rounds they are rejected.
  * Every upload is screened (``repro_torch.fault.guard``): non-finite
    deltas reject as ``corrupt``, norm outliers (``byzantine_norm_k`` x the
    cohort median) as ``byzantine``.
  * ``secure_aggregation=True`` masks each upload against the started
    cohort, and the server re-cancels the dropped clients' pairwise masks
    (``repro_torch.core.secure_agg``): exact, bit for bit, on the int8
    secure wire (integer codes on a shared grid, masked mod 2**32 on the
    host), approximate in f32.  Late uploads cannot buffer in secure mode;
    they count as dropouts.
  * ``snapshot_path=`` writes an atomic round-state snapshot after every
    (round, cluster) window (adapters and FedAdam moments, EF residuals,
    the staleness buffer, the participation clock, the numpy RNG state, the
    virtual clock); ``resume=True`` restores it and continues bit for bit
    (a deterministic timeline: ``fault_plan.base_fit_s`` set, or no
    deadline).  Each server's state and each client's residual is a file
    of its own in ``<snapshot_path>.d/``, written in the windows that
    change it; a copy of a snapshot is its file and that directory.

Telemetry (``repro_torch.obs``, the reference's names): ``fed.round`` spans
around ``fed.client_fit`` spans on a per-cluster track and ``fed.aggregate``;
``fault.*``, ``fed.reject``, ``fed.deadline_miss``, ``fed.resume`` and
``secureagg.recover`` instants; ``fed.rejected.<reason>``,
``fed.buffered``, ``fed.retries`` and ``fed.wire_bytes`` counters; the EF
residual and adapter-delta norms as gauges and histograms; a flight dump
when a window loses most of its cohort.  The fleet ledger
(``FedResult.fleet``) records every client fit, and every exclusion with
its reason; ``fleet_out=`` (or ``REPRO_FLEET_OUT``) writes ``fleet.json``.

``two_phase_fit`` is the paper's pipeline (Fig. 1a): supervised
fine-tuning rounds, DPO alignment of the averaged adapters on the server,
then forecasting rounds warm-started from the aligned adapters.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch import tree as tree_util
from repro_torch.configs.base import ModelConfig
from repro_torch.core import comm, dpo, fedtime, secure_agg
from repro_torch.core.client import local_update
from repro_torch.core.clustering import cluster_clients
from repro_torch.core.lora import (FAMILY_TARGETS, attach_lora, lora_tree,
                                   merge_lora, quantize_base,
                                   trainable_fraction)
from repro_torch.core.server import (BufferedDelta, ClusterServer,
                                     StalenessBuffer)
from repro_torch.data.federated import client_weights
from repro_torch.dist import fedcomm
from repro_torch.fault import (Attempt, FaultPlan, VirtualClock,
                               load_round_state, save_round_state,
                               validate_deltas)
from repro_torch.optim.fedadam import fedavg
from repro_torch.train import checkpoint


@dataclasses.dataclass
class RoundLog:
    round: int
    cluster: int
    train_loss: float
    comm: comm.RoundStats


@dataclasses.dataclass
class FedResult:
    adapters_per_cluster: list
    base_params: dict
    logs: List[RoundLog]
    assignments: np.ndarray
    trainable_frac: float
    fleet: Optional[obs.FleetLedger] = None

    def total_megabytes(self) -> float:
        return sum(l.comm.megabytes for l in self.logs)

    def params_for_cluster(self, c: int) -> dict:
        return merge_lora(self.base_params, self.adapters_per_cluster[c])


def _stack_batches(x: np.ndarray, y: np.ndarray, steps: int, batch: int,
                   seed: int, device) -> dict:
    rng = np.random.default_rng(seed)
    sel = rng.integers(0, len(x), (steps, batch))
    return {"x": torch.from_numpy(x[sel]).to(device),
            "y": torch.from_numpy(y[sel]).to(device)}


def _tree_delta(new, old):
    return tree_util.map_(lambda a, g: a.float() - g.float(), new, old)


# ---------------------------------------------------------------------------
# Round-state snapshot plumbing (repro_torch.fault.snapshot)
# ---------------------------------------------------------------------------

def _parts_dir(path: str) -> str:
    """Where a snapshot at ``path`` keeps its parts."""
    return f"{path}.d"


def _write_snapshot(path, *, r, c, rounds, clock, rng, servers,
                    wire_residuals, parts, ef_dirty, ledger, logs, buffer):
    """The round state after window (r, c).  The file at ``path`` holds
    the small state and the staleness buffer, and names a file a part in
    ``_parts_dir(path)``: ``server<i>``, a cluster server's adapters and
    FedAdam moments, and ``client<k>``, a client's EF residual.  A window
    writes only the parts it changed (its cluster's server, the residuals
    of its uploads: ``ef_dirty``), so what it writes does not grow with
    the fleet or the clusters.  A new part takes a new name, and the old
    one goes only after the state that names the new one is in place: a
    crash at any instant leaves a complete snapshot.  ``parts`` maps each
    part to its file.  Returns the bytes written."""
    changed = {f"server{i}": {"adapters": s.adapters, "m": s.opt["m"],
                              "v": s.opt["v"]}
               for i, s in enumerate(servers)
               if i == c or f"server{i}" not in parts}
    changed.update({f"client{k}": {"residual": wire_residuals[k]}
                    for k in ef_dirty})
    ef_dirty.clear()
    d = _parts_dir(path)
    written = 0
    for key in sorted(changed):
        parts[key] = f"{key}.r{r}c{c}"
        written += checkpoint.save(os.path.join(d, parts[key]), changed[key])
    arrays = {"buffer": {str(i): e.delta
                         for i, e in enumerate(buffer.entries)}}
    meta = {
        "round": r, "cluster": c, "rounds_total": rounds,
        "clock": clock.now(),
        "rng": rng.bit_generator.state,
        "parts": parts,
        "server_rounds": [s.round for s in servers],
        "last_round": {str(k): v for k, v in ledger._last_round.items()},
        "records": [rec.to_dict() for rec in ledger.records],
        "logs": [[l.round, l.cluster, l.train_loss, l.comm.bytes_up,
                  l.comm.bytes_down, l.comm.messages, l.comm.time_s]
                 for l in logs],
        "buffer": [{"client": e.client, "cluster": e.cluster,
                    "origin_round": e.origin_round, "ready_at": e.ready_at,
                    "weight": e.weight, "loss": e.loss}
                   for e in buffer.entries],
    }
    written += save_round_state(path, arrays, meta)
    named = set(parts.values())
    for f in os.listdir(d):
        if f not in named:                # superseded, or a torn temp file
            os.unlink(os.path.join(d, f))
    return written


def _restore_snapshot(path, *, servers, wire_residuals, parts, ledger,
                      logs, buffer, rng, clock, device,
                      host_residuals: bool):
    meta, arrays = load_round_state(path, device)
    parts.clear()
    parts.update(meta["parts"])
    wire_residuals.clear()
    for key, name in parts.items():
        part = checkpoint.load(os.path.join(_parts_dir(path), name), device)
        if key.startswith("server"):
            s = servers[int(key.removeprefix("server"))]
            s.adapters, s.opt = part["adapters"], {"m": part["m"],
                                                   "v": part["v"]}
        else:
            v = part["residual"]
            wire_residuals[int(key.removeprefix("client"))] = (
                v.cpu().numpy() if host_residuals else v)
    for s, n in zip(servers, meta["server_rounds"]):
        s.round = int(n)
    ledger._last_round.update({int(k): int(v)
                               for k, v in meta["last_round"].items()})
    for d in meta["records"]:
        extra = d.pop("extra", None) or {}
        ledger.records.append(obs.ClientRecord(
            d["round"], d["cluster"], d["client"], wall_s=d["wall_s"],
            wire_bytes=d["wire_bytes"], ef_norm=d["ef_norm"],
            delta_norm=d["delta_norm"], staleness=d["staleness"],
            participated=d["participated"], extra=extra or None))
    for (r_, c_, loss, up, down, msgs, t) in meta["logs"]:
        logs.append(RoundLog(int(r_), int(c_), float(loss),
                             comm.RoundStats(int(up), int(down),
                                             int(msgs), float(t))))
    deltas = arrays.get("buffer", {})
    buffer.entries = [
        BufferedDelta(int(bm["client"]), int(bm["cluster"]),
                      int(bm["origin_round"]), float(bm["ready_at"]),
                      float(bm["weight"]), float(bm["loss"]),
                      deltas[str(i)])
        for i, bm in enumerate(meta["buffer"])]
    rng.bit_generator.state = meta["rng"]
    clock.advance_to(meta["clock"])
    return int(meta["round"]), int(meta["cluster"])


def federated_fit(cfg: ModelConfig, client_data, *, rounds: int = 5,
                  batch_size: int = 16, seed: int = 0,
                  phase: str = "forecast",
                  loss_fn: Optional[Callable] = None,
                  base_params: Optional[dict] = None,
                  init_adapters: Optional[dict] = None,
                  kmeans_first: Optional[int] = None,
                  straggler_prob: float = 0.0,
                  secure_aggregation: bool = False,
                  wire: Optional[str] = None,
                  slow_clients: Optional[Dict[int, float]] = None,
                  fault_plan: Optional[FaultPlan] = None,
                  deadline_s: Optional[float] = None,
                  staleness_limit: int = 2,
                  staleness_decay: float = 0.5,
                  byzantine_norm_k: float = 25.0,
                  snapshot_path: Optional[str] = None,
                  resume: bool = False,
                  fleet_out: Optional[str] = None,
                  progress: Optional[Callable[[str], None]] = None,
                  device="cuda") -> FedResult:
    """client_data: list of (x (n, L, M), y (n, T, M)) numpy arrays per
    client.

    Random draws (the base parameters when ``base_params`` is None, the
    LoRA A matrices, the first K-means centre when ``kmeans_first`` is None)
    come from one ``torch.Generator`` on ``device`` seeded with ``seed``, in
    that order; the float-domain secure masks from generators seeded from
    (``seed``, round, pair).  ``init_adapters`` overrides the drawn adapters
    (a warm start, or the reference's adapters in a parity test).
    Everything runs on ``device``; the clustering, and the secure int8
    wire's encode and masks, run on the host."""
    ft = cfg.fedtime
    wire = wire or comm.wire_format()
    gen = torch.Generator(device=device).manual_seed(seed)

    M = client_data[0][0].shape[-1]
    if base_params is None:
        base_params = fedtime.init(cfg, gen, num_channels=M, device=device)
    else:
        base_params = tree_util.map_(lambda a: a.to(device), base_params)
    targets = FAMILY_TARGETS["dense"]
    params = attach_lora(base_params, gen, rank=ft.lora_rank,
                         alpha=ft.lora_alpha, targets=targets)
    del base_params          # the quantized tree below replaces it
    if ft.qlora:
        params = quantize_base(params, qblock=ft.qlora_block,
                               targets=targets)
    if init_adapters is not None:
        params = merge_lora(params, tree_util.map_(
            lambda a: a.to(device), init_adapters))
    frac = trainable_fraction(params)
    adapters0 = lora_tree(params)

    # --- step 0: K-means clustering (paper Algorithm 1, line 3) ---
    series = [np.asarray(x).reshape(-1, x.shape[-1] * x.shape[-2])[:256]
              for x, _ in client_data]
    if kmeans_first is None:
        kmeans_first = int(torch.randint(0, len(series), (), generator=gen,
                                         device=device))
    assign, _, _ = cluster_clients(series, ft.num_clusters,
                                   first=kmeans_first)
    assign = assign.numpy()
    weights_all = client_weights(client_data)

    if loss_fn is None:
        def loss_fn(p, batch):  # noqa: F811
            return fedtime.loss(p, cfg, batch, phase=phase)

    # slow_clients: a delay-only FaultPlan on the virtual clock
    plan = fault_plan
    if plan is None and slow_clients:
        plan = FaultPlan.from_slow_clients(slow_clients)

    servers = [ClusterServer(adapters0) for _ in range(ft.num_clusters)]
    logs: List[RoundLog] = []
    rng = np.random.default_rng(7)
    clock = VirtualClock()
    buffer = StalenessBuffer(limit=staleness_limit, decay=staleness_decay)
    wire_residuals: dict = {}     # client -> flat EF residual across rounds
    parts: dict = {}              # snapshot part -> its file
    ef_dirty: set = set()         # clients whose residual is not in it yet
    ledger = obs.FleetLedger()
    secure_int = secure_aggregation and wire == "int8"
    secure_step = secure_agg.default_step()
    # one upload's bytes: the single source fedtime_round prices too, so the
    # ledger's per-cluster sums equal the logs' bytes up exactly
    client_wire_bytes = comm.wire_payload_bytes(
        comm.count_params(adapters0), wire)

    resume_after = None
    if resume:
        if not snapshot_path:
            raise ValueError("resume=True needs snapshot_path")
        resume_after = _restore_snapshot(
            snapshot_path, servers=servers, wire_residuals=wire_residuals,
            parts=parts, ledger=ledger, logs=logs, buffer=buffer, rng=rng,
            clock=clock, device=device, host_residuals=secure_int)
        obs.instant("fed.resume", cat="fault", round=resume_after[0],
                    cluster=resume_after[1], clock=clock.now())

    for r in range(rounds):
        for c in range(ft.num_clusters):
            if resume_after is not None and (r, c) <= resume_after:
                continue                     # completed before the crash
            members = np.where(assign == c)[0]
            if len(members) == 0:
                continue
            take = min(ft.clients_per_round, len(members))
            sel = rng.choice(members, take, replace=False)
            # systems heterogeneity: stragglers miss the round and are
            # excluded before they start
            if straggler_prob > 0:
                alive = sel[rng.random(len(sel)) >= straggler_prob]
                if len(alive) == 0:
                    alive = sel[:1]               # quorum of one
            else:
                alive = sel
            alive_set = {int(s) for s in alive}
            for s in sel:
                if int(s) not in alive_set:
                    ledger.record(r, c, int(s), participated=False,
                                  reason="sampled_out")

            t0 = clock.now()
            window_end = (t0 + deadline_s if deadline_s is not None
                          else math.inf)
            participants = [int(s) for s in alive]   # secure mask cohort
            w_alive = np.asarray([weights_all[s] for s in alive], np.float32)
            w_alive = w_alive / w_alive.sum()
            n_started = len(participants)
            track = f"fed:cluster{c}"
            round_span = obs.span("fed.round", track=track, round=r,
                                  cluster=c, clients=n_started,
                                  stragglers=int(take - n_started),
                                  deadline_s=deadline_s, wire=wire)
            round_span.__enter__()

            # -- client fits + wire encode (arrival on the virtual clock) --
            arrivals: List[dict] = []
            for idx, s in enumerate(alive):
                s = int(s)
                will_upload = plan.will_upload(s, r) if plan else True
                measured, ad, l_val = 0.0, None, float("nan")
                fit_t0 = time.perf_counter()
                if will_upload:
                    x, y = client_data[s]
                    batches = _stack_batches(x, y, ft.local_steps,
                                             batch_size, seed=1000 * r + s,
                                             device=device)
                    with obs.span("fed.client_fit", track=track, client=s,
                                  cluster=c, round=r, steps=ft.local_steps):
                        ad, loss = local_update(loss_fn, params,
                                                servers[c].adapters, batches,
                                                steps=ft.local_steps)
                    measured = time.perf_counter() - fit_t0
                    l_val = float(loss)
                att = (plan.attempt(s, r, measured) if plan
                       else Attempt(s, r, "ok", measured))
                for k in att.kinds:
                    obs.instant(f"fault.{k}", cat="fault", track=track,
                                client=s, round=r)
                if att.retries:
                    obs.counter("fed.retries", att.retries)
                if not att.uploads:       # crash before upload / hang
                    ledger.record(r, c, s, participated=False,
                                  reason=att.outcome)
                    continue

                delta = _tree_delta(ad, servers[c].adapters)
                ef, new_res = 0.0, None
                if secure_int:
                    # shared-grid int8 EF encode + pairwise code masks: a
                    # byzantine scale is clipped at the grid edge and NaN
                    # cannot cross an integer wire at all
                    if plan is not None:
                        delta = plan.mutate_delta(s, r, delta)
                    scale_i = n_started * float(w_alive[idx])
                    codes, new_res = secure_agg.secure_encode(
                        tree_util.ravel(delta).cpu().numpy() * scale_i,
                        wire_residuals.get(s), step=secure_step)
                    payload = secure_agg.mask_codes(
                        codes, client_id=s, participants=participants,
                        round_idx=r)
                    ef = float(np.linalg.norm(new_res))
                elif secure_aggregation:
                    # float-domain masks over the (optionally quantized)
                    # pre-scaled delta
                    scale_i = n_started * float(w_alive[idx])
                    scaled = tree_util.map_(lambda a: a * scale_i, delta)
                    if wire != "f32":
                        scaled, new_res = fedcomm.quantize_update(
                            scaled, wire_residuals.get(s), wire=wire)
                        ef = float(torch.linalg.vector_norm(new_res))
                    if plan is not None:
                        scaled = plan.mutate_delta(s, r, scaled)
                    payload = secure_agg.mask_update(
                        scaled, client_id=s, participants=participants,
                        round_idx=r, seed=seed)
                else:
                    payload = delta
                    if wire != "f32":
                        # the upload is the adapter DELTA through the wire
                        # (+ carried residual); the server sees what the
                        # network delivers
                        payload, new_res = fedcomm.quantize_update(
                            delta, wire_residuals.get(s), wire=wire)
                        ef = float(torch.linalg.vector_norm(new_res))
                    if plan is not None:
                        payload = plan.mutate_delta(s, r, payload)
                if ef and obs.enabled():
                    obs.gauge(f"fed.ef_residual_norm.client{s}", ef)
                if wire != "f32":
                    # the carried EF residual norm: the quantization error
                    # this client drags into its next round
                    obs.hist("fed.ef_residual_norm", ef)
                arrivals.append({
                    "client": s, "arrival": t0 + att.virtual_s,
                    "virtual_s": att.virtual_s, "fit_t0": fit_t0,
                    "loss": l_val, "weight": float(weights_all[s]),
                    "payload": payload, "new_res": new_res, "ef": ef,
                })

            # -- deadline partition ---------------------------------------
            ontime = [a for a in arrivals if a["arrival"] <= window_end]
            late = [a for a in arrivals if a["arrival"] > window_end]
            for a in late:
                obs.instant("fed.deadline_miss", cat="fault", track=track,
                            client=a["client"], round=r,
                            arrival=a["arrival"])
                if not secure_aggregation:
                    buffer.add(BufferedDelta(
                        a["client"], c, r, a["arrival"], a["weight"],
                        a["loss"], a["payload"]))
                    obs.counter("fed.buffered", 1)
                # in secure mode the masks bind to this round's cohort: a
                # late masked upload is useless alone, so it counts as a
                # dropout whose masks the recovery below re-cancels
                ledger.record(r, c, a["client"], participated=False,
                              reason="deadline")
            # commit EF residuals of the uploads that completed (a late
            # non-secure upload still delivered its encoded payload, so its
            # residual carries too; a crash or hang never encoded)
            for a in (ontime if secure_aggregation else arrivals):
                if a["new_res"] is not None:
                    wire_residuals[a["client"]] = a["new_res"]
                    ef_dirty.add(a["client"])

            # -- aggregate: partial cohort + drained buffer ---------------
            applied_deltas, applied_w, applied_losses = [], [], []
            n_uploads = n_metered = 0
            if secure_aggregation:
                survivors = [a["client"] for a in ontime]
                dropped = [p for p in participants if p not in survivors]
                n_uploads = len(survivors)
                if dropped and survivors:
                    obs.instant("secureagg.recover", cat="fault", round=r,
                                cluster=c, dropped=len(dropped))
                if survivors:
                    if secure_int:
                        code_sum = secure_agg.unmask_sum(
                            [a["payload"] for a in ontime], survivors,
                            participants=participants, round_idx=r)
                        total = tree_util.unravel(adapters0, torch.from_numpy(
                            secure_agg.secure_decode_sum(
                                code_sum, step=secure_step)).to(device))
                    else:
                        # the clients pre-scaled by their weights: the sum
                        total = secure_agg.aggregate_masked(
                            [a["payload"] for a in ontime],
                            weights=[a["weight"] for a in ontime])
                        if dropped:
                            rec = secure_agg.float_recovery_mask(
                                survivors, dropped, round_idx=r, like=total,
                                seed=seed)
                            total = tree_util.map_(lambda x_, m: x_ - m,
                                                   total, rec)
                    denom = float(sum(
                        n_started * w_alive[participants.index(sv)]
                        for sv in survivors))
                    # a tensor divisor: the card turns division by a Python
                    # number into a product with its reciprocal
                    avg_delta = tree_util.map_(lambda x_: x_ / torch.full(
                        (), denom, dtype=x_.dtype, device=x_.device), total)
                    finite = all(bool(torch.isfinite(l).all())
                                 for l in tree_util.leaves(avg_delta))
                    for a in ontime:
                        ledger.record(
                            r, c, a["client"], participated=finite,
                            wall_s=a["virtual_s"],
                            wire_bytes=client_wire_bytes,
                            ef_norm=a["ef"], t0=a["fit_t0"],
                            **({} if finite
                               else {"reason": "corrupt_aggregate"}))
                    if finite:
                        applied_deltas, applied_w = [avg_delta], [1.0]
                        applied_losses = [a["loss"] for a in ontime]
                        n_metered = len(survivors)
                    else:
                        # only the float-masked wire can carry NaN; the
                        # int8 secure wire rejects it structurally
                        obs.instant("fed.reject", cat="fault", round=r,
                                    cluster=c, reason="corrupt_aggregate")
                        obs.counter("fed.rejected.corrupt_aggregate", 1)
            else:
                drained, stale_rejects = buffer.drain(c, r, window_end)
                for e, staleness in stale_rejects:
                    obs.instant("fed.reject", cat="fault", track=track,
                                client=e.client, round=r, reason="stale",
                                staleness=staleness)
                    obs.counter("fed.rejected.stale", 1)
                    ledger.record(r, c, e.client, participated=False,
                                  wire_bytes=client_wire_bytes,
                                  reason="stale", staleness_rejected=True)
                # the apply path shares drain's boundary predicate, and the
                # ledgered staleness is the floored value drain decayed by
                cohort = (
                    [(a["client"], a["payload"], a["weight"], a["loss"],
                      a["virtual_s"], a["fit_t0"], a["ef"], 0)
                     for a in ontime] +
                    [(e.client, e.delta, w, e.loss, 0.0, None, 0.0,
                      buffer.staleness_of(r, e.origin_round))
                     for e, w in drained
                     if not buffer.is_stale(
                         buffer.staleness_of(r, e.origin_round))])
                n_uploads = len(cohort) + len(stale_rejects)
                verdicts = validate_deltas([p for _, p, *_ in cohort],
                                           byz_k=byzantine_norm_k)
                for (cl, payload, w, l_val, virt, ft0, ef,
                     stale), (ok, why, nrm) in zip(cohort, verdicts):
                    if ok:
                        applied_deltas.append(payload)
                        applied_w.append(w)
                        n_metered += 1
                        if math.isfinite(l_val):
                            applied_losses.append(l_val)
                        ledger.record(r, c, cl, participated=True,
                                      wall_s=virt,
                                      wire_bytes=client_wire_bytes,
                                      ef_norm=ef, delta_norm=nrm, t0=ft0,
                                      **({"buffered_staleness": stale}
                                         if stale else {}))
                    else:
                        obs.instant("fed.reject", cat="fault", track=track,
                                    client=cl, round=r, reason=why, norm=nrm)
                        obs.counter(f"fed.rejected.{why}", 1)
                        ledger.record(r, c, cl, participated=False,
                                      wall_s=virt,
                                      wire_bytes=client_wire_bytes,
                                      reason=why)

            prev_adapters = (servers[c].adapters
                             if obs.enabled() and applied_deltas else None)
            if applied_deltas:
                with obs.span("fed.aggregate", track=track, round=r,
                              cluster=c, clients=len(applied_deltas),
                              secure=secure_aggregation):
                    servers[c].apply_deltas(applied_deltas,
                                            np.asarray(applied_w,
                                                       np.float32))
            else:
                obs.instant("fed.round_empty", cat="fault", round=r,
                            cluster=c, uploads=n_uploads)
                obs.flight_maybe_dump(f"fed.round{r}.cluster{c}.empty")
            if applied_deltas and len(applied_deltas) * 2 < n_started:
                # distress: most of the cohort was lost this window
                obs.flight_maybe_dump(f"fed.round{r}.cluster{c}.partial")

            # comm is metered over the uploads AGGREGATED this window
            # (crashed or hung clients moved no bytes; rejected uploads keep
            # their bytes on their records but stay out of the sums; a late
            # upload is priced in the window that applies it)
            stats = comm.fedtime_round(
                params, clients_per_round=n_metered,
                num_clusters=ft.num_clusters, wire=wire)
            loss_r = (float(np.mean(applied_losses))
                      if applied_losses else float("nan"))
            if applied_deltas:
                logs.append(RoundLog(r, c, loss_r, stats))
            if obs.enabled() and prev_adapters is not None:
                # round-over-round movement of the aggregated adapters
                dn = float(torch.sqrt(sum(
                    torch.sum((a.float() - b.float()) ** 2)
                    for a, b in zip(tree_util.leaves(servers[c].adapters),
                                    tree_util.leaves(prev_adapters)))))
                obs.gauge(f"fed.adapter_delta_norm.cluster{c}", dn)
                obs.hist("fed.adapter_delta_norm", dn)
                obs.gauge(f"fed.round_loss.cluster{c}", loss_r)
                obs.counter("fed.wire_bytes",
                            stats.bytes_up + stats.bytes_down)
                obs.counter_track(f"fed.cluster{c}", delta_norm=dn,
                                  loss=loss_r)
            # the deadline bounds the window even when stragglers ran long;
            # without one the slowest upload sets the pace
            finite_arrivals = [a["arrival"] for a in arrivals
                               if math.isfinite(a["arrival"])]
            clock.advance_to(window_end if deadline_s is not None
                             else max(finite_arrivals, default=t0))
            round_span.__exit__(None, None, None)
            if snapshot_path:
                _write_snapshot(snapshot_path, r=r, c=c, rounds=rounds,
                                clock=clock, rng=rng, servers=servers,
                                wire_residuals=wire_residuals,
                                parts=parts, ef_dirty=ef_dirty,
                                ledger=ledger, logs=logs, buffer=buffer)
            if progress:
                progress(f"round {r} cluster {c}: loss={loss_r:.4f} "
                         f"comm={stats.megabytes:.2f}MB")
        if obs.enabled():
            # device-memory watermark at the round boundary
            obs.watermark(f"fed.round{r}")

    ledger.to_trace()
    fleet_out = fleet_out or os.environ.get("REPRO_FLEET_OUT")
    if fleet_out:
        ledger.dump(fleet_out)
    return FedResult([s.adapters for s in servers], params, logs,
                     assign, frac, fleet=ledger)


# ---------------------------------------------------------------------------
# Two-phase pipeline with DPO alignment (paper Fig. 1a)
# ---------------------------------------------------------------------------

def two_phase_fit(cfg: ModelConfig, client_data, *, rounds_sft: int = 2,
                  rounds_forecast: int = 3, dpo_steps: int = 20,
                  batch_size: int = 16, seed: int = 0,
                  wire: Optional[str] = None,
                  base_params: Optional[dict] = None,
                  init_adapters: Optional[dict] = None,
                  kmeans_first: Optional[Sequence[Optional[int]]] = None,
                  pairs: Optional[dict] = None,
                  progress: Optional[Callable[[str], None]] = None,
                  device="cuda") -> FedResult:
    """SFT (instance norm) -> DPO alignment -> forecasting (RevIN).

    The SFT rounds draw from ``seed``, the forecasting rounds from
    ``seed + 1`` and the preference pairs from ``seed + 2``.  Each draw
    can be handed in instead: ``base_params`` and ``init_adapters`` (the
    SFT fit's), ``kmeans_first`` (the first K-means centre of each phase,
    a pair) and ``pairs`` ({"x", "y_w", "y_l"}, arrays or tensors).  The
    returned result is the forecasting fit's, its logs preceded by the SFT
    fit's."""
    first_sft, first_fc = (tuple(kmeans_first) if kmeans_first is not None
                           else (None, None))
    fit = dict(batch_size=batch_size, wire=wire, progress=progress,
               device=device)

    # phase 1: supervised fine-tuning
    res_sft = federated_fit(cfg, client_data, rounds=rounds_sft, seed=seed,
                            phase="sft", base_params=base_params,
                            init_adapters=init_adapters,
                            kmeans_first=first_sft, **fit)

    # the cluster adapters averaged for the server-side DPO stage
    global_ad = fedavg(res_sft.adapters_per_cluster,
                       np.ones(len(res_sft.adapters_per_cluster)))
    params = merge_lora(res_sft.base_params, global_ad)

    # phase 1.5: DPO alignment on synthetic preference pairs
    ref_params = params
    if pairs is None:
        x_all = np.concatenate([x[:8] for x, _ in client_data])[:batch_size]
        y_all = np.concatenate([y[:8] for _, y in client_data])[:batch_size]
        gen = torch.Generator(device=device).manual_seed(seed + 2)
        pairs = dpo.make_preference_pairs(
            gen, torch.from_numpy(x_all).to(device),
            torch.from_numpy(y_all).to(device))
    pairs = {k: (v if torch.is_tensor(v) else torch.from_numpy(np.array(v))
                 ).to(device)[None]            # one batch, every step
             for k, v in pairs.items()}

    def dpo_loss_fn(p, batch):
        return dpo.dpo_loss(p, ref_params, cfg, batch,
                            beta=cfg.fedtime.dpo_beta)

    aligned_ad, dpo_l = local_update(dpo_loss_fn, params, global_ad, pairs,
                                     steps=dpo_steps, lr=1e-4)
    if progress:
        progress(f"DPO alignment loss={float(dpo_l):.4f}")
    params = merge_lora(params, aligned_ad)

    # phase 2: forecasting fine-tuning (RevIN), warm-started from the
    # SFT + DPO adapters on the SFT fit's base
    res = federated_fit(cfg, client_data, rounds=rounds_forecast,
                        seed=seed + 1, phase="forecast",
                        base_params=res_sft.base_params,
                        init_adapters=lora_tree(params),
                        kmeans_first=first_fc, **fit)
    res.logs = res_sft.logs + res.logs
    return res
