"""Federated training — paper Algorithm 1 on its plain path.

  0. K-means clustering of the clients on local-data statistics.
  1. Per cluster and round: sampled clients run ``local_update`` (AdamW on
     the LoRA leaves over the frozen, NF4-quantized base), upload their
     adapter delta through the wire, and the cluster's server applies
     FedAdam to the weighted average of what the wire delivered.

Only LoRA adapters cross the "network"; every round's traffic is metered by
``repro_torch.core.comm`` in the wire format (``REPRO_FED_WIRE`` or
``wire=``).  On the int8 and bf16 wires each upload goes through
``repro_torch.dist.fedcomm.quantize_update`` — the fused wire-hop kernel on
the card — with the error-feedback residual carried per client between
rounds.  Client sampling (``np.random.default_rng(7)``) and local batches
(``default_rng(1000 * round + client)``) draw as the reference draws them.
Every upload is screened (``repro_torch.fault.guard``) before aggregation.

``two_phase_fit`` is the paper's pipeline (Fig. 1a): supervised
fine-tuning rounds, DPO alignment of the averaged adapters on the server,
then forecasting rounds warm-started from the aligned adapters.

Not ported yet, and refused with ``NotImplementedError``: secure
aggregation, fault plans and slow clients, round deadlines (and with them
the staleness buffer), stragglers, round-state snapshots and resume, the
fleet ledger's file, and the ``repro.obs`` spans.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import tree as tree_util
from repro_torch.configs.base import ModelConfig
from repro_torch.core import comm, dpo, fedtime
from repro_torch.core.client import local_update
from repro_torch.core.clustering import cluster_clients
from repro_torch.core.lora import (FAMILY_TARGETS, attach_lora, lora_tree,
                                   merge_lora, quantize_base,
                                   trainable_fraction)
from repro_torch.core.server import ClusterServer
from repro_torch.data.federated import client_weights
from repro_torch.dist import fedcomm
from repro_torch.fault.guard import validate_deltas
from repro_torch.optim.fedadam import fedavg


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


def federated_fit(cfg: ModelConfig, client_data, *, rounds: int = 5,
                  batch_size: int = 16, seed: int = 0,
                  phase: str = "forecast",
                  base_params: Optional[dict] = None,
                  init_adapters: Optional[dict] = None,
                  kmeans_first: Optional[int] = None,
                  wire: Optional[str] = None,
                  straggler_prob: float = 0.0,
                  secure_aggregation: bool = False,
                  slow_clients=None, fault_plan=None,
                  deadline_s: Optional[float] = None,
                  snapshot_path: Optional[str] = None,
                  resume: bool = False, fleet_out: Optional[str] = None,
                  progress: Optional[Callable[[str], None]] = None,
                  device="cuda") -> FedResult:
    """client_data: list of (x (n, L, M), y (n, T, M)) numpy arrays per
    client.

    Random draws (the base parameters when ``base_params`` is None, the
    LoRA A matrices, the first K-means centre when ``kmeans_first`` is None)
    come from one ``torch.Generator`` on ``device`` seeded with ``seed``, in
    that order.  ``init_adapters`` overrides the drawn adapters (a warm
    start, or the reference's adapters in a parity test).  Everything runs
    on ``device``; the clustering runs on the CPU."""
    refused = [name for name, on in (
        ("straggler_prob", straggler_prob > 0),
        ("secure_aggregation", secure_aggregation),
        ("slow_clients", slow_clients), ("fault_plan", fault_plan),
        ("deadline_s", deadline_s is not None),
        ("snapshot_path", snapshot_path), ("resume", resume),
        ("fleet_out", fleet_out)) if on]
    if refused:
        raise NotImplementedError(f"federated_fit options not ported yet: "
                                  f"{refused}")
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

    def loss_fn(p, batch):
        return fedtime.loss(p, cfg, batch, phase=phase)

    servers = [ClusterServer(adapters0) for _ in range(ft.num_clusters)]
    logs: List[RoundLog] = []
    rng = np.random.default_rng(7)
    wire_residuals: dict = {}     # client -> flat EF residual across rounds

    for r in range(rounds):
        for c in range(ft.num_clusters):
            members = np.where(assign == c)[0]
            if len(members) == 0:
                continue
            take = min(ft.clients_per_round, len(members))
            sel = rng.choice(members, take, replace=False)

            uploads = []                  # (client, payload, weight, loss)
            for s in sel:
                s = int(s)
                x, y = client_data[s]
                batches = _stack_batches(x, y, ft.local_steps, batch_size,
                                         seed=1000 * r + s, device=device)
                ad, loss = local_update(loss_fn, params, servers[c].adapters,
                                        batches, steps=ft.local_steps)
                payload = _tree_delta(ad, servers[c].adapters)
                if wire != "f32":
                    # the upload is the adapter DELTA through the wire
                    # (+ carried residual); the server sees what the
                    # network delivers
                    payload, wire_residuals[s] = fedcomm.quantize_update(
                        payload, wire_residuals.get(s), wire=wire)
                uploads.append((s, payload, float(weights_all[s]),
                                float(loss)))

            verdicts = validate_deltas([u[1] for u in uploads])
            applied = [u for u, (ok, _, _) in zip(uploads, verdicts) if ok]
            if applied:
                servers[c].apply_deltas(
                    [u[1] for u in applied],
                    np.asarray([u[2] for u in applied], np.float32))
            stats = comm.fedtime_round(
                params, clients_per_round=len(applied),
                num_clusters=ft.num_clusters, wire=wire)
            finite = [u[3] for u in applied if np.isfinite(u[3])]
            loss_r = float(np.mean(finite)) if finite else float("nan")
            if applied:
                logs.append(RoundLog(r, c, loss_r, stats))
            if progress:
                progress(f"round {r} cluster {c}: loss={loss_r:.4f} "
                         f"comm={stats.megabytes:.2f}MB")

    return FedResult([s.adapters for s in servers], params, logs,
                     assign, frac)


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
