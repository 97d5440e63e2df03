"""Per-client federated round ledger with straggler detection.

``fed_trainer`` emits one compact :class:`ClientRecord` per client fit
(client id, cluster id, fit seconds on the virtual clock, wire bytes,
EF-residual norm, adapter-delta norm, round staleness = rounds since the
client last participated); excluded clients are recorded with
``participated=False`` and a ``reason``.

  * Cluster-level roll-ups go through mergeable
    :class:`~repro_torch.obs.sketch.QuantileSketch` objects, so the
    per-cluster to fleet reduction is associative.
  * Straggler flagging is two-rule: **p99-relative** (a fit at or above the
    cluster's p99 that is also >= ``p99_rel`` x the cluster median) and
    **MAD-based** (more than ``mad_k`` median absolute deviations above the
    cluster median).  Either rule flags; the reason string says which.
  * Export: ``to_trace()`` lays every fit out as per-cluster Perfetto
    tracks (``fleet:cluster{c}``) on the live tracer; ``dump()`` writes a
    standalone ``fleet.json`` (schema ``repro.fleet/v1``, key for key the
    reference's) whose per-cluster summed wire bytes equal the bytes up of
    ``comm.fedtime_round`` exactly.

``extra`` metrics ride along on each record (the fit's ``reason``,
``buffered_staleness``, ``staleness_rejected``).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.obs.sketch import QuantileSketch, merge_all

__all__ = ["ClientRecord", "FleetLedger"]

SCHEMA = "repro.fleet/v1"


@dataclass
class ClientRecord:
    """One client's participation in one federated round (compact: this is
    emitted once per client fit, potentially millions of times)."""

    round: int
    cluster: int
    client: int
    wall_s: float = 0.0
    wire_bytes: int = 0
    ef_norm: float = 0.0
    delta_norm: float = 0.0
    staleness: int = 0
    participated: bool = True
    t0: Optional[float] = None        # perf_counter at fit start (for trace)
    extra: Optional[dict] = None

    def to_dict(self) -> dict:
        d = {
            "round": self.round,
            "cluster": self.cluster,
            "client": self.client,
            "wall_s": self.wall_s,
            "wire_bytes": self.wire_bytes,
            "ef_norm": self.ef_norm,
            "delta_norm": self.delta_norm,
            "staleness": self.staleness,
            "participated": self.participated,
        }
        if self.extra:
            d["extra"] = self.extra
        return d


@dataclass
class FleetLedger:
    """Append-only ledger of :class:`ClientRecord` with sketch roll-ups and
    straggler flagging; see module docstring."""

    rel_acc: float = 0.01
    records: List[ClientRecord] = field(default_factory=list)
    _last_round: Dict[int, int] = field(default_factory=dict)

    def record(self, round: int, cluster: int, client: int, *,
               wall_s: float = 0.0, wire_bytes: int = 0,
               ef_norm: float = 0.0, delta_norm: float = 0.0,
               participated: bool = True, t0: Optional[float] = None,
               **extra) -> ClientRecord:
        """Append one record.  Staleness is derived here: rounds elapsed
        since this client last *participated* (0 on first sighting), and
        the participation clock only advances for participating fits —
        an excluded straggler keeps aging."""
        prev = self._last_round.get(client)
        staleness = 0 if prev is None else max(round - prev, 0)
        if participated:
            self._last_round[client] = round
        rec = ClientRecord(round, cluster, client, wall_s=wall_s,
                           wire_bytes=wire_bytes, ef_norm=ef_norm,
                           delta_norm=delta_norm, staleness=staleness,
                           participated=participated, t0=t0,
                           extra=extra or None)
        self.records.append(rec)
        return rec

    def __len__(self) -> int:
        return len(self.records)

    # -- aggregation ---------------------------------------------------------

    @property
    def clusters(self) -> List[int]:
        return sorted({r.cluster for r in self.records})

    def _values(self, cluster: Optional[int], name: str) -> List[float]:
        return [float(getattr(r, name)) for r in self.records
                if r.participated
                and (cluster is None or r.cluster == cluster)]

    def cluster_sketch(self, cluster: int, name: str = "wall_s"
                       ) -> QuantileSketch:
        """Quantile sketch of one field over one cluster's participating
        fits (the unit the fleet roll-up merges)."""
        s = QuantileSketch(rel_acc=self.rel_acc)
        s.add_many(self._values(cluster, name))
        return s

    def fleet_sketch(self, name: str = "wall_s") -> QuantileSketch:
        """Fleet-wide sketch = merge of the per-cluster sketches — the
        associativity of :meth:`QuantileSketch.merge` is what makes this
        equal a sketch of the concatenated stream."""
        cs = [self.cluster_sketch(c, name) for c in self.clusters]
        if not cs:
            return QuantileSketch(rel_acc=self.rel_acc)
        return merge_all(cs)

    def wire_bytes_by_cluster(self, round: Optional[int] = None
                              ) -> Dict[int, int]:
        """Summed uploaded wire bytes per cluster (optionally one round).
        This is the number tests pin against ``comm.fedtime_round``."""
        out: Dict[int, int] = {}
        for r in self.records:
            if not r.participated or (round is not None and r.round != round):
                continue
            out[r.cluster] = out.get(r.cluster, 0) + r.wire_bytes
        return out

    def total_wire_bytes(self) -> int:
        return sum(self.wire_bytes_by_cluster().values())

    # -- straggler / outlier flagging ---------------------------------------

    def stragglers(self, name: str = "wall_s", *, p99_rel: float = 2.0,
                   mad_k: float = 5.0) -> List[Tuple[ClientRecord, str]]:
        """Flag outlier fits per cluster.  Two rules, either fires:

        * ``p99``: value ≥ cluster p99 **and** ≥ ``p99_rel`` × cluster
          median (the second clause stops homogeneous clusters from
          flagging their own fastest tail).
        * ``mad``: value > median + ``mad_k`` × MAD (median absolute
          deviation — robust: the stragglers being flagged cannot inflate
          the scale estimate the way they would a stddev).

        Returns ``(record, reason)`` pairs; reason is ``"p99"``, ``"mad"``
        or ``"p99+mad"``."""
        flagged: List[Tuple[ClientRecord, str]] = []
        for c in self.clusters:
            vals = sorted(self._values(c, name))
            if len(vals) < 4:    # too few fits to call anything an outlier
                continue
            mid = vals[len(vals) // 2]
            mad = sorted(abs(v - mid) for v in vals)[len(vals) // 2]
            p99 = self.cluster_sketch(c, name).quantile(99)
            for r in self.records:
                if r.cluster != c or not r.participated:
                    continue
                v = float(getattr(r, name))
                reasons = []
                if v >= p99 and mid > 0 and v >= p99_rel * mid:
                    reasons.append("p99")
                if mad > 0 and v > mid + mad_k * mad:
                    reasons.append("mad")
                if reasons:
                    flagged.append((r, "+".join(reasons)))
        return flagged

    # -- export --------------------------------------------------------------

    def rejections_by_reason(self, cluster: Optional[int] = None
                             ) -> Dict[str, int]:
        """Histogram of exclusion reasons (``reason=`` extra on
        non-participating records: crash/hang/deadline/corrupt/byzantine/
        stale/...) — the audit trail of the fault-tolerant round loop."""
        out: Dict[str, int] = {}
        for r in self.records:
            if r.participated or (cluster is not None
                                  and r.cluster != cluster):
                continue
            why = (r.extra or {}).get("reason", "unknown")
            out[why] = out.get(why, 0) + 1
        return out

    def to_json(self) -> dict:
        per_cluster = {}
        for c in self.clusters:
            per_cluster[str(c)] = {
                "clients": len({r.client for r in self.records
                                if r.cluster == c}),
                "fits": sum(1 for r in self.records
                            if r.cluster == c and r.participated),
                "skipped": sum(1 for r in self.records
                               if r.cluster == c and not r.participated),
                "rejections": self.rejections_by_reason(c),
                "wire_bytes": self.wire_bytes_by_cluster().get(c, 0),
                "wall_s": self.cluster_sketch(c, "wall_s").summary(),
                "staleness": self.cluster_sketch(c, "staleness").summary(),
                "wall_s_sketch": self.cluster_sketch(c, "wall_s").to_dict(),
            }
        return {
            "schema": SCHEMA,
            "records": [r.to_dict() for r in self.records],
            "clusters": per_cluster,
            "fleet": {
                "wire_bytes": self.total_wire_bytes(),
                "wall_s": self.fleet_sketch("wall_s").summary(),
                "stragglers": [
                    {"round": r.round, "cluster": r.cluster,
                     "client": r.client, "wall_s": r.wall_s,
                     "reason": why}
                    for r, why in self.stragglers()
                ],
            },
        }

    def dump(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1)
        return path

    def to_trace(self) -> None:
        """Lay every recorded fit out on the live tracer as per-cluster
        Perfetto tracks (``fleet:cluster{c}``) — no-op when both the tracer
        and the flight recorder are off.  Skipped (non-participating) fits
        become instants so exclusion is visible on the timeline."""
        from repro_torch import obs
        flagged = {id(r): why for r, why in self.stragglers()}
        for r in self.records:
            track = f"fleet:cluster{r.cluster}"
            if not r.participated:
                obs.instant(f"client{r.client}.skipped", cat="fleet",
                            track=track, round=r.round,
                            staleness=r.staleness,
                            reason=(r.extra or {}).get("reason"))
                continue
            if r.t0 is None:
                continue
            args = {"round": r.round, "wire_bytes": r.wire_bytes,
                    "staleness": r.staleness, "ef_norm": r.ef_norm,
                    "delta_norm": r.delta_norm}
            why = flagged.get(id(r))
            if why:
                args["straggler"] = why
            obs.add_span(f"client{r.client}.fit", r.t0, r.t0 + r.wall_s,
                         cat="fleet", track=track, **args)
