"""``repro_torch.fault``: deterministic fault injection and recovery.

  * :mod:`~repro_torch.fault.clock`: a virtual clock.  Fit durations,
    retry backoffs, round deadlines and serving SLOs are virtual seconds,
    so a chaos run covering hours of simulated time runs in seconds.
  * :mod:`~repro_torch.fault.plan`: :class:`FaultPlan` / :class:`Fault`,
    a declarative per-client fault schedule (crash before upload, hang,
    transient failure with exponential backoff, corrupt/NaN delta,
    byzantine-scaled delta, plain delay), and :class:`ServingFaultPlan`,
    its per-request counterpart for serving.
  * :mod:`~repro_torch.fault.guard`: server-side delta screens (non-finite
    and norm-outlier uploads are rejected before aggregation) and the
    serve step's per-lane logits screen.
  * :mod:`~repro_torch.fault.snapshot`: atomic round-state snapshots
    through :mod:`repro_torch.train.checkpoint`, so a killed fit resumes
    the same round bit for bit.

``train/fed_trainer.federated_fit(fault_plan=..., deadline_s=...,
snapshot_path=...)`` threads them together.
"""

from repro_torch.fault.clock import VirtualClock
from repro_torch.fault.guard import delta_norm, logits_finite, validate_deltas
from repro_torch.fault.plan import (FAULT_KINDS, SERVE_FAULT_KINDS, Attempt,
                                    Fault, FaultPlan, ServingFaultPlan)
from repro_torch.fault.snapshot import (SNAPSHOT_SCHEMA, load_round_state,
                                        save_round_state)

__all__ = [
    "Attempt", "FAULT_KINDS", "Fault", "FaultPlan", "SERVE_FAULT_KINDS",
    "SNAPSHOT_SCHEMA", "ServingFaultPlan", "VirtualClock", "delta_norm",
    "load_round_state", "logits_finite", "save_round_state",
    "validate_deltas",
]
