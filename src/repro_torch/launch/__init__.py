"""Launchers and step functions (the reference's ``src/repro/launch/``).

``repro_torch.launch.mesh`` -- meshes of ranks on ``torch.distributed``
and ``spawn_local``, a world of local processes.

``repro_torch.launch.steps`` -- ``make_train_step``,
``make_fed_train_step``, ``make_prefill_step``, ``make_serve_step`` and
``decode_force_window``; under a mesh each rank runs them on its own rows
(and cache stripe).

``repro_torch.launch.serve`` -- the serving launcher: the fixed batch and
the continuous-batching engine, with their request traces.

``repro_torch.launch.train`` -- the training launcher: full fine-tuning or
the federated LoRA step on Markov tokens, on one rank or a mesh of ranks.

``repro_torch.launch.dryrun`` -- the dry run: rank 0's step of a fake
256- or 512-rank world on fake tensors (``specs.dryrun_args``), counted
by the step cost model (``obs.cost.CostCounter``: FLOPs, bytes,
collectives, live memory) into ``experiments/dryrun_torch/``.
"""
