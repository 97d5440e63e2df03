"""Distribution layer: partition rules, the reference's collectives over
``torch.distributed``, and the federated and decode paths that run on them.

``repro_torch.dist.collectives`` -- ``axis_index``, ``ppermute``, ``psum``,
``pmax`` and ``all_gather`` over the named axes of a ``DeviceMesh``
(``repro_torch.launch.mesh``), one process a rank.

``repro_torch.dist.sharding`` -- partition-spec tables for params
(Megatron-style tensor parallelism over ``model``) and optimizer state
(ZeRO-1 widening over ``data``/``pod``).

``repro_torch.dist.fed`` -- FedTime's Algorithm 1 aggregation mapped onto
mesh axes: cluster aggregation reduces over ``data``, cross-site
aggregation crosses ``pod``.

``repro_torch.dist.fedcomm`` -- the communication those axes run on: the
bidirectional ring all-reduce (``repro_torch.kernels.ring_allreduce``) on
the ``REPRO_FED_WIRE`` wire with carried error-feedback residuals, plus the
host-loop wire emulation used by ``train/fed_trainer``.

``repro_torch.dist.decode`` -- the decode step for seq-sharded caches:
each rank's flash-decode (m, l, acc) partials combined with a pmax/psum
over ``model``.
"""
