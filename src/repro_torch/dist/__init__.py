"""Distribution layer: partition rules, the reference's collectives over
``torch.distributed``, and the federated and decode paths that run on them.

``repro_torch.dist.collectives`` -- ``axis_index``, ``ppermute``, ``psum``,
``pmax`` and ``all_gather`` over the named axes of a ``DeviceMesh``
(``repro_torch.launch.mesh``), one process a rank.

``repro_torch.dist.sharding`` -- partition-spec tables for params
(Megatron-style tensor parallelism over ``model``), optimizer state
(ZeRO-1 widening over ``data``/``pod``), KV caches (``cache_specs``) and
input batches (``data_specs``), and ``local_shard``, which takes a rank's
own piece of a tree: the port's placement on a mesh.

``repro_torch.dist.fed`` -- FedTime's Algorithm 1 aggregation mapped onto
mesh axes: cluster aggregation reduces over ``data``, cross-site
aggregation crosses ``pod``.

``repro_torch.dist.fedcomm`` -- the communication those axes run on: the
bidirectional ring all-reduce (``repro_torch.kernels.ring_allreduce``) on
the ``REPRO_FED_WIRE`` wire with carried error-feedback residuals, plus the
host-loop wire emulation used by ``train/fed_trainer``.

``repro_torch.dist.decode`` -- the decode step for seq-sharded caches:
each rank's flash-decode (m, l, acc) partials over its own stripe combined
with a pmax/psum over ``model`` (``stripe_flash_decode``, which the
attention layer's decode step calls under a mesh).
"""
