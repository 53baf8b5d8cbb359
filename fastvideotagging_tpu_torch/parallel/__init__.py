"""Parallelism across processes (the counterpart of
``fastvideotagging_tpu/parallel/``): the job's process layout, its data and
model groups (``mesh``), the channel-sharded conv's collectives
(``channel``) and the time-sharded halo conv (``temporal``)."""

from fastvideotagging_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    init_multihost,
    local_batch_rows,
    make_mesh,
    param_partition_specs,
    shard_batch,
    shard_train_state,
)
