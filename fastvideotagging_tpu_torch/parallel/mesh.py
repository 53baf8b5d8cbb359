"""The process layout of a data-parallel job (the counterpart of
``fastvideotagging_tpu/parallel/mesh.py``).

The JAX package declares a device mesh and lets XLA place the collectives.
Here a job is one process per card, joined by ``torch.distributed``: a
``Mesh`` is the world size, this process's rank and device, and the data
group, the process group that gradients and BatchNorm statistics are summed
over. Each rank owns a contiguous block of every global batch's rows (the
reference's row mapping: shard r of a batch sharded over the data axis).

Backends: NCCL when the ranks' device is CUDA, gloo on the CPU, unless the
caller names one. NCCL takes one rank per card; two ranks that share one
card run over gloo, whose all-reduce, broadcast and all-gather take CUDA
tensors (point-to-point does not: parallel/temporal.py stages its halos
through the host on such a group).

Channel sharding (``model_parallel > 1``) is not ported: ROADMAP.md Queue A
item 7.
"""

from __future__ import annotations

import dataclasses
import datetime

import torch
import torch.distributed as dist

from fastvideotagging_tpu_torch._device import resolve_device

_NO_CHANNEL_SHARDING = (
    "model_parallel > 1 (SlowFast's channel sharding, param_partition_specs, the "
    "channel-sharded checkpoint) is not ported yet (ROADMAP.md Queue A item 7)")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One process's view of a data-parallel job.

    ``group`` is the data group (every rank of the job), or None for a
    single process that joined no job: collectives are then skipped, and a
    step on this mesh is the single-process step."""

    world: int
    rank: int
    device: torch.device
    group: dist.ProcessGroup | None = None

    @property
    def is_main(self) -> bool:
        """Rank 0: the process that logs and writes checkpoints."""
        return self.rank == 0


def rank_device(device: str | torch.device = "cuda", rank: int | None = None) -> torch.device:
    """The device of ``rank`` (this process's rank by default): ``cuda:(rank %
    device_count)`` for the card, which is the default; raises without a
    card unless ``device='cpu'``."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    if rank is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
    return torch.device("cuda", rank % torch.cuda.device_count())


def init_multihost(coordinator_address: str, num_processes: int, process_id: int,
                   backend: str | None = None, device: str | torch.device = "cuda",
                   timeout: float | None = None) -> str:
    """Join the job: ``init_process_group`` over ``tcp://coordinator_address``
    (``HOST:PORT``, rank 0's host) with ``num_processes`` ranks, this one
    ``process_id``. The backend is NCCL when the rank's device is CUDA and
    gloo on the CPU unless ``backend`` names one; ``timeout`` (seconds)
    bounds every collective. Returns the backend."""
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id={process_id} must be in [0, {num_processes})")
    dev = rank_device(device, process_id)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the NCCL backend needs the ranks on CUDA devices")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = {} if timeout is None else {"timeout": datetime.timedelta(seconds=timeout)}
    if backend == "nccl":
        kw["device_id"] = dev
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id, **kw)
    return backend


def make_mesh(data_parallel: int = -1, model_parallel: int = 1,
              device: str | torch.device = "cuda") -> Mesh:
    """The mesh of this process. ``data_parallel = -1`` means the world size
    (1 outside a job); any other value must equal it, since each rank owns
    one card and one shard. ``device``: the card by default (this rank's,
    ``rank_device``); raises without one unless ``'cpu'``. In a job the data
    group is the whole world, also at world size 1."""
    if model_parallel > 1:
        raise NotImplementedError(_NO_CHANNEL_SHARDING)
    if model_parallel < 1:
        raise ValueError(f"model_parallel={model_parallel} must be >= 1")
    joined = dist.is_initialized()
    world = dist.get_world_size() if joined else 1
    rank = dist.get_rank() if joined else 0
    if data_parallel == -1:
        data_parallel = world
    if data_parallel != world:
        raise ValueError(
            f"data_parallel={data_parallel} must equal the {world} process(es) of the "
            f"job (one card and one shard a process; -1 takes them all)")
    return Mesh(world=world, rank=rank, device=rank_device(device, rank),
                group=dist.group.WORLD if joined else None)


def check_mesh(mesh) -> Mesh | None:
    """``mesh`` if it is a ``Mesh`` or None; raises otherwise."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.Mesh (make_mesh), got {type(mesh).__name__}")
    return mesh


def local_batch_rows(mesh: Mesh, batch_size: int) -> list[int]:
    """The global batch rows this rank owns: the contiguous block ``[r * b /
    n, (r + 1) * b / n)``. Raises unless the world divides the batch."""
    if batch_size % mesh.world:
        raise ValueError(
            f"batch_size={batch_size} must be divisible by the data-parallel degree "
            f"{mesh.world}")
    per = batch_size // mesh.world
    return list(range(mesh.rank * per, (mesh.rank + 1) * per))


def shard_batch(mesh: Mesh, batch: dict) -> dict:
    """This rank's rows of a global host batch, on its device."""
    rows = local_batch_rows(mesh, len(next(iter(batch.values()))))
    lo, hi = rows[0], rows[-1] + 1
    return {k: torch.as_tensor(v)[lo:hi].to(mesh.device) for k, v in batch.items()}


def shard_train_state(state, mesh: Mesh):
    """Give every rank rank 0's weights and BatchNorm statistics (a broadcast
    of the model's state_dict over the data group); returns ``state``."""
    if mesh.group is not None:
        with torch.no_grad():
            for t in state.model.state_dict().values():
                dist.broadcast(t, src=0, group=mesh.group)
    return state


def all_reduce_mean_(tensors: list[torch.Tensor], mesh: Mesh) -> None:
    """Replace each tensor by its mean over the data group, in place: one
    all-reduce (a sum) a tensor, then a division by the world size."""
    for t in tensors:
        dist.all_reduce(t, group=mesh.group)
        t.div_(mesh.world)


def any_rank(flag: bool, mesh: Mesh) -> bool:
    """Whether ``flag`` is set on any rank (an all-reduce with MAX): the
    collective stop decision. Without a group, ``flag`` itself."""
    if mesh.group is None:
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int32, device=mesh.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group)
    return bool(t.item())


def barrier(mesh: Mesh | None) -> None:
    """Wait for every rank of the data group (nothing without one)."""
    if mesh is not None and mesh.group is not None:
        if dist.get_backend(mesh.group) == "nccl":
            dist.barrier(group=mesh.group, device_ids=[mesh.device.index])
        else:
            dist.barrier(group=mesh.group)
