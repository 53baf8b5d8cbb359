"""The process layout of a job (the counterpart of
``fastvideotagging_tpu/parallel/mesh.py``).

The JAX package declares a (data, model) device mesh and lets XLA place the
collectives. Here a job is one process per card, joined by
``torch.distributed``, laid out as the reference lays its devices: a grid of
``data_parallel`` rows by ``model_parallel`` columns, row-major, so rank
``r = d * mp + m`` has data index ``d`` and model index ``m``. A ``Mesh`` is
this process's view of it: the world size, its rank and device, the grid,
the data group (the ranks with its model index, over which gradients,
BatchNorm statistics and metrics are averaged) and the model group (the
``mp`` consecutive ranks with its data index, over which SlowFast's convs
are channel-sharded, parallel/channel.py). Each data index owns a
contiguous block of every global batch's rows (the reference's row mapping:
shard d of a batch sharded over the data axis); the ranks of a model group
hold the same rows.

Backends: NCCL when the ranks' device is CUDA, gloo on the CPU, unless the
caller names one. NCCL takes one rank per card; two ranks that share one
card run over gloo, whose all-reduce, broadcast and all-gather take CUDA
tensors (point-to-point does not: parallel/temporal.py stages its halos
through the host on such a group).

With ``model_parallel > 1`` each rank of a model group keeps its
``Cout / mp`` columns of every sharded conv kernel (``param_partition_specs``
names them; the model's convs carry their model group); ``full_state_dict``
gathers them back and ``local_parts`` slices whole tensors for a rank, so
that checkpoints and pretrained weights hold whole tensors at any degree.
"""

from __future__ import annotations

import dataclasses
import datetime

import torch
import torch.distributed as dist

from fastvideotagging_tpu_torch._device import resolve_device
from fastvideotagging_tpu_torch.parallel.channel import gather_along, shard_of


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One process's view of a job.

    ``group`` is the data group (every rank of the job when
    ``model_parallel`` is 1), or None for a single process that joined no
    job: collectives are then skipped, and a step on this mesh is the
    single-process step. ``model_group`` is the model group, None when
    ``model_parallel`` is 1."""

    world: int
    rank: int
    device: torch.device
    group: dist.ProcessGroup | None = None
    model_parallel: int = 1
    model_group: dist.ProcessGroup | None = None

    @property
    def data_parallel(self) -> int:
        """The data-parallel degree: the size of the data group."""
        return self.world // self.model_parallel

    @property
    def data_index(self) -> int:
        """This rank's row of the grid: its block of every batch's rows."""
        return self.rank // self.model_parallel

    @property
    def model_index(self) -> int:
        """This rank's column of the grid: its part of every sharded kernel."""
        return self.rank % self.model_parallel

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
    """The mesh of this process, with the reference's checks:
    ``model_parallel`` must divide the world size (1 outside a job; so one
    process with ``model_parallel = 2`` raises ``ValueError``), and
    ``data_parallel = -1`` means ``world // model_parallel``; any other
    value must make ``data_parallel * model_parallel`` the world, since
    each rank owns one card. ``device``: the card by default (this rank's,
    ``rank_device``); raises without one unless ``'cpu'``. In a job with
    ``model_parallel = 1`` the data group is the whole world, also at world
    size 1; with more, every rank makes every data and model group (each
    ``new_group`` is collective), in the same order."""
    joined = dist.is_initialized()
    world = dist.get_world_size() if joined else 1
    rank = dist.get_rank() if joined else 0
    if model_parallel < 1 or world % model_parallel:
        raise ValueError(f"model_parallel={model_parallel} must divide {world} process(es)")
    if data_parallel == -1:
        data_parallel = world // model_parallel
    if data_parallel * model_parallel != world:
        per = "" if model_parallel == 1 else f" over model_parallel={model_parallel}"
        raise ValueError(
            f"data_parallel={data_parallel} must equal the {world} process(es) of the job"
            f"{per} (one card a process; -1 takes them all)")
    dev = rank_device(device, rank)
    if not joined:
        return Mesh(world=1, rank=0, device=dev)
    if model_parallel == 1:
        return Mesh(world=world, rank=rank, device=dev, group=dist.group.WORLD)
    mp, dp = model_parallel, data_parallel
    data_groups = [dist.new_group([d * mp + m for d in range(dp)]) for m in range(mp)]
    model_groups = [dist.new_group([d * mp + m for m in range(mp)]) for d in range(dp)]
    return Mesh(world=world, rank=rank, device=dev, group=data_groups[rank % mp],
                model_parallel=mp, model_group=model_groups[rank // mp])


def check_mesh(mesh) -> Mesh | None:
    """``mesh`` if it is a ``Mesh`` or None; raises otherwise."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.Mesh (make_mesh), got {type(mesh).__name__}")
    return mesh


def local_batch_rows(mesh: Mesh, batch_size: int) -> list[int]:
    """The global batch rows this rank owns: the contiguous block ``[d * b /
    n, (d + 1) * b / n)`` of its data index ``d`` of ``n``. Raises unless
    the data-parallel degree divides the batch."""
    n = mesh.data_parallel
    if batch_size % n:
        raise ValueError(
            f"batch_size={batch_size} must be divisible by the data-parallel degree {n}")
    per = batch_size // n
    return list(range(mesh.data_index * per, (mesh.data_index + 1) * per))


def shard_batch(mesh: Mesh, batch: dict) -> dict:
    """This rank's rows of a global host batch, on its device."""
    rows = local_batch_rows(mesh, len(next(iter(batch.values()))))
    lo, hi = rows[0], rows[-1] + 1
    return {k: torch.as_tensor(v)[lo:hi].to(mesh.device) for k, v in batch.items()}


def sharded_params(model: torch.nn.Module) -> dict[str, tuple[int, object]]:
    """``{parameter name: (sharded dimension, model group)}`` of the model's
    channel-sharded parameters: the kernel of every conv with
    ``shard_axis``, on its output channels (dimension 4 of ``(kt, kh, kw,
    Cin, Cout)``)."""
    out = {}
    for prefix, module in model.named_modules():
        group = getattr(module, "shard_axis", None)
        if group is not None and isinstance(getattr(module, "kernel", None), torch.nn.Parameter):
            out[f"{prefix}.kernel" if prefix else "kernel"] = (4, group)
    return out


def param_partition_specs(model: torch.nn.Module) -> dict[str, int | None]:
    """``{parameter name: the dimension sharded over the model group, or
    None}`` (the counterpart of the reference's ``with_partitioning``
    metadata): everything but the sharded convs' kernels is replicated."""
    sharded = sharded_params(model)
    return {name: sharded[name][0] if name in sharded else None
            for name, _ in model.named_parameters()}


def whole_shapes(model: torch.nn.Module) -> dict[str, tuple[int, ...]]:
    """The shape of each state_dict entry of the model as one process holds
    it: a sharded parameter's with its dimension times the group's size."""
    shapes = {name: list(t.shape) for name, t in model.state_dict().items()}
    for name, (dim, group) in sharded_params(model).items():
        shapes[name][dim] *= group.size()
    return {name: tuple(shape) for name, shape in shapes.items()}


def full_state_dict(model: torch.nn.Module) -> dict[str, torch.Tensor]:
    """The model's state_dict with every sharded parameter gathered whole
    over its model group (a collective: every rank of the group calls it);
    the state_dict itself without channel sharding."""
    sd = model.state_dict()
    for name, (dim, group) in sharded_params(model).items():
        sd[name] = gather_along(sd[name].detach(), dim, group)
    return sd


def local_parts(model: torch.nn.Module, full: dict) -> dict:
    """This rank's part of each whole tensor in ``full`` (keyed by the
    model's parameter and buffer names): its slice of each sharded
    parameter, the others as they are."""
    sharded = sharded_params(model)
    out = {}
    for name, value in full.items():
        if name in sharded:
            dim, group = sharded[name]
            value = shard_of(value, dim, group.rank(), group.size())
        out[name] = value
    return out


def shard_train_state(state, mesh: Mesh):
    """Give every rank rank 0's weights and BatchNorm statistics: the whole
    state_dict (``full_state_dict``) broadcast over the job, then each
    rank's part of it loaded (``local_parts``); returns ``state``."""
    if mesh.group is not None:
        with torch.no_grad():
            full = full_state_dict(state.model)
            for t in full.values():
                dist.broadcast(t, src=0)
            if sharded_params(state.model):  # else the broadcast wrote the model's own tensors
                state.model.load_state_dict(local_parts(state.model, full))
    return state


def all_reduce_mean_(tensors: list[torch.Tensor], mesh: Mesh) -> None:
    """Replace each tensor by its mean over the data group, in place: one
    all-reduce (a sum) a tensor, then a division by the data-parallel
    degree."""
    for t in tensors:
        dist.all_reduce(t, group=mesh.group)
        t.div_(mesh.data_parallel)


def any_rank(flag: bool, mesh: Mesh) -> bool:
    """Whether ``flag`` is set on any rank of the job (an all-reduce with
    MAX): the collective stop decision. Without a group, ``flag`` itself."""
    if mesh.group is None:
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int32, device=mesh.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def barrier(mesh: Mesh | None) -> None:
    """Wait for every rank of the job (nothing without one)."""
    if mesh is not None and mesh.group is not None:
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[mesh.device.index])
        else:
            dist.barrier()
