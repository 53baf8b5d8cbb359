"""Channel sharding over a model group: the collectives that XLA's SPMD
partitioner inserts around a conv whose kernel the JAX package shards on
its output channels (``fastvideotagging_tpu/models/layers.py::Conv3D``,
``shard_axis``), spelled out.

A model group is ``mp`` ranks that hold the same batch rows (parallel/
mesh.py). Each keeps the ``Cout / mp`` columns of the conv kernel that its
index in the group names, and everything else (BatchNorm, the fc, the
activations between the convs) replicated. A sharded conv is then

    x_in = model_input(x, group)         # identity; backward: all-reduce dx
    y_i  = conv(x_in, kernel[..., i])    # this rank's Cout / mp channels
    y    = gather_channels(y_i, group)   # all-gather on C; backward: slice

Backward: the computation downstream of ``y`` is replicated, so every rank
of the group receives the same, whole gradient of ``y`` and keeps its own
channels of it, with no communication; each rank's conv then gives only its
channels' part of dx, and the all-reduce (a sum) makes the whole dx, the
same on every rank. ``torch.distributed.nn.functional.all_gather`` is not
this: its backward reduce-scatters, which sums ``mp`` equal copies and
makes every gradient upstream ``mp`` times too large.

Collectives take the group's ``rank()`` and ``size()`` from the process
group object itself. gloo's all-gather and all-reduce take CUDA tensors,
so ranks that share one card work.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

# Per process: all-gathers and all-reduces run, and the bytes of the
# tensors they produced (the gathered whole width; the summed dx).
channel_counts = {"gathers": 0, "gather_bytes": 0, "reduces": 0, "reduce_bytes": 0}


def reset_channel_counts() -> None:
    for key in channel_counts:
        channel_counts[key] = 0


def check_shard_axis(group):
    """``group`` if it is a process group (an object with ``rank()`` and
    ``size()``) or None; raises otherwise (the JAX package names a mesh
    axis, the port passes the group itself: ``Mesh.model_group``)."""
    if group is not None and not (callable(getattr(group, "rank", None))
                                  and callable(getattr(group, "size", None))):
        raise TypeError(
            f"shard_axis must be a process group (parallel.Mesh.model_group), got "
            f"{type(group).__name__} {group!r}")
    return group


def shard_of(t: torch.Tensor, dim: int, index: int, count: int) -> torch.Tensor:
    """Part ``index`` of ``count`` equal parts of ``t`` along ``dim`` (a
    contiguous copy); raises unless ``count`` divides that dimension."""
    size = t.shape[dim]
    if size % count:
        raise ValueError(f"{count} shards do not divide dimension {dim} of size {size}")
    per = size // count
    return t.narrow(dim, index * per, per).contiguous()


def gather_along(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's parts of a tensor, concatenated along ``dim`` in group
    order (no autograd)."""
    parts = [torch.empty_like(t) for _ in range(group.size())]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


class _ModelInput(torch.autograd.Function):
    """Identity forward; backward: the sum of the group's dx parts."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        channel_counts["reduces"] += 1
        channel_counts["reduce_bytes"] += g.numel() * g.element_size()
        return g, None


class _GatherChannels(torch.autograd.Function):
    """All-gather on the last (channel) dimension forward; backward: this
    rank's channels of the (replicated) gradient, no communication."""

    @staticmethod
    def forward(ctx, y, group):
        ctx.index, ctx.width = group.rank(), y.shape[-1]
        out = gather_along(y, -1, group)
        channel_counts["gathers"] += 1
        channel_counts["gather_bytes"] += out.numel() * out.element_size()
        return out

    @staticmethod
    def backward(ctx, g):
        return g.narrow(-1, ctx.index * ctx.width, ctx.width).contiguous(), None


def model_input(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` entering a sharded conv: the identity, whose backward sums dx
    over ``group``."""
    return _ModelInput.apply(x, group)


def gather_channels(y: torch.Tensor, group) -> torch.Tensor:
    """A sharded conv's output parts concatenated on C in group order; its
    backward keeps this rank's channels."""
    return _GatherChannels.apply(y, group)
