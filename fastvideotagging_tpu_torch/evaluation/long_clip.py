"""Whole-clip sequence-parallel inference for very long clips (the
counterpart of ``fastvideotagging_tpu/evaluation/long_clip.py``).

One clip of any length runs through the backbone with its time axis split
over the ranks of a time group: per-card activation memory is O(T / n),
every temporal conv exchanges p = k // 2 frames with each neighbour
(parallel/temporal.py: K2 over the halo'd slab on the card), spatial convs
and BatchNorm (eval mode) stay local, and the pooled features are summed
over the group and classified once. Equal to the unsharded forward up to
float summation order (f32: within 1e-5 on the CPU).

Constraints (the r2plus1d family): T divisible by the number of shards, and
T / n by the total temporal stride (8 for the 4-stage layout), so every
stage keeps whole frames on every rank: T >= 8 n.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from fastvideotagging_tpu_torch.models import heads
from fastvideotagging_tpu_torch.parallel.mesh import Mesh, make_mesh
from fastvideotagging_tpu_torch.parallel.temporal import time_shard

TOTAL_STRIDE = 8  # r2plus1d's 4-stage temporal downsampling


def make_time_mesh(n_shards: int | None = None, device: str | torch.device = "cuda") -> Mesh:
    """The time group: every rank of the job (``n_shards``, when given, must
    equal the world size), each on its own device (the card by default)."""
    mesh = make_mesh(-1, device=device)
    if n_shards is not None and n_shards != mesh.world:
        raise ValueError(f"n_shards={n_shards} must equal the job's {mesh.world} process(es)")
    if mesh.group is None:
        raise ValueError("a time mesh needs a job (parallel.init_multihost)")
    return mesh


def _halve(v: int, times: int) -> int:
    for _ in range(times):  # a stride-2 symmetric conv: out = ceil(in / 2)
        v = -(-v // 2)
    return v


def score_long_clip(model_factory, variables: dict, clips: torch.Tensor, mesh: Mesh,
                    multilabel: bool = False) -> torch.Tensor:
    """Scores (B, num_classes) f32 for (B, T, H, W, 3) preprocessed clips,
    T sharded over ``mesh``'s ranks. Every rank passes the whole clip and
    gets the same scores; each forwards its block of frames.

    ``model_factory(time_axis=group)`` builds the backbone (e.g.
    ``functools.partial(get_model, "r2plus1d_18", num_classes=K,
    device=...)``); ``variables`` are its ordinary weights (a state_dict):
    the sharded and unsharded models share one parameter tree; the time
    group is the mesh's."""
    if mesh.model_parallel > 1:
        raise ValueError(f"score_long_clip runs on a time mesh (make_time_mesh), not on one "
                         f"of model_parallel={mesh.model_parallel}")
    n = mesh.world
    t = clips.shape[1]
    if t % n or (t // n) % TOTAL_STRIDE:
        raise ValueError(
            f"T={t} must be divisible by n_shards={n} and T/n by {TOTAL_STRIDE} "
            f"(whole frames per shard at every stage)")
    model = model_factory(time_axis=mesh.group).to(mesh.device).eval()
    model.load_state_dict(variables)
    with torch.inference_mode():
        feats = model(time_shard(clips, mesh.group).to(mesh.device), features_only=True)
        # local sum over (T_local', H', W') + a sum over the group == the
        # global average pool, in f32
        pooled_sum = feats.float().sum(dim=(1, 2, 3))
        dist.all_reduce(pooled_sum, group=mesh.group)
        count = (t // TOTAL_STRIDE) * _halve(clips.shape[2], 4) * _halve(clips.shape[3], 4)
        pooled = pooled_sum / count
        logits = pooled @ model.fc.weight.float().T + model.fc.bias.float()
        return heads.predict_scores(logits, multilabel)
