"""The time-sharded (sequence-parallel) train step (the counterpart of
``fastvideotagging_tpu/train/time_sharded.py``).

The clip's T axis is split over the ranks of a time group: temporal convs
run as halo convs (parallel/temporal.py, K2 over the halo'd slab), every
BatchNorm averages its statistics over the group (so it normalizes with the
statistics of the whole (B, T, H, W)), and the head is rearranged so that
every parameter sits upstream of one all-reduce:

    local_sum = sum over (T'_local, H', W') of the f32 features
    partial   = (local_sum / global_count) @ W_fc + b_fc / n
    logits    = all_reduce(partial)          # == the unsharded logits
    loss      = CE(logits, labels)           # the same on every rank

The all-reduce is autograd-aware, and its backward is itself an all-reduce
of the gradient: every rank's loss is the whole loss, so each rank's raw
gradient is n times its share of the total. The step therefore averages the
gradients over the group (a sum, then a division by n), not sums them.

The head's dropout is bypassed (the pooled head is computed by hand), and
the pooled features stay f32 between the pool and the fc. For clips too
long for one card: per-card activation memory is O(T / n).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed.nn.functional as dist_nn

from fastvideotagging_tpu_torch.config import ExperimentConfig
from fastvideotagging_tpu_torch.models import heads
from fastvideotagging_tpu_torch.ops.preprocess import preprocess_batch
from fastvideotagging_tpu_torch.parallel.mesh import Mesh, all_reduce_mean_
from fastvideotagging_tpu_torch.parallel.temporal import time_shard
from fastvideotagging_tpu_torch.train.state import TrainState


def time_shardable(model) -> bool:
    """The r2plus1d family carries the ``time_axis`` / ``features_only``
    machinery; other backbones would need their own halo plumbing."""
    return hasattr(model, "time_axis") and hasattr(model, "stem_temporal")


def make_time_sharded_train_step(model_factory, cfg: ExperimentConfig, mesh: Mesh,
                                 ) -> tuple[Callable[..., tuple[TrainState, dict]], torch.nn.Module]:
    """Build the step; returns ``(step, model)``.

    ``model_factory(time_axis=group, bn_axis_name=group)`` builds the
    backbone (e.g. ``functools.partial(get_model, "r2plus1d_18",
    num_classes=K, device=...)``); the group is the mesh's. The step is
    ``(state, batch, generator=None) -> (state, metrics)`` with
    train/loop.py's batch contract on the whole batch, which every rank
    passes: each takes its block of the frames' T axis, which must be
    divisible by the group's size (and T / n by the backbone's total
    temporal stride, 8 for r2plus1d). ``generator`` is accepted for the
    signature's sake; the head's dropout is bypassed."""
    d = cfg.data
    multilabel = cfg.model.multilabel
    compute_dtype = getattr(torch, cfg.model.compute_dtype)
    resize_hw = d.crop_hw if d.host_crop else d.resize_hw
    if mesh.model_parallel > 1:
        raise ValueError(
            f"the time-sharded step runs on a mesh of model_parallel=1, not "
            f"{mesh.model_parallel} (the JAX package does not combine it with channel "
            f"sharding either)")
    group, n = mesh.group, mesh.world
    model = model_factory(time_axis=group, bn_axis_name=group)
    if not time_shardable(model):
        raise ValueError(f"{type(model).__name__} has no time-sharded form "
                         f"(the r2plus1d family has)")

    def step(state: TrainState, batch: dict, generator: torch.Generator | None = None):
        del generator
        if state.model is not model:
            raise ValueError("the state holds another model than this step was built for")
        dev = next(model.parameters()).device
        batch = {k: torch.as_tensor(v).to(dev, non_blocking=True) for k, v in batch.items()}
        # the preprocess is frame-wise (resize, crop, flip, normalize), so
        # it runs on this rank's frames; the crops are per clip, the same
        # on every rank
        clips = preprocess_batch(
            time_shard(batch["frames"], group), batch["crop_tops"], batch["crop_lefts"],
            batch["flips"], d.mean, d.std, resize_hw=resize_hw, crop_hw=d.crop_hw,
            out_dtype=compute_dtype)
        model.train()
        feats = model(clips, features_only=True)
        local_sum = feats.float().sum(dim=(1, 2, 3))
        count = feats.shape[1] * n * feats.shape[2] * feats.shape[3]
        fc = model.fc
        partial = (local_sum / count) @ fc.weight.float().T + fc.bias.float() / n
        logits = dist_nn.all_reduce(partial, group=group)
        if multilabel:
            loss = heads.sigmoid_bce(logits, batch["multihot"], batch["weights"])
        else:
            loss = heads.softmax_cross_entropy(logits, batch["labels"], batch["weights"])
        loss.backward()
        all_reduce_mean_([p.grad for p in model.parameters() if p.grad is not None], mesh)
        state.apply_gradients()
        metrics = {"loss": loss.detach()}
        if not multilabel:
            w = batch["weights"].float()
            top1 = (logits.detach().argmax(dim=-1) == batch["labels"]).float()
            metrics["top1"] = (top1 * w).sum() / torch.clamp(w.sum(), min=1.0)
        return state, metrics

    return step, model
