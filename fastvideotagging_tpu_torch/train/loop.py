"""The train step (counterpart of ``fastvideotagging_tpu/train/loop.py``):

  uint8 frames (or cache rows gathered on the device) -> device preprocess
  (resize, random crop, flip, normalize)
  -> model forward in train mode (compute dtype) -> loss (f32) -> backward
  (through the hand kernels with ``kernels='cuda'``) -> clip -> SGD update.

The step runs eagerly on the state's device and never waits for it: the
metrics come back as device tensors, for the caller to read every
``log_every`` steps.

Parallel (``mesh`` with a data group, parallel/mesh.py): each rank runs
the step on its data index's rows of the global batch; every BatchNorm sums
its statistics over the data group (``layers.sync_batch_norm``), the
dropout mask is the global batch's (``layers.global_dropout_rows``, by the
data index, so the ranks of a model group draw the same mask), and after
the backward the gradients are averaged over the data group (one all-reduce
a gradient, then a division), as are the loss and top-1 metrics. Each rank
then makes the same update, so the ranks' weights stay equal. A
channel-sharded model (``model_parallel > 1``) runs its convs' collectives
over the model group inside its forward and backward (parallel/channel.py);
each rank then updates its part of every sharded kernel.

With a profiler's scopes on (ops/scopes.py), the preprocess and the update
run under ``fvt/preprocess`` and ``fvt/optimizer``.
"""

from __future__ import annotations

from typing import Callable

import torch

from fastvideotagging_tpu_torch.config import ExperimentConfig
from fastvideotagging_tpu_torch.models import heads
from fastvideotagging_tpu_torch.models.layers import global_dropout_rows, sync_batch_norm
from fastvideotagging_tpu_torch.ops import scopes
from fastvideotagging_tpu_torch.ops.preprocess import preprocess_batch
from fastvideotagging_tpu_torch.parallel.mesh import Mesh, all_reduce_mean_, check_mesh
from fastvideotagging_tpu_torch.train.state import TrainState


def make_train_step(
    model: torch.nn.Module, cfg: ExperimentConfig, device_cache: bool = False,
    mesh: Mesh | None = None,
) -> Callable[..., tuple[TrainState, dict]]:
    """Build the train step: ``(state, batch, generator) -> (state, metrics)``.

    batch: frames uint8 (B,T,H,W,3), labels int (B,) or multihot f32 (B,K),
    crop_tops/crop_lefts int (B,), flips bool (B,), weights f32 (B,) —
    tensors or numpy arrays on the host or the device. ``generator`` (on
    the model's device) draws the dropout mask. The state is updated in
    place and returned; ``metrics`` holds ``loss`` and, for single-label
    models, ``top1`` as 0-d device tensors.

    ``device_cache=True`` (the device-resident pack, data/device_cache.py):
    the step takes a fourth argument, the cache's (total_frames, H, W, 3)
    uint8 tensor on the model's device, and the batch carries ``rows`` (B, T)
    int cache rows in place of ``frames``; the clips' pixels are gathered
    there (one gather over the leading axis), so a step copies a few KB of
    indices to the device.

    ``mesh``: the job's mesh (the batch is this rank's rows; the model's
    BatchNorms are put on the mesh's data group here; a channel-sharded
    model is built on its model group).
    """
    group = check_mesh(mesh) and mesh.group
    if group is not None:
        sync_batch_norm(model, group)
    d = cfg.data
    multilabel = cfg.model.multilabel
    compute_dtype = getattr(torch, cfg.model.compute_dtype)
    # host_crop ships pre-cropped frames: the device "resize" becomes the
    # (crop_hw -> crop_hw) identity and only flip + normalize remain.
    resize_hw = d.crop_hw if d.host_crop else d.resize_hw

    def step(state: TrainState, batch: dict, generator: torch.Generator | None = None,
             cache_frames: torch.Tensor | None = None):
        if state.model is not model:
            raise ValueError("the state holds another model than this step was built for")
        if device_cache != (cache_frames is not None):
            raise ValueError("a device_cache step takes the cache's frames, and only it does")
        dev = next(model.parameters()).device
        # a no-op for batches that data.pipeline.device_prefetch put on the card
        batch = {k: torch.as_tensor(v).to(dev, non_blocking=True) for k, v in batch.items()}
        frames = (cache_frames[batch["rows"].long()] if device_cache
                  else batch["frames"])
        with scopes.region("preprocess"):
            clips = preprocess_batch(
                frames, batch["crop_tops"], batch["crop_lefts"], batch["flips"],
                d.mean, d.std, resize_hw=resize_hw, crop_hw=d.crop_hw,
                out_dtype=compute_dtype)
        model.train()
        if group is None:
            logits = model(clips, generator=generator)
        else:
            b = clips.shape[0]
            with global_dropout_rows(b * mesh.data_parallel, b * mesh.data_index):
                logits = model(clips, generator=generator)
        if multilabel:
            loss = heads.sigmoid_bce(logits, batch["multihot"], batch["weights"])
        else:
            loss = heads.softmax_cross_entropy(logits, batch["labels"], batch["weights"])
        loss.backward()
        if group is not None:
            all_reduce_mean_([p.grad for p in model.parameters() if p.grad is not None],
                             mesh)
            state.model_group = mesh.model_group
        with scopes.region("optimizer"):
            state.apply_gradients()
        metrics = {"loss": loss.detach()}
        if not multilabel:
            w = batch["weights"].float()
            top1 = (logits.detach().argmax(dim=-1) == batch["labels"]).float()
            metrics["top1"] = (top1 * w).sum() / torch.clamp(w.sum(), min=1.0)
        if group is not None:
            values = list(metrics.values())
            all_reduce_mean_(values, mesh)
        return state, metrics

    return step


def make_sample_batch(cfg: ExperimentConfig, batch_size: int | None = None,
                      device_cache: bool = False) -> dict:
    """A zeros batch (host tensors) with the config's exact shapes.

    ``device_cache=True`` swaps the frames tensor for the (B, T) int32
    cache-row indices of the device-resident tier (the caller gives the
    step the cache itself)."""
    d = cfg.data
    b = batch_size or cfg.train.batch_size
    t = d.sampler.clip_len
    h, w = d.crop_hw if d.host_crop else (d.source_hw or d.resize_hw)
    batch = {
        "labels": torch.zeros((b,), dtype=torch.int32),
        "crop_tops": torch.zeros((b,), dtype=torch.int32),
        "crop_lefts": torch.zeros((b,), dtype=torch.int32),
        "flips": torch.zeros((b,), dtype=torch.bool),
        "weights": torch.ones((b,), dtype=torch.float32),
    }
    if device_cache:
        batch["rows"] = torch.zeros((b, t), dtype=torch.int32)
    else:
        batch["frames"] = torch.zeros((b, t, h, w, 3), dtype=torch.uint8)
    if cfg.model.multilabel:
        batch["multihot"] = torch.zeros((b, cfg.model.num_classes), dtype=torch.float32)
    return batch
