"""Multi-clip evaluation (the counterpart of
``fastvideotagging_tpu/evaluation/evaluate.py``).

Per video: K deterministic clips (center/uniform/dense per config) ->
device preprocess of all K in one call -> forward in fixed-size chunks ->
scores -> **mean over clips in clip order, f32 accumulation** -> video-level
prediction. The fixed clip order and f32 sum make reruns bitwise identical,
and the aggregation is the JAX package's, so engines compare fairly.

``variables`` is a ``state_dict`` of the model's weights. The device that
evaluation runs on is theirs: clips are preprocessed and forwarded there,
and nothing moves to the CPU or to a plain kernel version on a card.

Parallel (``mesh``, parallel/mesh.py): every rank decodes every video;
each chunk of clip_batch clips is split over the data indices (data index d
forwards its contiguous block of rows) and the scores are all-gathered over
the data group, so every rank returns the same array. A clip_batch the data
indices do not divide is rounded up to a multiple of them (chunks are
padded to clip_batch anyway, so the scores do not change). With
``model_parallel > 1`` the ranks of a model group score the same rows
through the channel-sharded model (``make_eval_fn`` builds it on the model
group; ``variables`` are then each rank's parts), and each data group,
which holds one rank of every model group, gathers the scores.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.distributed as dist
from torch.func import functional_call

from fastvideotagging_tpu_torch._device import device_of
from fastvideotagging_tpu_torch.config import ExperimentConfig
from fastvideotagging_tpu_torch.data.packed import open_dataset
from fastvideotagging_tpu_torch.data.pipeline import ClipDataset
from fastvideotagging_tpu_torch.models import heads
from fastvideotagging_tpu_torch.models.zoo import config_clip_shape, model_from_config
from fastvideotagging_tpu_torch.ops.preprocess import preprocess_eval_clip
from fastvideotagging_tpu_torch.parallel.mesh import Mesh, check_mesh
from fastvideotagging_tpu_torch.train.metrics import (
    mean_average_precision,
    per_tag_precision_recall,
    topk_accuracy,
)
from fastvideotagging_tpu_torch.utils.logging import get_logger

log = get_logger("fvt.eval")


def _eval_plan(mesh, clip_batch: int) -> tuple[Mesh | None, int]:
    """-> (the mesh to split chunks over, or None; the clip_batch). A
    clip_batch the data indices do not divide is rounded up to a multiple of
    them (with a warning): every rank must take whole rows of every
    chunk."""
    if check_mesh(mesh) is None or mesh.group is None or mesh.data_parallel <= 1:
        return None, clip_batch
    shards = mesh.data_parallel
    if clip_batch % shards:
        rounded = -(-clip_batch // shards) * shards
        log.warning("eval: clip_batch=%d not divisible by data shards %d; padding "
                    "chunks to %d", clip_batch, shards, rounded)
        return mesh, rounded
    return mesh, clip_batch


def _make_apply(model, multilabel: bool):
    """The default engine: the model's forward with ``variables`` as its
    weights (``torch.func.functional_call``), in eval mode, then
    ``predict_scores``."""
    model.eval()

    def apply(variables, clips):
        return heads.predict_scores(functional_call(model, variables, (clips,)), multilabel)

    return apply


@torch.inference_mode()
def _forward_scores(apply, variables, clips: torch.Tensor, clip_batch: int = 8,
                    mesh: Mesh | None = None) -> np.ndarray:
    """Forward (K, T, ch, cw, 3) clips in fixed-size chunks; returns (K, C)
    f32. Chunks are padded to clip_batch, so every forward has one shape.
    With ``mesh`` each data index forwards its rows of every chunk and the
    scores are all-gathered over the data group."""
    k = clips.shape[0]
    out = []
    for i in range(0, k, clip_batch):
        chunk = clips[i : i + clip_batch]
        n = chunk.shape[0]
        if n < clip_batch:
            pad = chunk.new_zeros((clip_batch - n,) + tuple(chunk.shape[1:]))
            chunk = torch.cat([chunk, pad], dim=0)
        if mesh is None:
            scores = apply(variables, chunk)
        else:
            per, d = clip_batch // mesh.data_parallel, mesh.data_index
            part = apply(variables, chunk[d * per:(d + 1) * per]).float()
            parts = [torch.empty_like(part) for _ in range(mesh.data_parallel)]
            dist.all_gather(parts, part.contiguous(), group=mesh.group)
            scores = torch.cat(parts)
        out.append(scores[:n].float().cpu().numpy())
    return np.concatenate(out, axis=0)


def evaluate_video_scores(
    model, variables, dataset: ClipDataset, cfg: ExperimentConfig,
    clip_batch: int = 8, apply_fn=None, mesh=None,
) -> tuple[np.ndarray, list]:
    """Per-video aggregated scores. Returns (scores (N, C) f32, records).

    ``apply_fn(variables, clips) -> scores`` overrides the default model
    forward — the hook for alternate serving engines, e.g. the fused engine
    on K4 (ops/fused_infer.py; ``variables`` is then its ``state_dict``).
    The aggregation downstream is the same for every engine.
    ``mesh``: evaluate data-parallel over its ranks (``variables`` on each
    rank's device); every rank returns the same scores."""
    mesh, clip_batch = _eval_plan(mesh, clip_batch)
    d = cfg.data
    device = device_of(variables)  # a state_dict, or a nested qpack (int8 apply_fn)
    apply = apply_fn or _make_apply(model, cfg.model.multilabel)
    dtype = getattr(torch, cfg.model.compute_dtype)
    all_scores = []
    # host_crop (DataConfig): apply the center crop host-side and ship only
    # the crop_hw window; the dataset guard already rejected host_crop with
    # source_hw, so clips arrive at resize_hw here and the slice is exact.
    host_crop = d.host_crop
    ch, cw = d.crop_hw
    ctop, cleft = (d.resize_hw[0] - ch) // 2, (d.resize_hw[1] - cw) // 2
    pre_hw = d.crop_hw if host_crop else d.resize_hw
    # One-video decode lookahead: video i+1 decodes on a worker thread while
    # video i's clips run on the device. Videos are still taken strictly in
    # order, so the aggregation (f32 sum in clip order) is untouched.
    with ThreadPoolExecutor(max_workers=1) as pool:
        pending = pool.submit(dataset.get_eval_clips, 0) if len(dataset) else None
        for i in range(len(dataset)):
            clips_u8, _rec = pending.result()
            pending = (pool.submit(dataset.get_eval_clips, i + 1)
                       if i + 1 < len(dataset) else None)
            if host_crop:
                clips_u8 = clips_u8[:, :, ctop:ctop + ch, cleft:cleft + cw]
            frames = torch.from_numpy(np.ascontiguousarray(clips_u8))
            if device.type == "cuda":
                frames = frames.pin_memory().to(device, non_blocking=True)
            clips = preprocess_eval_clip(frames, pre_hw, d.crop_hw, d.mean, d.std,
                                         out_dtype=dtype)
            scores = _forward_scores(apply, variables, clips, clip_batch, mesh)
            # Aggregation spec: f32 sum in clip order, divided by clip count.
            video = scores.astype(np.float32).sum(axis=0) / scores.shape[0]
            all_scores.append(video)
    out = np.stack(all_scores)
    if not np.all(np.isfinite(out)):
        # Without this, a diverged model reads as chance-level top1 (argmax
        # of a NaN row is 0) and silently-empty tags — diagnose it loudly.
        bad = int((~np.isfinite(out).all(axis=1)).sum())
        log.warning(
            "non-finite scores for %d/%d videos — the model diverged in "
            "training (try --clip-grad-norm / a lower --lr) or the weights "
            "do not match the architecture; metrics are meaningless",
            bad, out.shape[0])
    return out, dataset.records


def evaluate(
    model, variables, dataset: ClipDataset, cfg: ExperimentConfig,
    clip_batch: int = 8, threshold: float = 0.5, apply_fn=None, mesh=None,
) -> dict:
    """Full eval pass -> scalar metrics dict."""
    scores, records = evaluate_video_scores(model, variables, dataset, cfg,
                                            clip_batch, apply_fn=apply_fn,
                                            mesh=mesh)
    out: dict = {"num_videos": len(records)}
    if cfg.model.multilabel:
        multihot = np.stack([r.multihot(cfg.model.num_classes) for r in records])
        pr = per_tag_precision_recall(scores, multihot, threshold)
        out["mAP"] = mean_average_precision(scores, multihot)
        out["macro_f1"] = float(pr["f1"].mean())
    else:
        labels = np.asarray([r.label for r in records])
        out["top1"] = topk_accuracy(scores, labels, k=1)
        out["top5"] = topk_accuracy(scores, labels, k=min(5, scores.shape[1]))
    return out


def make_eval_fn(cfg: ExperimentConfig, val_records, num_tags=None,
                 clip_batch: int = 8, mesh=None,
                 device: str | torch.device = "cuda"):
    """The per-epoch eval hook for a training loop: ``eval_fn(state, epoch)
    -> metrics`` with the state's current weights.

    ``val_records``: VideoRecords or a ``.fvtpack`` path (decode-once tier).
    The eval model is built once, on ``device`` (the card unless the caller
    asks for the CPU), or with ``mesh`` on this rank's device, channel-
    sharded on its model group when ``model_parallel > 1`` (the state's
    weights are then this rank's parts); the forward then runs over the
    mesh (every rank decodes the whole val list; fit passes its training
    mesh).
    """
    kw = {}
    if check_mesh(mesh) is not None:
        device = mesh.device
        if mesh.model_group is not None:
            kw["shard_axis"] = mesh.model_group
    dataset = open_dataset(val_records, cfg.data, mode="eval", num_tags=num_tags)
    model = model_from_config(cfg.model, device=device, clip_shape=config_clip_shape(cfg.data),
                              **kw)
    apply = _make_apply(model, cfg.model.multilabel)

    def eval_fn(state, epoch):
        scalars = evaluate(model, state.model.state_dict(), dataset, cfg, clip_batch,
                           apply_fn=apply, mesh=mesh)
        if mesh is None or mesh.is_main:
            log.info("epoch %d eval: %s", epoch, scalars)
        return scalars

    return eval_fn
