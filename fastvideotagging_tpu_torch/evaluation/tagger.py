"""tag(video): the one-call inference entry point of the port.

The counterpart of ``fastvideotagging_tpu/evaluation/tagger.py``. Pipeline:
decode -> dense/uniform clip sampling -> device preprocess -> batched
forward (fixed-size chunks) -> sigmoid/softmax -> f64 host mean over clips
-> [(tag, score), ...] above threshold. Long videos stream in bounded
chunks, so memory is O(chunk), not O(video length). ``iter_pack_tags``
tags every video of a decode-once ``.fvtpack``.
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch

from fastvideotagging_tpu_torch._device import resolve_device
from fastvideotagging_tpu_torch.config import (
    ClipSamplerConfig,
    DataConfig,
    ExperimentConfig,
    ModelConfig,
)
from fastvideotagging_tpu_torch.data import decode, sampler
from fastvideotagging_tpu_torch.data.frames import _ensure_size
from fastvideotagging_tpu_torch.data.packed import Pack
from fastvideotagging_tpu_torch.models import heads
from fastvideotagging_tpu_torch.models.convert import from_jax_variables
from fastvideotagging_tpu_torch.models.zoo import config_clip_shape, model_from_config
from fastvideotagging_tpu_torch.ops.preprocess import preprocess_eval_clip
from fastvideotagging_tpu_torch.train.checkpoint import load_weights


@dataclasses.dataclass
class TagResult:
    tag: str
    score: float
    index: int


def eval_clip_index(n_frames: int, sampler_cfg) -> np.ndarray:
    """The (K, T) eval clip index grid for a video of ``n_frames``."""
    s = sampler_cfg
    return sampler.sample_eval_indices(
        max(int(n_frames), 1), s.clip_len, s.stride, mode=s.eval_mode,
        num_clips=s.num_eval_clips)


def iter_eval_chunks(read_frames, clip_idx: np.ndarray, ship_hw,
                     clip_batch: int):
    """Yield ``(clips_u8, nclips)`` fixed-shape chunks in clip order, each
    padded to ``clip_batch``; ``nclips`` counts the real clips."""
    k = clip_idx.shape[0]
    for i in range(0, k, clip_batch):
        chunk_idx = clip_idx[i : i + clip_batch]
        nclips, t = chunk_idx.shape
        flat = read_frames(chunk_idx.reshape(-1))
        flat = _ensure_size(flat, ship_hw)
        clips_u8 = flat.reshape((nclips, t) + flat.shape[1:])
        if nclips < clip_batch:  # pad to the fixed chunk shape
            pad = np.zeros(
                (clip_batch - nclips,) + clips_u8.shape[1:], np.uint8)
            clips_u8 = np.concatenate([clips_u8, pad], axis=0)
        yield clips_u8, nclips


def scores_from_frames(read_frames, n_frames: int, sampler_cfg, ship_hw,
                       num_classes: int, clip_batch: int,
                       score_u8) -> np.ndarray:
    """The clip-aggregation loop shared by every frame source.

    ``read_frames(flat_idx)`` returns uint8 frames at any geometry (resized
    to ``ship_hw`` here if needed); ``score_u8(clips_u8, nclips)`` returns
    scores ``(nclips, num_classes)`` for the real clips of a chunk as a
    tensor, possibly still being computed on the device.
    """
    clip_idx = eval_clip_index(n_frames, sampler_cfg)
    total = np.zeros((num_classes,), np.float64)
    # One-chunk lookahead: the previous chunk's readback (which waits for
    # the device) happens only after the next chunk has been decoded and
    # dispatched, so host decode of chunk k+1 overlaps the device's work on
    # chunk k. The accumulation order is unchanged.
    pending = None
    for clips_u8, nclips in iter_eval_chunks(read_frames, clip_idx, ship_hw,
                                             clip_batch):
        scores = score_u8(clips_u8, nclips)
        if pending is not None:
            total += pending.float().cpu().numpy().astype(np.float64).sum(axis=0)
        pending = scores
    if pending is not None:
        total += pending.float().cpu().numpy().astype(np.float64).sum(axis=0)
    return (total / clip_idx.shape[0]).astype(np.float32)


def open_sequential_reader(video_path: str, sampler_cfg):
    """-> (probe frame count, SequentialReader) with the dense-eval cache
    size (2 clip spans of backward overlap)."""
    n, _, _, _ = decode.probe_video(video_path)
    span = (sampler_cfg.clip_len - 1) * sampler_cfg.stride + 1
    return n, decode.SequentialReader(video_path,
                                      cache_size=max(128, 2 * span))


def stream_video_scores(video_path: str, sampler_cfg, ship_hw,
                        num_classes: int, clip_batch: int,
                        score_u8) -> np.ndarray:
    """scores_from_frames over one forward decode pass of a video file."""
    n, reader = open_sequential_reader(video_path, sampler_cfg)
    with reader:
        return scores_from_frames(reader.read, n, sampler_cfg, ship_hw,
                                  num_classes, clip_batch, score_u8)


def rank_tags(scores: np.ndarray, tag_names: list[str],
              threshold: float = 0.5,
              top_k: int | None = None) -> list[TagResult]:
    """scores -> sorted [(tag, score, index), ...] above threshold."""
    if not np.all(np.isfinite(scores)):
        # NaN fails every >= threshold test, so a diverged model would
        # otherwise return [] with no explanation.
        logging.getLogger("fvt.tag").warning(
            "non-finite tag scores (%d/%d) — the weights diverged or do not "
            "match the architecture; no tags can clear the threshold",
            int((~np.isfinite(scores)).sum()), scores.size)
    order = np.argsort(-scores, kind="stable")
    results = [
        TagResult(tag_names[i], float(scores[i]), int(i))
        for i in order
        if scores[i] >= threshold
    ]
    if top_k is not None:
        results = results[:top_k]
    return results


class Tagger:
    """Reusable tagger: holds the model and its weights on one device."""

    def __init__(
        self,
        cfg: ExperimentConfig,
        state_dict: dict,
        tag_names: list[str] | None = None,
        clip_batch: int = 8,
        device: str | torch.device = "cuda",
    ):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.clip_batch = clip_batch
        k = cfg.model.num_classes
        self.tag_names = tag_names or [f"tag_{i}" for i in range(k)]
        if len(self.tag_names) != k:
            raise ValueError(
                f"{len(self.tag_names)} tag names for {k} classes"
            )
        self.model = model_from_config(cfg.model, device=self.device,
                                       clip_shape=config_clip_shape(cfg.data))
        self.model.load_state_dict(state_dict)
        self._dtype = getattr(torch, cfg.model.compute_dtype)

    @property
    def sampler_cfg(self):
        return self.cfg.data.sampler

    @property
    def ship_hw(self):
        return self.cfg.data.source_hw or self.cfg.data.resize_hw

    @property
    def num_classes(self) -> int:
        return self.cfg.model.num_classes

    def video_scores(self, video_path: str) -> np.ndarray:
        """Aggregated per-tag scores for one video, streaming over clips."""
        return stream_video_scores(
            video_path, self.sampler_cfg, self.ship_hw, self.num_classes,
            self.clip_batch, self._score_u8)

    def scores_from(self, read_frames, n_frames: int) -> np.ndarray:
        """Aggregated scores from an arbitrary frame source (e.g. a pack)."""
        return scores_from_frames(
            read_frames, n_frames, self.sampler_cfg, self.ship_hw,
            self.num_classes, self.clip_batch, self._score_u8)

    @torch.inference_mode()
    def _score_u8(self, clips_u8: np.ndarray, nclips: int) -> torch.Tensor:
        d = self.cfg.data
        frames = torch.from_numpy(clips_u8)
        if self.device.type == "cuda":
            # pinned, so the copy is queued behind the previous chunk's
            # forward instead of blocking the host until it finishes
            frames = frames.pin_memory().to(self.device, non_blocking=True)
        clips = preprocess_eval_clip(
            frames, d.resize_hw, d.crop_hw, d.mean, d.std, out_dtype=self._dtype)
        scores = heads.predict_scores(self.model(clips), self.cfg.model.multilabel)
        # still in flight on the card: the caller reads it back one chunk later
        return scores[:nclips]

    def tag(self, video_path: str, threshold: float = 0.5,
            top_k: int | None = None) -> list[TagResult]:
        return rank_tags(self.video_scores(video_path), self.tag_names,
                         threshold=threshold, top_k=top_k)


def iter_pack_tags(engine, pack, threshold: float = 0.5,
                   top_k: int | None = None, root: str = ""):
    """Bulk-tag every video in a ``.fvtpack`` — the decode-once backfill
    tier: no decode per request, frames served from the pack's mmap to any
    engine that exposes ``scores_from`` and ``ship_hw`` (``Tagger``).

    Sampling parity with the streaming ``tag()`` holds by construction: the
    pack stores ship-geometry frames from the same decode + resize path and
    ``probe_frames`` (the container-reported count the streaming sampler
    draws indices from). Yields ``(video_path, [TagResult, ...])`` per video
    in pack order (paths joined onto ``root``)."""
    pack = pack if isinstance(pack, Pack) else Pack(pack)
    ship = tuple(engine.ship_hw)
    if (pack.height, pack.width) != ship:
        raise ValueError(
            f"pack geometry {pack.height}x{pack.width} != the engine's ship "
            f"geometry {ship}; re-write the pack at this config")
    for i, rec in enumerate(pack.records(root)):
        scores = engine.scores_from(
            lambda idx, _i=i: pack.gather(_i, idx),
            pack.entries[i]["probe_frames"])
        yield rec.path, rank_tags(scores, engine.tag_names,
                                  threshold=threshold, top_k=top_k)


def tag(
    video_path: str,
    checkpoint: str | None = None,
    variables: dict | None = None,
    state_dict: dict | None = None,
    model_name: str = "r2plus1d_18",
    num_classes: int = 101,
    multilabel: bool = True,
    tag_names: list[str] | None = None,
    threshold: float = 0.5,
    top_k: int | None = None,
    clip_len: int = 16,
    stride: int = 1,
    eval_mode: str = "dense",
    cfg: ExperimentConfig | None = None,
    device: str | torch.device = "cuda",
) -> list[TagResult]:
    """One-call API, in the JAX package's parameter order. The weights are
    exactly one of: a ``checkpoint`` path (a weights export of
    ``train.checkpoint.export_weights``), the JAX package's ``variables``
    (nested dicts of arrays) or a port ``state_dict``."""
    if sum(w is not None for w in (checkpoint, variables, state_dict)) != 1:
        raise ValueError(
            "provide exactly one of `checkpoint`, `variables` or `state_dict`")
    if cfg is None:
        cfg = ExperimentConfig(
            model=ModelConfig(name=model_name, num_classes=num_classes,
                              multilabel=multilabel),
            data=DataConfig(sampler=ClipSamplerConfig(
                clip_len=clip_len, stride=stride, eval_mode=eval_mode)),
        )
    if checkpoint is not None:
        state_dict = load_weights(checkpoint)
    elif variables is not None:
        state_dict = from_jax_variables(variables)
    tagger = Tagger(cfg, state_dict, tag_names, device=device)
    return tagger.tag(video_path, threshold=threshold, top_k=top_k)
