"""tag(video) over the native C++ serving daemon (the counterpart of
``fastvideotagging_tpu/evaluation/native_tagger.py``).

The Python side here is a host front end: decode, clip sampling and
request framing (numpy only; it builds no model and runs nothing on the
card). The device work (staging, the compiled preprocess + backbone + head
program, readback) happens in the long-running ``fvt_native_runner
--serve`` child, which loads the ``cli.export --format native`` package
(``serving.native.pt2`` + ``meta.json``) once.

    with NativeTagger("art/") as t:
        results = t.tag("video.mp4", threshold=0.5)

Aggregation (dense sampling, f64 accumulation, the mean over clips) is
shared with the in-process Tagger through ``stream_video_scores`` /
``scores_from_frames``: the same chunks in the same order, so the two
engines differ only by their forwards.

The package runs where it was exported (``meta.json``'s
``artifacts["native"]["device"]``): a CUDA package on the card (raises
without one), a CPU package only when the caller passes ``device='cpu'``.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile

import numpy as np
import torch

from fastvideotagging_tpu_torch._device import resolve_device
from fastvideotagging_tpu_torch.config import ClipSamplerConfig
from fastvideotagging_tpu_torch.data.packed import Pack
from fastvideotagging_tpu_torch.evaluation.serving import NATIVE_PACKAGE
from fastvideotagging_tpu_torch.evaluation.tagger import (
    TagResult,
    eval_clip_index,
    iter_eval_chunks,
    open_sequential_reader,
    rank_tags,
    scores_from_frames,
    stream_video_scores,
)
from fastvideotagging_tpu_torch.native.runner import NativeServer


class NativeTagger:
    """Video tagger backed by the no-Python native serving daemon."""

    def __init__(self, artifacts_dir: str, tag_names: list[str] | None = None,
                 workdir: str | None = None, ready_timeout: float = 600.0,
                 pipeline: int = 0, device: str = "cuda"):
        meta_path = os.path.join(artifacts_dir, "meta.json")
        package = os.path.join(artifacts_dir, NATIVE_PACKAGE)
        if not os.path.exists(meta_path) or not os.path.exists(package):
            raise FileNotFoundError(
                f"{artifacts_dir!r} is not an export-CLI artifact dir (need meta.json + "
                f"{NATIVE_PACKAGE}; create with `python -m "
                "fastvideotagging_tpu_torch.cli.export ... --format native|both`)")
        with open(meta_path) as f:
            self.meta = json.load(f)
        dev = resolve_device(device).type
        exported = self.meta.get("artifacts", {}).get("native", {}).get("device")
        if exported != dev:
            raise ValueError(
                f"{package} was compiled for {exported!r}; it is served on that device "
                f"only (device={exported!r})")
        shape = tuple(self.meta["input"]["shape"])  # (B, T, H, W, 3)
        self.clip_batch = shape[0]
        self.ship_hw = (shape[2], shape[3])
        self.num_classes = int(self.meta["num_classes"])
        self.sampler_cfg = ClipSamplerConfig(**self.meta["sampler"])
        self.tag_names = (tag_names or self.meta.get("tag_names")
                          or [f"tag_{i}" for i in range(self.num_classes)])
        if len(self.tag_names) != self.num_classes:
            raise ValueError(f"{len(self.tag_names)} tag names for "
                             f"{self.num_classes} classes")
        self._own_workdir = workdir is None
        self.workdir = workdir or tempfile.mkdtemp(prefix="fvt_native_serve_")
        try:
            self.server = NativeServer(package, [(shape, np.uint8)], self.workdir, device=dev,
                                       ready_timeout=ready_timeout, pipeline=pipeline)
        except BaseException:
            # close() never runs without self.server: do not leak the
            # mkdtemp on every failed construction (e.g. a retry loop)
            if self._own_workdir:
                shutil.rmtree(self.workdir, ignore_errors=True)
            raise

    def _score_u8(self, clips_u8: np.ndarray, nclips: int) -> torch.Tensor:
        # a tensor, as scores_from_frames takes a chunk's scores
        return torch.from_numpy(self.server.request([clips_u8])[0][:nclips])

    def _pipelined_scores(self, chunks, num_clips: int) -> np.ndarray:
        """One video's scores with up to pipeline+1 chunk requests in flight
        (the host's decode or pack gather of chunk k+1 overlaps the daemon's
        execution of chunk k). Chunks come from the shared
        ``iter_eval_chunks`` in clip order and the f64 accumulation is
        ``scores_from_frames``': bit-identical to the sequential path."""
        nclips_per_req: list[int] = []

        def requests():
            for clips_u8, nclips in chunks:
                nclips_per_req.append(nclips)
                yield [clips_u8]

        total = np.zeros((self.num_classes,), np.float64)
        depth = max(1, self.server.pipeline + 1)
        for m, outs in enumerate(self.server.request_many(requests(), depth=depth)):
            total += np.asarray(outs[0][:nclips_per_req[m]]).astype(np.float64).sum(axis=0)
        return (total / num_clips).astype(np.float32)

    def video_scores(self, video_path: str) -> np.ndarray:
        if self.server.pipeline <= 0:
            return stream_video_scores(video_path, self.sampler_cfg, self.ship_hw,
                                       self.num_classes, self.clip_batch, self._score_u8)
        # pipelined: the one forward decode pass feeds chunks to the daemon
        # ahead of execution (the reader and overlap cache of
        # stream_video_scores)
        n, reader = open_sequential_reader(video_path, self.sampler_cfg)
        clip_idx = eval_clip_index(n, self.sampler_cfg)
        with reader:
            return self._pipelined_scores(
                iter_eval_chunks(reader.read, clip_idx, self.ship_hw, self.clip_batch),
                clip_idx.shape[0])

    def scores_from(self, read_frames, n_frames: int) -> np.ndarray:
        """Aggregated scores from an arbitrary frame source (e.g. a pack)."""
        return scores_from_frames(read_frames, n_frames, self.sampler_cfg, self.ship_hw,
                                  self.num_classes, self.clip_batch, self._score_u8)

    def iter_pack_scores(self, pack, root: str = ""):
        """Score every video of a pack, keeping requests in flight across
        video boundaries (``NativeServer.request_many``), so that the pack
        gather and staging of the next chunks hide behind the daemon's
        execution of the current one. Yields ``(video_path, scores)`` in
        pack order, bit-identical to the sequential path: the chunks of
        ``iter_eval_chunks`` in the same order, replies in request order,
        each video's f64 accumulation that of ``scores_from_frames``."""
        pack = pack if isinstance(pack, Pack) else Pack(pack)
        recs = pack.records(root)
        meta: list[tuple[int, int]] = []  # per request: (video index, nclips)
        num_clips = [0] * len(recs)

        def requests():
            for i in range(len(recs)):
                clip_idx = eval_clip_index(pack.entries[i]["probe_frames"], self.sampler_cfg)
                num_clips[i] = clip_idx.shape[0]
                for clips_u8, nclips in iter_eval_chunks(
                        lambda idx, _i=i: pack.gather(_i, idx), clip_idx, self.ship_hw,
                        self.clip_batch):
                    meta.append((i, nclips))
                    yield [clips_u8]

        total = np.zeros((self.num_classes,), np.float64)
        done_chunks = 0
        video_i = 0
        depth = max(1, self.server.pipeline + 1)  # pipeline=0 -> sequential
        for m, outs in enumerate(self.server.request_many(requests(), depth=depth)):
            i, nclips = meta[m]
            if i != video_i:
                raise RuntimeError("replies out of pack order")
            total += np.asarray(outs[0][:nclips]).astype(np.float64).sum(axis=0)
            done_chunks += nclips
            if done_chunks == num_clips[i]:
                yield recs[i].path, (total / num_clips[i]).astype(np.float32)
                total = np.zeros((self.num_classes,), np.float64)
                done_chunks = 0
                video_i += 1

    def tag(self, video_path: str, threshold: float = 0.5,
            top_k: int | None = None) -> list[TagResult]:
        return rank_tags(self.video_scores(video_path), self.tag_names,
                         threshold=threshold, top_k=top_k)

    def close(self) -> None:
        self.server.close()
        if self._own_workdir:
            shutil.rmtree(self.workdir, ignore_errors=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
