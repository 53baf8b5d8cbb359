"""Serving-artifact export CLI (the counterpart of
``fastvideotagging_tpu/cli/export.py``).

Bakes trained weights into the serving program (uint8 preprocess +
backbone + sigmoid/softmax, evaluation/serving.py) and writes deployable
artifacts to ``--out``:

* ``serving.pt2`` — a ``torch.export`` artifact, reloadable by any process
  that imports the port's op library, through
  ``evaluation.serving.load_serving`` (``--format torch``).
* ``serving.native.pt2`` — the same program compiled ahead of time by
  AOTInductor for the no-Python C++ runner (``--format native``; the
  counterpart of the JAX CLI's ``stablehlo``): ``cli.tag`` / ``cli.serve
  --engine native --artifacts DIR`` serve it. ``--format both`` writes both.
* ``meta.json`` — input/output shapes+dtypes, model identity, tag names:
  everything a serving front-end needs to feed the program (the JAX CLI's
  keys; ``artifacts`` names each file, the native package with the device
  it was compiled for).

``--int8`` exports through the PTQ engine (int8 weights + requant
constants baked in as the program's buffers), calibrated on dense clips
from ``--calib-video``: a video file, or a ``.fvtpack`` (each of its
videos) — pass clips representative of production traffic.

    python -m fastvideotagging_tpu_torch.cli.export --weights w.pt --out art/ \
        --model r2plus1d_18 --num-classes 1000 --multilabel \
        --clip-batch 8 [--int8 --calib-video sample.mp4]

The artifacts run on the device they were exported on: the card unless
``--device cpu``. ``--platforms`` (the JAX CLI's cross-platform lowering)
is refused: an AOTInductor package is compiled for the device it is built
on.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from fastvideotagging_tpu_torch.cli.common import add_common_flags, apply_platform, build_config
from fastvideotagging_tpu_torch.config import ExperimentConfig
from fastvideotagging_tpu_torch.data import decode, sampler
from fastvideotagging_tpu_torch.data.frames import _ensure_size
from fastvideotagging_tpu_torch.data.packed import Pack, is_pack
from fastvideotagging_tpu_torch.evaluation.serving import (
    NATIVE_PACKAGE,
    export_serving,
    export_serving_native,
    quantize_for_serving,
)
from fastvideotagging_tpu_torch.train.checkpoint import load_weights
from fastvideotagging_tpu_torch.utils.logging import get_logger

log = get_logger("fvt.export")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__)
    add_common_flags(p)
    p.add_argument("--weights", required=True,
                   help="a weights file of train.checkpoint.export_weights")
    p.add_argument("--out", required=True, help="output artifact directory")
    p.add_argument("--clip-batch", type=int, default=8,
                   help="baked batch size of the serving program")
    p.add_argument("--format", choices=["torch", "native", "both"], default="torch",
                   help="torch: serving.pt2; native: serving.native.pt2 (AOTInductor, "
                        "for the C++ runner); both: the two")
    p.add_argument("--platforms", nargs="*", default=None, metavar="PLAT",
                   help="refused: the artifacts are compiled for the device they are "
                        "exported on (--device)")
    p.add_argument("--tag-names", default=None,
                   help="text file, one tag name per line, copied into "
                        "meta.json")
    p.add_argument("--int8", action="store_true",
                   help="export through the int8 PTQ engine")
    p.add_argument("--calib-video", action="append", default=None,
                   metavar="VIDEO",
                   help="calibration video or .fvtpack for --int8 (repeatable)")
    p.add_argument("--calib-clips", type=int, default=8,
                   help="max calibration clips per video")
    return p.parse_args(argv)


def _dense_clips(cfg: ExperimentConfig, n_frames: int, read, clip_batch: int,
                 max_clips: int) -> np.ndarray:
    """Up to ``max_clips`` eval clips (n, T, H, W, 3) uint8 of a video of
    ``n_frames`` at the ship geometry, tiled to ``clip_batch``."""
    d = cfg.data
    s = d.sampler
    clip_idx = sampler.sample_eval_indices(
        max(int(n_frames), 1), s.clip_len, s.stride, mode=s.eval_mode,
        num_clips=s.num_eval_clips)[:max_clips]
    flat = _ensure_size(read(clip_idx.reshape(-1)), d.source_hw or d.resize_hw)
    clips = flat.reshape(clip_idx.shape + flat.shape[1:])
    if clips.shape[0] < clip_batch:  # pad to the baked batch shape
        reps = -(-clip_batch // clips.shape[0])
        clips = np.concatenate([clips] * reps, axis=0)
    return clips[:clip_batch]


def collect_calib_clips(cfg: ExperimentConfig, video_path: str,
                        clip_batch: int, max_clips: int = 8) -> np.ndarray:
    """Dense-sampled uint8 clips (n, T, H, W, 3) at the serving ship
    geometry — the same decode path the Tagger streams — bounded to
    ``max_clips`` and tiled (not zero-padded: zeros would poison the
    calibration range) to ``clip_batch``."""
    s = cfg.data.sampler
    n_frames, _, _, _ = decode.probe_video(video_path)
    span = (s.clip_len - 1) * s.stride + 1
    with decode.SequentialReader(video_path, cache_size=max(128, 2 * span)) as reader:
        return _dense_clips(cfg, n_frames, reader.read, clip_batch, max_clips)


def collect_pack_calib_clips(cfg: ExperimentConfig, pack_path: str, clip_batch: int,
                             max_clips: int = 8) -> list[np.ndarray]:
    """``collect_calib_clips`` of each video of a ``.fvtpack`` (its frames
    and probed frame count, as ``iter_pack_tags`` samples them)."""
    pack = Pack(pack_path)
    return [_dense_clips(cfg, e["probe_frames"], lambda idx, i=i: pack.gather(i, idx),
                         clip_batch, max_clips)
            for i, e in enumerate(pack.entries)]


FORMATS = ("torch", "native", "both")


def _check_format(fmt: str, platforms) -> None:
    if fmt not in FORMATS:
        raise SystemExit(f"--format {fmt}: one of {', '.join(FORMATS)}")
    if platforms is not None:
        raise SystemExit(
            "--platforms: the artifacts are compiled for the device they are exported on "
            "(--device); there is no cross-platform lowering")


def export_artifacts(cfg: ExperimentConfig, state_dict: dict, out_dir: str,
                     clip_batch: int, fmt: str = "torch", platforms=None,
                     tag_names=None, qpack=None, device="cuda") -> dict:
    """Write the serving artifact(s) of ``fmt`` + meta.json to ``out_dir``;
    returns meta."""
    _check_format(fmt, platforms)
    os.makedirs(out_dir, exist_ok=True)
    d = cfg.data
    h, w = d.source_hw or d.resize_hw
    meta = {
        "model": cfg.model.name,
        "num_classes": cfg.model.num_classes,
        "multilabel": cfg.model.multilabel,
        "compute_dtype": cfg.model.compute_dtype,
        "int8": qpack is not None,
        "clip_batch": clip_batch,
        # host-side serving contract: the program bakes in preprocess
        # (resize/crop/normalize) but clip SAMPLING happens in the
        # front-end — it must follow this spec for parity with tag()
        "sampler": {"clip_len": d.sampler.clip_len,
                    "stride": d.sampler.stride,
                    "eval_mode": d.sampler.eval_mode,
                    "num_eval_clips": d.sampler.num_eval_clips},
        "resize_hw": list(d.resize_hw), "crop_hw": list(d.crop_hw),
        "input": {"shape": [clip_batch, d.sampler.clip_len, h, w, 3],
                  "dtype": "uint8",
                  "layout": "NTHWC raw frames; preprocess is baked in"},
        "output": {"shape": [clip_batch, cfg.model.num_classes],
                   "dtype": "float32",
                   "semantics": ("sigmoid scores" if cfg.model.multilabel
                                 else "softmax probabilities")},
        "platforms": None,
        "tag_names": tag_names,
        "artifacts": {},
    }
    if fmt in ("torch", "both"):
        path = os.path.join(out_dir, "serving.pt2")
        data = export_serving(cfg, state_dict, clip_batch, path=path, qpack=qpack,
                              device=device)
        meta["artifacts"]["torch"] = {"file": "serving.pt2", "bytes": len(data)}
        log.info("export: wrote %s (%d bytes)", path, len(data))
    if fmt in ("native", "both"):
        path = export_serving_native(cfg, state_dict, clip_batch,
                                     os.path.join(out_dir, NATIVE_PACKAGE), qpack=qpack,
                                     device=device)
        meta["artifacts"]["native"] = {"file": NATIVE_PACKAGE, "bytes": os.path.getsize(path),
                                       "device": torch.device(device).type}
        log.info("export: wrote %s (%d bytes)", path, os.path.getsize(path))
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(meta, f, indent=2)
    return meta


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = apply_platform(args)
    cfg = build_config(args)
    _check_format(args.format, args.platforms)

    tag_names = None
    if args.tag_names:
        with open(args.tag_names) as f:
            tag_names = [line.strip() for line in f if line.strip()]
        if len(tag_names) != cfg.model.num_classes:
            raise SystemExit(
                f"{len(tag_names)} tag names for {cfg.model.num_classes} "
                "classes")

    state_dict = load_weights(args.weights)

    qpack = None
    if args.int8:
        if not args.calib_video:
            raise SystemExit("--int8 needs at least one --calib-video")
        calib = []
        for v in args.calib_video:
            if is_pack(v):
                calib += collect_pack_calib_clips(cfg, v, args.clip_batch,
                                                  max_clips=args.calib_clips)
            else:
                calib.append(collect_calib_clips(cfg, v, args.clip_batch,
                                                 max_clips=args.calib_clips))
        try:
            qpack = quantize_for_serving(cfg, state_dict, calib, device=dev)
        except KeyError as e:  # int8 coverage error -> clean CLI failure
            raise SystemExit(e.args[0])

    meta = export_artifacts(cfg, state_dict, args.out, args.clip_batch, fmt=args.format,
                            platforms=args.platforms, tag_names=tag_names, qpack=qpack,
                            device=dev)
    log.info("export: done %s", json.dumps(meta["artifacts"]))
    return meta


if __name__ == "__main__":
    main()
