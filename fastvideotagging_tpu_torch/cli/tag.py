"""Tag CLI (the counterpart of ``fastvideotagging_tpu/cli/tag.py``).

    python -m fastvideotagging_tpu_torch.cli.tag video.mp4 --weights w.pt \
        --model r2plus1d_18 --num-classes 1000 --multilabel --tag-names tags.txt

``--weights`` is a file of ``train.checkpoint.export_weights``. A
``.fvtpack`` argument tags every video in the pack (the decode-once
backfill tier). One JSON line per video: ``{"video", "tags": [{"tag",
"score"}]}``, scores rounded to 5 places. ``--int8`` serves through the
int8 engine, self-calibrated per video. Runs on the card unless
``--device cpu``.

``--engine native --artifacts art/`` scores through the long-running C++
daemon (csrc/native_runner.cpp) on a ``cli.export --format native``
package instead of the in-process engine; for packs the daemon pipelines:
``--pipeline K`` requests are staged ahead while the device executes, with
bit-identical aggregation. The sampler, the clip batch and ``--int8`` are
baked into the package (its meta.json).
"""

from __future__ import annotations

import argparse
import json
import sys

from fastvideotagging_tpu_torch.cli.common import (
    add_common_flags,
    apply_platform,
    build_config,
)
from fastvideotagging_tpu_torch.data.packed import is_pack
from fastvideotagging_tpu_torch.evaluation.tagger import Tagger, iter_pack_tags
from fastvideotagging_tpu_torch.train.checkpoint import load_weights


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    add_common_flags(p)
    p.add_argument("videos", nargs="+",
                   help="video file(s) and/or .fvtpack pack(s) to tag")
    p.add_argument("--weights", default=None,
                   help="a weights file of train.checkpoint.export_weights "
                        "(required with --engine torch)")
    p.add_argument("--tag-names", default=None,
                   help="text file, one tag name per line (row = class id)")
    p.add_argument("--threshold", type=float, default=0.5)
    p.add_argument("--top-k", type=int, default=None)
    p.add_argument("--clip-batch", type=int, default=8)
    p.add_argument("--int8", action="store_true",
                   help="serve through the int8 PTQ engine (self-calibrates "
                        "on each video's first chunk)")
    p.add_argument("--engine", choices=["torch", "native"], default="torch",
                   help="torch: in-process engine from --weights. native: the C++ "
                        "daemon from --artifacts (Python stays a host-only decode "
                        "front end)")
    p.add_argument("--artifacts", default=None,
                   help="export-CLI artifact dir (required with --engine native)")
    p.add_argument("--pipeline", type=int, default=2,
                   help="native engine: requests staged ahead of execution in the "
                        "daemon; bulk pack tagging keeps this many chunks in flight "
                        "(0 = strictly sequential)")
    args = p.parse_args(argv)
    dev = apply_platform(args)
    cfg = build_config(args)

    tag_names = None
    if args.tag_names:
        with open(args.tag_names) as f:
            tag_names = [line.strip() for line in f if line.strip()]

    if args.engine == "native":
        if not args.artifacts:
            raise SystemExit("--engine native needs --artifacts (an export-CLI directory: "
                             "serving.native.pt2 + meta.json)")
        if args.int8:
            raise SystemExit("--int8 is baked at export time for the native engine "
                             "(cli.export --int8)")
        # The native engine's sampling and batch are frozen in the exported
        # meta.json: these flags are refused rather than ignored.
        raw = list(argv) if argv is not None else sys.argv[1:]
        frozen = {"--weights", "--clip-len", "--stride", "--eval-mode", "--num-eval-clips",
                  "--clip-batch", "--resize", "--crop"}
        offending = sorted(frozen.intersection(raw))
        if offending:
            raise SystemExit(
                f"{' '.join(offending)}: fixed at export time for --engine native (see "
                f"{args.artifacts}/meta.json); re-export with cli.export to change them")
        from fastvideotagging_tpu_torch.evaluation.native_tagger import NativeTagger

        tagger = NativeTagger(args.artifacts, tag_names=tag_names, pipeline=args.pipeline,
                              device=dev)
    else:
        if not args.weights:
            raise SystemExit("--engine torch needs --weights")
        tagger = Tagger(cfg, load_weights(args.weights), tag_names,
                        clip_batch=args.clip_batch, int8=args.int8, device=dev)

    def emit(video, results):
        print(json.dumps({
            "video": video,
            "tags": [{"tag": r.tag, "score": round(r.score, 5)}
                     for r in results],
        }))

    try:
        for video in args.videos:
            if is_pack(video):
                for path, results in iter_pack_tags(
                        tagger, video, threshold=args.threshold,
                        top_k=args.top_k, root=cfg.data.root or ""):
                    emit(path, results)
            else:
                emit(video, tagger.tag(video, threshold=args.threshold,
                                       top_k=args.top_k))
    finally:
        if hasattr(tagger, "close"):
            tagger.close()  # the native engine owns a daemon and a workdir


if __name__ == "__main__":
    main()
