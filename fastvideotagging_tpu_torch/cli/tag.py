"""Tag CLI (the counterpart of ``fastvideotagging_tpu/cli/tag.py``).

    python -m fastvideotagging_tpu_torch.cli.tag video.mp4 --weights w.pt \
        --model r2plus1d_18 --num-classes 1000 --multilabel --tag-names tags.txt

``--weights`` is a file of ``train.checkpoint.export_weights``. A
``.fvtpack`` argument tags every video in the pack (the decode-once
backfill tier). One JSON line per video: ``{"video", "tags": [{"tag",
"score"}]}``, scores rounded to 5 places. ``--int8`` serves through the
int8 engine, self-calibrated per video. Runs on the card unless
``--device cpu``. Not ported yet: ``--engine native``, ``--artifacts`` and
``--pipeline`` (the C++ daemon, ROADMAP.md Queue A item 6).
"""

from __future__ import annotations

import argparse
import json

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
                   help="torch: in-process engine from --weights; native: not "
                        "ported yet (ROADMAP.md Queue A item 6)")
    p.add_argument("--artifacts", default=None,
                   help="not ported yet (ROADMAP.md Queue A item 6)")
    p.add_argument("--pipeline", type=int, default=None,
                   help="not ported yet (ROADMAP.md Queue A item 6)")
    args = p.parse_args(argv)
    dev = apply_platform(args)
    cfg = build_config(args)
    if args.engine == "native" or args.artifacts is not None or args.pipeline is not None:
        raise NotImplementedError(
            "--engine native, --artifacts and --pipeline need the C++ serving "
            "daemon, which is not ported yet (ROADMAP.md Queue A item 6)")
    if not args.weights:
        raise SystemExit("--engine torch needs --weights")

    tag_names = None
    if args.tag_names:
        with open(args.tag_names) as f:
            tag_names = [line.strip() for line in f if line.strip()]
    tagger = Tagger(cfg, load_weights(args.weights), tag_names,
                    clip_batch=args.clip_batch, int8=args.int8, device=dev)

    def emit(video, results):
        print(json.dumps({
            "video": video,
            "tags": [{"tag": r.tag, "score": round(r.score, 5)}
                     for r in results],
        }))

    for video in args.videos:
        if is_pack(video):
            for path, results in iter_pack_tags(
                    tagger, video, threshold=args.threshold,
                    top_k=args.top_k, root=cfg.data.root or ""):
                emit(path, results)
        else:
            emit(video, tagger.tag(video, threshold=args.threshold,
                                   top_k=args.top_k))


if __name__ == "__main__":
    main()
