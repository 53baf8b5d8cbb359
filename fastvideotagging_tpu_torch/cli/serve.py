"""Serving daemon CLI (the counterpart of ``fastvideotagging_tpu/cli/serve.py``).

Loads the model (and the int8 engine) once, then serves tag requests line
by line from stdin until EOF: the deployment shape for batch backfills and
socket front ends (``nc -l | python -m fastvideotagging_tpu_torch.cli.serve
... | ...``), where a process per request would pay the imports, the weight
load and the kernels' first build every time.

A request per line: a bare video path, or a JSON object ``{"video": path,
"threshold"?: float, "top_k"?: int}``. A path ending in ``.fvtpack`` tags
every video of the pack (one response line each, the decode-once tier of
``cli.tag``). A response per line (stdout, flushed): ``{"video", "tags":
[{tag, score}]}`` or ``{"video", "error"}``: a failing request never takes
the daemon down. ``ready`` goes to stderr once the engine is warm.

    python -m fastvideotagging_tpu_torch.cli.serve --weights w.pt \
        --model r2plus1d_18 --num-classes 1000 --tag-names tags.txt [--int8]

Runs on the card unless ``--device cpu``. ``--engine native --artifacts
art/`` serves through the no-Python C++ daemon instead (csrc/native_runner.cpp
on a ``cli.export --format native`` package, loaded once; this process stays
a host-only decode front end). If that daemon dies, the loop stops with
``NativeServerDied`` instead of answering every later request with an
error line.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys

from fastvideotagging_tpu_torch.cli.common import (
    add_common_flags,
    apply_platform,
    build_config,
)
from fastvideotagging_tpu_torch.data.packed import is_pack
from fastvideotagging_tpu_torch.evaluation.tagger import Tagger, iter_pack_tags
from fastvideotagging_tpu_torch.native.runner import NativeServerDied
from fastvideotagging_tpu_torch.train.checkpoint import load_weights

log = logging.getLogger("fvt.serve")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__)
    add_common_flags(p)
    p.add_argument("--weights", default=None,
                   help="a weights file of train.checkpoint.export_weights "
                        "(required with --engine torch)")
    p.add_argument("--engine", choices=["torch", "native"], default="torch",
                   help="torch: in-process engine from --weights. native: the "
                        "no-Python C++ daemon (fvt_native_runner --serve) on the "
                        "package of an export-CLI --artifacts dir; model / data "
                        "flags are then baked in and ignored")
    p.add_argument("--artifacts", default=None,
                   help="cli.export output dir (required with --engine native)")
    p.add_argument("--tag-names", default=None,
                   help="text file, one tag name per line (row = class id)")
    p.add_argument("--threshold", type=float, default=0.5)
    p.add_argument("--top-k", type=int, default=None)
    p.add_argument("--clip-batch", type=int, default=8)
    p.add_argument("--int8", action="store_true",
                   help="serve through the int8 PTQ engine")
    p.add_argument("--warmup", default=None, metavar="VIDEO",
                   help="tag this video (or pack) before reading stdin, so "
                        "that the first request does not pay the kernels' build")
    return p.parse_args(argv)


def _parse_request(line: str) -> dict:
    line = line.strip()
    if line.startswith("{"):
        req = json.loads(line)
        if "video" not in req:
            raise ValueError("request object needs a 'video' key")
        return req
    return {"video": line}


def _tags_json(video: str, results) -> str:
    return json.dumps({
        "video": video,
        "tags": [{"tag": r.tag, "score": round(r.score, 5)} for r in results],
    })


def serve(tagger: Tagger, requests, out, threshold: float = 0.5,
          top_k=None, root: str | None = None) -> dict:
    """Drain ``requests`` (iterable of lines) -> one JSON line each on
    ``out`` (one per video of a pack). Returns counters of requests. Split
    from main() so tests can drive it without a subprocess."""
    if root is None:  # a pack's paths join onto the tagger's data root
        cfg = getattr(tagger, "cfg", None)
        root = (cfg.data.root if cfg is not None else None) or ""
    n_ok = n_err = 0
    for line in requests:
        if not line.strip():
            continue
        video = None
        try:
            req = _parse_request(line)
            video = req["video"]
            th = float(req.get("threshold", threshold))
            k = req.get("top_k", top_k)
            if is_pack(video):
                lines = [_tags_json(path, results) for path, results in iter_pack_tags(
                    tagger, video, threshold=th, top_k=k, root=root)]
            else:
                lines = [_tags_json(video, tagger.tag(video, threshold=th, top_k=k))]
            out.write("".join(ln + "\n" for ln in lines))
            n_ok += 1
        except NativeServerDied:
            # the engine itself is gone: every further request would error
            # too, so fail fast instead of flooding error lines
            raise
        except Exception as e:  # per-request fault isolation
            log.warning("serve: request failed for %r: %s", video or line, e)
            out.write(json.dumps(
                {"video": video or line.strip(), "error": str(e)}) + "\n")
            n_err += 1
        out.flush()
    return {"served": n_ok, "errors": n_err}


def main(argv=None) -> dict:
    args = parse_args(argv)
    tag_names = None
    if args.tag_names:
        with open(args.tag_names) as f:
            tag_names = [line.strip() for line in f if line.strip()]
    if args.engine == "native":
        if not args.artifacts:
            raise SystemExit("--engine native needs --artifacts (an export-CLI output dir)")
        if args.int8:
            raise SystemExit("--int8 is baked at export time for the native engine "
                             "(cli.export --int8)")
        dev = apply_platform(args)
        from fastvideotagging_tpu_torch.evaluation.native_tagger import NativeTagger

        tagger = NativeTagger(args.artifacts, tag_names=tag_names, device=dev)
        root = build_config(args).data.root or ""
    else:
        dev = apply_platform(args)
        if not args.weights:
            raise SystemExit("--engine torch needs --weights")
        cfg = build_config(args)
        tagger = Tagger(cfg, load_weights(args.weights), tag_names,
                        clip_batch=args.clip_batch, int8=args.int8, device=dev)
        root = cfg.data.root or ""
    try:
        if args.warmup:
            if is_pack(args.warmup):
                for _ in iter_pack_tags(tagger, args.warmup, top_k=1):
                    pass
            else:
                tagger.tag(args.warmup, top_k=1)
        print("ready", file=sys.stderr, flush=True)
        stats = serve(tagger, sys.stdin, sys.stdout, threshold=args.threshold,
                      top_k=args.top_k, root=root)
        log.info("serve: done %s", stats)
    finally:
        if hasattr(tagger, "close"):
            tagger.close()  # the native engine owns a daemon and a workdir
    return stats


if __name__ == "__main__":
    main()
