"""int8 PTQ serving benchmark: accuracy and throughput against the bf16
engine (the port of the JAX package's ``benchmarks/int8_serving.py``).

Trains r2plus1d_18 on the hard 50-class motion benchmark
(benchmarks/accuracy_hard.py's recipe, field for field), calibrates the int8
engine on the first eval clips of 16 train videos, then reports:

  * bf16 against int8 video-level top-1 on the held-out set (the same clip
    sampling and aggregation for both engines), over the JAX file's sweep:
    which blocks stay bf16, the dynamic scales, the static margin, the exact
    residual;
  * serving throughput (clips/s at B = 32, 16x112x112, random weights:
    throughput does not depend on them) of the bf16 model (kernels='cuda')
    against the int8 engine static, dynamic and with the exact residual,
    timed by CUDA events.

    python -m fastvideotagging_tpu_torch.benchmarks.int8_serving --source pack \\
        --out fastvideotagging_tpu_torch/benchmarks/INT8_SERVING.json

``--source`` as in accuracy_hard (``pack`` needs no cv2). The result JSON
records the card's name and power limit. Runs on the card.
"""

from __future__ import annotations

import argparse
import json
import shutil
import tempfile
import time

import numpy as np
import torch

from fastvideotagging_tpu_torch._device import resolve_device
from fastvideotagging_tpu_torch.benchmarks.accuracy_hard import (
    SOURCES,
    _check_source,
    _packs,
    hard_config,
)
from fastvideotagging_tpu_torch.benchmarks.kernel_micro import card
from fastvideotagging_tpu_torch.data import synthetic_motion
from fastvideotagging_tpu_torch.data.packed import PackedDataset
from fastvideotagging_tpu_torch.data.pipeline import ClipDataset
from fastvideotagging_tpu_torch.data.ucf101 import load_video_list
from fastvideotagging_tpu_torch.evaluation.evaluate import evaluate_video_scores
from fastvideotagging_tpu_torch.models import heads
from fastvideotagging_tpu_torch.models.zoo import get_model
from fastvideotagging_tpu_torch.ops.int8_infer import (
    calibrate,
    quantize_variables,
    r2plus1d_int8_infer,
)
from fastvideotagging_tpu_torch.ops.preprocess import preprocess_eval_clip
from fastvideotagging_tpu_torch.train.fit import fit
from fastvideotagging_tpu_torch.train.metrics import topk_accuracy

CALIB_VIDEOS = 16


def _event_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


@torch.inference_mode()
def serving_throughput(batch_size: int = 32, clip_len: int = 16, crop: int = 112,
                       classes: int = 101, iters: int = 10, seed: int = 0) -> dict:
    """ms per forward and clips/s of the bf16 model and of the int8 engine's
    three modes on the same random weights and clips, on the card."""
    dev = resolve_device("cuda")
    model = get_model("r2plus1d_18", num_classes=classes, device=dev,
                      generator=torch.Generator().manual_seed(seed))
    model.eval()
    x = torch.randn((batch_size, clip_len, crop, crop, 3),
                    generator=torch.Generator(device=dev).manual_seed(seed),
                    device=dev).to(torch.bfloat16)
    sd = model.state_dict()
    qpack = quantize_variables(sd, calibrate(sd, [x[:4]]))
    runs = {
        "bf16": lambda: model(x),
        "int8": lambda: r2plus1d_int8_infer(qpack, x),  # the engine's defaults
        "int8_dynamic": lambda: r2plus1d_int8_infer(qpack, x, dynamic=True),
        "int8_exact_residual": lambda: r2plus1d_int8_infer(qpack, x, residual="exact"),
    }
    out = {}
    for name, fn in runs.items():
        ms = _event_ms(fn, iters)
        out[name] = dict(ms=ms, clips_per_sec=batch_size / ms * 1e3)
    return out


def accuracy(num_classes: int = 50, epochs: int = 60, batch_size: int = 64,
             base_lr: float = 0.05, seed: int = 0, source: str = "pack",
             device: str | torch.device = "cuda") -> tuple[float, dict, dict]:
    """-> (bf16 top-1, {sweep point: int8 top-1}, facts of the run)."""
    _check_source(source)
    dev = resolve_device(device)
    root = tempfile.mkdtemp(prefix="fvt_int8_")
    try:
        if source == "mp4":
            train_list, eval_list = synthetic_motion.make_motion_dataset(
                root, num_classes=num_classes, seed=seed)
            train_src = load_video_list(train_list, root=root)
            eval_src = load_video_list(eval_list, root=root)
        else:
            train_src, eval_src = _packs(root, synthetic_motion.iter_motion_videos(
                num_classes, seed=seed), None)
        cfg = hard_config(num_classes, epochs, batch_size, base_lr, seed)
        t0 = time.time()
        state = fit(cfg, train_src, device=dev)
        train_s = time.time() - t0
        model = state.model.eval()
        sd = model.state_dict()

        def dataset(src, n=None):
            if source == "mp4":
                return ClipDataset(src[:n] if n else src, cfg.data, mode="eval")
            return PackedDataset(src, cfg.data, mode="eval")

        # calibration: the first eval clips of a few TRAIN videos, preprocessed
        # as the engines consume them
        d = cfg.data
        train_ds = dataset(train_src, CALIB_VIDEOS)
        calib = [preprocess_eval_clip(
            torch.from_numpy(np.ascontiguousarray(train_ds.get_eval_clips(i)[0])).to(dev),
            d.resize_hw, d.crop_hw, d.mean, d.std, out_dtype=torch.bfloat16)
            for i in range(min(CALIB_VIDEOS, len(train_ds)))]
        scales = calibrate(sd, calib)
        qpack = quantize_variables(sd, scales)
        qpacks_margin = {m: quantize_variables(sd, scales, static_margin=m)
                         for m in (1.0, 1.5, 2.0)}

        ds = dataset(eval_src)
        t0 = time.time()
        bf16_scores, records = evaluate_video_scores(model, sd, ds, cfg, clip_batch=8)
        bf16_s = time.time() - t0

        def int8_scores_for(float_blocks, dynamic=False, qp=None, residual="dequant"):
            def apply(q, x):
                return heads.predict_scores(r2plus1d_int8_infer(
                    q, x, float_blocks=float_blocks, dynamic=dynamic, residual=residual), False)
            scores, _ = evaluate_video_scores(model, qp or qpack, ds, cfg, clip_batch=8,
                                              apply_fn=apply)
            return scores

        labels = np.asarray([r.label for r in records])
        all_blocks = tuple(f"stage{s + 1}_block{b}" for s in range(4) for b in range(2))
        sweep = {
            "full_int8": (),
            "stage4_float": ("stage4_block0", "stage4_block1"),
            "stage34_float": ("stage3_block0", "stage3_block1",
                              "stage4_block0", "stage4_block1"),
            "stage234_float": ("stage2_block0", "stage2_block1",
                               "stage3_block0", "stage3_block1",
                               "stage4_block0", "stage4_block1"),
            "stem_only_int8": all_blocks,
        }
        t0 = time.time()
        top1 = {name: topk_accuracy(int8_scores_for(fb), labels, k=1)
                for name, fb in sweep.items()}
        int8_s = (time.time() - t0) / len(sweep)
        top1["stage4_float_dynamic"] = topk_accuracy(
            int8_scores_for(sweep["stage4_float"], dynamic=True), labels, k=1)
        for m, qp in qpacks_margin.items():
            top1[f"stage4_float_margin{m}"] = topk_accuracy(
                int8_scores_for(sweep["stage4_float"], qp=qp), labels, k=1)
        top1["stage4_float_exact_residual"] = topk_accuracy(
            int8_scores_for(sweep["stage4_float"], residual="exact"), labels, k=1)
        facts = dict(train_seconds=round(train_s, 1), steps=int(state.step),
                     eval_videos=len(records), bf16_eval_seconds=round(bf16_s, 2),
                     int8_eval_seconds=round(int8_s, 2))
        return topk_accuracy(bf16_scores, labels, k=1), top1, facts
    finally:
        shutil.rmtree(root, ignore_errors=True)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", default=None)
    p.add_argument("--epochs", type=int, default=60)
    p.add_argument("--classes", type=int, default=50)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--source", choices=SOURCES, default="mp4")
    p.add_argument("--skip-throughput", action="store_true")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)

    bf16_top1, sweep_top1, facts = accuracy(num_classes=args.classes, epochs=args.epochs,
                                            batch_size=args.batch, source=args.source,
                                            device=args.device)
    result = {
        "benchmark": "int8_ptq_serving",
        "scheme": ("per-out-channel int8 weights with folded smoothing factors (clamped 10x "
                   "band); static per-site scales with 2x headroom (default) or dynamic "
                   "per-tensor scales; stage 4 in bf16"),
        "bf16_top1": round(bf16_top1, 4),
        "sweep_top1": {k: round(v, 4) for k, v in sweep_top1.items()},
        "int8_top1": round(sweep_top1["stage4_float"], 4),
        "epochs": args.epochs,
        "source": args.source,
        **facts,
        "device": args.device,
        "card": card() if args.device == "cuda" else None,
    }
    if not args.skip_throughput:
        rates = serving_throughput()
        result.update({
            "geometry": "B=32 16x112x112, 101 classes, random weights",
            "timing": "CUDA events, 10 forwards after 2 warm-up",
            "bf16_clips_per_sec": round(rates["bf16"]["clips_per_sec"], 1),
            "int8_clips_per_sec": round(rates["int8"]["clips_per_sec"], 1),
            "int8_dynamic_clips_per_sec": round(rates["int8_dynamic"]["clips_per_sec"], 1),
            "int8_exact_residual_clips_per_sec": round(
                rates["int8_exact_residual"]["clips_per_sec"], 1),
            "speedup": round(rates["int8"]["clips_per_sec"] / rates["bf16"]["clips_per_sec"], 3),
            "ms_per_forward": {k: round(v["ms"], 4) for k, v in rates.items()},
        })
    line = json.dumps(result, indent=2)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return result


if __name__ == "__main__":
    main()
