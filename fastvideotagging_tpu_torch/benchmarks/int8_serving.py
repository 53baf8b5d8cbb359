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
    each a captured CUDA graph (evaluation/graphed.py, as the JAX script
    times jitted engines), timed by CUDA events (the fastest of 5 windows;
    ``serving_throughput`` serves int8_inception too).

    python -m fastvideotagging_tpu_torch.benchmarks.int8_serving --source pack \\
        --out fastvideotagging_tpu_torch/benchmarks/INT8_SERVING.json

``--source`` as in accuracy_hard (``pack`` needs no cv2). The result JSON
records the card's name and power limit. Runs on the card.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import shutil
import tempfile
import time

import numpy as np
import torch

from fastvideotagging_tpu_torch._device import resolve_device
from fastvideotagging_tpu_torch.benchmarks.accuracy_hard import (
    SOURCES,
    LaunchCounter,
    eval_dataset,
    hard_config,
    motion_sources,
)
from fastvideotagging_tpu_torch.benchmarks.kernel_micro import card
from fastvideotagging_tpu_torch.config import ExperimentConfig
from fastvideotagging_tpu_torch.evaluation.evaluate import evaluate_video_scores
from fastvideotagging_tpu_torch.evaluation.graphed import Graphed
from fastvideotagging_tpu_torch.models import heads
from fastvideotagging_tpu_torch.models.zoo import get_model
from fastvideotagging_tpu_torch.ops import int8_conv
from fastvideotagging_tpu_torch.ops.arch_spec import iter_convs, spec_for
from fastvideotagging_tpu_torch.ops.int8_infer import (
    calibrate,
    int8_infer,
    quantize_variables,
    r2plus1d_int8_infer,
)
from fastvideotagging_tpu_torch.ops.preprocess import preprocess_eval_clip
from fastvideotagging_tpu_torch.train.fit import fit
from fastvideotagging_tpu_torch.train.metrics import topk_accuracy
from fastvideotagging_tpu_torch.utils.profiling import window_ms

CALIB_VIDEOS = 16


def int8_hard_config(model_name: str, num_classes: int = 50, epochs: int = 120,
                     batch_size: int = 64, base_lr: float = 0.05, seed: int = 0,
                     clip_grad_norm: float = 0.0, clip_len: int = 8, stride: int = 2,
                     dropout: float = 0.0, kernels: str = "cuda") -> ExperimentConfig:
    """The config the JAX package's int8_s3d / int8_family / int8_inception
    train with: accuracy_hard's, logging every 50 steps."""
    cfg = hard_config(num_classes, epochs, batch_size, base_lr, seed, model_name,
                      clip_grad_norm, clip_len=clip_len, stride=stride, dropout=dropout,
                      kernels=kernels)
    return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, log_every=50))


def train_motion(cfg: ExperimentConfig, root: str, source: str, dev: torch.device):
    """Write the motion set under ``root`` and train ``cfg`` on it: -> (state,
    train source, eval dataset, facts: train seconds, steps, K1-K3 launches)."""
    train_src, eval_src = motion_sources(root, source, cfg.model.num_classes, cfg.train.seed)
    counter = LaunchCounter()
    t0 = time.time()
    with counter("fit"):
        state = fit(cfg, train_src, device=dev)
    facts = dict(train_seconds=round(time.time() - t0, 1), steps=int(state.step),
                 train_launches=counter.counts["fit"])
    state.model.eval()
    return state, train_src, eval_dataset(eval_src, cfg.data, source), facts


def calibration_clips(train_src, cfg: ExperimentConfig, source: str, dev: torch.device,
                      n: int = CALIB_VIDEOS) -> list[torch.Tensor]:
    """The first eval clips of the first ``n`` train videos, preprocessed as
    the engines consume them: the int8 benchmarks' calibration set."""
    ds = eval_dataset(train_src[:n] if source == "mp4" else train_src, cfg.data, source)
    return eval_clips(ds, cfg, dev, n)


def eval_clips(ds, cfg: ExperimentConfig, dev: torch.device, n: int) -> list[torch.Tensor]:
    """The eval clips of the first ``n`` videos of ``ds``, one (K, T, ch, cw,
    3) batch a video, preprocessed as the engines consume them."""
    d = cfg.data
    return [preprocess_eval_clip(
        torch.from_numpy(np.ascontiguousarray(ds.get_eval_clips(i)[0])).to(dev),
        d.resize_hw, d.crop_hw, d.mean, d.std, out_dtype=getattr(torch, cfg.model.compute_dtype))
        for i in range(min(n, len(ds)))]


def int8_convs(spec, float_blocks) -> int:
    """Q1 calls an int8 forward makes: the spec's convs outside its bf16 blocks."""
    return sum(1 for key, _ in iter_convs(spec) if key not in float_blocks)


@contextlib.contextmanager
def _walk_calls(calls: dict):
    """Count the engine walk's calls of Q1 and Q2 into ``calls`` (Q2's
    two-pass dynamic calls, the amax pass, under ``quantize_s8_amax``)."""
    conv, quant = int8_conv.conv3d_s8, int8_conv.quantize_s8

    def counted_conv(*args, **kw):
        calls["conv3d_s8"] += 1
        return conv(*args, **kw)

    def counted_quant(y, inv_f, s=None, amax=None, slot=None):
        calls["quantize_s8"] += 1
        calls["quantize_s8_amax"] += int(s is None and amax is None)
        return quant(y, inv_f, s, amax, slot)

    int8_conv.conv3d_s8, int8_conv.quantize_s8 = counted_conv, counted_quant
    try:
        yield
    finally:
        int8_conv.conv3d_s8, int8_conv.quantize_s8 = conv, quant


@torch.inference_mode()
def forward_launches(apply_fn, qpack, x: torch.Tensor, spec, float_blocks) -> dict:
    """Q1 / Q2 launches of one int8 forward of ``x`` beside the calls the
    engine's walk makes and the Q1 calls ``spec`` predicts outside
    ``float_blocks`` (on the card they agree; the CPU launches nothing). The
    launches are the counts' growth over the forward: nothing is reset.
    ``apply_fn`` is a graphed engine (``make_int8_engine``): the walk is its
    eager one (``apply_fn.fn``: a replay runs no Python); the forward
    counted is ``apply_fn`` itself, after a call that captures its graph."""
    walk = dict.fromkeys(int8_conv.launch_counts, 0)
    with _walk_calls(walk):
        apply_fn.fn(qpack, x)
    apply_fn(qpack, x)
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    before = dict(int8_conv.launch_counts)
    apply_fn(qpack, x)
    return {"clips": int(x.shape[0]),
            "launches": {k: n - before[k] for k, n in int8_conv.launch_counts.items()},
            "walk": walk, "int8_convs": int8_convs(spec, float_blocks)}


# the r2plus1d_18 engine's serving modes: int8_infer's options a run takes
R2PLUS1D_ENGINES = {"int8": {},  # the engine's defaults
                    "int8_dynamic": {"dynamic": True},
                    "int8_exact_residual": {"residual": "exact"}}


@torch.inference_mode()
def serving_throughput(model_name: str = "r2plus1d_18", engines: dict | None = None,
                       batch_size: int = 32, clip_len: int = 16, crop: int = 112,
                       classes: int = 101, iters: int = 20, windows: int = 5,
                       seed: int = 0, calib: int = 4, device: str = "cuda") -> dict:
    """ms per forward and clips/s of the bf16 model (kernels='cuda') and of
    the int8 engine in each mode of ``engines`` ({run: int8_infer options},
    the spec's bf16 blocks unless a mode names its own; R2PLUS1D_ENGINES by
    default), on the same random weights and clips, the qpack calibrated on
    the first ``calib`` clips; each forward a captured CUDA graph
    (``Graphed``, captured in the window that is not kept), as the JAX
    script times each engine as one jitted executable. On the card unless
    ``device='cpu'`` (the host's clock, the forwards eager).

    A run's time is its fastest window, as the JAX package's
    ``bench._timeit_chain`` takes the least of repeated estimates: one window
    swings with the host, whose launches bound these forwards. The runs take
    turns within a window, so a drift of the card's clock reaches all of
    them. -> {"runs": {run: {ms, clips_per_sec, window_ms}}, "timing": ...}."""
    dev = resolve_device(device)
    model = get_model(model_name, num_classes=classes, device=dev,
                      generator=torch.Generator().manual_seed(seed)).eval()
    x = torch.randn((batch_size, clip_len, crop, crop, 3),
                    generator=torch.Generator(device=dev).manual_seed(seed),
                    device=dev).to(torch.bfloat16)
    spec = spec_for(model_name)
    sd = model.state_dict()
    qpack = quantize_variables(sd, calibrate(sd, [x[:calib]], spec=spec), spec=spec)
    runs = {"bf16": functools.partial(Graphed(model, f"the {model_name} bf16 model"), x)}
    for name, opts in (R2PLUS1D_ENGINES if engines is None else engines).items():
        engine = Graphed(functools.partial(int8_infer, spec=spec, **opts),
                         f"the {model_name} {name} engine", reused=(0,))
        runs[name] = functools.partial(engine, qpack, x)
    out = {}
    cuda = dev.type == "cuda"
    for name, ms in window_ms(runs, iters, windows, cuda).items():
        out[name] = dict(ms=round(min(ms), 4), clips_per_sec=round(batch_size / min(ms) * 1e3, 1),
                         window_ms=[round(t, 4) for t in ms])
    return {"runs": out,
            "timing": (f"{'CUDA events' if cuda else 'the host clock'}, the fastest of {windows} "
                       f"windows of {iters} forwards, the runs in turn within a window, after "
                       "one window not kept"
                       + ("; each forward a captured CUDA graph" if cuda else ""))}


def accuracy(num_classes: int = 50, epochs: int = 60, batch_size: int = 64,
             base_lr: float = 0.05, seed: int = 0, source: str = "pack",
             device: str | torch.device = "cuda") -> tuple[float, dict, dict]:
    """-> (bf16 top-1, {sweep point: int8 top-1}, facts of the run)."""
    dev = resolve_device(device)
    root = tempfile.mkdtemp(prefix="fvt_int8_")
    try:
        cfg = hard_config(num_classes, epochs, batch_size, base_lr, seed)
        state, train_src, ds, facts = train_motion(cfg, root, source, dev)
        model = state.model
        sd = model.state_dict()

        scales = calibrate(sd, calibration_clips(train_src, cfg, source, dev))
        qpack = quantize_variables(sd, scales)
        qpacks_margin = {m: quantize_variables(sd, scales, static_margin=m)
                         for m in (1.0, 1.5, 2.0)}

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
        facts.update(eval_videos=len(records), bf16_eval_seconds=round(bf16_s, 2),
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
        tp = serving_throughput()
        rates = tp["runs"]
        result.update({
            "geometry": "B=32 16x112x112, 101 classes, random weights",
            "timing": tp["timing"],
            "bf16_clips_per_sec": rates["bf16"]["clips_per_sec"],
            "int8_clips_per_sec": rates["int8"]["clips_per_sec"],
            "int8_dynamic_clips_per_sec": rates["int8_dynamic"]["clips_per_sec"],
            "int8_exact_residual_clips_per_sec": rates["int8_exact_residual"]["clips_per_sec"],
            "speedup": round(rates["int8"]["clips_per_sec"] / rates["bf16"]["clips_per_sec"], 3),
            "ms_per_forward": {k: v["ms"] for k, v in rates.items()},
        })
    line = json.dumps(result, indent=2)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return result


if __name__ == "__main__":
    main()
