"""int8 PTQ accuracy of the spec-driven engine on trained P3D-63 and C3D
(the port of the JAX package's ``benchmarks/int8_family.py``).

Each backbone trains on the hard 50-class motion benchmark with the JAX
file's config (40 epochs, no grad clip), the engine calibrates on the first
eval clips of 16 train videos (global static margin 2.0) and video-level
top-1 of bf16 is held beside int8's over the JAX file's sweep of bf16
blocks: none (``full_int8``) and the spec's default tail
(``default_tail``, the record's ``int8_top1``). The record adds the
launches of Q1 / Q2 in one forward of each sweep point beside the calls the
engine's walk makes, and K1-K3's over training.

C3D cannot take the JAX file's 8-frame clip: its five temporal pools leave
pool5 empty (the JAX model trains its head's bias alone there; the port's
raises). It trains on ACCURACY_HARD_C3D's recipe instead (``FAMILY_RECIPES``:
16x32x32 at stride 1, grad clip 1.0, lr 0.03), for this file's 40 epochs.

    python -m fastvideotagging_tpu_torch.benchmarks.int8_family --source pack \\
        --out fastvideotagging_tpu_torch/benchmarks/INT8_FAMILY.json

``--source`` as in accuracy_hard. Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import shutil
import tempfile

import numpy as np
import torch

from fastvideotagging_tpu_torch._device import resolve_device
from fastvideotagging_tpu_torch.benchmarks.accuracy_hard import SOURCES, add_pack_dir
from fastvideotagging_tpu_torch.benchmarks.int8_serving import (
    calibration_clips,
    forward_launches,
    int8_hard_config,
    train_motion,
)
from fastvideotagging_tpu_torch.benchmarks.kernel_micro import card
from fastvideotagging_tpu_torch.evaluation.evaluate import evaluate_video_scores
from fastvideotagging_tpu_torch.evaluation.quantized import make_int8_engine
from fastvideotagging_tpu_torch.ops.arch_spec import spec_for
from fastvideotagging_tpu_torch.ops.int8_infer import calibrate, quantize_variables
from fastvideotagging_tpu_torch.train.metrics import topk_accuracy

# where a family departs from the JAX file's config, and why: C3D's pool5
# needs 16 frames, and without norm layers it trains only under a grad clip
# (the C3D record's recipe)
FAMILY_RECIPES = {"c3d": dict(clip_len=16, stride=1, clip_grad_norm=1.0, base_lr=0.03)}


def family_config(model_name: str, num_classes: int = 50, epochs: int = 40,
                  batch_size: int = 64, base_lr: float = 0.05, seed: int = 0):
    """The JAX file's config for ``model_name``, with ``FAMILY_RECIPES``'
    departures."""
    kw = {"base_lr": base_lr, **FAMILY_RECIPES.get(model_name, {})}
    return int8_hard_config(model_name, num_classes, epochs, batch_size, seed=seed, **kw)


def run_model(model_name: str, num_classes: int = 50, epochs: int = 40,
              batch_size: int = 64, base_lr: float = 0.05, seed: int = 0,
              source: str = "mp4", device: str | torch.device = "cuda",
              pack_dir: str | None = None) -> dict:
    dev = resolve_device(device)
    cfg = family_config(model_name, num_classes, epochs, batch_size, base_lr, seed)
    root = tempfile.mkdtemp(prefix=f"fvt_int8_{model_name}_")
    try:
        state, train_src, ds, facts = train_motion(cfg, root, source, dev, pack_dir)
        model = state.model
        sd = model.state_dict()
        spec = spec_for(model_name)
        calib = calibration_clips(train_src, cfg, source, dev)
        qpack = quantize_variables(sd, calibrate(sd, calib, spec=spec), spec=spec)

        bf16_scores, records = evaluate_video_scores(model, sd, ds, cfg, clip_batch=8)
        labels = np.asarray([r.label for r in records])
        x = torch.cat(calib[:2])
        launches = {}

        def int8_top1(name: str, float_blocks) -> float:
            apply = make_int8_engine(model_name, float_blocks=float_blocks, dynamic=False)
            launches[name] = forward_launches(apply, qpack, x, spec, float_blocks)
            scores, _ = evaluate_video_scores(model, qpack, ds, cfg, clip_batch=8,
                                              apply_fn=apply)
            return topk_accuracy(scores, labels, k=1)

        sweep = {"full_int8": (), "default_tail": spec.default_float_blocks}
        top1 = {name: round(int8_top1(name, fb), 4) for name, fb in sweep.items()}
        d, s = cfg.data, cfg.data.sampler
        return {
            "model": model_name,
            "bf16_top1": round(topk_accuracy(bf16_scores, labels, k=1), 4),
            "int8_top1": top1["default_tail"],
            "sweep_top1": top1,
            "default_float_blocks": list(spec.default_float_blocks),
            "epochs": epochs,
            **facts,
            "clip_geometry": f"{s.clip_len}x{d.crop_hw[0]}x{d.crop_hw[1]} (stride {s.stride})",
            "clip_grad_norm": cfg.train.clip_grad_norm,
            "base_lr": cfg.train.base_lr,
            "int8_launches": launches,
        }
    finally:
        shutil.rmtree(root, ignore_errors=True)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", default=None)
    p.add_argument("--epochs", type=int, default=40)
    p.add_argument("--models", nargs="+", default=["p3d_63", "c3d"])
    p.add_argument("--classes", type=int, default=50)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--source", choices=SOURCES, default="mp4")
    add_pack_dir(p)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)
    result = {"benchmark": "int8_ptq_family",
              "task": "hard_synthetic_motion_50 (8x32x32 clips)",
              "results": [run_model(m, num_classes=args.classes, epochs=args.epochs,
                                    batch_size=args.batch, source=args.source,
                                    device=args.device, pack_dir=args.pack_dir)
                          for m in args.models],
              "source": args.source,
              "device": args.device,
              "card": card() if args.device == "cuda" else None}
    line = json.dumps(result, indent=2)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return result


if __name__ == "__main__":
    main()
