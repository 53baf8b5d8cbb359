"""Chip smoke run of the PyTorch port on one NVIDIA GPU (an H100 for the
numbers the repo keeps).

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) if it fails:

1. card   — name, power limit and device count;
2. build  — compile every csrc/*.cu kernel (one nvcc per source, in
            parallel) and print ptxas' register / shared memory report;
3. kernels — K1 (spatial 1xkxk) and K2 (temporal kx1x1) at every shape of
            the R(2+1)D-18 serving path (clip_batch 8, 16x112x112, bf16):
            kernel vs its plain PyTorch version, and times of the kernel,
            the plain version and F.conv3d (cuDNN, TF32 off) on the same
            tensors, beside the least time the card could take;
4. path   — the port's Tagger (r2plus1d_18, 400 classes, multilabel, bf16,
            kernels='cuda', seeded random weights) on seeded synthetic
            frames through ``scores_from``: launch counts per forward,
            finite scores, agreement with the kernels='torch' tagger and
            with an f32 reference forward, clips/s of both taggers.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. Exits non-zero, printing no
result, when no CUDA device is present.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from fastvideotagging_tpu_torch import Tagger, get_model
from fastvideotagging_tpu_torch.config import (
    ClipSamplerConfig,
    DataConfig,
    ExperimentConfig,
    ModelConfig,
)
from fastvideotagging_tpu_torch.data.synthetic import make_frames
from fastvideotagging_tpu_torch.models.layers import r2plus1d_mid_channels
from fastvideotagging_tpu_torch.ops import _build
from fastvideotagging_tpu_torch.ops import conv2plus1d as ops

# Published H100 SXM peaks (dense bf16 tensor-core rate, HBM3 bandwidth).
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_S = 3.35e12

CLIP_BATCH = 8
SEED = 0
# kernel vs plain version: both take the same bf16 inputs and sum in f32;
# they differ by summation order and the bf16 rounding of the output
# (2^-8 relative), so 1e-2 of the output's largest magnitude.
KERNEL_TOL = 1e-2
# path: the kernels='cuda' and kernels='torch' taggers round to bf16 at
# different places; logits agree within 5e-2 of the largest |logit|
# (the model-level bound of tests/test_fused_infer.py), scores within 5e-2.
PATH_TOL = 5e-2

KERNELS = {
    "spatial_conv": dict(
        name="spatial_conv_kernel", route="cuda",
        source="fastvideotagging_tpu_torch/csrc/conv2plus1d.cu",
        replaces="fastvideotagging_tpu/ops/conv2plus1d.py:94 (_spatial_pallas)"),
    "temporal_conv": dict(
        name="temporal_conv_kernel", route="cuda",
        source="fastvideotagging_tpu_torch/csrc/conv2plus1d.cu",
        replaces="fastvideotagging_tpu/ops/conv2plus1d.py:225 (_temporal_pallas)"),
}


def path_sites(b: int = CLIP_BATCH):
    """The stride-1, kernel-eligible (2+1)D conv sites of r2plus1d_18 at
    16x112x112: (site, kernel, x shape (B,T,H,W,C), Co, launches/forward)."""
    sites = [("stem_temporal", "temporal_conv", (b, 16, 56, 56, 45), 64, 1)]
    t, hw = 16, 56
    for stage in range(4):
        c = 64 * 2 ** stage
        if stage:
            t, hw = t // 2, hw // 2
        m = r2plus1d_mid_channels(c, c)
        n = 4 if stage == 0 else 3  # stage entries (stride 2) go to F.conv3d
        sites.append((f"stage{stage + 1}_spatial", "spatial_conv", (b, t, hw, hw, c), m, n))
        sites.append((f"stage{stage + 1}_temporal", "temporal_conv", (b, t, hw, hw, m), c, n))
    return sites


def bound(kernel: str, x_shape, co: int, k: int = 3):
    b, t, h, w, c = x_shape
    taps = k * k if kernel == "spatial_conv" else k
    flops = 2.0 * b * t * h * w * taps * c * co
    nbytes = 2.0 * (b * t * h * w * (c + co) + taps * c * co)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def time_ms(fn, iters: int, warmup: int = 2) -> float:
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


def phase_card() -> str:
    print("== phase 1: card", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0])
    kind = torch.cuda.get_device_name(0)
    print(f"torch.cuda.get_device_name(0)={kind} device_count={torch.cuda.device_count()} "
          f"torch={torch.__version__} cuda={torch.version.cuda}")
    return smi.splitlines()[0]


def phase_build() -> None:
    print("== phase 2: build", flush=True)
    t0 = time.perf_counter()
    reports = _build.build_all()
    print(f"built {sorted(reports)} in {time.perf_counter() - t0:.1f} s")
    for name, report in reports.items():
        print(f"-- ptxas report for {name}.cu:")
        print(report.strip())


def phase_kernels(card: str) -> dict:
    print("== phase 3: kernels", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(SEED)
    dev = torch.device("cuda")
    agg = {k: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
                   library_ms=0.0, ops_ms=0.0, bytes_ms=0.0, ok=True, sites=[])
           for k in KERNELS}
    failures = []
    for site, kernel, xs, co, n in path_sites():
        b, t, h, w, c = xs
        k = 3
        x5 = torch.randn(xs, generator=g, device=dev).to(torch.bfloat16)
        if kernel == "spatial_conv":
            x = x5.reshape(b * t, h, w, c)
            wt = (torch.randn((k, k, c, co), generator=g, device=dev)
                  / (k * k * c) ** 0.5).to(torch.bfloat16)
            run, plain = ops.spatial_conv_cuda, ops.spatial_conv_plain
            w5 = wt[None]
            lib = lambda: ops.conv3d_nthwc(x5, w5, (1, 1, 1), (0, 1, 1))  # noqa: E731
        else:
            x = x5.reshape(b, t, h * w, c)
            wt = (torch.randn((k, c, co), generator=g, device=dev)
                  / (k * c) ** 0.5).to(torch.bfloat16)
            run, plain = ops.temporal_conv_cuda, ops.temporal_conv_plain
            w5 = wt[:, None, None]
            lib = lambda: ops.conv3d_nthwc(x5, w5, (1, 1, 1), (1, 0, 0))  # noqa: E731
        got = run(x, wt)
        torch.cuda.synchronize()
        ref = plain(x, wt)
        libout = lib()
        torch.cuda.synchronize()
        diff = (got.float() - ref.float()).abs()
        scale = ref.float().abs().max().item()
        max_abs = diff.max().item()
        max_rel = max_abs / scale
        lib_rel = (libout.reshape(ref.shape).float() - ref.float()).abs().max().item() / scale
        ok = bool(torch.isfinite(got).all().item()) and max_rel <= KERNEL_TOL
        ms = time_ms(lambda: run(x, wt), iters=20)
        plain_ms = time_ms(lambda: plain(x, wt), iters=5, warmup=1)
        library_ms = time_ms(lib, iters=20)
        bound_ms, by = bound(kernel, xs, co)
        print(f"{site:18s} {kernel:14s} x={xs} Co={co} x{n}/forward  "
              f"max_abs_err={max_abs:.3e} max_rel_err={max_rel:.3e} "
              f"(tol {KERNEL_TOL}; F.conv3d vs plain {lib_rel:.3e}) "
              f"kernel={ms:.4f} ms plain={plain_ms:.4f} ms F.conv3d={library_ms:.4f} ms "
              f"bound={bound_ms * 1e3:.1f} us ({by}) ok={ok}", flush=True)
        if not ok:
            failures.append(site)
        a = agg[kernel]
        a["max_abs_err"] = max(a["max_abs_err"], max_abs)
        a["ok"] = a["ok"] and ok
        for key, v in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", library_ms),
                       ("bound_ms", bound_ms)):
            a[key] += n * v
        a["ops_ms" if by == "operations" else "bytes_ms"] += n * bound_ms
        a["sites"].append(dict(site=site, x=list(xs), co=co, launches_per_forward=n,
                               max_abs_err=max_abs, max_rel_err=max_rel, ms=ms,
                               plain_ms=plain_ms, library_ms=library_ms,
                               bound_ms=bound_ms, bound_by=by))
        del x5, x, wt, got, ref, libout, diff
    print(f"per-forward sums (launches x time, {card}):")
    for kernel, a in agg.items():
        print(f"  {kernel}: kernel {a['ms']:.4f} ms, plain {a['plain_ms']:.4f} ms, "
              f"F.conv3d {a['library_ms']:.4f} ms, bound {a['bound_ms']:.4f} ms")
    if failures:
        raise SystemExit(f"kernel disagrees with its plain version at {failures}")
    return agg


def _cfg(kernels: str, compute_dtype: str = "bfloat16") -> ExperimentConfig:
    return ExperimentConfig(
        model=ModelConfig(name="r2plus1d_18", num_classes=400, multilabel=True,
                          kernels=kernels, compute_dtype=compute_dtype),
        data=DataConfig(sampler=ClipSamplerConfig(clip_len=16, eval_mode="dense")),
    )


def phase_path(card: str) -> dict:
    print("== phase 4: path", flush=True)
    g = torch.Generator().manual_seed(SEED)
    state = get_model("r2plus1d_18", num_classes=400, device="cpu",
                      generator=g).state_dict()
    frames = make_frames(3, num_frames=160, height=128, width=171, seed=SEED)

    def read_frames(idx):
        return frames[idx]

    n_clips = 160 // 16
    chunks = -(-n_clips // CLIP_BATCH)
    cuda_tagger = Tagger(_cfg("cuda"), state, clip_batch=CLIP_BATCH, device="cuda")
    torch_tagger = Tagger(_cfg("torch"), state, clip_batch=CLIP_BATCH, device="cuda")

    ops.reset_launch_counts()
    scores = cuda_tagger.scores_from(read_frames, len(frames))
    launches = dict(ops.launch_counts)
    print(f"launches over {chunks} chunks: {launches}")
    want = {"spatial_conv": 13 * chunks, "temporal_conv": 14 * chunks}
    if launches != want:
        raise SystemExit(f"launch counts {launches} != {want}")
    if scores.shape != (400,) or not np.isfinite(scores).all():
        raise SystemExit(f"bad scores: shape {scores.shape}, finite {np.isfinite(scores).all()}")
    ref_scores = torch_tagger.scores_from(read_frames, len(frames))
    score_err = float(np.abs(scores - ref_scores).max())
    print(f"scores: cuda vs torch tagger max abs diff {score_err:.3e} (tol {PATH_TOL}); "
          f"top-5 cuda {np.argsort(-scores)[:5].tolist()} torch {np.argsort(-ref_scores)[:5].tolist()}")
    if score_err > PATH_TOL:
        raise SystemExit("scores of the kernels='cuda' tagger disagree with kernels='torch'")

    # Logits of one chunk: both bf16 paths against an f32 reference forward
    # (F.conv3d, TF32 off).
    torch.backends.cudnn.allow_tf32 = False
    clip_idx = np.arange(CLIP_BATCH * 16).reshape(CLIP_BATCH, 16)
    clips_u8 = torch.from_numpy(frames[clip_idx]).cuda()
    from fastvideotagging_tpu_torch.ops.preprocess import preprocess_eval_clip
    d = cuda_tagger.cfg.data
    f32_model = get_model("r2plus1d_18", num_classes=400, device="cuda", backend="torch",
                          dtype=torch.float32)
    f32_model.load_state_dict(state)
    with torch.inference_mode():
        x32 = preprocess_eval_clip(clips_u8, d.resize_hw, d.crop_hw, d.mean, d.std,
                                   out_dtype=torch.float32)
        ref = f32_model(x32)
        lc = cuda_tagger.model(x32.to(torch.bfloat16))
        lt = torch_tagger.model(x32.to(torch.bfloat16))
        torch.cuda.synchronize()
        scale = ref.abs().max().item()
        err_cuda = (lc - ref).abs().max().item() / scale
        err_torch = (lt - ref).abs().max().item() / scale
        err_ct = (lc - lt).abs().max().item() / scale
        fwd_ms = {name: time_ms(lambda m=m: m(x32.to(torch.bfloat16)), iters=10)
                  for name, m in (("cuda", cuda_tagger.model), ("torch", torch_tagger.model))}
    print(f"logits (8 clips): max|logit| {scale:.3f}; max abs err / max|logit| vs the f32 "
          f"reference: kernels='cuda' {err_cuda:.3e}, kernels='torch' {err_torch:.3e}; "
          f"cuda vs torch {err_ct:.3e} (tol {PATH_TOL})")
    if not (err_ct <= PATH_TOL and err_cuda <= PATH_TOL):
        raise SystemExit("logits of the kernels='cuda' model disagree")

    rates = {}
    for name, tagger in (("cuda", cuda_tagger), ("torch", torch_tagger)):
        runs = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tagger.scores_from(read_frames, len(frames))
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - t0)
        rates[name] = n_clips / float(np.median(runs))
        print(f"kernels='{name}': {rates[name]:.2f} clips/s through scores_from "
              f"({n_clips} clips, {chunks} chunks of {CLIP_BATCH}, median of 5), "
              f"forward of 8 clips {fwd_ms[name]:.3f} ms (CUDA events) on {card}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 2
    card = phase_card()
    phase_build()
    agg = phase_kernels(card)
    launches = phase_path(card)
    entries = []
    for kernel, meta in KERNELS.items():
        a = agg[kernel]
        entries.append(dict(
            meta, launches=launches[kernel], max_abs_err=a["max_abs_err"],
            ms=a["ms"], plain_ms=a["plain_ms"], bound_ms=a["bound_ms"],
            bound_by="operations" if a["ops_ms"] >= a["bytes_ms"] else "bytes",
            library_ms=a["library_ms"], ok=a["ok"], bound_us=a["bound_ms"] * 1e3,
            per="one r2plus1d_18 forward at clip_batch 8 (sum over its launches)",
            sites=a["sites"]))
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
