"""Micro-benchmark of the temporal (k x 1 x 1) conv's kernel designs on the
card: the port of the JAX package's ``benchmarks/kernel_micro.py``.

    python -m fastvideotagging_tpu_torch.benchmarks.kernel_micro
        [--shape tpu1|faithful1|tpu2] [--k 3] [--device cuda|cpu]

At one of three fixed shapes (``SHAPES``, B = 32) it runs the five designs
of ``ops/temporal_micro.py`` (K5 v2: pad + halo'd slab; K6 v3: no pad,
clipped row-shifted taps, and its dx; K8 v3p: packed taps; K7 / K9: the dw
without and with the pad) beside the library's conv (``F.conv3d``,
``torch.nn.grad.conv3d_input`` / ``conv3d_weight``; cuDNN, TF32 off).
Inputs come from numpy's ``default_rng(0)`` in the JAX file's order (x,
w * 0.05, g), cast to bf16.

Parity first, in the JAX file's order and then for every other timed
design: each kernel against the library call on the same inputs taken to
f32 (TF32 off), within 1e-2 of the reference's largest magnitude for the
bf16 forward and dx outputs (their rounding), 1e-3 for the f32 dw.
Unlike the JAX file, a kernel outside its tolerance raises (non-zero
exit). Then one timed row per design under the JAX file's names: CUDA
events over back-to-back calls after a warm-up (the JAX file's evolving
input chain and overhead rung defeat a TPU runtime's dedupe and have no
counterpart here), with TFLOP/s, GB/s and the share of the least time the
card could take (each input and output byte moved once at 3.35 TB/s, the
taps inside [0, T) at 989 TFLOP/s; H100 SXM data sheet). The card's name
and power limit are printed beside the numbers.

It runs on the card unless ``--device cpu`` is given (the kernels then take
their plain versions, and only host times are printed); without a card it
raises.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from fastvideotagging_tpu_torch._device import resolve_device
from fastvideotagging_tpu_torch.ops import temporal_micro as micro
from fastvideotagging_tpu_torch.ops.conv2plus1d import conv3d_nthwc

SHAPES = {
    # (B, T, S, Cin, Cout): _tpu stage1 (full lanes), faithful stage1,
    # _tpu stage2 (after stride-2: T=8, S=28*28).
    "tpu1": (32, 16, 56 * 56, 128, 128),
    "faithful1": (32, 16, 56 * 56, 144, 64),
    "tpu2": (32, 8, 28 * 28, 256, 128),
}

# Published H100 SXM peaks (dense bf16 tensor-core rate, HBM3 bandwidth).
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_S = 3.35e12
# bf16 outputs against an f32 reference differ by their rounding (2^-8
# relative) and summation order; the f32 dw by summation order only.
FWD_TOL = 1e-2
DW_TOL = 1e-3


def _ncdhw(a: torch.Tensor) -> torch.Tensor:
    """(B, T, S, C) as an NCDHW view (B, C, T, S, 1), no copy."""
    return a.permute(0, 3, 1, 2)[..., None]


def library_temporal(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The library's conv (``F.conv3d``): x (B, T, S, C), w (k, C, Co)."""
    p = w.shape[0] // 2
    return conv3d_nthwc(x[:, :, :, None], w[:, None, None], (1, 1, 1), (p, 0, 0))[:, :, :, 0]


def library_temporal_dx(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """dx of ``library_temporal`` (``conv3d_input``): g (B, T, S, Co)."""
    b, t, s, _ = g.shape
    p = w.shape[0] // 2
    dx = torch.nn.grad.conv3d_input((b, w.shape[1], t, s, 1), w.permute(2, 1, 0)[..., None, None],
                                    _ncdhw(g), padding=(p, 0, 0))
    return dx[..., 0].permute(0, 2, 3, 1)


def library_temporal_dw(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dw of ``library_temporal`` (``conv3d_weight``) -> (k, C, Co)."""
    k, c, co = w.shape
    dw = torch.nn.grad.conv3d_weight(_ncdhw(x), (co, c, k, 1, 1), _ncdhw(g),
                                     padding=(k // 2, 0, 0))
    return dw[..., 0, 0].permute(2, 1, 0)


def work(b: int, t: int, s: int, c: int, co: int, k: int, dw: bool = False):
    """(operations, bytes) of one call: the taps that fall inside [0, T)
    (none into the zero frames), each input read once and each output
    written once (dw in f32)."""
    pairs = sum(max(0, t - abs(d - k // 2)) for d in range(k))
    flops = 2.0 * b * s * pairs * c * co
    nbytes = 2.0 * b * t * s * (c + co) + (4.0 if dw else 2.0) * k * c * co
    return flops, nbytes


def bound_ms(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


def time_ms(fn, dev: torch.device, iters: int = 20, warmup: int = 2) -> float:
    """ms a call: CUDA events over ``iters`` back-to-back calls on the card
    (a host clock on the CPU)."""
    for _ in range(warmup):
        fn()
    if dev.type != "cuda":
        start = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - start) * 1e3 / iters
    torch.cuda.synchronize(dev)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / iters


def _rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    scale = ref.float().abs().max().item()
    return (got.float() - ref.float()).abs().max().item() / (scale + 1e-30)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shape", default="tpu1", choices=sorted(SHAPES))
    ap.add_argument("--k", type=int, default=3)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    b, t, s, c, co = SHAPES[args.shape]
    k = args.k
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0)

    def bf16(a):
        return torch.from_numpy(a).to(dev).to(torch.bfloat16)

    x = bf16(rng.standard_normal((b, t, s, c)))
    w = bf16(rng.standard_normal((k, c, co)) * 0.05)
    g = bf16(rng.standard_normal((b, t, s, co)))

    where = card() if dev.type == "cuda" else "cpu (host times, not device times)"
    flops, nbytes = work(b, t, s, c, co, k)
    _, dw_bytes = work(b, t, s, c, co, k, dw=True)
    lim_ms, lim_by = bound_ms(flops, nbytes)
    dw_lim_ms, dw_lim_by = bound_ms(flops, dw_bytes)
    print(f"shape={args.shape} B={b} T={t} S={s} C={c}->{co} k={k} on {where}")
    print(f"flops/op = {flops / 1e9:.1f} GFLOP (taps inside [0, T)), min bytes = "
          f"{nbytes / 1e6:.1f} MB; least time {lim_ms:.4f} ms ({lim_by}) at "
          f"{PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s and {PEAK_BYTES_S / 1e12:.2f} TB/s\n", flush=True)

    # parity first: each kernel against the library on the inputs in f32
    x32, w32, g32 = x.float(), w.float(), g.float()
    y_ref = library_temporal(x32, w32)
    dx_ref = library_temporal_dx(g32, w32)
    dw_ref = library_temporal_dw(x32, w32, g32)
    del x32, w32, g32
    checks = [
        ("fwd parity |library - v2|", lambda: micro.temporal_v2(x, w, k), y_ref, FWD_TOL),
        ("dw parity (dw v2)", lambda: micro.temporal_dw_v2(x, g, k), dw_ref, DW_TOL),
        ("fwd parity |library - v3|", lambda: micro.temporal_v3(x, w, k), y_ref, FWD_TOL),
        ("dx parity |library - v3|", lambda: micro.temporal_dx_v3(g, w, k), dx_ref, FWD_TOL),
        ("dw parity (dw v3)", lambda: micro.temporal_dw_v3(x, g, k), dw_ref, DW_TOL),
        ("fwd parity |library - v3 tile<=224|", lambda: micro.temporal_v3(x, w, k, max_tile=224),
         y_ref, FWD_TOL),
        ("fwd parity |library - v3p|", lambda: micro.temporal_v3p(x, w, k), y_ref, FWD_TOL),
        ("fwd parity |library - v3p tile<=224|",
         lambda: micro.temporal_v3p(x, w, k, max_tile=224), y_ref, FWD_TOL),
    ]
    parity, failures = {}, []
    for name, run, ref, tol in checks:
        got = run()
        err = _rel_err(got, ref)
        ok = bool(torch.isfinite(got).all().item()) and err <= tol
        parity[name] = err
        print(f"{name} max / max|ref| = {err:.3e} (tol {tol}){'' if ok else '  FAILED'}",
              flush=True)
        if not ok:
            failures.append(name)
        del got
    del y_ref, dx_ref, dw_ref
    if failures:
        raise SystemExit(f"kernel_micro: outside tolerance: {failures}")
    print()

    rows = [("library conv fwd", lambda: library_temporal(x, w), nbytes, lim_ms),
            ("v2 fwd", lambda: micro.temporal_v2(x, w, k), nbytes, lim_ms)]
    for mt in (448, 224):
        rows += [(f"v3 fwd tile<={mt}", lambda mt=mt: micro.temporal_v3(x, w, k, max_tile=mt),
                  nbytes, lim_ms),
                 (f"v3p fwd tile<={mt}", lambda mt=mt: micro.temporal_v3p(x, w, k, max_tile=mt),
                  nbytes, lim_ms)]
    rows += [("v3 dx", lambda: micro.temporal_dx_v3(g, w, k), nbytes, lim_ms),
             ("library conv dx", lambda: library_temporal_dx(g, w), nbytes, lim_ms),
             ("library conv dw", lambda: library_temporal_dw(x, w, g), dw_bytes, dw_lim_ms),
             ("dw v2", lambda: micro.temporal_dw_v2(x, g, k), dw_bytes, dw_lim_ms),
             ("dw v3", lambda: micro.temporal_dw_v3(x, g, k), dw_bytes, dw_lim_ms)]
    timed = {}
    for name, fn, moved, least in rows:
        ms = time_ms(fn, dev)
        if dev.type != "cuda":  # a host time: no device rate or share
            timed[name] = dict(host_ms=ms)
            print(f"{name:24s} {ms:9.4f} host ms", flush=True)
            continue
        timed[name] = dict(ms=ms, tflops=flops / ms / 1e9, gbs=moved / ms / 1e6,
                           share=least / ms)
        print(f"{name:24s} {ms:9.4f} ms  {flops / ms / 1e9:7.1f} TFLOP/s  "
              f"{moved / ms / 1e6:8.1f} GB/s  {least / ms:.3f} of the bound", flush=True)
    result = dict(shape=args.shape, dims=[b, t, s, c, co], k=k, device=where,
                  bound_ms=lim_ms, bound_by=lim_by, dw_bound_ms=dw_lim_ms, dw_bound_by=dw_lim_by,
                  parity=parity, rows=timed)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
