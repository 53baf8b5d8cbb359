"""On-device preprocessing: uint8 frames -> normalized clips.

The counterpart of ``fastvideotagging_tpu/ops/preprocess_kernel.py``. The
separable bilinear resize is two small f32 coefficient matmuls
(``A_h @ img @ A_w^T``); cropping is a row-slice of the coefficient
matrices and a horizontal flip is a row reversal of ``A_w``, so
resize + crop + flip collapse into the same two contractions. Normalization
is the epilogue. The JAX package leaves this to XLA, not Pallas, so plain
``torch.einsum`` is the port.

Numerics follow the host spec in data/preprocess.py (same coefficients, same
contraction order, f32). The matmuls run in full f32: TF32 would put the
resize about 1e-3 relative off the spec, the reason the JAX side pins
``Precision.HIGHEST``.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from fastvideotagging_tpu_torch.data.preprocess import resize_coeffs


@contextlib.contextmanager
def _full_f32_matmul():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def preprocess_batch(
    frames: torch.Tensor,  # (B, T, H0, W0, 3) uint8
    crop_tops: torch.Tensor,  # (B,) int
    crop_lefts: torch.Tensor,  # (B,) int
    flips: torch.Tensor,  # (B,) bool
    mean,  # (3,) [0,1] units
    std,  # (3,) [0,1] units
    *,
    resize_hw: tuple[int, int],
    crop_hw: tuple[int, int],
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """uint8 NTHWC frames -> normalized (B, T, ch, cw, 3) in ``out_dtype``,
    on the device of ``frames``."""
    if frames.dtype != torch.uint8 or frames.ndim != 5:
        raise ValueError(
            f"expected (B, T, H, W, C) uint8 frames, got {tuple(frames.shape)} "
            f"{frames.dtype}")
    b, t, h0, w0, c = frames.shape
    rh, rw = resize_hw
    ch, cw = crop_hw
    dev = frames.device
    ah = torch.from_numpy(resize_coeffs(h0, rh)).to(dev)  # (rh, h0)
    aw = torch.from_numpy(resize_coeffs(w0, rw)).to(dev)  # (rw, w0)
    tops = crop_tops.to(dev, torch.long)
    lefts = crop_lefts.to(dev, torch.long)
    # Fold the crop into the coefficient rows, per sample.
    rows_h = tops[:, None] + torch.arange(ch, device=dev)  # (B, ch)
    cols = torch.arange(cw, device=dev)
    # Fold the flip into the row order of A_w.
    cols = torch.where(flips.to(dev, torch.bool)[:, None], cols.flip(0), cols)
    ah_b = ah[rows_h]  # (B, ch, h0)
    aw_b = aw[lefts[:, None] + cols]  # (B, cw, w0)
    x = frames.to(torch.float32)
    with _full_f32_matmul():
        # Same contraction order as the host spec: height, then width.
        x = torch.einsum("boh,bthwc->btowc", ah_b, x)
        x = torch.einsum("bpw,btowc->btopc", aw_b, x)
    m = torch.as_tensor(np.asarray(mean, np.float32), device=dev) * 255.0
    s = torch.as_tensor(np.asarray(std, np.float32), device=dev) * 255.0
    x = (x - m) / s
    return x.to(out_dtype)


def preprocess_eval_clip(
    frames: torch.Tensor,  # (K, T, H0, W0, 3) uint8, K clips
    resize_hw: tuple[int, int],
    crop_hw: tuple[int, int],
    mean,
    std,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Deterministic eval path: center crop, no flip, fixed float order."""
    k = frames.shape[0]
    rh, rw = resize_hw
    ch, cw = crop_hw
    top = (rh - ch) // 2
    left = (rw - cw) // 2
    return preprocess_batch(
        frames,
        torch.full((k,), top, dtype=torch.long),
        torch.full((k,), left, dtype=torch.long),
        torch.zeros((k,), dtype=torch.bool),
        mean,
        std,
        resize_hw=resize_hw,
        crop_hw=crop_hw,
        out_dtype=out_dtype,
    )
