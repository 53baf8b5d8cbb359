"""Fused inference engine for R(2+1)D (the counterpart of
``fastvideotagging_tpu/ops/fused_infer.py``).

Runs a trained R2Plus1D's forward pass straight from its weights — the
port's ``state_dict``, whose names map one to one onto the JAX package's
variables (models/convert.py) — with each stride-1 (2+1)D pair + BN + ReLU on
K4 (ops/fused_block.py) and every BatchNorm folded into an affine. The
strided stage-entry pairs, the stem and the downsample convs go to
``F.conv3d`` with symmetric k//2 padding, where the JAX engine uses lax.

Its numerics are the engine's own, not the model's: the input is cast to
bf16 whatever the config's compute dtype; a BN is ``x.float() * scale +
bias`` (then ReLU, then the cast back), not ``Norm``'s ``(x - mean) * mul +
bias``; the pool is an f32 mean with no bf16 rounding before ``fc``.

As an ``evaluate`` engine (``apply_fn(variables, clips) -> scores``)::

    apply_fn = lambda sd, clips: heads.predict_scores(
        r2plus1d_fused_infer(sd, clips), multilabel)
"""

from __future__ import annotations

import re

import torch

from fastvideotagging_tpu_torch.ops.conv2plus1d import conv3d_nthwc
from fastvideotagging_tpu_torch.ops.fused_block import (
    conv2plus1d_fused,
    fold_bn,
    fused_supported,
)


def _conv(x, kernel, strides):
    """Symmetric (k//2, k//2) padding — the models.layers semantics."""
    pad = tuple(k // 2 for k in kernel.shape[:3])
    return conv3d_nthwc(x, kernel.to(x.dtype), strides, pad)


def _bn_affine(sd, name):
    return fold_bn(sd[f"{name}.scale"], sd[f"{name}.bias"], sd[f"{name}.mean"],
                   sd[f"{name}.var"])


def _apply_affine(x, scale, bias, relu=False):
    y = x.float() * scale + bias
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype)


def _conv2plus1d(x, sd, name, spatial_stride, temporal_stride):
    """One factorized pair; K4 when stride-1 and supported."""
    w_sp = sd[f"{name}.spatial.kernel"][0]  # (k, k, C, M)
    w_tmp = sd[f"{name}.temporal.kernel"][:, 0, 0]  # (k, M, Co)
    scale, bias = _bn_affine(sd, f"{name}.bn_mid")
    if (spatial_stride == 1 and temporal_stride == 1
            and fused_supported(x.shape, w_sp.shape[0], w_sp.shape[-1], w_tmp.shape[-1])):
        return conv2plus1d_fused(x, w_sp, scale, bias, w_tmp)
    y = _conv(x, w_sp[None], (1, spatial_stride, spatial_stride))
    y = _apply_affine(y, scale, bias, relu=True)
    return _conv(y, w_tmp[:, None, None], (temporal_stride, 1, 1))


_BLOCK_KEY = re.compile(r"^(stage\d+_block\d+)\.")


def _check_blocks(sd: dict, stage_blocks: tuple) -> None:
    """Raise unless the weights hold exactly the blocks ``stage_blocks``
    walks: deeper weights (r2plus1d_34 under the default (2, 2, 2, 2))
    would otherwise give a shallower network's logits with no error."""
    have = {m.group(1) for m in map(_BLOCK_KEY.match, sd) if m}
    want = {f"stage{s + 1}_block{b}" for s, n in enumerate(stage_blocks) for b in range(n)}
    if have != want:
        raise ValueError(
            f"stage_blocks={tuple(stage_blocks)} does not match the weights: blocks "
            f"not walked {sorted(have - want)}, blocks missing {sorted(want - have)}")


@torch.inference_mode()
def r2plus1d_fused_infer(state_dict: dict, x: torch.Tensor,
                         stage_blocks: tuple = (2, 2, 2, 2)) -> torch.Tensor:
    """Inference-mode forward, fused. x: (B, T, H, W, 3) -> (B, K) f32 logits,
    on the device of x and the weights. Raises ValueError when the weights'
    ``stageN_blockM`` blocks are not exactly those ``stage_blocks`` walks."""
    sd = state_dict
    _check_blocks(sd, stage_blocks)
    x = x.to(torch.bfloat16)

    # Stem (3 input channels, then 45: F.conv3d).
    y = _conv(x, sd["stem_spatial.kernel"], (1, 2, 2))
    y = _apply_affine(y, *_bn_affine(sd, "stem_bn1"), relu=True)
    y = _conv(y, sd["stem_temporal.kernel"], (1, 1, 1))
    y = _apply_affine(y, *_bn_affine(sd, "stem_bn2"), relu=True)

    for stage, num_blocks in enumerate(stage_blocks):
        for block in range(num_blocks):
            stride = 2 if (stage > 0 and block == 0) else 1
            name = f"stage{stage + 1}_block{block}"
            residual = y
            z = _conv2plus1d(y, sd, f"{name}.conv1", stride, stride)
            z = _apply_affine(z, *_bn_affine(sd, f"{name}.bn1"), relu=True)
            z = _conv2plus1d(z, sd, f"{name}.conv2", 1, 1)
            z = _apply_affine(z, *_bn_affine(sd, f"{name}.bn2"))
            if f"{name}.downsample.kernel" in sd:
                residual = _conv(y, sd[f"{name}.downsample.kernel"], (stride, stride, stride))
                residual = _apply_affine(residual, *_bn_affine(sd, f"{name}.bn_down"))
            y = torch.relu(z + residual)

    pooled = y.float().mean(dim=(1, 2, 3))
    return pooled @ sd["fc.weight"].float().T + sd["fc.bias"].float()
