"""Model zoo: constructor-by-name registry (counterpart of
``fastvideotagging_tpu/models/zoo.py``; the R(2+1)D family and the
tiny3d debug backbone for now).

    net = get_model("r2plus1d_18", num_classes=101)   # on the card, eval mode
    logits = net(clips)                                # clips (B, T, H, W, 3)
    net.train()                                        # batch-stat BN, dropout

Every constructor takes ``num_classes``, ``backend`` ('cuda' | 'torch'),
``dtype``, ``norm``, ``dropout`` and a ``generator`` for its seeded init;
the R(2+1)D family also ``remat``.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from fastvideotagging_tpu_torch._device import resolve_device
from fastvideotagging_tpu_torch.models.layers import mxu_aligned_mid_channels
from fastvideotagging_tpu_torch.models.r2plus1d import R2Plus1D
from fastvideotagging_tpu_torch.models.tiny3d import Tiny3D

_REGISTRY: dict[str, Callable[..., nn.Module]] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def list_models() -> list[str]:
    return sorted(_REGISTRY)


def get_model(name: str, num_classes: int = 101, device: str | torch.device = "cuda",
              **kwargs) -> nn.Module:
    """Build a registered model in eval mode on ``device`` (the card by
    default; raises without one unless ``device='cpu'``)."""
    dev = resolve_device(device)
    if name not in _REGISTRY:
        raise ValueError(f"unknown model {name!r}; available: {list_models()}")
    return _REGISTRY[name](num_classes=num_classes, **kwargs).to(dev).eval()


def model_from_config(m_cfg, device: str | torch.device = "cuda",
                      **overrides) -> nn.Module:
    """Build the model exactly as a ``ModelConfig`` specifies: ``kernels``
    becomes the conv backend and ``compute_dtype`` the activation dtype.
    ``remat`` is passed only when it is not 'none', so a model without the
    knob (tiny3d) fails loudly instead of ignoring it.
    ``overrides`` win over config fields."""
    kw = dict(
        num_classes=m_cfg.num_classes,
        backend=m_cfg.kernels,
        dropout=m_cfg.dropout,
        dtype=getattr(torch, m_cfg.compute_dtype),
        norm=m_cfg.norm,
    )
    if m_cfg.remat != "none":
        kw["remat"] = m_cfg.remat
    kw.update(overrides)
    return get_model(m_cfg.name, device=device, **kw)


@register("r2plus1d_18")
def _r2plus1d_18(num_classes: int, **kw) -> nn.Module:
    return R2Plus1D(stage_blocks=(2, 2, 2, 2), num_classes=num_classes, **kw)


@register("r2plus1d_34")
def _r2plus1d_34(num_classes: int, **kw) -> nn.Module:
    return R2Plus1D(stage_blocks=(3, 4, 6, 3), num_classes=num_classes, **kw)


@register("r2plus1d_18_tpu")
def _r2plus1d_18_tpu(num_classes: int, **kw) -> nn.Module:
    """Mid-channels rounded to multiples of 128 (an architecture name of the
    JAX zoo; not weight-compatible with r2plus1d_18)."""
    return R2Plus1D(stage_blocks=(2, 2, 2, 2), num_classes=num_classes,
                    mid_channels_fn=mxu_aligned_mid_channels, stem_mid=128, **kw)


@register("r2plus1d_34_tpu")
def _r2plus1d_34_tpu(num_classes: int, **kw) -> nn.Module:
    return R2Plus1D(stage_blocks=(3, 4, 6, 3), num_classes=num_classes,
                    mid_channels_fn=mxu_aligned_mid_channels, stem_mid=128, **kw)


@register("tiny3d")
def _tiny3d(num_classes: int, **kw) -> nn.Module:
    """Small debug backbone for the fit and pipeline tests (library convs
    only: ``backend`` and ``dropout`` do not apply)."""
    kw.pop("backend", None)
    kw.pop("dropout", None)
    return Tiny3D(num_classes=num_classes, **kw)
