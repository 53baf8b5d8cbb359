"""Model zoo: constructor-by-name registry (the counterpart of
``fastvideotagging_tpu/models/zoo.py``, with the same 16 names).

    net = get_model("r2plus1d_18", num_classes=101)   # on the card, eval mode
    logits = net(clips)                                # clips (B, T, H, W, 3)
    net.train()                                        # batch-stat BN, dropout
    net, state = load_pretrained("p3d_63", "p3d.pth", num_classes=51)

Every constructor takes ``num_classes``, ``dtype``, ``dropout`` and a
``generator`` for its seeded init, and the keywords of its family, with the
JAX zoo's handling: ``backend`` ('cuda' | 'torch') reaches the families
with factorized convs (R(2+1)D, P3D, S3D) and is dropped by the others;
``norm`` other than 'batch' raises on the models without norm variants
(C3D, P3D, SlowFast); ``remat`` is the R(2+1)D family's. C3D also takes
``clip_shape`` (T, H, W), which sizes ``fc6``.
"""

from __future__ import annotations

import logging
from typing import Callable

import torch
from torch import nn

from fastvideotagging_tpu_torch._device import resolve_device
from fastvideotagging_tpu_torch.models.c3d import C3D
from fastvideotagging_tpu_torch.models.i3d import I3D
from fastvideotagging_tpu_torch.models.layers import mxu_aligned_mid_channels
from fastvideotagging_tpu_torch.models.p3d import P3D
from fastvideotagging_tpu_torch.models.r2plus1d import R2Plus1D
from fastvideotagging_tpu_torch.models.s3d import S3D
from fastvideotagging_tpu_torch.models.slowfast import SlowFastR2Plus1D
from fastvideotagging_tpu_torch.models.tiny3d import Tiny3D
from fastvideotagging_tpu_torch.models.videoresnet import VideoResNet3D

log = logging.getLogger("fvt")

_REGISTRY: dict[str, Callable[..., nn.Module]] = {}
# models whose parameters depend on the clip's (T, H, W): C3D's fc6
CLIP_SHAPED = ("c3d",)


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


def model_from_config(m_cfg, device: str | torch.device = "cuda", clip_shape=None,
                      **overrides) -> nn.Module:
    """Build the model exactly as a ``ModelConfig`` specifies: ``kernels``
    becomes the conv backend and ``compute_dtype`` the activation dtype.
    ``remat`` is passed only when it is not 'none', so a model without the
    knob fails loudly instead of ignoring it. ``clip_shape`` (T, H, W) of
    the clips the model will see reaches the models that need it
    (``CLIP_SHAPED``). ``overrides`` win over config fields."""
    kw = dict(
        num_classes=m_cfg.num_classes,
        backend=m_cfg.kernels,
        dropout=m_cfg.dropout,
        dtype=getattr(torch, m_cfg.compute_dtype),
        norm=m_cfg.norm,
    )
    if m_cfg.remat != "none":
        kw["remat"] = m_cfg.remat
    if clip_shape is not None and m_cfg.name in CLIP_SHAPED:
        kw["clip_shape"] = tuple(clip_shape)
    kw.update(overrides)
    return get_model(m_cfg.name, device=device, **kw)


def config_clip_shape(d_cfg) -> tuple[int, int, int]:
    """(T, H, W) of the clips a ``DataConfig`` makes."""
    return (d_cfg.sampler.clip_len, *d_cfg.crop_hw)


# --------------------------------------------------------------------------
# pretrained weights
# --------------------------------------------------------------------------


def _read_weights(name: str, weights_path: str) -> dict[str, torch.Tensor]:
    """A weights file as the port's state_dict for model ``name``: the
    port's own exports (``train.checkpoint.export_weights``, keys such as
    ``stem_conv.kernel``) as they are, and public torch checkpoints
    (``.pth`` / ``.pt`` in a layout of models/torch_import.py) converted."""
    obj = torch.load(weights_path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and any(str(k).endswith(".kernel") for k in obj):
        return dict(obj)
    from fastvideotagging_tpu_torch.models.torch_import import convert_checkpoint

    return convert_checkpoint(name, obj)


def load_pretrained(name: str, weights_path: str, num_classes: int = 101,
                    reinit_head: bool = True, device: str | torch.device = "cuda",
                    clip_shape=None, **kwargs) -> tuple[nn.Module, dict[str, torch.Tensor]]:
    """Constructor with weights (the reference's ``pretrained=`` path):
    builds the model, reads the weights (``_read_weights``), checks them
    against the model and loads them. Returns (model, state_dict).

    ``reinit_head``: when the checkpoint's classifier size differs from
    ``num_classes`` (a Kinetics-400 checkpoint onto an N-class dataset),
    its head takes the model's fresh seeded init instead of failing;
    ``False`` keeps the strict shape check. The init draws from
    ``generator`` (default: seed 0). ``clip_shape`` reaches the models that
    need it (``CLIP_SHAPED``)."""
    kwargs.setdefault("generator", torch.Generator().manual_seed(0))
    if clip_shape is not None and name in CLIP_SHAPED:
        kwargs["clip_shape"] = tuple(clip_shape)
    model = get_model(name, num_classes=num_classes, device=device, **kwargs)
    state = _read_weights(name, weights_path)
    if reinit_head:
        state = _maybe_reinit_head(model, state, name)
    _check_variable_shapes(model, state, name)
    model.load_state_dict(state)
    return model, state


def _maybe_reinit_head(model: nn.Module, state: dict, name: str) -> dict:
    """Replace a classifier head of another class count with the model's
    own init. The head is ``fc`` for the resnet-style zoo and ``fc8`` for
    C3D (its fc6/fc7 do not depend on the class count)."""
    head = next((k for k in ("fc", "fc8") if f"{k}.weight" in state), None)
    if head is None:
        return state
    own = model.state_dict()
    keys = [k for k in own if k.startswith(head + ".")]
    got = {k: tuple(state[k].shape) for k in keys if k in state}
    want = {k: tuple(own[k].shape) for k in keys}
    if got != want:
        log.info("%s: checkpoint head %s != model head %s — reinitializing %s for "
                 "fine-tune", name, got, want, head)
        state = dict(state)
        for k in keys:
            state[k] = own[k].detach().cpu().clone()
    return state


def _check_variable_shapes(model: nn.Module, state: dict, name: str) -> None:
    """A converted state_dict must match the model's own exactly: the same
    keys, the same shapes."""
    expected = model.state_dict()
    missing = sorted(set(expected) - set(state))
    extra = sorted(set(state) - set(expected))
    if missing or extra:
        raise ValueError(
            f"converted weights do not match {name}: missing={missing[:5]} extra={extra[:5]}")
    for key, value in expected.items():
        if tuple(state[key].shape) != tuple(value.shape):
            raise ValueError(
                f"shape mismatch at {key}: checkpoint {tuple(state[key].shape)} vs "
                f"model {tuple(value.shape)}")


# --------------------------------------------------------------------------
# registrations
# --------------------------------------------------------------------------


def _require_batch_norm(kw: dict, name: str) -> None:
    """Models without norm variants must not ignore the config: any other
    norm than 'batch' is an error."""
    norm = kw.pop("norm", "batch")
    if norm != "batch":
        raise ValueError(
            f"{name} supports only norm='batch' (got {norm!r}); norm "
            f"variants are implemented for the r2plus1d family and tiny3d")


@register("tiny3d")
def _tiny3d(num_classes: int, **kw) -> nn.Module:
    """Small debug backbone for the fit and pipeline tests (library convs
    only: ``backend`` and ``dropout`` do not apply)."""
    kw.pop("backend", None)
    kw.pop("dropout", None)
    return Tiny3D(num_classes=num_classes, **kw)


@register("c3d")
def _c3d(num_classes: int, dropout: float = 0.5, **kw) -> nn.Module:
    kw.pop("backend", None)  # full 3D convs; no factorized kernels
    _require_batch_norm(kw, "c3d")  # C3D has no norm layers at all (paper)
    return C3D(num_classes=num_classes, dropout=dropout, **kw)


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


@register("p3d_63")
def _p3d_63(num_classes: int, **kw) -> nn.Module:
    _require_batch_norm(kw, "p3d_63")
    return P3D(stage_blocks=(3, 4, 6, 3), num_classes=num_classes, **kw)


@register("p3d_131")
def _p3d_131(num_classes: int, **kw) -> nn.Module:
    _require_batch_norm(kw, "p3d_131")
    return P3D(stage_blocks=(3, 4, 23, 3), num_classes=num_classes, **kw)


@register("p3d_199")
def _p3d_199(num_classes: int, **kw) -> nn.Module:
    _require_batch_norm(kw, "p3d_199")
    return P3D(stage_blocks=(3, 8, 36, 3), num_classes=num_classes, **kw)


@register("r3d_18")
def _r3d_18(num_classes: int, **kw) -> nn.Module:
    """Full-3D VideoResNet (the Tran'18 sibling of R(2+1)D)."""
    kw.pop("backend", None)  # full 3x3x3 convs; no factorized kernels
    return VideoResNet3D(stage_blocks=(2, 2, 2, 2), stage_conv_types=("3d",) * 4,
                         num_classes=num_classes, **kw)


@register("mc3_18")
def _mc3_18(num_classes: int, **kw) -> nn.Module:
    """Mixed-conv VideoResNet: 3D stage 1, 1x3x3 stages 2-4 (Tran'18 MC3)."""
    kw.pop("backend", None)
    return VideoResNet3D(stage_blocks=(2, 2, 2, 2),
                         stage_conv_types=("3d", "no_t", "no_t", "no_t"),
                         num_classes=num_classes, **kw)


@register("s3d")
def _s3d(num_classes: int, **kw) -> nn.Module:
    """Separable-3D Inception (Xie'18), torchvision layout."""
    return S3D(num_classes=num_classes, **kw)


@register("s3d_g")
def _s3d_g(num_classes: int, **kw) -> nn.Module:
    """S3D-G: S3D with per-channel self-gating on every separable conv."""
    return S3D(num_classes=num_classes, gating=True, **kw)


@register("i3d")
def _i3d(num_classes: int, **kw) -> nn.Module:
    """Inflated 3D Inception, RGB stream (Carreira'17; pytorch-i3d layout)."""
    kw.pop("backend", None)  # full 3x3x3 convs; no factorized kernels
    return I3D(num_classes=num_classes, **kw)


@register("slowfast_r2plus1d")
def _slowfast(num_classes: int, **kw) -> nn.Module:
    """Dual-pathway stretch config; kwargs: alpha, beta, shard_axis (a model
    group: the convs channel-sharded over it, parallel/channel.py)."""
    kw.pop("backend", None)  # full 3D convs
    _require_batch_norm(kw, "slowfast_r2plus1d")
    return SlowFastR2Plus1D(num_classes=num_classes, **kw)


@register("slowfast_r2plus1d_tpu")
def _slowfast_tpu(num_classes: int, **kw) -> nn.Module:
    """SlowFast with the time-to-channel packed fast pathway (an
    architecture name of the JAX zoo; not weight-compatible with
    slowfast_r2plus1d)."""
    kw.pop("backend", None)
    _require_batch_norm(kw, "slowfast_r2plus1d_tpu")
    return SlowFastR2Plus1D(num_classes=num_classes, pack_fast=True, **kw)
