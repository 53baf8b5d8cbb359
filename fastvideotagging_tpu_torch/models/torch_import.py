"""Pretrained-weight import from public torch checkpoints (the counterpart
of ``fastvideotagging_tpu/models/torch_import.py``).

Covered layouts:

- R(2+1)D-18/34: torchvision ``VideoResNet`` state_dicts (stem
  1x7x7->45->3x1x1->64, BasicBlock stages);
- r3d_18 / mc3_18: the same torchvision family with plain Conv3d blocks
  (``convN.0`` conv + ``convN.1`` BN);
- C3D: the classic Sports-1M-conversion layout (biased conv1..conv5b and
  fc6/fc7/fc8), fc6's input permuted from channel-first to channels-last;
- P3D-63/131/199: the public P3D PyTorch bottleneck schema (conv1..conv4 /
  bn1..bn4 per block + downsample, stem conv1_custom/bn1);
- S3D: torchvision ``models.video.s3d`` (a 1x1x1-conv classifier, which
  commutes with the head's pooling onto the Dense ``fc``);
- I3D: the pytorch-i3d port of the DeepMind checkpoint (Unit3D /
  InceptionModule layout).

Each maps the torch layout onto the port model's ``state_dict``:

  conv weight (Cout, Cin, kt, kh, kw) -> ``<conv>.kernel`` (kt, kh, kw, Cin, Cout)
  BatchNorm weight/bias/running_mean/running_var -> ``<bn>.scale/bias/mean/var``
  Linear weight (K, Cin) -> ``<fc>.weight`` as it is

The converters are strict: a missing key raises ``KeyError`` and an unused
one ``ValueError``, so a drifted layout fails loudly instead of loading a
half-initialized model.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import torch


class _StateDict:
    """Strict accessor: every key must be consumed exactly once."""

    def __init__(self, sd: Mapping[str, torch.Tensor]):
        self.sd = {k: v for k, v in sd.items() if not k.endswith("num_batches_tracked")}
        self.used: set[str] = set()
        self.out: dict[str, torch.Tensor] = {}

    def take(self, key: str) -> torch.Tensor:
        if key not in self.sd:
            raise KeyError(
                f"torch state_dict is missing {key!r} — wrong layout for this "
                f"converter? ({len(self.sd)} keys present)")
        self.used.add(key)
        return torch.as_tensor(self.sd[key]).detach().to("cpu", torch.float32)

    def has(self, key: str) -> bool:
        return key in self.sd

    def conv(self, key: str, to: str) -> None:
        """torch (Cout, Cin, kt, kh, kw) -> (kt, kh, kw, Cin, Cout)."""
        self.out[f"{to}.kernel"] = self.take(key + ".weight").permute(2, 3, 4, 1, 0).contiguous()

    def bn(self, key: str, to: str) -> None:
        self.out[f"{to}.scale"] = self.take(key + ".weight")
        self.out[f"{to}.bias"] = self.take(key + ".bias")
        self.out[f"{to}.mean"] = self.take(key + ".running_mean")
        self.out[f"{to}.var"] = self.take(key + ".running_var")

    def linear(self, key: str, to: str) -> None:
        w = self.take(key + ".weight")
        self.out[f"{to}.weight"] = w.reshape(w.shape[0], w.shape[1]).contiguous()
        self.out[f"{to}.bias"] = self.take(key + ".bias")

    def finish(self) -> dict[str, torch.Tensor]:
        unused = sorted(set(self.sd) - self.used)
        if unused:
            raise ValueError(
                f"{len(unused)} unconsumed torch keys (wrong depth/layout?): "
                f"{unused[:8]}{'...' if len(unused) > 8 else ''}")
        return self.out


def convert_r2plus1d_state_dict(state_dict: Mapping[str, torch.Tensor],
                                stage_blocks: Sequence[int] = (2, 2, 2, 2)
                                ) -> dict[str, torch.Tensor]:
    """torchvision VideoResNet-R(2+1)D state_dict -> the port's R2Plus1D."""
    sd = _StateDict(state_dict)
    sd.conv("stem.0", "stem_spatial")
    sd.bn("stem.1", "stem_bn1")
    sd.conv("stem.3", "stem_temporal")
    sd.bn("stem.4", "stem_bn2")
    for stage, num_blocks in enumerate(stage_blocks):
        for block in range(num_blocks):
            t, f = f"layer{stage + 1}.{block}", f"stage{stage + 1}_block{block}"
            for conv in ("conv1", "conv2"):
                sd.conv(f"{t}.{conv}.0.0", f"{f}.{conv}.spatial")
                sd.bn(f"{t}.{conv}.0.1", f"{f}.{conv}.bn_mid")
                sd.conv(f"{t}.{conv}.0.3", f"{f}.{conv}.temporal")
            sd.bn(f"{t}.conv1.1", f"{f}.bn1")
            sd.bn(f"{t}.conv2.1", f"{f}.bn2")
            if sd.has(f"{t}.downsample.0.weight"):
                sd.conv(f"{t}.downsample.0", f"{f}.downsample")
                sd.bn(f"{t}.downsample.1", f"{f}.bn_down")
    sd.linear("fc", "fc")
    return sd.finish()


def convert_c3d_state_dict(state_dict: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Classic C3D torch layout (biased Conv3d conv1..conv5b, Linear
    fc6/fc7/fc8, the port's module names) -> the port's C3D.

    torch flattens pool5 channel-first (C, T, H, W), the NTHWC model
    (T, H, W, C): fc6's input is permuted so (512 x 1 x s x s pool5, s = 4
    at 16x112x112)."""
    sd = _StateDict(state_dict)
    for name in ("conv1", "conv2", "conv3a", "conv3b", "conv4a", "conv4b", "conv5a", "conv5b"):
        sd.conv(name, name)
        sd.out[f"{name}.bias"] = sd.take(name + ".bias")
    w6 = sd.take("fc6.weight")  # (4096, C*T*H*W), torch flatten order
    if w6.shape[1] % 512:
        raise ValueError(
            f"fc6 input dim {w6.shape[1]} is not a multiple of C3D's 512 pool5 "
            f"channels — not the classic C3D layout")
    s = int(round((w6.shape[1] // 512) ** 0.5))
    if 512 * s * s != w6.shape[1]:
        raise ValueError(f"cannot factor fc6 input dim {w6.shape[1]} as 512*s*s")
    sd.out["fc6.weight"] = (w6.reshape(-1, 512, 1, s, s).permute(0, 2, 3, 4, 1)
                            .reshape(w6.shape[0], -1).contiguous())
    sd.out["fc6.bias"] = sd.take("fc6.bias")
    sd.linear("fc7", "fc7")
    sd.linear("fc8", "fc8")
    return sd.finish()


def convert_p3d_state_dict(state_dict: Mapping[str, torch.Tensor],
                           stage_blocks: Sequence[int] = (3, 4, 6, 3)
                           ) -> dict[str, torch.Tensor]:
    """Public P3D torch layout (stem ``conv1_custom``/``bn1``; per block
    conv1/bn1 reduce, conv2/bn2 spatial, conv3/bn3 temporal, conv4/bn4
    expand, downsample.0/.1; head ``fc``) -> the port's P3D. The A/B/C
    cycle is control flow, so one mapping covers all three block types."""
    sd = _StateDict(state_dict)
    sd.conv("conv1_custom", "stem_conv")
    sd.bn("bn1", "stem_bn")
    members = (("conv1", "bn1", "reduce", "bn_reduce"), ("conv2", "bn2", "spatial", "bn_s"),
               ("conv3", "bn3", "temporal", "bn_t"), ("conv4", "bn4", "expand", "bn_expand"))
    for stage, num_blocks in enumerate(stage_blocks):
        for block in range(num_blocks):
            t, f = f"layer{stage + 1}.{block}", f"stage{stage + 1}_block{block}"
            for t_conv, t_bn, f_conv, f_bn in members:
                sd.conv(f"{t}.{t_conv}", f"{f}.{f_conv}")
                sd.bn(f"{t}.{t_bn}", f"{f}.{f_bn}")
            if sd.has(f"{t}.downsample.0.weight"):
                sd.conv(f"{t}.downsample.0", f"{f}.downsample")
                sd.bn(f"{t}.downsample.1", f"{f}.bn_down")
    sd.linear("fc", "fc")
    return sd.finish()


def convert_videoresnet_state_dict(state_dict: Mapping[str, torch.Tensor],
                                   stage_blocks: Sequence[int] = (2, 2, 2, 2)
                                   ) -> dict[str, torch.Tensor]:
    """torchvision VideoResNet r3d_18 / mc3_18 -> the port's VideoResNet3D
    (the conv type changes kernel shapes only, which the caller checks)."""
    sd = _StateDict(state_dict)
    sd.conv("stem.0", "stem_conv")
    sd.bn("stem.1", "stem_bn")
    for stage, num_blocks in enumerate(stage_blocks):
        for block in range(num_blocks):
            t, f = f"layer{stage + 1}.{block}", f"stage{stage + 1}_block{block}"
            for conv, bn in (("conv1", "bn1"), ("conv2", "bn2")):
                sd.conv(f"{t}.{conv}.0", f"{f}.{conv}")
                sd.bn(f"{t}.{conv}.1", f"{f}.{bn}")
            if sd.has(f"{t}.downsample.0.weight"):
                sd.conv(f"{t}.downsample.0", f"{f}.downsample")
                sd.bn(f"{t}.downsample.1", f"{f}.bn_down")
    sd.linear("fc", "fc")
    return sd.finish()


_S3D_BLOCKS = {"mixed3b": 5, "mixed3c": 6, "mixed4b": 8, "mixed4c": 9, "mixed4d": 10,
               "mixed4e": 11, "mixed4f": 12, "mixed5b": 14, "mixed5c": 15}


def convert_s3d_state_dict(state_dict: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """torchvision ``models.video.s3d`` -> the port's S3D (``gating=False``).
    ``features`` holds TemporalSeparableConv / Conv3dNormActivation /
    SepInceptionBlock3D modules at fixed indices, each conv + BN pair as
    ``<prefix>.0.weight`` + ``<prefix>.1.*``; the classifier is the biased
    1x1x1 ``classifier.1``."""
    sd = _StateDict(state_dict)

    def cna(t: str, f_conv: str, f_bn: str) -> None:
        sd.conv(t + ".0", f_conv)
        sd.bn(t + ".1", f_bn)

    def sep(t: str, f: str) -> None:
        cna(t + ".0", f + ".spatial", f + ".bn_s")
        cna(t + ".1", f + ".temporal", f + ".bn_t")

    sep("features.0", "stem")
    cna("features.2", "conv2", "conv2_bn")
    sep("features.3", "conv3")
    for name, idx in _S3D_BLOCKS.items():
        t = f"features.{idx}"
        cna(f"{t}.branch0", f"{name}.b0", f"{name}.b0_bn")
        cna(f"{t}.branch1.0", f"{name}.b1_reduce", f"{name}.b1_bn")
        sep(f"{t}.branch1.1", f"{name}.b1_sep")
        cna(f"{t}.branch2.0", f"{name}.b2_reduce", f"{name}.b2_bn")
        sep(f"{t}.branch2.1", f"{name}.b2_sep")
        cna(f"{t}.branch3.1", f"{name}.b3_conv", f"{name}.b3_bn")
    sd.linear("classifier.1", "fc")  # (K, 1024, 1, 1, 1) -> (K, 1024)
    return sd.finish()


def convert_i3d_state_dict(state_dict: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """pytorch-i3d -> the port's I3D: Unit3D modules ``Conv3d_1a_7x7`` /
    ``Conv3d_2b_1x1`` / ``Conv3d_2c_3x3`` and nine ``Mixed_Xx`` modules with
    branch units b0/b1a/b1b/b2a/b2b/b3b, each ``<unit>.conv3d.weight`` +
    ``<unit>.bn.*``; the classifier is the biased 1x1x1 ``logits.conv3d``."""
    sd = _StateDict(state_dict)

    def unit(t: str, f: str) -> None:
        sd.conv(t + ".conv3d", f + ".conv")
        sd.bn(t + ".bn", f + ".bn")

    unit("Conv3d_1a_7x7", "conv1")
    unit("Conv3d_2b_1x1", "conv2")
    unit("Conv3d_2c_3x3", "conv3")
    branches = {"b0": "b0", "b1a": "b1_reduce", "b1b": "b1_conv", "b2a": "b2_reduce",
                "b2b": "b2_conv", "b3b": "b3_conv"}
    for name in ("3b", "3c", "4b", "4c", "4d", "4e", "4f", "5b", "5c"):
        for t_branch, f_branch in branches.items():
            unit(f"Mixed_{name}.{t_branch}", f"mixed{name}.{f_branch}")
    sd.linear("logits.conv3d", "fc")
    return sd.finish()


_CONVERTERS = {
    "r2plus1d_18": lambda sd: convert_r2plus1d_state_dict(sd, (2, 2, 2, 2)),
    "r2plus1d_34": lambda sd: convert_r2plus1d_state_dict(sd, (3, 4, 6, 3)),
    "c3d": convert_c3d_state_dict,
    "p3d_63": lambda sd: convert_p3d_state_dict(sd, (3, 4, 6, 3)),
    "p3d_131": lambda sd: convert_p3d_state_dict(sd, (3, 4, 23, 3)),
    "p3d_199": lambda sd: convert_p3d_state_dict(sd, (3, 8, 36, 3)),
    "r3d_18": lambda sd: convert_videoresnet_state_dict(sd, (2, 2, 2, 2)),
    "mc3_18": lambda sd: convert_videoresnet_state_dict(sd, (2, 2, 2, 2)),
    "s3d": convert_s3d_state_dict,
    "i3d": convert_i3d_state_dict,
}


def _unwrap_checkpoint(obj) -> Mapping[str, torch.Tensor]:
    """Accept raw state_dicts and the common {'state_dict': ...} wrappers."""
    if not isinstance(obj, Mapping):
        raise TypeError(f"expected a state_dict mapping, got {type(obj)}")
    for key in ("state_dict", "model", "model_state"):
        inner = obj.get(key)
        if isinstance(inner, Mapping) and any(k.endswith(".weight") for k in inner):
            return inner
    return obj


def convert_checkpoint(name: str, obj) -> dict[str, torch.Tensor]:
    """A loaded torch checkpoint (a state_dict or a common wrapper of one)
    converted for model ``name``."""
    if name not in _CONVERTERS:
        raise ValueError(
            f"no torch-weight converter for {name!r}; available: {sorted(_CONVERTERS)}")
    return _CONVERTERS[name](_unwrap_checkpoint(obj))


def load_torch_variables(name: str, weights_path: str) -> dict[str, torch.Tensor]:
    """Load a .pth/.pt checkpoint from disk and convert it for model
    ``name`` into the port's state_dict."""
    obj = torch.load(weights_path, map_location="cpu", weights_only=True)
    return convert_checkpoint(name, obj)
