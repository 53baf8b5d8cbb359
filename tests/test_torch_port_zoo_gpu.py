"""The zoo's other backbones on the card (marker ``gpu``; skipped without
a CUDA card, decided inside the fixture): K1 / K2 / K3 against their plain
versions at a P3D-63 site and at S3D sites (forward, dx, dw), and one bf16
forward of each new family, its K1 / K2 launches equal to the count the
routing gives and its logits equal to the ``'torch'`` route's within 5e-2
of the largest |logit|. On the card, from the repository root:

    python -m pytest --noconftest -m gpu tests/test_torch_port_zoo_gpu.py -q
"""

import pytest
import torch

from fastvideotagging_tpu_torch import get_model
from fastvideotagging_tpu_torch.models.layers import SpatialConv, TemporalConv
from fastvideotagging_tpu_torch.ops import conv2plus1d as ops

pytestmark = pytest.mark.gpu

TOL, DW_TOL, PATH_TOL = 1e-2, 1e-3, 5e-2

# (kernel, x (B, T, H, W, C), Co): P3D-63's stage 3 at 32x224x224 (T = 16,
# 14x14) and S3D sites at 2 clips of 32x224x224: mixed3c's b1 (C = 128 ->
# 192 at 28x28), mixed4e's b1 (C = 144, Co = 288 at 14x14, T = 8), mixed5c's
# b2 (C = 48 -> 128 at 7x7, T = 4)
SITES = [
    ("spatial_conv", (2, 16, 14, 14, 256), 256), ("temporal_conv", (2, 16, 14, 14, 256), 256),
    ("spatial_conv", (2, 16, 28, 28, 128), 192), ("temporal_conv", (2, 16, 28, 28, 192), 192),
    ("spatial_conv", (2, 8, 14, 14, 144), 288), ("temporal_conv", (2, 8, 14, 14, 288), 288),
    ("spatial_conv", (2, 4, 7, 7, 48), 128), ("temporal_conv", (2, 4, 7, 7, 128), 128),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _rel(got, ref):
    return (got.float() - ref.float()).abs().max().item() / ref.float().abs().max().item()


@pytest.mark.parametrize("kernel,xs,co", SITES)
def test_kernels_match_plain_at_p3d_and_s3d_sites(cuda, kernel, xs, co):
    g = torch.Generator(device=cuda).manual_seed(0)
    b, t, h, w, c = xs
    x5 = torch.randn(xs, generator=g, device=cuda).to(torch.bfloat16)
    g5 = torch.randn((b, t, h, w, co), generator=g, device=cuda).to(torch.bfloat16)
    if kernel == "spatial_conv":
        x, gy = x5.reshape(b * t, h, w, c), g5.reshape(b * t, h, w, co)
        wt = (torch.randn((3, 3, c, co), generator=g, device=cuda) / (9 * c) ** 0.5).to(
            torch.bfloat16)
        pairs = [(ops.spatial_conv_cuda(x, wt), ops.spatial_conv_plain(x, wt), TOL),
                 (ops.spatial_conv_dx_cuda(gy, wt), ops.spatial_conv_dx_plain(gy, wt), TOL)]
    else:
        x, gy = x5.reshape(b, t, h * w, c), g5.reshape(b, t, h * w, co)
        wt = (torch.randn((3, c, co), generator=g, device=cuda) / (3 * c) ** 0.5).to(
            torch.bfloat16)
        pairs = [(ops.temporal_conv_cuda(x, wt), ops.temporal_conv_plain(x, wt), TOL),
                 (ops.temporal_conv_dx_cuda(gy, wt), ops.temporal_conv_dx_plain(gy, wt), TOL),
                 (ops.temporal_dw_cuda(x, gy, 3), ops.temporal_dw_plain(x, gy, 3), DW_TOL)]
    for got, ref, tol in pairs:
        assert got.shape == ref.shape and bool(torch.isfinite(got).all())
        assert _rel(got, ref) <= tol


FAMILIES = [("p3d_63", (16, 112, 112)), ("s3d", (16, 112, 112)), ("s3d_g", (16, 112, 112)),
            ("c3d", (16, 112, 112)), ("r3d_18", (8, 112, 112)), ("i3d", (16, 112, 112)),
            ("slowfast_r2plus1d", (16, 112, 112))]


@pytest.mark.parametrize("name,clip", FAMILIES)
def test_one_forward_of_each_family(cuda, name, clip):
    kw = {"clip_shape": clip} if name == "c3d" else {}
    model = get_model(name, num_classes=10, device="cpu",
                      generator=torch.Generator().manual_seed(0), **kw)
    ref_model = get_model(name, num_classes=10, device="cpu", backend="torch", **kw)
    ref_model.load_state_dict(model.state_dict())
    model, ref_model = model.to(cuda), ref_model.to(cuda)
    routed = {"spatial_conv": 0, "temporal_conv": 0}

    def hook(module, args):
        spatial = isinstance(module, SpatialConv)
        xs = tuple(args[0].shape)
        if (ops.spatial_eligible(xs, module.k, module.stride) if spatial
                else ops.temporal_eligible(xs, module.k, module.stride)):
            routed["spatial_conv" if spatial else "temporal_conv"] += 1

    for m in model.modules():
        if isinstance(m, (SpatialConv, TemporalConv)):
            m.register_forward_pre_hook(hook)
    x = torch.randn((2, *clip, 3), generator=torch.Generator(device=cuda).manual_seed(1),
                    device=cuda).to(torch.bfloat16)
    ops.reset_launch_counts()
    with torch.inference_mode():
        y = model(x)
        torch.cuda.synchronize()
        counts = {k: ops.launch_counts[k] for k in routed}
        ref = ref_model(x)
    assert counts == routed
    if name.startswith(("p3d", "s3d")):
        assert counts["spatial_conv"] > 0 and counts["temporal_conv"] > 0
    assert y.shape == (2, 10) and bool(torch.isfinite(y).all())
    assert _rel(y, ref) <= PATH_TOL
