"""The port's (2+1)D conv ops against the JAX package's Pallas kernels.

On CPU tensors the port's ``spatial_conv`` / ``temporal_conv`` take the
plain versions of K1 / K2 (``*_plain``); the JAX functions run their Pallas
kernels in interpret mode, as tests/test_ops_pallas.py does. Inputs come from
a numpy seed; f32, tolerance 1e-4 (tests/test_ops_pallas.py:51). The plain
versions are also held to ``F.conv3d``, the library yardstick.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from fastvideotagging_tpu.ops import conv2plus1d as jops
from fastvideotagging_tpu_torch.ops import conv2plus1d as tops

TOL = 1e-4


def _inputs(x_shape, w_shape, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=x_shape).astype(np.float32)
    fan_in = int(np.prod(w_shape[:-1]))
    w = (rng.normal(size=w_shape) / np.sqrt(fan_in)).astype(np.float32)
    return x, w


@pytest.mark.parametrize("shape,co,k,stride", [
    ((1, 2, 8, 8, 45), 40, 3, 1),     # C not a multiple of 8, Co not of 16
    ((1, 2, 6, 7, 144), 64, 3, 1),    # the stage-1 mid width
    ((2, 1, 8, 8, 32), 24, 5, 1),     # k = 5
    ((1, 2, 9, 8, 64), 40, 3, 2),     # strided: the library conv
    ((1, 2, 8, 8, 3), 16, 7, 2),      # the stem: 3 channels, stride 2
])
def test_spatial_conv_matches_jax(shape, co, k, stride):
    x, w = _inputs(shape, (k, k, shape[-1], co))
    ref = np.asarray(jops.spatial_conv(x, w, stride=stride))
    got = tops.spatial_conv(torch.from_numpy(x), torch.from_numpy(w), stride=stride)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("shape,co,k,stride", [
    ((1, 4, 3, 5, 45), 64, 3, 1),     # the stem's temporal conv: C = 45
    ((2, 3, 2, 4, 144), 40, 3, 1),    # C = 144, Co not a multiple of 16
    ((1, 5, 4, 4, 32), 24, 5, 1),     # k = 5
    ((1, 8, 4, 4, 64), 32, 3, 2),     # strided: the library conv
    ((1, 1, 4, 4, 64), 32, 3, 1),     # T = 1: the library conv
])
def test_temporal_conv_matches_jax(shape, co, k, stride):
    x, w = _inputs(shape, (k, shape[-1], co))
    ref = np.asarray(jops.temporal_conv(x, w, stride=stride))
    got = tops.temporal_conv(torch.from_numpy(x), torch.from_numpy(w), stride=stride)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("shape,co,k", [((3, 7, 9, 45), 21, 3), ((2, 5, 5, 36), 8, 5)])
def test_spatial_plain_matches_conv3d(shape, co, k):
    x, w = _inputs(shape, (k, k, shape[-1], co), seed=1)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    ref = F.conv2d(xt.permute(0, 3, 1, 2), wt.permute(3, 2, 0, 1), padding=k // 2)
    got = tops.spatial_conv_plain(xt, wt)
    torch.testing.assert_close(got, ref.permute(0, 2, 3, 1), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("shape,co,k", [((2, 6, 10, 45), 19, 3), ((1, 3, 4, 40), 8, 5)])
def test_temporal_plain_matches_conv3d(shape, co, k):
    x, w = _inputs(shape, (k, shape[-1], co), seed=2)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    # (B, T, S, C) -> (B, C, T, S, 1) for a k x 1 x 1 conv3d
    ref = F.conv3d(xt.permute(0, 3, 1, 2)[..., None],
                   wt.permute(2, 1, 0)[..., None, None], padding=(k // 2, 0, 0))
    got = tops.temporal_conv_plain(xt, wt)
    torch.testing.assert_close(got, ref[..., 0].permute(0, 2, 3, 1), rtol=TOL, atol=TOL)


def test_eligibility_mirrors_jax_routing():
    # the JAX routing (ops/conv2plus1d.py:181, 333) without its VMEM-halo term
    assert tops.spatial_eligible((1, 2, 8, 8, 32), 3, 1)
    assert not tops.spatial_eligible((1, 2, 8, 8, 31), 3, 1)
    assert not tops.spatial_eligible((1, 2, 8, 8, 64), 3, 2)
    assert not tops.spatial_eligible((1, 2, 2, 8, 64), 3, 1)
    assert tops.temporal_eligible((1, 2, 1, 1, 45), 3, 1)
    assert not tops.temporal_eligible((1, 1, 4, 4, 64), 3, 1)
    assert not tops.temporal_eligible((1, 4, 4, 4, 64), 3, 2)


def test_kernel_wrappers_reject_cpu_tensors():
    x = torch.zeros((1, 4, 4, 32), dtype=torch.bfloat16)
    before = dict(tops.launch_counts)
    with pytest.raises(ValueError, match="CUDA"):
        tops.spatial_conv_cuda(x, torch.zeros((3, 3, 32, 8), dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="CUDA"):
        tops.temporal_conv_cuda(x, torch.zeros((3, 32, 8), dtype=torch.bfloat16))
    assert tops.launch_counts == before


def test_cpu_route_takes_plain_version_without_a_launch():
    tops.reset_launch_counts()
    x, w = _inputs((1, 3, 5, 5, 32), (3, 3, 32, 16))
    tops.spatial_conv(torch.from_numpy(x), torch.from_numpy(w))
    tops.temporal_conv(torch.from_numpy(x), torch.from_numpy(w[0]))
    assert tops.launch_counts == {"spatial_conv": 0, "temporal_conv": 0, "temporal_dw": 0,
                                  "fused_block": 0}
