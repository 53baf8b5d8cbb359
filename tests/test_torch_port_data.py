"""The port's host data path and device preprocess against the JAX package.

Sampling indices, resize coefficients, synthetic frames and the host resize
must be exactly equal (integer / identical float arithmetic); the device
preprocess agrees within atol 1e-4 (tests/test_preprocess_device.py:38).
"""

from dataclasses import asdict

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvideotagging_tpu import config as jcfg
from fastvideotagging_tpu import native as jnative
from fastvideotagging_tpu.data import preprocess as jpre
from fastvideotagging_tpu.data import sampler as jsampler
from fastvideotagging_tpu.data import synthetic as jsynth
from fastvideotagging_tpu.ops import preprocess_kernel as jkernel
from fastvideotagging_tpu_torch import config as tcfg
from fastvideotagging_tpu_torch.data import frames as tframes
from fastvideotagging_tpu_torch.data import preprocess as tpre
from fastvideotagging_tpu_torch.data import sampler as tsampler
from fastvideotagging_tpu_torch.data import synthetic as tsynth
from fastvideotagging_tpu_torch.ops import preprocess as tkernel

MEAN = (0.43216, 0.394666, 0.37645)
STD = (0.22803, 0.22145, 0.216989)


@pytest.mark.parametrize("num_frames", [1, 7, 16, 31, 160, 257])
@pytest.mark.parametrize("clip_len,stride", [(16, 1), (4, 2), (8, 3)])
@pytest.mark.parametrize("mode", ["center", "uniform", "dense"])
def test_sample_eval_indices_equal(num_frames, clip_len, stride, mode):
    want = jsampler.sample_eval_indices(num_frames, clip_len, stride, mode=mode, num_clips=5)
    got = tsampler.sample_eval_indices(num_frames, clip_len, stride, mode=mode, num_clips=5)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_train_sampling_and_crops_equal():
    for i in range(20):
        n = 5 + 13 * i
        a = jsampler.sample_train_indices(n, 16, 2, jsampler.train_rng(3, 1, i))
        b = tsampler.sample_train_indices(n, 16, 2, tsampler.train_rng(3, 1, i))
        np.testing.assert_array_equal(a, b)
        assert (jsampler.random_crop_offsets(128, 171, 112, 112, jsampler.train_rng(0, 0, i))
                == tsampler.random_crop_offsets(128, 171, 112, 112, tsampler.train_rng(0, 0, i)))
    assert tsampler.center_crop_offsets(128, 171, 112, 112) == \
        jsampler.center_crop_offsets(128, 171, 112, 112)
    assert tsampler.clip_span(16, 3) == jsampler.clip_span(16, 3)
    with pytest.raises(ValueError):
        tsampler.sample_eval_indices(10, 4, 1, mode="nope")


@pytest.mark.parametrize("src,dst", [(128, 128), (240, 128), (320, 171), (48, 40), (7, 13)])
def test_resize_coeffs_equal(src, dst):
    np.testing.assert_array_equal(tpre.resize_coeffs(src, dst), jpre.resize_coeffs(src, dst))


def test_host_spec_and_frames_equal():
    a = jsynth.make_frames(5, num_frames=6, height=48, width=64, seed=2)
    b = tsynth.make_frames(5, num_frames=6, height=48, width=64, seed=2)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        tpre.preprocess_clip_host(b, (40, 56), (3, 5), (32, 32), MEAN, STD, flip=True),
        jpre.preprocess_clip_host(a, (40, 56), (3, 5), (32, 32), MEAN, STD, flip=True))
    # the port resizes as the JAX package's default tier does: its C tier
    assert jnative.available()
    np.testing.assert_array_equal(tframes._ensure_size(b, (40, 56)),
                                  jnative.resize_batch_u8(a, 40, 56))
    assert tframes._ensure_size(b, (48, 64)) is b


def _u8(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, size=shape, dtype=np.uint8)


def test_preprocess_batch_crop_and_flip_matches_jax():
    frames = _u8((3, 2, 30, 44, 3), seed=0)
    tops = np.array([0, 3, 6], np.int32)
    lefts = np.array([7, 0, 12], np.int32)
    flips = np.array([True, False, True])
    want = jkernel.preprocess_batch(
        jnp.asarray(frames), jnp.asarray(tops), jnp.asarray(lefts), jnp.asarray(flips),
        jnp.asarray(MEAN, jnp.float32), jnp.asarray(STD, jnp.float32),
        resize_hw=(32, 40), crop_hw=(24, 28), out_dtype_name="float32")
    got = tkernel.preprocess_batch(
        torch.from_numpy(frames), torch.from_numpy(tops), torch.from_numpy(lefts),
        torch.from_numpy(flips), MEAN, STD, resize_hw=(32, 40), crop_hw=(24, 28),
        out_dtype=torch.float32)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


@pytest.mark.parametrize("src_hw", [(40, 56), (48, 64)])
def test_preprocess_eval_clip_matches_jax(src_hw):
    frames = _u8((2, 3) + src_hw + (3,), seed=1)
    want = jkernel.preprocess_eval_clip(frames, (40, 56), (32, 32), MEAN, STD,
                                        out_dtype_name="float32")
    got = tkernel.preprocess_eval_clip(torch.from_numpy(frames), (40, 56), (32, 32),
                                       MEAN, STD)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
    bf = tkernel.preprocess_eval_clip(torch.from_numpy(frames), (40, 56), (32, 32),
                                      MEAN, STD, out_dtype=torch.bfloat16)
    assert bf.dtype == torch.bfloat16


def test_config_defaults_equal_except_kernels():
    for name in ("ClipSamplerConfig", "DataConfig"):
        assert asdict(getattr(tcfg, name)()) == asdict(getattr(jcfg, name)())
    jm, tm = asdict(jcfg.ModelConfig()), asdict(tcfg.ModelConfig())
    assert (jm.pop("kernels"), tm.pop("kernels")) == ("xla", "cuda")
    assert jm == tm
