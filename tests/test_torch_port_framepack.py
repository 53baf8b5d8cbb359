"""The port's host data plane (csrc/framepack.c through ``native``) against
the JAX package's default tier, its C ``native.resize_batch_u8``, bit for
bit: the resize at three shapes and ``_ensure_size`` (the serving, export
and pack-building resize), ``pack_frames`` with its clamping, the numpy
plain version held within one level, and the build: keyed into ``_build/``
and raising, never falling back, where it cannot be built."""

import os

import numpy as np
import pytest

from fastvideotagging_tpu import native as jnative
from fastvideotagging_tpu_torch import native as tnative
from fastvideotagging_tpu_torch.data import frames as tframes
from fastvideotagging_tpu_torch.ops import _build

SHAPES = [((48, 64), (112, 112)), ((48, 64), (40, 56)), ((240, 320), (128, 171))]


def _frames(hw, seed: int, t: int = 8) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, size=(t, *hw, 3), dtype=np.uint8)


def test_the_reference_runs_its_c_tier():
    assert jnative.available()  # the JAX package's default: its C tier, not numpy
    assert tnative.available()


@pytest.mark.parametrize("src,dst", SHAPES, ids=[f"{s[0]}x{s[1]}-{d[0]}x{d[1]}" for s, d in SHAPES])
def test_resize_equals_the_reference_c_tier(src, dst):
    """The port's resize and ``_ensure_size`` equal the JAX package's
    default ``resize_batch_u8`` bit for bit; the numpy plain version lies
    within one level of it (the C tier's fused multiply-adds round
    otherwise at a few values)."""
    x = _frames(src, seed=sum(src) + sum(dst))
    want = jnative.resize_batch_u8(x, *dst)
    np.testing.assert_array_equal(tnative.resize_batch_u8(x, *dst), want)
    np.testing.assert_array_equal(tframes._ensure_size(x, dst), want)
    plain = tframes.resize_batch_u8_plain(x, *dst)
    assert np.abs(plain.astype(np.int16) - want).max() <= 1


def test_ensure_size_leaves_ship_size_frames_alone_and_checks_shapes():
    x = _frames((40, 56), seed=1, t=2)
    assert tframes._ensure_size(x, (40, 56)) is x
    for bad in (np.zeros((2, 8, 8), np.uint8), np.zeros((2, 8, 8, 4), np.uint8)):
        with pytest.raises(ValueError, match="expected"):
            tnative.resize_batch_u8(bad, 4, 4)
    with pytest.raises(ValueError, match="positive"):
        tnative.resize_batch_u8(x, 0, 4)


def test_pack_frames_equals_the_reference_and_clamps():
    x = _frames((6, 5), seed=2, t=5)
    idx = np.array([-3, 0, 2, 4, 9, 1])
    got = tnative.pack_frames(x, idx)
    np.testing.assert_array_equal(got, jnative.pack_frames(x, idx))
    np.testing.assert_array_equal(got, x[[0, 0, 2, 4, 4, 1]])
    assert tnative.pack_frames(x, np.array([], np.int64)).shape == (0, 6, 5, 3)
    with pytest.raises(ValueError, match="at least one frame"):
        tnative.pack_frames(x[:0], idx)


def test_the_library_is_built_with_the_reference_flags_into_build_dir():
    path = _build.build_framepack()
    assert os.path.dirname(path) == _build.BUILD_DIR
    assert os.path.basename(path).startswith("libfvt_framepack-")
    assert _build.FRAMEPACK_FLAGS == ("-O3", "-march=native", "-shared", "-fPIC")
    assert _build.build_framepack() == path  # keyed: built once


def test_no_compiler_raises_instead_of_falling_back(monkeypatch, tmp_path):
    """Without a C compiler (and no library built) the entry points raise,
    naming the reason; ``available()`` says False; nothing resizes with
    numpy instead."""
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="no C compiler"):
        tnative.resize_batch_u8(_frames((8, 8), seed=3, t=1), 4, 4)
    with pytest.raises(RuntimeError, match="no C compiler"):
        tframes._ensure_size(_frames((8, 8), seed=3, t=1), (4, 4))
    assert not tnative.available()


def test_a_failed_build_raises(monkeypatch, tmp_path):
    """A compiler that fails: the build raises with its output, and no
    library is left behind."""
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_cc", lambda: "false")
    with pytest.raises(RuntimeError, match="building framepack failed"):
        tnative.pack_frames(_frames((4, 4), seed=4, t=2), np.array([0]))
    assert not any(f.endswith(".so") for f in os.listdir(tmp_path))
