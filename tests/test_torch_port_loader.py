"""The port's loader against the JAX package's: ``train_batches`` batch for
batch (exactly: frames, labels, crop offsets, flips, weights, multihot), from
``.mp4`` lists and from a ``.fvtpack`` with ``rows=``; ``device_prefetch``
on the CPU; ``read_all_frames``; the synthetic generators (``make_dataset``,
``synthetic_motion``), which must write the same frames and list files; and
the layout adapters.

The mp4 lists are the conftest's synthetic set (6 videos, 24 frames at
48x64). The configs ship frames at their decoded size (``source_hw``), so
no host resize runs and both packages see cv2's frames unchanged.
"""

import dataclasses
import os
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvideotagging_tpu import config as jconfig
from fastvideotagging_tpu.data import decode as jdecode
from fastvideotagging_tpu.data import packed as jpacked
from fastvideotagging_tpu.data import pipeline as jpipeline
from fastvideotagging_tpu.data import synthetic as jsynthetic
from fastvideotagging_tpu.data import synthetic_motion as jmotion
from fastvideotagging_tpu.data import ucf101 as jucf101
from fastvideotagging_tpu.utils import layout as jlayout
from fastvideotagging_tpu_torch import config as tconfig
from fastvideotagging_tpu_torch.data import decode as tdecode
from fastvideotagging_tpu_torch.data import packed as tpacked
from fastvideotagging_tpu_torch.data import pipeline as tpipeline
from fastvideotagging_tpu_torch.data import synthetic as tsynthetic
from fastvideotagging_tpu_torch.data import synthetic_motion as tmotion
from fastvideotagging_tpu_torch.data import ucf101 as tucf101
from fastvideotagging_tpu_torch.utils import layout as tlayout


def _data_cfgs(**kw):
    return [mod.DataConfig(source_hw=(48, 64), resize_hw=(40, 56), crop_hw=(32, 32),
                           sampler=mod.ClipSamplerConfig(clip_len=4, stride=2),
                           **kw)
            for mod in (jconfig, tconfig)]


def _assert_same_batches(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in w:
            assert g[key].dtype == w[key].dtype, key
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)


@pytest.fixture()
def record_lists(synthetic_dataset):
    root, list_path = synthetic_dataset
    return (jucf101.load_video_list(list_path, root=root),
            tucf101.load_video_list(list_path, root=root))


@pytest.mark.parametrize("batch_size,drop_last,multilabel", [
    (3, True, False), (4, False, False), (2, True, True)])
def test_train_batches_match_jax_from_video_lists(record_lists, batch_size, drop_last,
                                                  multilabel):
    jrecs, trecs = record_lists
    jd, td = _data_cfgs()
    num_tags = None
    if multilabel:  # tag sets: each video's label and the next one
        num_tags = 3
        jrecs = [dataclasses.replace(r, tags=(r.label, (r.label + 1) % 3)) for r in jrecs]
        trecs = [dataclasses.replace(r, tags=(r.label, (r.label + 1) % 3)) for r in trecs]
    jds = jpipeline.ClipDataset(jrecs, jd, num_tags=num_tags, seed=5)
    tds = tpipeline.ClipDataset(trecs, td, num_tags=num_tags, seed=5)
    for epoch in (0, 1):
        want = list(jpipeline.train_batches(jds, batch_size, epoch, num_workers=2,
                                            drop_last=drop_last))
        got = list(tpipeline.train_batches(tds, batch_size, epoch, num_workers=2,
                                           drop_last=drop_last))
        _assert_same_batches(got, want)
        assert ("multihot" in got[0]) == multilabel
        if not drop_last:  # 6 videos, batch 4: a last batch of 2
            assert [len(b["labels"]) for b in got] == [4, 2]


def test_train_batches_match_jax_from_a_pack(record_lists, tmp_path):
    """One pack, written by the port, read by both packages; ``rows=``
    yields those rows of each full batch."""
    _, trecs = record_lists
    path = str(tmp_path / "train.fvtpack")
    tpacked.write_pack(trecs, path, (48, 64))
    jd, td = _data_cfgs(random_flip=True)
    jds = jpacked.open_dataset(path, jd, mode="train", seed=3)
    tds = tpacked.open_dataset(path, td, mode="train", seed=3)
    assert isinstance(tds, tpacked.PackedDataset)
    for epoch in (0, 1):
        for rows in (None, [0, 2]):
            want = list(jpipeline.train_batches(jds, 3, epoch, num_workers=2, rows=rows))
            got = list(tpipeline.train_batches(tds, 3, epoch, num_workers=2, rows=rows))
            _assert_same_batches(got, want)
        full = list(tpipeline.train_batches(tds, 3, epoch, num_workers=2))
        sub = list(tpipeline.train_batches(tds, 3, epoch, num_workers=2, rows=[0, 2]))
        for f, s in zip(full, sub):
            assert all(np.array_equal(f[k][[0, 2]], s[k]) for k in f)


def test_train_batches_edge_cases_match_jax(record_lists):
    jrecs, trecs = record_lists
    jd, td = _data_cfgs()
    jds, tds = jpipeline.ClipDataset(jrecs, jd), tpipeline.ClipDataset(trecs, td)
    # 6 videos < batch 7: with drop_last no full batch exists, nothing decodes
    assert list(tpipeline.train_batches(tds, 7, 0, num_workers=2)) == []
    assert list(jpipeline.train_batches(jds, 7, 0, num_workers=2)) == []
    _assert_same_batches(
        list(tpipeline.train_batches(tds, 7, 0, num_workers=2, drop_last=False)),
        list(jpipeline.train_batches(jds, 7, 0, num_workers=2, drop_last=False)))
    with pytest.raises(ValueError, match="rows must be within"):
        list(tpipeline.train_batches(tds, 2, 0, rows=[2]))
    with pytest.raises(ValueError, match="drop_last"):
        list(tpipeline.train_batches(tds, 2, 0, drop_last=False, rows=[0]))


@pytest.mark.parametrize("n,depth", [(7, 3), (1, 4), (0, 2), (5, 1)])
def test_device_prefetch_on_the_cpu_keeps_order_and_count(n, depth):
    src = [{"x": np.full((2,), i), "flag": np.array([i % 2 == 0])} for i in range(n)]
    out = list(tpipeline.device_prefetch(iter(src), device="cpu", depth=depth))
    assert len(out) == n
    for i, b in enumerate(out):
        assert isinstance(b["x"], torch.Tensor) and b["x"].device.type == "cpu"
        np.testing.assert_array_equal(b["x"].numpy(), np.full((2,), i))
        assert b["flag"].dtype == torch.bool


def test_device_prefetch_stops_its_thread_and_raises_the_source_error():
    """Closed after one batch, the prefetch stops its producer thread
    (which pulled at most depth + 1 batches ahead) and leaves the source
    open for its owner; an error in the source reaches the consumer after
    the batches before it."""
    pulled = []

    def source(n, fail_at=None):
        for i in range(n):
            if i == fail_at:
                raise OSError(f"bad batch {i}")
            pulled.append(i)
            yield {"x": np.full((2,), i)}

    src = source(50)
    it = tpipeline.device_prefetch(src, device="cpu", depth=2)
    assert int(next(it)["x"][0]) == 0
    it.close()
    assert not any(t.name == "device_prefetch" for t in threading.enumerate())
    assert len(pulled) <= 1 + 2 + 1
    assert int(next(src)["x"][0]) == len(pulled) - 1  # the source goes on
    src.close()
    got = []
    with pytest.raises(OSError, match="bad batch 3"):
        for b in tpipeline.device_prefetch(source(6, fail_at=3), device="cpu", depth=2):
            got.append(int(b["x"][0]))
    assert got == [0, 1, 2]


def test_read_all_frames_matches_jax(record_lists):
    _, trecs = record_lists
    path = trecs[0].path
    for max_frames in (None, 5):
        np.testing.assert_array_equal(tdecode.read_all_frames(path, max_frames),
                                      jdecode.read_all_frames(path, max_frames))
    with pytest.raises(tdecode.DecodeError):
        tdecode.read_all_frames(path + ".missing")


def _decoded_tree(root, list_path):
    with open(list_path) as f:
        lines = f.read()
    rels = [line.split()[0] for line in lines.splitlines() if line]
    return lines, [tdecode.read_all_frames(os.path.join(root, r)) for r in rels]


def test_make_dataset_writes_what_jax_writes(tmp_path):
    kw = dict(num_classes=2, videos_per_class=2, num_frames=6, height=32, width=40, seed=3)
    a = tsynthetic.make_dataset(str(tmp_path / "port"), **kw)
    b = jsynthetic.make_dataset(str(tmp_path / "jax"), **kw)
    assert os.path.relpath(a, tmp_path / "port") == os.path.relpath(b, tmp_path / "jax")
    (la, fa), (lb, fb) = (_decoded_tree(str(tmp_path / "port"), a),
                          _decoded_tree(str(tmp_path / "jax"), b))
    assert la == lb and len(fa) == 4
    for x, y in zip(fa, fb):
        np.testing.assert_array_equal(x, y)


def test_synthetic_motion_matches_jax(tmp_path):
    assert tmotion.MAX_CLASSES == jmotion.MAX_CLASSES
    for label in (0, 17, 63):
        assert tmotion.class_params(label) == jmotion.class_params(label)
    for args in ((9, 2), (33, 5)):
        np.testing.assert_array_equal(
            tmotion.make_motion_frames(*args, num_frames=7, height=24, width=20, seed=1),
            jmotion.make_motion_frames(*args, num_frames=7, height=24, width=20, seed=1))
    np.testing.assert_array_equal(
        tmotion.make_multi_motion_frames([3, 40], 4, num_frames=5, height=16, width=24),
        jmotion.make_multi_motion_frames([3, 40], 4, num_frames=5, height=16, width=24))
    assert tmotion.tag_index(5) == jmotion.tag_index(5)
    with pytest.raises(ValueError):
        tmotion.class_params(tmotion.MAX_CLASSES)
    small = dict(num_frames=4, height=16, width=16, seed=2)
    for make, kw in (("make_motion_dataset", dict(num_classes=2, train_per_class=1,
                                                  eval_per_class=1)),
                     ("make_tagging_dataset", dict(num_classes=4, train_videos=2,
                                                   eval_videos=1))):
        got = getattr(tmotion, make)(str(tmp_path / make / "port"), **kw, **small)
        want = getattr(jmotion, make)(str(tmp_path / make / "jax"), **kw, **small)
        for g, w in zip(got, want):
            (lg, fg), (lw, fw) = (_decoded_tree(str(tmp_path / make / "port"), g),
                                  _decoded_tree(str(tmp_path / make / "jax"), w))
            assert lg == lw and fg
            for x, y in zip(fg, fw):
                np.testing.assert_array_equal(x, y)


def test_layout_matches_jax():
    x = np.random.default_rng(0).normal(size=(2, 3, 4, 5, 6)).astype(np.float32)
    got = tlayout.ncthw_to_nthwc(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jlayout.ncthw_to_nthwc(jnp.asarray(x))))
    back = tlayout.nthwc_to_ncthw(got)
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(
        tlayout.nthwc_to_ncthw(torch.from_numpy(x)).numpy(),
        np.asarray(jlayout.nthwc_to_ncthw(jnp.asarray(x))))
