"""Repeatable training and the reference's pixels, on the CPU.

- The max pool's backward as a gather (ops/maxpool_grad.py): its plain
  version equals autograd through ``F.max_pool3d`` bit for bit (f32 and f64,
  where both sum in the input's type) at every pool shape of
  tests/test_torch_port_maxpool.py's CASES, with and without ties, in 'sas'
  and 'sep'; a transliteration of csrc/maxpool_grad.cu's walk (one element
  at a time, its windows in output order, each window's first maximum)
  equals the plain version bit for bit; the wrapper's route (a CPU tensor
  the plain version, no kernel launch), the pools without a gradient
  (``_reduce_max`` alone) and the ctypes binding against the C signature.
- The deterministic scope of train/loop.py: on for 'cuda', restored after,
  nested, a no-op on the CPU; ``CUBLAS_WORKSPACE_CONFIG`` set on import.
- ``--source mp4pack`` (benchmarks/accuracy_hard.py): at 2 classes of 2 + 1
  videos its packs hold, bit for bit, the frames the JAX package's
  ``ClipDataset`` decodes from the JAX package's own ``make_motion_dataset``
  ``.mp4`` files (every frame, the eval clips and a train clip); a missing
  or mismatched pack raises.
"""

import ctypes
import itertools
import os
import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from fastvideotagging_tpu.config import ClipSamplerConfig as JClipSamplerConfig
from fastvideotagging_tpu.config import DataConfig as JDataConfig
from fastvideotagging_tpu.data import pipeline as jpipeline
from fastvideotagging_tpu.data import synthetic_motion as jmotion
from fastvideotagging_tpu.data.ucf101 import load_video_list as jload_video_list
from fastvideotagging_tpu_torch.benchmarks import accuracy_hard
from fastvideotagging_tpu_torch.config import ClipSamplerConfig, DataConfig
from fastvideotagging_tpu_torch.data.packed import Pack, PackedDataset
from fastvideotagging_tpu_torch.ops import _build
from fastvideotagging_tpu_torch.ops import maxpool_grad as mp
from fastvideotagging_tpu_torch.train.loop import deterministic
from test_torch_port_maxpool import CASES

SHAPE = (2, 5, 7, 6, 3)


def _x(ties: bool, dtype=torch.float64) -> torch.Tensor:
    rng = np.random.default_rng(11)
    x = rng.integers(0, 3, size=SHAPE) if ties else rng.normal(size=SHAPE)
    return torch.tensor(x, dtype=dtype)


def _library_pool(x, window, strides, pads, mode):
    """The pool as autograd through F.max_pool3d on the -inf padded input,
    one 3D pool ('sas') or the chain of 1D pools ('sep')."""
    def one(a, w, s, p):
        y = F.max_pool3d(mp._pad(a, p, float("-inf")).permute(0, 4, 1, 2, 3), w, s)
        return y.permute(0, 2, 3, 4, 1)

    if mode == "sas":
        return one(x, window, strides, pads)
    for i in mp._sep_dims(window, strides, pads):
        x = one(x, *mp._axis_spec(i, window, strides, pads))
    return x


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("mode", ["sas", "sep"])
@pytest.mark.parametrize("ties", [False, True], ids=["tie_free", "ties"])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_plain_backward_is_autograd_through_max_pool3d(case, ties, mode, dtype):
    window, strides, padding = CASES[case]
    pads = mp.resolve_pads(SHAPE[1:4], window, strides, padding)
    x = _x(ties, dtype).requires_grad_(True)
    y = mp.max_pool_nthwc(x, window, strides, padding, grad=mode)
    assert y.grad_fn is not None and "_GatherPool" in type(y.grad_fn).__name__
    ct = torch.tensor(np.random.default_rng(12).normal(size=y.shape), dtype=dtype)
    y.backward(ct)
    xr = _x(ties, dtype).requires_grad_(True)
    yr = _library_pool(xr, window, strides, pads, mode)
    yr.backward(ct)
    assert torch.equal(y, yr)
    assert torch.equal(x.grad, xr.grad)


def _kernel_walk(x, y, ct, window, strides, pads):
    """csrc/maxpool_grad.cu's walk, element by element, in f64 numpy: the
    windows holding the element in output (t, h, w) order, each adding its
    cotangent where the element is the window's first maximum (positions
    outside the input the -inf pad), the sum rounded once."""
    x, y, ct = (a.double().numpy() for a in (x, y, ct))
    n, *d, c = x.shape
    o = y.shape[1:4]
    lo_pad = [p[0] for p in pads]
    dx = np.zeros_like(x)
    for b, i0, i1, i2, ch in itertools.product(range(n), *map(range, d), range(c)):
        i = (i0, i1, i2)
        spans = []
        for a in range(3):
            q = i[a] + lo_pad[a]
            first = q - window[a] + 1
            lo = 0 if first <= 0 else -(-first // strides[a])
            spans.append(range(lo, min(q // strides[a], o[a] - 1) + 1))
        acc = 0.0
        for ow in itertools.product(*spans):
            yv = y[(b, *ow, ch)]
            if x[(b, *i, ch)] != yv:
                continue
            start = [ow[a] * strides[a] - lo_pad[a] for a in range(3)]
            for e in itertools.product(*(range(start[a], start[a] + window[a])
                                         for a in range(3))):
                if e == i:
                    acc += ct[(b, *ow, ch)]
                    break
                inside = all(0 <= e[a] < d[a] for a in range(3))
                if (x[(b, *e, ch)] if inside else -np.inf) == yv:
                    break
        dx[(b, *i, ch)] = acc
    return torch.from_numpy(dx)


@pytest.mark.parametrize("ties", [False, True], ids=["tie_free", "ties"])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_kernel_walk_equals_the_plain_version(case, ties):
    window, strides, padding = CASES[case]
    x = _x(ties)
    pads = mp.resolve_pads(SHAPE[1:4], window, strides, padding)
    for w, s, p in ([(window, strides, pads)]
                    + [mp._axis_spec(i, window, strides, pads)
                       for i in mp._sep_dims(window, strides, pads)]):
        y = mp._reduce_max(x, w, s, p)
        ct = torch.tensor(np.random.default_rng(13).normal(size=y.shape))
        assert torch.equal(_kernel_walk(x, y, ct, w, s, p),
                           mp.maxpool_grad_plain(x, y, ct, w, s, p))


def test_wrapper_route_and_the_pools_without_a_gradient(monkeypatch):
    """A CPU tensor takes the plain version and launches nothing; a pool
    with no gradient wanted is ``_reduce_max`` alone (eval, serving and
    export unchanged); bf16 sums in f32 and rounds once."""
    mp.reset_launch_counts()
    pads = ((1, 1),) * 3
    x = _x(False, torch.bfloat16).requires_grad_(True)
    y = mp.max_pool_nthwc(x, (3, 3, 3), (1, 1, 1), pads, train=True)  # 'sep'
    ct = torch.tensor(np.random.default_rng(14).normal(size=y.shape), dtype=torch.bfloat16)
    y.backward(ct)
    # the last 1D pool's gradient: its f32 sums rounded once to bf16
    w, s, p = mp._axis_spec(2, (3, 3, 3), (1, 1, 1), pads)
    xw = mp.max_pool_nthwc(x.detach(), (3, 3, 1), (1, 1, 1), pads[:2] + ((0, 0),), grad="sep")
    got = mp.maxpool_grad(xw, y.detach(), ct, w, s, p)
    want = mp.maxpool_grad_plain(xw.float(), y.detach().float(), ct.float(), w, s, p)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want.to(torch.bfloat16))
    assert x.grad.dtype == torch.bfloat16
    assert mp.launch_counts == {"maxpool_grad": 0}
    with torch.no_grad():
        assert mp.max_pool_nthwc(x, (3, 3, 3), (1, 1, 1), ((1, 1),) * 3,
                                 train=True).grad_fn is None
    calls = []
    monkeypatch.setattr(mp, "maxpool_grad_plain", lambda *a: calls.append(a) or torch.zeros(1))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        mp.maxpool_grad(x.detach().to("meta"), y.detach().to("meta"), ct.to("meta"),
                        (3, 1, 1), (1, 1, 1), ((1, 1), (0, 0), (0, 0)))
    assert not calls


def test_kernel_argtypes_match_its_c_signature():
    with open(os.path.join(_build.CSRC, "maxpool_grad.cu")) as f:
        src = f.read()
    params = re.search(r"int fvt_maxpool_grad\(([^)]*)\)", src).group(1).split(",")

    def kind(param):
        if "*" in param:
            return ctypes.c_void_p
        return ctypes.c_longlong if "long long" in param else ctypes.c_int

    assert mp._ARGTYPES == [kind(q) for q in params]
    assert "maxpool_grad" in _build.sources()


def test_deterministic_scope_sets_and_restores_the_flags():
    cudnn = torch.backends.cudnn
    before = (torch.are_deterministic_algorithms_enabled(), cudnn.deterministic,
              cudnn.benchmark)
    assert os.environ["CUBLAS_WORKSPACE_CONFIG"] in (":4096:8", ":16:8")
    with deterministic("cpu"):
        assert torch.are_deterministic_algorithms_enabled() == before[0]
    cudnn.benchmark = True
    try:
        with deterministic(torch.device("cuda")):
            assert torch.are_deterministic_algorithms_enabled()
            assert not torch.is_deterministic_algorithms_warn_only_enabled()
            assert cudnn.deterministic and not cudnn.benchmark
            with deterministic("cuda"):
                pass
            assert torch.are_deterministic_algorithms_enabled() and cudnn.deterministic
        assert cudnn.benchmark
    finally:
        cudnn.benchmark = before[2]
    assert (torch.are_deterministic_algorithms_enabled(), cudnn.deterministic,
            cudnn.benchmark) == before


# --- --source mp4pack against the JAX package's decoded .mp4 files -------

TINY = dict(train_per_class=2, eval_per_class=1)


def _data(cfg_cls, sampler_cls):
    return cfg_cls(source_hw=accuracy_hard.VIDEO_HW, resize_hw=(40, 40), crop_hw=(32, 32),
                   random_flip=False, num_workers=0,
                   sampler=sampler_cls(clip_len=8, stride=2, eval_mode="uniform",
                                       num_eval_clips=4))


def test_mp4pack_holds_the_pixels_the_jax_clip_dataset_decodes(tmp_path):
    train, ev = accuracy_hard.motion_sources(str(tmp_path / "port"), "mp4pack", 2, 0, **TINY)
    lists = jmotion.make_motion_dataset(str(tmp_path / "jax"), num_classes=2, seed=0, **TINY)
    for pack_path, jlist in zip((train, ev), lists):
        pack = Pack(pack_path)
        assert pack.meta == {**accuracy_hard.motion_set(2, 0, **TINY),
                             "cv2": pack.meta["cv2"]} and pack.meta["cv2"]
        jrecs = jload_video_list(jlist, root=str(tmp_path / "jax"))
        jds = jpipeline.ClipDataset(jrecs, _data(JDataConfig, JClipSamplerConfig), mode="eval")
        ds = PackedDataset(pack_path, _data(DataConfig, ClipSamplerConfig), mode="eval")
        tds = PackedDataset(pack_path, _data(DataConfig, ClipSamplerConfig), mode="train")
        jtds = jpipeline.ClipDataset(jrecs, _data(JDataConfig, JClipSamplerConfig), mode="train")
        assert len(pack) == len(jrecs) == 2 * (2 if pack_path == train else 1)
        for i, rec in enumerate(jrecs):
            n = jds._num_frames(rec)
            assert pack.entries[i]["probe_frames"] == n and pack.entries[i]["label"] == rec.label
            np.testing.assert_array_equal(pack.video_view(i), jds._clip_frames(rec, np.arange(n)))
            np.testing.assert_array_equal(ds.get_eval_clips(i)[0], jds.get_eval_clips(i)[0])
            got, want = tds.get_train(i, 1), jtds.get_train(i, 1)
            np.testing.assert_array_equal(got.frames, want.frames)
            assert (got.crop_top, got.crop_left, got.label) == (
                want.crop_top, want.crop_left, want.label)


def test_mp4pack_missing_or_mismatched_packs_raise(tmp_path):
    pack_dir = str(tmp_path / "packs")
    with pytest.raises(FileNotFoundError, match="no mp4pack train pack"):
        accuracy_hard.motion_sources(str(tmp_path), "mp4pack", 2, 0, pack_dir, **TINY)
    accuracy_hard.write_mp4_packs(pack_dir, 2, 0, **TINY)
    train, ev = accuracy_hard.motion_sources(str(tmp_path), "mp4pack", 2, 0, pack_dir, **TINY)
    assert (train, ev) == tuple(os.path.join(pack_dir, n) for n in ("train.fvtpack",
                                                                    "eval.fvtpack"))
    for other in (dict(num_classes=3, seed=0), dict(num_classes=2, seed=1)):
        with pytest.raises(ValueError, match="holds another set"):
            accuracy_hard.motion_sources(str(tmp_path), "mp4pack", other["num_classes"],
                                         other["seed"], pack_dir, **TINY)
    with pytest.raises(ValueError, match="holds another set"):
        accuracy_hard.mp4pack_paths(pack_dir, 2, 0)  # the default geometry: 16 + 4 a class
    os.remove(ev)
    with pytest.raises(FileNotFoundError, match="no mp4pack eval pack"):
        accuracy_hard.mp4pack_paths(pack_dir, 2, 0, **TINY)
    with pytest.raises(ValueError, match="no mp4pack packs"):
        accuracy_hard.run_multilabel(source="mp4pack", device="cpu")
