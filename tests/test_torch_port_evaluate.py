"""The port's evaluation path against the JAX package's, on the CPU: packs
(byte-identical in both directions), ClipDataset / PackedDataset sampling,
``evaluate`` (video scores and metrics), the fused engine as ``apply_fn``,
and the numpy-only copies (split lists, logging).

Small sizes: 40x48 frames, 32x32 crops, clip_len 4, dense clips, an
R(2+1)D with one block in each of two stages. Frames are made with numpy
from a seed. In f32 the two packages' video scores agree within 1e-4
(summation order only); the fused engine computes in bf16 and is held to
5e-2, the JAX engine's model-level bound.
"""

import dataclasses
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvideotagging_tpu import config as jcfg
from fastvideotagging_tpu.data import packed as jpacked
from fastvideotagging_tpu.data import pipeline as jpipeline
from fastvideotagging_tpu.data import ucf101 as jucf
from fastvideotagging_tpu.evaluation import evaluate as jeval
from fastvideotagging_tpu.models.r2plus1d import R2Plus1D as JR2Plus1D
from fastvideotagging_tpu_torch import config as tcfg
from fastvideotagging_tpu_torch.data import packed as tpacked
from fastvideotagging_tpu_torch.data import pipeline as tpipeline
from fastvideotagging_tpu_torch.data import synthetic
from fastvideotagging_tpu_torch.data import ucf101 as tucf
from fastvideotagging_tpu_torch.evaluation import evaluate as teval
from fastvideotagging_tpu_torch.models import heads
from fastvideotagging_tpu_torch.models.convert import from_jax_variables
from fastvideotagging_tpu_torch.models.r2plus1d import R2Plus1D as TR2Plus1D
from fastvideotagging_tpu_torch.ops import conv2plus1d as ops
from fastvideotagging_tpu_torch.ops.fused_infer import r2plus1d_fused_infer
from fastvideotagging_tpu_torch.utils import logging as tlogging

NUM_CLASSES = 5
HW = (40, 48)
SCORE_ATOL = 1e-4
ENGINE_TOL = 5e-2
# frame counts: dense clips 0,4,8 + a tail window; two windows; a video
# shorter than one clip (indices wrap)
VIDEOS = [(13, 1, (0, 2)), (8, 3, (1,)), (3, 4, (3, 4))]  # (frames, label, tags)


def _data(c, **kw):
    kw.setdefault("sampler", c.ClipSamplerConfig(clip_len=4, eval_mode="dense"))
    return c.DataConfig(resize_hw=HW, crop_hw=(32, 32), **kw)


def _cfg(c, multilabel, **data_kw):
    return c.ExperimentConfig(
        model=c.ModelConfig(name="r2plus1d_18", num_classes=NUM_CLASSES,
                            multilabel=multilabel, compute_dtype="float32"),
        data=_data(c, **data_kw))


def _items(with_tags=True):
    for i, (n, label, tags) in enumerate(VIDEOS):
        frames = synthetic.make_frames(label, num_frames=n, height=HW[0], width=HW[1], seed=i)
        yield f"v{i}.mp4", label, tags if with_tags else (), frames


@pytest.fixture(scope="module")
def packs(tmp_path_factory):
    root = tmp_path_factory.mktemp("packs")
    paths = {"torch": str(root / "t.fvtpack"), "jax": str(root / "j.fvtpack")}
    summary = {
        "torch": tpacked.write_pack_from_arrays(_items(), paths["torch"], HW, NUM_CLASSES),
        "jax": jpacked.write_pack_from_arrays(_items(), paths["jax"], HW, NUM_CLASSES),
    }
    return paths, summary


def test_pack_files_are_byte_identical_and_cross_readable(packs):
    paths, summary = packs
    assert {k: v for k, v in summary["torch"].items() if k != "path"} == {
        k: v for k, v in summary["jax"].items() if k != "path"}
    with open(paths["torch"], "rb") as f, open(paths["jax"], "rb") as g:
        blob = f.read()
        assert blob == g.read()
    assert blob[:8] == tpacked.MAGIC == jpacked.MAGIC
    for t_path, j_path in ((paths["jax"], paths["torch"]), (paths["torch"], paths["jax"])):
        tp, jp = tpacked.Pack(t_path), jpacked.Pack(j_path)
        assert (tp.height, tp.width, tp.num_tags) == (jp.height, jp.width, jp.num_tags)
        assert tp.entries == jp.entries
        assert ([dataclasses.astuple(r) for r in tp.records("root")]
                == [dataclasses.astuple(r) for r in jp.records("root")])
        for i in range(len(tp)):
            np.testing.assert_array_equal(tp.video_view(i), jp.video_view(i))
            idx = np.array([0, 5, 100, 2])  # past the end clamps to the last frame
            np.testing.assert_array_equal(tp.gather(i, idx), jp.gather(i, idx))
    assert tpacked.is_pack(paths["torch"]) and not tpacked.is_pack(["x.fvtpack"])


@pytest.mark.parametrize("num_tags", [None, NUM_CLASSES])
def test_packed_eval_clips_equal(packs, num_tags):
    paths, _ = packs
    # each package reads the other's pack
    tds = tpacked.open_dataset(paths["jax"], _data(tcfg), mode="eval", num_tags=num_tags)
    jds = jpacked.open_dataset(paths["torch"], _data(jcfg), mode="eval", num_tags=num_tags)
    assert isinstance(tds, tpacked.PackedDataset) and len(tds) == len(jds) == len(VIDEOS)
    for i in range(len(tds)):
        (a, ra), (b, rb) = tds.get_eval_clips(i), jds.get_eval_clips(i)
        assert a.dtype == np.uint8 and a.shape[1:] == (4,) + HW + (3,)
        np.testing.assert_array_equal(a, b)
        assert dataclasses.astuple(ra) == dataclasses.astuple(rb)


@pytest.mark.parametrize("seed,epoch,host_crop", [(0, 0, False), (3, 1, False), (7, 5, True)])
def test_packed_train_clips_equal(packs, seed, epoch, host_crop):
    paths, _ = packs
    tds = tpacked.PackedDataset(paths["torch"], _data(tcfg, host_crop=host_crop), seed=seed)
    jds = jpacked.PackedDataset(paths["jax"], _data(jcfg, host_crop=host_crop), seed=seed)
    assert tds.num_tags == NUM_CLASSES  # taken from the pack
    for index in range(5):  # past len(records): wraps onto the records again
        a, b = tds.get_train(index, epoch), jds.get_train(index, epoch)
        np.testing.assert_array_equal(a.frames, b.frames)
        assert (a.label, a.crop_top, a.crop_left, a.flip) == (
            b.label, b.crop_top, b.crop_left, b.flip)
        np.testing.assert_array_equal(a.multihot, b.multihot)
        rec_i, frame_idx, top, left, flip = tds.get_train_spec(index, epoch)
        np.testing.assert_array_equal(frame_idx, jds.get_train_spec(index, epoch)[1])
        assert (rec_i, top, left, flip) == jds.get_train_spec(index, epoch)[:1] + (
            jds.get_train_spec(index, epoch)[2:])


def test_dataset_guards_raise(packs, tmp_path):
    paths, _ = packs
    with pytest.raises(ValueError, match="pack geometry"):
        tpacked.PackedDataset(paths["torch"], tcfg.DataConfig(resize_hw=(48, 40)))
    tagless = str(tmp_path / "tagless.fvtpack")
    tpacked.write_pack_from_arrays(_items(with_tags=False), tagless, HW)
    with pytest.raises(ValueError, match="tag lists"):
        tpacked.PackedDataset(tagless, _data(tcfg), num_tags=NUM_CLASSES)
    records = tpacked.Pack(tagless).records()
    with pytest.raises(ValueError, match="needs records with tag sets"):
        tpipeline.ClipDataset(records, _data(tcfg), num_tags=NUM_CLASSES)
    with pytest.raises(ValueError, match="host_crop"):
        tpipeline.ClipDataset(records, _data(tcfg, host_crop=True, source_hw=(48, 64)))
    with pytest.raises(ValueError, match="mode must be"):
        tpipeline.ClipDataset(records, _data(tcfg), mode="test")
    with pytest.raises(ValueError, match="empty frame stack"):
        tpacked.write_pack_from_arrays([("e.mp4", 0, (), np.zeros((0,) + HW + (3,), np.uint8))],
                                       str(tmp_path / "e.fvtpack"), HW)
    with pytest.raises(ValueError, match="pack geometry"):
        tpacked.write_pack_from_arrays([("g.mp4", 0, (), np.zeros((2, 8, 8, 3), np.uint8))],
                                       str(tmp_path / "g.fvtpack"), HW)
    (tmp_path / "bad.fvtpack").write_bytes(b"NOTAPACK" + bytes(8))
    with pytest.raises(ValueError, match="not a .fvtpack"):
        tpacked.Pack(str(tmp_path / "bad.fvtpack"))
    assert type(tpacked.open_dataset(records, _data(tcfg))) is tpipeline.ClipDataset


@pytest.mark.parametrize("cache_mb", [0, 64])
def test_streaming_dataset_and_write_pack_match_jax(synthetic_dataset, tmp_path, cache_mb):
    # both sides resize with their C tier (the JAX package's default)
    root, list_path = synthetic_dataset
    records = tucf.load_video_list(list_path, root=root)
    assert ([dataclasses.astuple(r) for r in records]
            == [dataclasses.astuple(r) for r in jucf.load_video_list(list_path, root=root)])
    data = dict(resize_hw=(40, 56), crop_hw=(32, 32), cache_mb=cache_mb)
    t_data = tcfg.DataConfig(sampler=tcfg.ClipSamplerConfig(clip_len=4, stride=2), **data)
    j_data = jcfg.DataConfig(sampler=jcfg.ClipSamplerConfig(clip_len=4, stride=2), **data)
    tds = tpipeline.ClipDataset(records, t_data, mode="eval", seed=2)
    jds = jpipeline.ClipDataset(records, j_data, mode="eval", seed=2)
    for i in range(len(records)):
        np.testing.assert_array_equal(tds.get_eval_clips(i)[0], jds.get_eval_clips(i)[0])
    for index in range(3):
        a, b = tds.get_train(index, 1), jds.get_train(index, 1)
        np.testing.assert_array_equal(a.frames, b.frames)
        assert (a.crop_top, a.crop_left, a.flip) == (b.crop_top, b.crop_left, b.flip)
    if cache_mb:
        assert len(tds._frame_cache) == len(records)
    t_pack, j_pack = str(tmp_path / "t.fvtpack"), str(tmp_path / "j.fvtpack")
    assert tpacked.write_pack(records, t_pack, (40, 56), root=root)["videos"] == len(records)
    jpacked.write_pack(records, j_pack, (40, 56), root=root)
    with open(t_pack, "rb") as f, open(j_pack, "rb") as g:
        assert f.read() == g.read()


def test_split_lists_match_jax(tmp_path):
    (tmp_path / "classInd.txt").write_text("1 Walk\n2 Run\n\n")
    (tmp_path / "train.txt").write_text("Walk/a.avi 1\nRun/b.avi 2\n# c\n")
    (tmp_path / "test.txt").write_text("Walk/a.avi\nRun/b.avi\n")
    (tmp_path / "tags.txt").write_text("a.mp4 x,y\nb.mp4\nc.mp4 y,z\n")
    ci = str(tmp_path / "classInd.txt")
    assert tucf.load_class_index(ci) == jucf.load_class_index(ci) == {"Walk": 0, "Run": 1}
    for f, kw in (("train.txt", dict(class_index={"Walk": 0, "Run": 1})),
                  ("test.txt", dict(class_index={"Walk": 0, "Run": 1})),
                  ("train.txt", dict(ucf_style_ids=False))):
        path = str(tmp_path / f)
        assert ([dataclasses.astuple(r) for r in tucf.load_video_list(path, "r", **kw)]
                == [dataclasses.astuple(r) for r in jucf.load_video_list(path, "r", **kw)])
    t_recs, t_index = tucf.load_tag_list(str(tmp_path / "tags.txt"))
    j_recs, j_index = jucf.load_tag_list(str(tmp_path / "tags.txt"))
    assert t_index == j_index == {"x": 0, "y": 1, "z": 2}
    assert [dataclasses.astuple(r) for r in t_recs] == [dataclasses.astuple(r) for r in j_recs]
    np.testing.assert_array_equal(t_recs[0].multihot(3), j_recs[0].multihot(3))


def test_metrics_logger_writes_jsonl(tmp_path):
    path = str(tmp_path / "m.jsonl")
    logger = tlogging.MetricsLogger(path, logger_name="fvt.test")
    logger.log(3, loss=0.5, top1=1)
    logger.close()
    tlogging.MetricsLogger(str(tmp_path / "off.jsonl"), enabled=False).log(1, loss=1.0)
    with open(path) as f:
        rec = json.loads(f.read())
    assert rec["step"] == 3 and rec["loss"] == 0.5 and rec["top1"] == 1
    assert not os.path.exists(str(tmp_path / "off.jsonl"))
    assert tlogging.get_logger("fvt.test") is logger.logger


@pytest.fixture(scope="module")
def small_model():
    """A one-block-per-stage, two-stage R(2+1)D in both packages, f32, with
    the JAX init's weights (BN statistics and affine perturbed)."""
    jmodel = JR2Plus1D(stage_blocks=(1, 1), num_classes=NUM_CLASSES, dtype=jnp.float32)
    variables = jax.jit(jmodel.init, static_argnames="train")(
        jax.random.PRNGKey(0), jnp.zeros((1, 4, 32, 32, 3)), train=False)
    rng = np.random.default_rng(3)
    variables = jax.tree.map(
        lambda a: np.asarray(a) + (rng.uniform(0.0, 0.1, a.shape).astype(np.float32)
                                   if a.ndim == 1 else 0.0), variables)
    state = from_jax_variables(variables)
    tmodel = TR2Plus1D(stage_blocks=(1, 1), num_classes=NUM_CLASSES, dtype=torch.float32)
    tmodel.load_state_dict(state)
    return jmodel, variables, tmodel, state


@pytest.mark.parametrize("multilabel", [False, True])
def test_evaluate_matches_jax(packs, small_model, multilabel):
    paths, _ = packs
    jmodel, variables, tmodel, state = small_model
    num_tags = NUM_CLASSES if multilabel else None
    jc, tc = _cfg(jcfg, multilabel), _cfg(tcfg, multilabel)
    jds = jpacked.open_dataset(paths["jax"], jc.data, mode="eval", num_tags=num_tags)
    tds = tpacked.open_dataset(paths["torch"], tc.data, mode="eval", num_tags=num_tags)
    ref, _ = jeval.evaluate_video_scores(jmodel, variables, jds, jc, clip_batch=3)
    ops.reset_launch_counts()
    got, records = teval.evaluate_video_scores(tmodel, state, tds, tc, clip_batch=3)
    assert ops.launch_counts["spatial_conv"] == 0  # CPU tensors: the plain versions
    assert got.shape == (len(VIDEOS), NUM_CLASSES) and got.dtype == np.float32
    assert [r.path for r in records] == [f"v{i}.mp4" for i in range(len(VIDEOS))]
    np.testing.assert_allclose(got, ref, rtol=0, atol=SCORE_ATOL)
    j_metrics = jeval.evaluate(jmodel, variables, jds, jc, clip_batch=3)
    t_metrics = teval.evaluate(tmodel, state, tds, tc, clip_batch=3)
    assert t_metrics.keys() == j_metrics.keys()
    want = {"num_videos", "mAP", "macro_f1"} if multilabel else {"num_videos", "top1", "top5"}
    assert set(t_metrics) == want
    for k in t_metrics:
        assert t_metrics[k] == pytest.approx(j_metrics[k], abs=SCORE_ATOL)
    # the [B:5] contract: a rerun is bitwise identical
    again, _ = teval.evaluate_video_scores(tmodel, state, tds, tc, clip_batch=3)
    np.testing.assert_array_equal(again, got)


def test_fused_engine_as_apply_fn(packs, small_model):
    paths, _ = packs
    _, _, tmodel, state = small_model
    tc = _cfg(tcfg, True)
    tds = tpacked.open_dataset(paths["torch"], tc.data, mode="eval")

    def fused(sd, clips):
        return heads.predict_scores(r2plus1d_fused_infer(sd, clips, stage_blocks=(1, 1)), True)

    base, _ = teval.evaluate_video_scores(tmodel, state, tds, tc, clip_batch=2)
    got, _ = teval.evaluate_video_scores(tmodel, state, tds, tc, clip_batch=2, apply_fn=fused)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, base, rtol=0, atol=ENGINE_TOL)
    metrics = teval.evaluate(tmodel, state, tds, tc, clip_batch=2, apply_fn=fused)
    assert set(metrics) == {"num_videos", "mAP", "macro_f1"}


def test_evaluate_mesh_is_not_ported(packs, small_model):
    paths, _ = packs
    _, _, tmodel, state = small_model
    tc = _cfg(tcfg, False)
    tds = tpacked.open_dataset(paths["torch"], tc.data, mode="eval")
    # data-parallel evaluation is ported (tests/test_torch_port_multiproc.py):
    # a mesh must be a parallel.Mesh, and a single process's mesh is one card
    with pytest.raises(TypeError, match="parallel.Mesh"):
        teval.evaluate(tmodel, state, tds, tc, mesh=object())
    with pytest.raises(TypeError, match="parallel.Mesh"):
        teval.make_eval_fn(tc, paths["torch"], mesh=object(), device="cpu")
    from fastvideotagging_tpu_torch.parallel import make_mesh

    one = make_mesh(device="cpu")
    assert (one.world, one.rank, one.group) == (1, 0, None)
    assert teval._eval_plan(one, 3) == (None, 3)  # no split, no rounding


def test_make_eval_fn_over_a_pack(packs):
    paths, _ = packs
    tc = _cfg(tcfg, True)
    eval_fn = teval.make_eval_fn(tc, paths["torch"], num_tags=NUM_CLASSES, clip_batch=4,
                                 device="cpu")
    model = TR2Plus1D(stage_blocks=(2, 2, 2, 2), num_classes=NUM_CLASSES, dtype=torch.float32,
                      generator=torch.Generator().manual_seed(4)).train()
    got = eval_fn(types.SimpleNamespace(model=model), epoch=0)
    assert model.training  # the state's model is read, not switched to eval
    tds = tpacked.open_dataset(paths["torch"], tc.data, mode="eval", num_tags=NUM_CLASSES)
    want = teval.evaluate(model.eval(), model.state_dict(), tds, tc, clip_batch=4)
    assert got == want
