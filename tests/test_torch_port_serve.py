"""The port's int8 serving surfaces and ``cli.serve`` against the JAX
package's, on the CPU.

r2plus1d_18 (3 tags, multi-label, bf16 clips of 4 x 32 x 32 from 40 x 56
frames) with the same JAX variables in both packages and perturbed
BatchNorm statistics, on a pack of 3 seeded videos:

- ``Tagger(int8=True)`` (each video recalibrated on its first chunk) over the
  pack, and ``tag(int8=True)`` on a video file, against the JAX package's:
  scores within 5e-2 (the calibrations come from two bf16 walks that round
  at different places; the int8 engines agree bit for bit through stage 3
  on one qpack, tests/test_torch_port_int8.py);
- ``make_int8_apply`` through ``evaluate(..., apply_fn=)``, the qpack passed
  as ``variables``, against the JAX one: video scores within 5e-2;
- ``cli.tag --int8`` and ``cli.evaluate --int8`` against the JAX CLIs and
  against the port's library calls (equal);
- the coverage errors for tiny3d (the Tagger's ``ValueError``, the
  engine's ``KeyError``);
- ``cli.serve``'s ``serve()`` on an in-memory request stream (a bare path,
  a blank line, a JSON object with ``threshold`` / ``top_k``, a missing
  video, a pack) against the JAX ``serve()`` on tiny3d in f32 (scores within
  1e-4), and through the int8 tagger; ``main`` checks ``--engine native``'s
  flags as the JAX CLI does (the engine: tests/test_torch_port_native.py).
"""

import io
import json
import os
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvideotagging_tpu.cli import evaluate as jcli_evaluate
from fastvideotagging_tpu.cli import serve as jcli_serve
from fastvideotagging_tpu.cli import tag as jcli_tag
from fastvideotagging_tpu.config import ClipSamplerConfig as JSampler
from fastvideotagging_tpu.config import DataConfig as JData
from fastvideotagging_tpu.config import ExperimentConfig as JConfig
from fastvideotagging_tpu.config import ModelConfig as JModel
from fastvideotagging_tpu.config import TrainConfig as JTrainConfig
from fastvideotagging_tpu.data.packed import open_dataset as jopen_dataset
from fastvideotagging_tpu.data.ucf101 import load_video_list
from fastvideotagging_tpu.evaluation import evaluate as jevaluate
from fastvideotagging_tpu.evaluation import quantized as jquantized
from fastvideotagging_tpu.evaluation import tagger as jtagger
from fastvideotagging_tpu.models import get_model as jget_model
from fastvideotagging_tpu.ops.preprocess_kernel import preprocess_eval_clip as jpreprocess
from fastvideotagging_tpu.train import checkpoint as jckpt
from fastvideotagging_tpu.train import lr as jlr
from fastvideotagging_tpu.train.state import create_train_state as jcreate_train_state
from fastvideotagging_tpu_torch import config as tconfig
from fastvideotagging_tpu_torch.cli import evaluate as cli_evaluate
from fastvideotagging_tpu_torch.cli import serve as cli_serve
from fastvideotagging_tpu_torch.cli import tag as cli_tag
from fastvideotagging_tpu_torch.data import packed as tpacked
from fastvideotagging_tpu_torch.data.synthetic import make_frames
from fastvideotagging_tpu_torch.evaluation import evaluate as tevaluate
from fastvideotagging_tpu_torch.evaluation import quantized as tquantized
from fastvideotagging_tpu_torch.evaluation import tagger as ttagger
from fastvideotagging_tpu_torch.models.convert import from_jax_variables, qpack_from_jax
from fastvideotagging_tpu_torch.models.zoo import model_from_config
from fastvideotagging_tpu_torch.ops.preprocess import preprocess_eval_clip
from fastvideotagging_tpu_torch.train import checkpoint as tckpt
from fastvideotagging_tpu_torch.train.state import create_train_state

# int8, one calibration (the JAX package's, carried over with qpack_from_jax):
# the engines agree bit for bit through stage 3, and stage 4 (bf16) rounds
# at other places
WIRING_TOL = 5e-3
# int8, each package calibrating itself: the two bf16 calibration walks round
# at different places, so the static scales differ by up to 1e-2
# (tests/test_torch_port_int8.py), which at a random init moves a logit by a
# few percent and a sigmoid score near 0.5 by up to ~0.05
SCORE_TOL = 1e-1
F32_TOL = 1e-4  # tiny3d in f32, as tests/test_torch_port_cli.py
HW, CROP, CLIP = (40, 56), (32, 32), 4
COMMON = ["--model", "r2plus1d_18", "--num-classes", "3", "--multilabel", "--resize", "40",
          "56", "--crop", "32", "32", "--clip-len", str(CLIP), "--stride", "2", "--eval-mode",
          "dense", "--compute-dtype", "bfloat16", "--clip-batch", "2"]


@pytest.fixture(autouse=True, scope="module")
def threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfgs(name="r2plus1d_18", dtype="bfloat16"):
    sampler = dict(clip_len=CLIP, stride=2, eval_mode="dense")
    model = dict(name=name, num_classes=3, multilabel=True, compute_dtype=dtype)
    data = dict(resize_hw=HW, crop_hw=CROP)
    return (JConfig(model=JModel(**model), data=JData(sampler=JSampler(**sampler), **data)),
            tconfig.ExperimentConfig(model=tconfig.ModelConfig(**model),
                                     data=tconfig.DataConfig(
                                         sampler=tconfig.ClipSamplerConfig(**sampler), **data)))


def _perturb(stats):
    def leaf(path, x):
        name = jax.tree_util.keystr(path)
        rng = np.random.default_rng(zlib.crc32(name.encode()))
        if "mean" in name:
            return jnp.asarray(rng.normal(0, 0.05, x.shape), x.dtype)
        return jnp.asarray(1.0 + rng.uniform(-0.2, 0.2, x.shape), x.dtype)

    return jax.tree_util.tree_map_with_path(leaf, stats)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A multi-label pack of 3 videos at 40x56 and r2plus1d_18's JAX
    variables: a JAX checkpoint directory and weights export, and the port's
    from the converted variables."""
    tmp = tmp_path_factory.mktemp("served_int8")
    pack = str(tmp / "val.fvtpack")
    items = [(f"v{i}.mp4", None, (i % 3, (i + 1) % 3), make_frames(i, 12, *HW, seed=i))
             for i in range(3)]
    tpacked.write_pack_from_arrays(items, pack, HW, num_tags=3)
    model = jget_model("r2plus1d_18", num_classes=3)
    jstate = jcreate_train_state(model, jlr.make_optimizer(JTrainConfig(), 1),
                                 jax.random.PRNGKey(4), jnp.zeros((1, CLIP) + CROP + (3,)))
    jstate = jstate.replace(batch_stats=_perturb(jstate.batch_stats))
    variables = jax.device_get({"params": jstate.params, "batch_stats": jstate.batch_stats})
    mgr = jckpt.CheckpointManager(str(tmp / "jax_ckpt"))
    mgr.save(2, jstate, {"epoch": 0})
    mgr.close()
    jckpt.export_weights(str(tmp / "jax_weights"), variables["params"],
                         variables["batch_stats"])
    _, tcfg = _cfgs()
    tstate = create_train_state(tcfg, 1, device="cpu")
    sd = from_jax_variables(variables)
    tstate.model.load_state_dict(sd)
    tstate.step = 2
    tckpt.CheckpointManager(str(tmp / "port_ckpt")).save(2, tstate, {"epoch": 0})
    tckpt.export_weights(str(tmp / "port_weights.pt"), tstate.model.state_dict())
    return dict(tmp=tmp, pack=pack, variables=variables, sd=sd)


def _pack_scores(engine, pack):
    return {path: {r.tag: r.score for r in results}
            for path, results in jtagger.iter_pack_tags(engine, pack, threshold=0.0)}


def _close_scores(got, want, tol):
    assert list(got) == list(want)
    for video in want:
        assert set(got[video]) == set(want[video])
        for tag, score in want[video].items():
            assert abs(got[video][tag] - score) <= tol, (video, tag)


def _jax_calibration(served):
    """The port Tagger's ``quantize_for`` swapped for the JAX package's on
    the same clips, its qpack carried over."""
    def quantize_for(name, weights, clips, w_cols=None):
        jclips = [jnp.asarray(c.float().numpy()).astype(jnp.bfloat16) for c in clips]
        return qpack_from_jax(jax.device_get(
            jquantized.quantize_for(name, served["variables"], jclips)))
    return quantize_for


def test_int8_tagger_matches_jax(served, monkeypatch):
    jcfg, tcfg = _cfgs()
    jt = jtagger.Tagger(jcfg, served["variables"], clip_batch=2, int8=True)
    tt = ttagger.Tagger(tcfg, served["sd"], clip_batch=2, int8=True, device="cpu")
    want = _pack_scores(jt, served["pack"])
    got = {path: {r.tag: r.score for r in results} for path, results in
           ttagger.iter_pack_tags(tt, served["pack"], threshold=0.0)}
    _close_scores(got, want, SCORE_TOL)
    # the wiring (per-video calibration on the first chunk, the chunks, the
    # aggregation) on the JAX package's calibration
    with monkeypatch.context() as m:
        m.setattr(ttagger, "quantize_for", _jax_calibration(served))
        wired = {path: {r.tag: r.score for r in results} for path, results in
                 ttagger.iter_pack_tags(tt, served["pack"], threshold=0.0)}
    _close_scores(wired, want, WIRING_TOL)
    # recalibrated per video: the last video's qpack, the same on a second pass
    last = tt._qpack
    again = {path: {r.tag: r.score for r in results} for path, results in
             ttagger.iter_pack_tags(tt, served["pack"], threshold=0.0)}
    assert again == got and tt._qpack is not last


def test_int8_tagger_coverage_error():
    _, tcfg = _cfgs("tiny3d", "float32")
    with pytest.raises(ValueError, match="int8 tagging covers"):
        ttagger.Tagger(tcfg, {}, int8=True, device="cpu")
    with pytest.raises(KeyError, match="covers"):
        tquantized.make_int8_apply("tiny3d", {}, [])


def test_tag_int8_on_a_video_matches_jax(served, synthetic_dataset):
    root, list_path = synthetic_dataset
    video = load_video_list(list_path, root=root)[0].path
    kw = dict(model_name="r2plus1d_18", num_classes=3, multilabel=True, threshold=0.0,
              clip_len=CLIP, stride=2, eval_mode="dense")
    jcfg, tcfg = _cfgs()
    want = jtagger.tag(video, variables=served["variables"], cfg=jcfg, int8=True, **kw)
    got = ttagger.tag(video, state_dict=served["sd"], cfg=tcfg, int8=True, device="cpu", **kw)
    assert len(got) == len(want) == 3
    scores = {r.tag: r.score for r in got}
    for r in want:
        assert abs(scores[r.tag] - r.score) <= SCORE_TOL, r.tag


def _calib(dataset, cfg, preprocess, n=2):
    d = cfg.data
    out = []
    for i in range(n):
        clips_u8, _ = dataset.get_eval_clips(i)
        out.append(preprocess(clips_u8, d))
    return out


def test_make_int8_apply_through_evaluate_matches_jax(served):
    jcfg, tcfg = _cfgs()
    jds = jopen_dataset(served["pack"], jcfg.data, mode="eval", num_tags=3)
    tds = tpacked.open_dataset(served["pack"], tcfg.data, mode="eval", num_tags=3)
    jcal = _calib(jds, jcfg, lambda c, d: jpreprocess(c, d.resize_hw, d.crop_hw, d.mean, d.std,
                                                      out_dtype_name="bfloat16"))
    tcal = _calib(tds, tcfg, lambda c, d: preprocess_eval_clip(
        torch.from_numpy(c), d.resize_hw, d.crop_hw, d.mean, d.std, out_dtype=torch.bfloat16))
    jq, japply = jquantized.make_int8_apply("r2plus1d_18", served["variables"], jcal,
                                            multilabel=True)
    tq, tapply = tquantized.make_int8_apply("r2plus1d_18", served["sd"], tcal, multilabel=True)
    jmodel = jget_model("r2plus1d_18", num_classes=3)
    want, _ = jevaluate.evaluate_video_scores(jmodel, jq, jds, jcfg, clip_batch=2,
                                              apply_fn=japply)
    tmodel = model_from_config(tcfg.model, device="cpu")
    got, _ = tevaluate.evaluate_video_scores(tmodel, tq, tds, tcfg, clip_batch=2,
                                             apply_fn=tapply)
    assert got.shape == (3, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=SCORE_TOL)
    metrics = tevaluate.evaluate(tmodel, tq, tds, tcfg, clip_batch=2, apply_fn=tapply)
    assert metrics["num_videos"] == 3


def _out_lines(capsys):
    return [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]


def test_evaluate_cli_int8_matches_jax_and_the_library(served, capsys):
    tmp, pack = served["tmp"], served["pack"]
    argv = COMMON + ["--val-list", pack, "--int8", "--int8-calib-videos", "2"]
    capsys.readouterr()
    jcli_evaluate.main(argv + ["--checkpoint-dir", str(tmp / "jax_ckpt")])
    want = _out_lines(capsys)[-1]
    got = cli_evaluate.main(argv + ["--device", "cpu", "--checkpoint-dir", str(tmp / "port_ckpt")])
    assert _out_lines(capsys)[-1] == got
    assert set(got) == set(want) and got["num_videos"] == want["num_videos"] == 3
    # the library call the CLI makes, on the same calibration clips
    _, tcfg = _cfgs()
    tds = tpacked.open_dataset(pack, tcfg.data, mode="eval", num_tags=3)
    cal = _calib(tds, tcfg, lambda c, d: preprocess_eval_clip(
        torch.from_numpy(c), d.resize_hw, d.crop_hw, d.mean, d.std, out_dtype=torch.bfloat16))
    tq, tapply = tquantized.make_int8_apply("r2plus1d_18", served["sd"], cal, multilabel=True)
    direct = tevaluate.evaluate(model_from_config(tcfg.model, device="cpu"), tq, tds, tcfg,
                                clip_batch=2, apply_fn=tapply)
    assert direct == got
    # over three videos a metric moves by up to 1/3 when two scores swap
    # order; the scores themselves are held to SCORE_TOL by the tests above
    for k in want:
        if k != "num_videos":
            assert abs(got[k] - want[k]) <= 0.34, k


def test_tag_cli_int8_matches_jax(served, capsys):
    tmp, pack = served["tmp"], served["pack"]
    flags = ["--threshold", "0.0", "--int8"]
    capsys.readouterr()
    jcli_tag.main(COMMON + [pack, "--weights", str(tmp / "jax_weights")] + flags)
    want = {r["video"]: {t["tag"]: t["score"] for t in r["tags"]} for r in _out_lines(capsys)}
    cli_tag.main(COMMON + [pack, "--weights", str(tmp / "port_weights.pt"), "--device", "cpu"]
                 + flags)
    got = {r["video"]: {t["tag"]: t["score"] for t in r["tags"]} for r in _out_lines(capsys)}
    _close_scores(got, want, SCORE_TOL)


def test_parse_request_forms():
    assert cli_serve._parse_request("a.mp4\n") == {"video": "a.mp4"}
    assert cli_serve._parse_request('{"video": "b.mp4", "top_k": 2}') == {
        "video": "b.mp4", "top_k": 2}
    with pytest.raises(ValueError, match="'video'"):
        cli_serve._parse_request('{"top_k": 2}')


def _requests(root, records, pack):
    return [
        records[0].path + "\n",
        "\n",  # blank lines are skipped
        json.dumps({"video": records[1].path, "top_k": 1, "threshold": 0.0}) + "\n",
        os.path.join(root, "missing.mp4") + "\n",  # must not end the loop
        records[2].path + "\n",
        pack + "\n",  # a pack: one line per video
    ]


def test_serve_matches_the_jax_serve(synthetic_dataset, served):
    """tiny3d in f32 (the JAX package's tests/test_serve.py setup): the
    same lines, scores within 1e-4; the error line names the video."""
    root, list_path = synthetic_dataset
    records = load_video_list(list_path, root=root)
    jcfg, tcfg = _cfgs("tiny3d", "float32")
    model = jget_model("tiny3d", num_classes=3, dropout=0.0)
    variables = jax.device_get(jax.jit(model.init, static_argnames="train")(
        jax.random.PRNGKey(0), jnp.zeros((1, CLIP) + CROP + (3,)), train=False))
    names = ["cat", "dog", "bird"]
    jt = jtagger.Tagger(jcfg, variables, tag_names=names, clip_batch=2)
    tt = ttagger.Tagger(tcfg, from_jax_variables(variables), tag_names=names, clip_batch=2,
                        device="cpu")
    reqs = _requests(root, records, served["pack"])
    # the JAX serve tags video files only: its pack line is an error line
    jout, tout = io.StringIO(), io.StringIO()
    jstats = jcli_serve.serve(jt, reqs[:-1], jout, threshold=0.0, top_k=2)
    tstats = cli_serve.serve(tt, reqs, tout, threshold=0.0, top_k=2)
    assert jstats == {"served": 3, "errors": 1}
    assert tstats == {"served": 4, "errors": 1}
    want = [json.loads(line) for line in jout.getvalue().splitlines()]
    got = [json.loads(line) for line in tout.getvalue().splitlines()]
    assert len(got) == len(want) + 3
    for g, w in zip(got, want):
        assert g["video"] == w["video"] and ("error" in g) == ("error" in w)
        if "error" in w:
            continue
        assert [t["tag"] for t in g["tags"]] == [t["tag"] for t in w["tags"]]
        for gt, wt in zip(g["tags"], w["tags"]):
            assert abs(gt["score"] - wt["score"]) <= F32_TOL
    assert len(got[1]["tags"]) == 1 and len(got[0]["tags"]) == 2  # top_k per request
    assert "missing.mp4" in got[2]["video"]
    assert [g["video"] for g in got[4:]] == ["v0.mp4", "v1.mp4", "v2.mp4"]


def test_serve_int8_isolates_faults(served, tmp_path):
    _, tcfg = _cfgs()
    tt = ttagger.Tagger(tcfg, served["sd"], clip_batch=2, int8=True, device="cpu")
    reqs = [served["pack"] + "\n", str(tmp_path / "missing.fvtpack") + "\n",
            json.dumps({"video": served["pack"], "top_k": 1}) + "\n"]
    out = io.StringIO()
    assert cli_serve.serve(tt, reqs, out, threshold=0.0) == {"served": 2, "errors": 1}
    lines = [json.loads(line) for line in out.getvalue().splitlines()]
    assert len(lines) == 7 and "error" in lines[3]
    assert all(len(r["tags"]) == 3 for r in lines[:3])
    assert all(len(r["tags"]) == 1 for r in lines[4:])
    assert [r["tags"][0] for r in lines[4:]] == [max(r["tags"], key=lambda t: t["score"])
                                                 for r in lines[:3]]


def test_serve_main_flags(served, monkeypatch, capsys):
    tmp = served["tmp"]
    # --engine native is ported (tests/test_torch_port_native.py): the JAX
    # CLI's checks, before any daemon starts
    for flags, msg in ((["--engine", "native"], "needs --artifacts"),
                       (["--engine", "native", "--artifacts", "art", "--int8"],
                        "baked at export time")):
        with pytest.raises(SystemExit, match=msg):
            cli_serve.main(COMMON + flags)
    with pytest.raises(SystemExit, match="needs --weights"):
        cli_serve.main(COMMON + ["--device", "cpu"])
    monkeypatch.setattr("sys.stdin", io.StringIO(served["pack"] + "\n"))
    stats = cli_serve.main(COMMON + ["--device", "cpu", "--weights", str(tmp / "port_weights.pt"),
                                     "--threshold", "0.0", "--int8"])
    assert stats == {"served": 1, "errors": 0}
    captured = capsys.readouterr()
    assert "ready" in captured.err
    assert len(captured.out.strip().splitlines()) == 3
