"""The port's serving export (evaluation/serving.py, cli/export.py) against
the JAX package's, on the CPU.

- ``export_serving`` -> ``load_serving`` of both packages on the same
  numpy weights (a seeded port init with perturbed BatchNorm statistics,
  carried to the JAX layout by models/convert.py) and the same seeded
  uint8 clips: tiny3d (tests/test_eval_tag.py's ``eval_cfg`` geometry) and
  r2plus1d_18 at a 4x32x32 clip, which reaches ``fvt::spatial_conv`` /
  ``fvt::temporal_conv`` (counted), both in f32, within rtol 1e-5, atol
  1e-6 (tests/test_serving_export.py's tolerance);
- the int8 export of both packages on one qpack (the port's calibration,
  carried to the JAX layout) within the two engines' parity bound
  (``INT8_SCORE_ATOL``: their bf16 tails round at different places), the
  same top-1, and the port's artifact bit for bit its in-process serving
  fn (the JAX roundtrip's own check, tests/test_serving_export.py:65);
- ``cli.export --device cpu`` against the JAX ``cli.export``: meta.json key
  for key (``artifacts`` names ``serving.pt2``) and the two artifacts'
  scores; ``collect_calib_clips`` of a video against the JAX CLI's.

The custom ops, the dynamic int8 export and the CLI's exits are in
test_torch_port_export_ops.py.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from fastvideotagging_tpu import config as jcfg
from fastvideotagging_tpu.cli import export as jcli_export
from fastvideotagging_tpu.evaluation import serving as jserving
from fastvideotagging_tpu.train.checkpoint import export_weights as jexport_weights
from fastvideotagging_tpu_torch import config as tcfg
from fastvideotagging_tpu_torch import get_model
from fastvideotagging_tpu_torch.cli import export as tcli_export
from fastvideotagging_tpu_torch.evaluation import serving as tserving
from fastvideotagging_tpu_torch.models.convert import to_jax_variables
from fastvideotagging_tpu_torch.ops import library
from fastvideotagging_tpu_torch.train.checkpoint import export_weights

RTOL, ATOL = 1e-5, 1e-6  # tests/test_serving_export.py:29, :65
# The int8 engines of the two packages agree within 1e-6 in the logits
# where every block is int8, but their bf16 tail (the spec's float blocks,
# stage 4) rounds its convs at other places (K1 / K2's f32 sum over taps
# against XLA's conv): a bf16 ulp there moves the logits by ~4e-3. The
# engines' own parity bound, tests/test_torch_port_int8.py's LOGIT_TOL
# (5e-2), times the sigmoid's largest slope (1/4), bounds the scores.
INT8_SCORE_ATOL = 5e-2 / 4
CLASSES = 5
CLIPS = (2, 4, 48, 64, 3)  # uint8 (N, T, H, W, 3) at source_hw


def _cfg(c, name, dtype, kernels):
    return c.ExperimentConfig(
        model=c.ModelConfig(name=name, num_classes=CLASSES, multilabel=True,
                            compute_dtype=dtype, dropout=0.0, kernels=kernels),
        data=c.DataConfig(source_hw=(48, 64), resize_hw=(40, 56), crop_hw=(32, 32),
                          sampler=c.ClipSamplerConfig(clip_len=4, stride=2, num_eval_clips=3)))


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def seeded_state(name: str) -> dict:
    """A seeded port init of ``name`` (5 classes), its 1-D tensors (BatchNorm
    statistics and affines, biases) perturbed so that eval BN is not the
    identity."""
    model = get_model(name, num_classes=CLASSES, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(3)
    return {k: v + torch.from_numpy(rng.uniform(0.0, 0.1, v.shape).astype(np.float32))
            if v.ndim == 1 and v.dtype == torch.float32 else v
            for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def weights():
    """{name: (JAX variables, the port's state_dict)}, the same numbers."""
    out = {}
    for name in ("tiny3d", "r2plus1d_18"):
        sd = seeded_state(name)
        out[name] = (to_jax_variables(sd), sd)
    return out


@pytest.fixture(scope="module")
def clips():
    return np.random.default_rng(7).integers(0, 256, CLIPS, dtype=np.uint8)


def _jax_scores(cfg, variables, clips, qpack=None):
    data = jserving.export_serving(cfg, variables, clip_batch=CLIPS[0], qpack=qpack)
    return np.asarray(jserving.load_serving(bytes(data)).call(jnp.asarray(clips)))


@pytest.mark.parametrize("name", ["tiny3d", "r2plus1d_18"])
def test_export_matches_jax_export(weights, clips, name, monkeypatch):
    jv, sd = weights[name]
    want = _jax_scores(_cfg(jcfg, name, "float32", "xla"), jv, clips)
    data = tserving.export_serving(_cfg(tcfg, name, "float32", "cuda"), sd,
                                   clip_batch=CLIPS[0], device="cpu")
    run = tserving.load_serving(data)
    calls = {"spatial_conv_plain": 0, "temporal_conv_plain": 0}
    for key in calls:
        def counted(*a, _key=key, _plain=getattr(library.k12, key)):
            calls[_key] += 1
            return _plain(*a)
        monkeypatch.setattr(library.k12, key, counted)
    got = run(clips).numpy()
    assert got.shape == (CLIPS[0], CLASSES) and ((got >= 0) & (got <= 1)).all()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    nodes = [str(n.target) for n in run.program.graph.nodes if n.op == "call_function"]
    if name == "r2plus1d_18":  # the factorized convs are the kernels' ops in the artifact
        assert calls["spatial_conv_plain"] == nodes.count("fvt.spatial_conv.default") > 0
        assert calls["temporal_conv_plain"] == nodes.count("fvt.temporal_conv.default") > 0
    else:
        assert not any(n.startswith("fvt.") for n in nodes)


def _to_jax_qpack(qpack):
    """The port's qpack in the JAX engine's layout (no ``wk``)."""
    tree = dict(qpack, convs={cid: {k: v for k, v in pack.items() if k != "wk"}
                              for cid, pack in qpack["convs"].items()})
    return pytree.tree_map(lambda t: jnp.asarray(t.numpy()), tree)


def test_int8_export_matches_jax_int8_export(weights, clips):
    jv, sd = weights["r2plus1d_18"]
    cfg = _cfg(tcfg, "r2plus1d_18", "bfloat16", "cuda")
    qpack = tserving.quantize_for_serving(cfg, sd, [clips], device="cpu")
    want = _jax_scores(_cfg(jcfg, "r2plus1d_18", "bfloat16", "xla"), jv, clips,
                       qpack=_to_jax_qpack(qpack))
    data = tserving.export_serving(cfg, sd, clip_batch=CLIPS[0], qpack=qpack, device="cpu")
    got = tserving.load_serving(data)(clips)
    with torch.no_grad():
        eager = tserving.make_serving_fn(cfg, sd, qpack=qpack, device="cpu")(
            torch.from_numpy(clips))
    torch.testing.assert_close(got, eager, rtol=0, atol=0)
    assert got.shape == (CLIPS[0], CLASSES)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=INT8_SCORE_ATOL)
    assert (got.numpy().argmax(-1) == want.argmax(-1)).all()


GEOM = ["--clip-len", "4", "--stride", "2", "--eval-mode", "dense",
        "--resize", "40", "56", "--crop", "32", "32"]


def test_cli_export_meta_matches_jax_cli(tmp_path, weights, clips):
    jv, sd = weights["tiny3d"]
    jexport_weights(str(tmp_path / "jw"), jv["params"], jv["batch_stats"])
    export_weights(str(tmp_path / "w.pt"), sd)
    names = tmp_path / "tags.txt"
    names.write_text("a\nb\nc\nd\ne\n")
    flags = ["--model", "tiny3d", "--num-classes", str(CLASSES), "--multilabel",
             "--dropout", "0.0", "--compute-dtype", "float32", *GEOM, "--clip-batch", "2",
             "--tag-names", str(names)]
    jcli_export.main(flags + ["--weights", str(tmp_path / "jw"), "--out", str(tmp_path / "j"),
                              "--format", "jax"])
    meta = tcli_export.main(flags + ["--weights", str(tmp_path / "w.pt"), "--out",
                                     str(tmp_path / "t"), "--device", "cpu"])
    want = json.load(open(tmp_path / "j" / "meta.json"))
    got = json.load(open(tmp_path / "t" / "meta.json"))
    assert got == meta and list(got) == list(want)
    for key in want:
        if key != "artifacts":
            assert got[key] == want[key], key
    size = os.path.getsize(tmp_path / "t" / "serving.pt2")
    assert got["artifacts"] == {"torch": {"file": "serving.pt2", "bytes": size}}
    frames = clips[:, :, :40, :56]  # the ship geometry: resize_hw
    run = tserving.load_serving(str(tmp_path / "t" / "serving.pt2"))
    jrun = jserving.load_serving(str(tmp_path / "j" / "serving.jax"))
    np.testing.assert_allclose(run(frames).numpy(), np.asarray(jrun.call(jnp.asarray(frames))),
                               rtol=RTOL, atol=ATOL)


def test_collect_calib_clips_matches_jax(synthetic_dataset):
    from fastvideotagging_tpu.data.ucf101 import load_video_list

    root, list_path = synthetic_dataset
    video = load_video_list(list_path, root=root)[0].path
    for batch, max_clips in ((2, 4), (8, 1)):
        want = jcli_export.collect_calib_clips(
            _cfg(jcfg, "tiny3d", "float32", "xla"), video, batch, max_clips)
        got = tcli_export.collect_calib_clips(
            _cfg(tcfg, "tiny3d", "float32", "cuda"), video, batch, max_clips)
        np.testing.assert_array_equal(got, want)
