"""The port's native runner (csrc/native_runner.cpp) itself, on the CPU.

The CPU runner is built with g++ against the installed libtorch
(ops/_build.py) and runs a ``cli.export --format native --device cpu``
package of tiny3d (f32, ``kernels='torch'``: no ``fvt::*`` op, which only
the card's op library implements in C++). Its scores are held to the JAX
package's serving function on the same weights (carried across by
models/convert.py) within 1e-4, in its one-shot, ``--bench``, ``--serve``
and ``--pipeline 2`` modes; its argument errors exit non-zero with a
message; ``NativeTagger`` and ``cli.tag --engine native`` over it agree
with the in-process ``Tagger``. The line protocol's client cases against a
fake daemon are in test_torch_port_native.py.
"""

import json
import os
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvideotagging_tpu import config as jcfg
from fastvideotagging_tpu.evaluation import serving as jserving
from fastvideotagging_tpu_torch import config as tcfg
from fastvideotagging_tpu_torch import get_model
from fastvideotagging_tpu_torch.cli import export as cli_export
from fastvideotagging_tpu_torch.cli import tag as cli_tag
from fastvideotagging_tpu_torch.data.packed import write_pack_from_arrays
from fastvideotagging_tpu_torch.data.synthetic import make_frames
from fastvideotagging_tpu_torch.evaluation.native_tagger import NativeTagger
from fastvideotagging_tpu_torch.evaluation.serving import NATIVE_PACKAGE
from fastvideotagging_tpu_torch.evaluation.tagger import Tagger, iter_pack_tags
from fastvideotagging_tpu_torch.models.convert import to_jax_variables
from fastvideotagging_tpu_torch.native import runner
from fastvideotagging_tpu_torch.ops import _build
from fastvideotagging_tpu_torch.train.checkpoint import export_weights

TOL = 1e-4  # f32 on both sides: the runner's compiled program against XLA's
CLASSES = 3
CLIPS = (2, 4, 40, 56, 3)  # uint8 (N, T, H, W, 3) at the ship geometry
FLAGS = ["--model", "tiny3d", "--num-classes", str(CLASSES), "--multilabel", "--dropout", "0.0",
         "--compute-dtype", "float32", "--kernels", "torch", "--clip-len", "4", "--stride", "2",
         "--eval-mode", "dense", "--resize", "40", "56", "--crop", "32", "32"]


def _cfg(c):
    return c.ExperimentConfig(
        model=c.ModelConfig(name="tiny3d", num_classes=CLASSES, multilabel=True,
                            compute_dtype="float32", dropout=0.0,
                            kernels="torch" if c is tcfg else "xla"),
        data=c.DataConfig(resize_hw=(40, 56), crop_hw=(32, 32),
                          sampler=c.ClipSamplerConfig(clip_len=4, stride=2, eval_mode="dense")))


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def art(tmp_path_factory):
    """The CPU runner, a --format native export of seeded tiny3d weights
    (BatchNorm statistics perturbed) and the JAX serving function on the
    same numbers."""
    d = tmp_path_factory.mktemp("native_runner")
    binary = _build.build_runner("cpu")
    model = get_model("tiny3d", num_classes=CLASSES, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(3)
    sd = {k: v + torch.from_numpy(rng.uniform(0.0, 0.1, v.shape).astype(np.float32))
          if v.ndim == 1 and v.dtype == torch.float32 else v
          for k, v in model.state_dict().items()}
    export_weights(str(d / "w.pt"), sd)
    meta = cli_export.main(FLAGS + ["--weights", str(d / "w.pt"), "--out", str(d / "art"),
                                    "--clip-batch", str(CLIPS[0]), "--format", "native",
                                    "--device", "cpu"])
    data = jserving.export_serving(_cfg(jcfg), to_jax_variables(sd), clip_batch=CLIPS[0])
    jrun = jserving.load_serving(bytes(data))
    return dict(dir=str(d / "art"), package=os.path.join(str(d / "art"), NATIVE_PACKAGE),
                binary=binary, meta=meta, sd=sd, tmp=d,
                jax=lambda x: np.asarray(jrun.call(jnp.asarray(x))))


def _clips(seed, n=None):
    shape = CLIPS if n is None else (n, *CLIPS)
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def test_export_meta_names_the_native_package(art):
    meta = art["meta"]
    assert meta["artifacts"] == {"native": {"file": NATIVE_PACKAGE, "device": "cpu",
                                            "bytes": os.path.getsize(art["package"])}}
    assert json.load(open(os.path.join(art["dir"], "meta.json"))) == meta
    assert meta["input"]["shape"] == list(CLIPS) and not os.path.exists(
        os.path.join(art["dir"], "serving.pt2"))


def test_one_shot_and_bench_match_jax(art, tmp_path):
    x = _clips(1)
    summary = runner.run_summary(art["package"], [x], str(tmp_path / "one"), device="cpu")
    out, = summary["outputs"]
    assert out.shape == (CLIPS[0], CLASSES) and out.dtype == np.float32
    assert summary["launches"] is None  # the CPU runner loads no op library
    np.testing.assert_allclose(out, art["jax"](x), rtol=0, atol=TOL)
    xs = _clips(2, n=8)
    outs, bench = runner.run_serving(art["package"], [xs], str(tmp_path / "bench"),
                                     device="cpu", bench=8)
    # the outputs are the last instance's; the slope, where the two batches
    # are timed apart (a toy program's times are noise), is positive
    np.testing.assert_allclose(outs[0], art["jax"](xs[-1]), rtol=0, atol=TOL)
    if bench is not None:
        assert bench["n_short"] == 1 and bench["n_long"] == 6 and bench["sec_per_exec"] > 0


@pytest.mark.parametrize("pipeline", [0, 2])
def test_serve_matches_jax_and_survives_a_bad_request(art, tmp_path, pipeline):
    xs = [_clips(10 + i) for i in range(4)]
    with runner.NativeServer(art["package"], [(CLIPS, np.uint8)], str(tmp_path / "wd"),
                             device="cpu", pipeline=pipeline) as s:
        out, = s.request([xs[0]])
        np.testing.assert_allclose(out, art["jax"](xs[0]), rtol=0, atol=TOL)
        for x, (got,) in zip(xs, s.request_many(iter([[x] for x in xs]))):
            np.testing.assert_allclose(got, art["jax"](x), rtol=0, atol=TOL)
        # the daemon's own checks answer an error line and live on
        short = tmp_path / "short.bin"
        short.write_bytes(b"\0" * 10)
        for line in ("/no/such/file.bin", f"{short} {short}", str(short)):
            s._proc.stdin.write(line + "\n")
            s._proc.stdin.flush()
            reply = json.loads(s._proc.stdout.readline())
            assert reply["request"] == s._req_id and "error" in reply
            s._req_id += 1  # the raw line spent an id the client did not issue
        assert "holds 10 bytes" in reply["error"]
        out, = s.request([xs[1]])
        np.testing.assert_allclose(out, art["jax"](xs[1]), rtol=0, atol=TOL)
    assert s._proc.returncode == 0
    assert not [f for f in os.listdir(tmp_path / "wd") if f.startswith(("req", "out"))]


def _run(args):
    return subprocess.run(args, capture_output=True, text=True, timeout=300)


def test_argument_errors(art, tmp_path):
    b, pkg = art["binary"], art["package"]
    h = _run([b, "--help"])
    assert h.returncode == 0 and "--serve" in h.stdout and "stdin" in h.stdout
    assert "--op-library" in h.stdout
    x = tmp_path / "x.bin"
    _clips(1).tofile(x)
    spec = "u8:" + ",".join(map(str, CLIPS))
    cases = [([], "--package is required"),
             (["--package", pkg], "one-shot mode needs --input"),
             (["--package", pkg, "--serve"], "--serve-input"),
             (["--package", pkg, "--serve", "--serve-input", spec, "--bench", "8"],
              "--serve takes --serve-input"),
             (["--package", pkg, "--input", f"{spec}:{x}", "--pipeline", "2"],
              "--pipeline only applies to --serve"),
             (["--package", pkg, "--input", f"{spec}:{x}", "--bench", "3"], "needs >= 6"),
             (["--package", pkg, "--input", "garbage"], "bad --input"),
             (["--package", pkg, "--input", f"f64:1,2:{x}"], "unsupported input dtype"),
             (["--package", pkg, "--input", f"u8:1,2:{x}"], "input file size"),
             (["--package", pkg, "--input", f"{spec}:/no/such.bin"], "cannot open"),
             (["--package", str(tmp_path / "none.pt2"), "--input", f"{spec}:{x}"], ""),
             (["--package", pkg, "--op-library", "/no/such.so", "--input", f"{spec}:{x}"],
              "dlopen"),
             (["--package", pkg, "--bogus"], "unknown arg")]
    for args, msg in cases:
        r = _run([b] + args)
        assert r.returncode != 0 and r.stdout == "", args
        assert msg in r.stderr and "fvt_native_runner: " in r.stderr, (args, r.stderr)


def test_native_tagger_and_cli_over_the_real_runner(art, tmp_path, capsys):
    """NativeTagger on the CPU runner against the in-process Tagger on the
    same weights (f32, within TOL), over a pack, sequential and pipelined;
    cli.tag --engine native prints the same tags."""
    items = [(f"v{i}.mp4", i, (i,), make_frames(i, n, 40, 56, seed=i))
             for i, n in enumerate((11, 6))]
    pack = str(tmp_path / "v.fvtpack")
    write_pack_from_arrays(items, pack, (40, 56), CLASSES)
    tagger = Tagger(_cfg(tcfg), art["sd"], clip_batch=CLIPS[0], device="cpu")
    want = {p: r for p, r in iter_pack_tags(tagger, pack, threshold=0.0)}
    for pipeline in (0, 2):
        with NativeTagger(art["dir"], pipeline=pipeline, device="cpu") as nt:
            got = dict(iter_pack_tags(nt, pack, threshold=0.0))
        assert list(got) == list(want) == ["v0.mp4", "v1.mp4"]
        for path in got:
            assert [r.tag for r in got[path]] == [r.tag for r in want[path]]
            np.testing.assert_allclose([r.score for r in got[path]],
                                       [r.score for r in want[path]], rtol=0, atol=TOL)
    cli_tag.main([pack, "--engine", "native", "--artifacts", art["dir"], "--device", "cpu",
                  "--threshold", "0.0", "--pipeline", "0"])
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["video"] for r in lines] == ["v0.mp4", "v1.mp4"]
    for line in lines:
        ref = {r.tag: r.score for r in want[line["video"]]}
        assert {t["tag"] for t in line["tags"]} == set(ref)
        for t in line["tags"]:
            assert abs(t["score"] - ref[t["tag"]]) <= TOL
