"""The serving kernels' custom ops (ops/library.py) and the parts of the
serving export that need no JAX reference, on the CPU.

- ``torch.library.opcheck`` on every ``fvt::*`` op with CPU inputs (schema,
  fake implementation, mutation declaration, the op under AOT dispatch),
  Q1 in each epilogue form, Q2 in its three modes (the dynamic ones on
  views of one scale buffer, as ``ScaleSlots`` hands them out);
- an export of the dynamic int8 engine keeps the in-place amax reductions
  (``fvt::conv3d_s8_amax``, ``fvt::quantize_s8_given``,
  ``fvt::quantize_s8_dynamic``): the loaded program makes 28 Q1 / 26 Q2 / 1
  amax-pass calls and equals the eager engine bit for bit;
- ``cli.export``'s exits: ``--int8`` without ``--calib-video``, a model the
  int8 engine does not cover, the JAX CLI's ``--format jax`` /
  ``stablehlo`` and ``--platforms`` (an AOTInductor package is compiled
  for its device); ``--int8`` calibrated on a ``.fvtpack`` (each of its
  videos).

Weights: seeded port inits (r2plus1d_18, tiny3d; 5 classes). The JAX
comparisons are in test_torch_port_export.py.
"""

import io
import os

import numpy as np
import pytest
import torch

from fastvideotagging_tpu_torch import config as tcfg
from fastvideotagging_tpu_torch import get_model
from fastvideotagging_tpu_torch.cli import export as tcli_export
from fastvideotagging_tpu_torch.cli.common import build_config
from fastvideotagging_tpu_torch.data.packed import write_pack_from_arrays
from fastvideotagging_tpu_torch.data.synthetic import make_frames
from fastvideotagging_tpu_torch.evaluation import serving as tserving
from fastvideotagging_tpu_torch.ops import int8_conv as q8
from fastvideotagging_tpu_torch.ops import library
from fastvideotagging_tpu_torch.train.checkpoint import export_weights

CLASSES = 5
GEOM = ["--clip-len", "4", "--stride", "2", "--eval-mode", "dense",
        "--resize", "40", "56", "--crop", "32", "32"]


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _state(name):
    return get_model(name, num_classes=CLASSES, device="cpu",
                     generator=torch.Generator().manual_seed(0)).state_dict()


@pytest.fixture(scope="module")
def int8_setup():
    """r2plus1d_18 (bf16, 5 classes) at 4x32x32 clips from 48x64 frames, its
    qpack calibrated on the clips."""
    cfg = tcfg.ExperimentConfig(
        model=tcfg.ModelConfig(name="r2plus1d_18", num_classes=CLASSES, multilabel=True,
                               dropout=0.0),
        data=tcfg.DataConfig(source_hw=(48, 64), resize_hw=(40, 56), crop_hw=(32, 32),
                             sampler=tcfg.ClipSamplerConfig(clip_len=4)))
    sd = _state("r2plus1d_18")
    clips = np.random.default_rng(7).integers(0, 256, (2, 4, 48, 64, 3), dtype=np.uint8)
    return cfg, sd, tserving.quantize_for_serving(cfg, sd, [clips], device="cpu"), clips


def _q1_args(res_kind, co=8, relu=True):
    g = torch.Generator().manual_seed(5)
    q = torch.randint(-127, 128, (1, 4, 5, 5, 16), generator=g, dtype=torch.int8)
    wk = torch.randint(-127, 128, (co, 27, 16), generator=g, dtype=torch.int8)
    mul = torch.rand(co, generator=g) * 1e-3
    add = torch.randn(co, generator=g)
    s = torch.tensor(0.05)
    res = {"": (None, None, None),
           "dequant": (torch.randint(-127, 128, (1, 4, 5, 5, 16), generator=g,
                                     dtype=torch.int8), torch.rand(co, generator=g) + 0.5,
                       torch.tensor(0.02)),
           "f32": (torch.randn((1, 4, 5, 5, co), generator=g), None, None),
           "bf16": (torch.randn((1, 4, 5, 5, co), generator=g).to(torch.bfloat16), None, None)}
    return (q, wk, [3, 3, 3], mul, add, s, [1, 1, 1], [1, 1, 1, 1, 1, 1],
            relu and not res_kind, res_kind, *res[res_kind])


def _opcheck_cases():
    g = torch.Generator().manual_seed(4)
    inv_f = torch.rand(8, generator=g) + 0.5
    slots = torch.zeros((3, 2))
    y = torch.randn((2, 3, 5, 8), generator=g).to(torch.bfloat16)
    yield "spatial_conv", (torch.randn((2, 5, 6, 8), generator=g),
                           torch.randn((3, 3, 8, 4), generator=g))
    yield "temporal_conv", (torch.randn((2, 4, 6, 8), generator=g),
                            torch.randn((3, 8, 4), generator=g))
    for kind in ("", "dequant", "f32", "bf16"):
        a = _q1_args(kind)
        yield f"conv3d_s8[{kind or 'plain'}]", (*a[:9], False, *a[9:])
        yield f"conv3d_s8[{kind or 'plain'},f32]", (*a[:9], True, *a[9:])
        yield f"conv3d_s8_requant[{kind or 'plain'}]", (*a, inv_f, torch.tensor(0.03))
        yield f"conv3d_s8_requant_bf16[{kind or 'plain'}]", (*a, inv_f, torch.tensor(0.03))
        yield f"conv3d_s8_amax[{kind or 'plain'}]", (*a, inv_f, slots[0, 0])
    yield "quantize_s8", (y, inv_f, torch.tensor(0.04))
    yield "quantize_s8[f32]", (y.float(), inv_f, torch.tensor(0.04))
    yield "quantize_s8_dynamic", (y, inv_f, slots[1, 0], slots[1, 1])
    yield "quantize_s8_given", (y, inv_f, torch.tensor(3.5), slots[2, 1])


@pytest.mark.parametrize("name,args", list(_opcheck_cases()),
                         ids=[c[0] for c in _opcheck_cases()])
def test_opcheck_every_fvt_op(name, args):
    op = getattr(torch.ops.fvt, name.split("[")[0])
    torch.library.opcheck(op, args)


def test_every_op_of_the_library_is_checked():
    names = {c[0].split("[")[0] for c in _opcheck_cases()}
    assert names == {op._schema.name.split("::")[1] for op in library.OPS}


def test_dynamic_int8_export_keeps_the_amax_mutations(int8_setup, monkeypatch):
    cfg, sd, qpack, clips = int8_setup
    engine = tserving.ServingFn(cfg, sd, qpack=qpack, device="cpu", dynamic=True)
    x = torch.from_numpy(clips)
    with torch.no_grad():
        want = engine(x)
        program = torch.export.export(engine, (x,))
    nodes = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert nodes.count("fvt.conv3d_s8_amax.default") == 25
    assert nodes.count("fvt.quantize_s8_given.default") == 25
    assert nodes.count("fvt.quantize_s8_dynamic.default") == 1
    calls = {"q1": 0, "q2": 0, "amax": 0}
    plain_q1, plain_q2 = q8.conv3d_s8_plain, q8.quantize_s8_plain

    def q1(*a):
        calls["q1"] += 1
        return plain_q1(*a)

    def q2(y, inv_f, s=None, amax=None, slot=None):
        calls["q2"] += 1
        calls["amax"] += s is None and amax is None
        return plain_q2(y, inv_f, s, amax, slot)

    monkeypatch.setattr(q8, "conv3d_s8_plain", q1)
    monkeypatch.setattr(q8, "quantize_s8_plain", q2)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    got = torch.export.load(io.BytesIO(buf.getvalue())).module()(x)
    assert calls == {"q1": 28, "q2": 26, "amax": 1}
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_cli_export_exits(tmp_path):
    export_weights(str(tmp_path / "w.pt"), _state("tiny3d"))
    flags = ["--model", "tiny3d", "--num-classes", str(CLASSES), *GEOM, "--device", "cpu",
             "--weights", str(tmp_path / "w.pt"), "--out", str(tmp_path / "x")]
    with pytest.raises(SystemExit, match="calib-video"):
        tcli_export.main(flags + ["--int8"])
    frames = make_frames(0, 12, 40, 56)
    pack = str(tmp_path / "c.fvtpack")
    write_pack_from_arrays([("v.mp4", 0, (), frames)], pack, (40, 56))
    with pytest.raises(SystemExit, match="serving/int8 engine covers"):
        tcli_export.main(flags + ["--int8", "--calib-video", pack])
    # the JAX CLI's jax / stablehlo formats are the port's torch / native
    # (--format native is in tests/test_torch_port_native_runner.py); an
    # AOTInductor package is compiled for its device: --platforms is refused
    for fmt in ("jax", "stablehlo"):
        with pytest.raises(SystemExit):
            tcli_export.main(flags + ["--format", fmt])
    with pytest.raises(SystemExit, match="compiled for the device"):
        tcli_export.main(flags + ["--platforms", "tpu"])
    with pytest.raises(SystemExit, match="--format jax: one of torch, native, both"):
        tcli_export.export_artifacts(None, {}, str(tmp_path / "x"), 2, fmt="jax")
    assert not os.path.exists(tmp_path / "x")


def test_cli_export_int8_calibrates_on_a_pack(tmp_path):
    """Each video of a ``.fvtpack`` is a calibration video: the artifact
    equals the serving fn on the qpack calibrated on their clips."""
    sd = _state("r2plus1d_18")
    export_weights(str(tmp_path / "w.pt"), sd)
    videos = [make_frames(i, 10, 40, 56, seed=i) for i in range(2)]
    pack = str(tmp_path / "c.fvtpack")
    write_pack_from_arrays([(f"v{i}.mp4", 0, (), f) for i, f in enumerate(videos)], pack,
                           (40, 56))
    argv = ["--model", "r2plus1d_18", "--num-classes", str(CLASSES), "--multilabel",
            "--dropout", "0.0", *GEOM, "--device", "cpu", "--weights", str(tmp_path / "w.pt"),
            "--out", str(tmp_path / "a"), "--clip-batch", "2", "--int8", "--calib-video", pack,
            "--calib-clips", "2"]
    meta = tcli_export.main(argv)
    assert meta["int8"] is True and meta["input"]["shape"] == [2, 4, 40, 56, 3]
    cfg = build_config(tcli_export.parse_args(argv))
    calib = tcli_export.collect_pack_calib_clips(cfg, pack, 2, max_clips=2)
    assert len(calib) == 2 and all(c.shape == (2, 4, 40, 56, 3) for c in calib)
    qpack = tserving.quantize_for_serving(cfg, sd, calib, device="cpu")
    run = tserving.load_serving(str(tmp_path / "a" / "serving.pt2"))
    with torch.no_grad():
        want = tserving.make_serving_fn(cfg, sd, qpack=qpack, device="cpu")(
            torch.from_numpy(calib[0]))
    torch.testing.assert_close(run(calib[0]), want, rtol=0, atol=0)
