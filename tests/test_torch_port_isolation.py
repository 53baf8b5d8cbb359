"""The port stands alone and its entry points refuse to run silently on the
host: importing every module of ``fastvideotagging_tpu_torch`` loads no JAX
stack and no module of the JAX package; with no CUDA card, an entry point
called without ``device='cpu'`` raises; a failed kernel build raises."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from fastvideotagging_tpu_torch import Tagger, get_model, tag
from fastvideotagging_tpu_torch.config import ExperimentConfig, ModelConfig
from fastvideotagging_tpu_torch.ops import _build

_IMPORT_ALL = r"""
import importlib, json, pkgutil, sys
import fastvideotagging_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
print(json.dumps({"imported": names, "modules": sorted(sys.modules)}))
"""


def test_importing_every_port_module_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], capture_output=True,
                         text=True, check=True, timeout=300)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert {"fastvideotagging_tpu_torch.ops.conv2plus1d",
            "fastvideotagging_tpu_torch.evaluation.tagger",
            "fastvideotagging_tpu_torch.models.convert",
            "fastvideotagging_tpu_torch.models.heads",
            "fastvideotagging_tpu_torch.train.loop",
            "fastvideotagging_tpu_torch.train.lr",
            "fastvideotagging_tpu_torch.train.metrics",
            "fastvideotagging_tpu_torch.train.state",
            "fastvideotagging_tpu_torch.utils.profiling",
            "fastvideotagging_tpu_torch.utils.logging",
            "fastvideotagging_tpu_torch.data.ucf101",
            "fastvideotagging_tpu_torch.data.pipeline",
            "fastvideotagging_tpu_torch.data.packed",
            "fastvideotagging_tpu_torch.ops.fused_block",
            "fastvideotagging_tpu_torch.ops.fused_infer",
            "fastvideotagging_tpu_torch.evaluation.evaluate",
            "fastvideotagging_tpu_torch.ops.temporal_micro",
            "fastvideotagging_tpu_torch.benchmarks.kernel_micro",
            "fastvideotagging_tpu_torch.cli.common",
            "fastvideotagging_tpu_torch.cli.train",
            "fastvideotagging_tpu_torch.data.decode",
            "fastvideotagging_tpu_torch.data.synthetic",
            "fastvideotagging_tpu_torch.data.synthetic_motion",
            "fastvideotagging_tpu_torch.models.tiny3d",
            "fastvideotagging_tpu_torch.train.checkpoint",
            "fastvideotagging_tpu_torch.train.fit",
            "fastvideotagging_tpu_torch.utils.debug",
            "fastvideotagging_tpu_torch.utils.interrupt",
            "fastvideotagging_tpu_torch.utils.layout",
            "fastvideotagging_tpu_torch.data.device_cache",
            "fastvideotagging_tpu_torch.cli.prepare",
            "fastvideotagging_tpu_torch.cli.evaluate",
            "fastvideotagging_tpu_torch.cli.tag",
            "fastvideotagging_tpu_torch.cli.bench_loader",
            "fastvideotagging_tpu_torch.benchmarks.accuracy_hard",
            "fastvideotagging_tpu_torch.models.c3d",
            "fastvideotagging_tpu_torch.models.p3d",
            "fastvideotagging_tpu_torch.models.videoresnet",
            "fastvideotagging_tpu_torch.models.s3d",
            "fastvideotagging_tpu_torch.models.i3d",
            "fastvideotagging_tpu_torch.models.slowfast",
            "fastvideotagging_tpu_torch.models.torch_import",
            "fastvideotagging_tpu_torch.ops.maxpool_grad",
            "fastvideotagging_tpu_torch.ops.arch_spec"} <= set(res["imported"])
    for mod in res["modules"]:
        root = mod.split(".")[0]
        assert root not in ("jax", "jaxlib", "flax", "optax", "orbax"), mod
        # exact match: the prefix also matches fastvideotagging_tpu_torch
        assert root != "fastvideotagging_tpu", mod


def _needs_no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")


def test_entry_points_raise_without_cuda():
    _needs_no_card()
    cfg = ExperimentConfig(model=ModelConfig(num_classes=3))
    state = get_model("r2plus1d_18", num_classes=3, device="cpu").state_dict()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Tagger(cfg, state)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        get_model("r2plus1d_18", num_classes=3)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tag("unused.mp4", state_dict=state, num_classes=3)
    with pytest.raises(ValueError, match="exactly one"):
        tag("unused.mp4", device="cpu")
    # an explicit CPU request runs
    tagger = Tagger(cfg, state, device="cpu")
    assert tagger.model.fc.weight.device.type == "cpu"


def test_training_entry_points_raise_without_cuda(tmp_path):
    """fit, the train CLI (which builds the state through fit), the device
    prefetch and tag(checkpoint=...) run on the card unless told otherwise."""
    _needs_no_card()
    from fastvideotagging_tpu_torch.cli import train as cli_train
    from fastvideotagging_tpu_torch.data.packed import write_pack_from_arrays
    from fastvideotagging_tpu_torch.data.pipeline import device_prefetch
    from fastvideotagging_tpu_torch.data.synthetic import make_frames
    from fastvideotagging_tpu_torch.train.checkpoint import export_weights
    from fastvideotagging_tpu_torch.train.fit import fit

    pack = str(tmp_path / "t.fvtpack")
    write_pack_from_arrays([("v.mp4", 0, (), make_frames(0, 4, 40, 56))], pack, (40, 56))
    cfg = ExperimentConfig(model=ModelConfig(name="tiny3d", num_classes=3))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fit(cfg, pack)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli_train.main(["--model", "tiny3d", "--num-classes", "3", "--train-list", pack,
                        "--resize", "40", "56", "--batch-size", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        next(device_prefetch(iter([{"x": np.zeros(2)}])))
    weights = str(tmp_path / "w.pt")
    export_weights(weights, get_model("tiny3d", num_classes=3, device="cpu").state_dict())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tag("unused.mp4", weights, model_name="tiny3d", num_classes=3)


def test_entry_points_of_the_last_slice_raise_without_cuda(tmp_path):
    """cli.evaluate, cli.tag, cli.bench_loader, the accuracy benchmark and
    the device cache run on the card unless told otherwise."""
    _needs_no_card()
    from fastvideotagging_tpu_torch.benchmarks import accuracy_hard
    from fastvideotagging_tpu_torch.cli import bench_loader
    from fastvideotagging_tpu_torch.cli import evaluate as cli_evaluate
    from fastvideotagging_tpu_torch.cli import tag as cli_tag
    from fastvideotagging_tpu_torch.data.device_cache import build_cache
    from fastvideotagging_tpu_torch.data.packed import PackedDataset, write_pack_from_arrays
    from fastvideotagging_tpu_torch.data.synthetic import make_frames
    from fastvideotagging_tpu_torch.config import DataConfig

    pack = str(tmp_path / "t.fvtpack")
    write_pack_from_arrays([("v.mp4", 0, (), make_frames(0, 4, 40, 56))], pack, (40, 56))
    flags = ["--model", "tiny3d", "--num-classes", "3", "--resize", "40", "56"]
    cases = [lambda: cli_evaluate.main(flags + ["--val-list", pack, "--checkpoint-dir",
                                                str(tmp_path / "ck")]),
             lambda: cli_tag.main(flags + [pack, "--weights", "w.pt"]),
             lambda: bench_loader.measure(videos=1, frames=4),
             lambda: accuracy_hard.run(num_classes=2, epochs=5, root=str(tmp_path / "a")),
             lambda: build_cache(PackedDataset(pack, DataConfig(resize_hw=(40, 56))))]
    for case in cases:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            case()


def test_kernel_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()
    assert _build.sources() == ["fused_block", "spatial_conv", "temporal_dw", "temporal_micro"]


def test_kernel_build_is_keyed_on_source_hash(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    a = _build._so_path("spatial_conv")
    assert a.startswith(str(tmp_path)) and a.endswith(".so")
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-lineinfo",))
    assert _build._so_path("spatial_conv") != a


def test_fused_block_is_built_with_its_wrappers_tile_plan(tmp_path, monkeypatch):
    """K4's tile constants have one source, ops/fused_block.py: nvcc gets
    them as -D flags, and a changed plan is a new build."""
    from fastvideotagging_tpu_torch.ops import fused_block

    flags = _build._flags("fused_block")
    assert flags[: len(_build.NVCC_FLAGS)] == _build.NVCC_FLAGS
    assert set(fused_block.NVCC_DEFINES) <= set(flags)
    assert f"-DFVT_K4_STAGES={fused_block._K4_STAGES}" in flags
    assert _build._flags("unplanned") == _build.NVCC_FLAGS  # a source with no plan
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    a = _build._so_path("fused_block")
    monkeypatch.setattr(fused_block, "NVCC_DEFINES", fused_block.NVCC_DEFINES + ("-DFVT_X=1",))
    assert _build._so_path("fused_block") != a


def test_spatial_conv_is_built_with_its_wrappers_ring_depth(tmp_path, monkeypatch):
    """K1's ring depth has one source, ops/conv2plus1d.py: nvcc gets it as a
    -D flag, each launch passes the plan's depth (which the kernel checks),
    and a changed depth is a new build."""
    from fastvideotagging_tpu_torch.ops import conv2plus1d

    flags = _build._flags("spatial_conv")
    assert flags[: len(_build.NVCC_FLAGS)] == _build.NVCC_FLAGS
    assert f"-DFVT_K1_STAGES={conv2plus1d.spatial_plan((1, 8, 8, 64), 64, 3).stages}" in flags
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    a = _build._so_path("spatial_conv")
    monkeypatch.setattr(conv2plus1d, "NVCC_DEFINES", ("-DFVT_K1_STAGES=4",))
    assert _build._so_path("spatial_conv") != a


def test_tagger_rejects_wrong_tag_names():
    cfg = ExperimentConfig(model=ModelConfig(num_classes=3))
    state = get_model("r2plus1d_18", num_classes=3, device="cpu").state_dict()
    with pytest.raises(ValueError, match="2 tag names for 3 classes"):
        Tagger(cfg, state, tag_names=["a", "b"], device="cpu")
    with pytest.raises(RuntimeError, match="size mismatch"):
        Tagger(ExperimentConfig(model=ModelConfig(num_classes=4)), state, device="cpu")
    assert np.isfinite(state["fc.weight"].numpy()).all()


_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_chip_smoke_refuses_to_run_without_a_card():
    _needs_no_card()
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=_ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 2 and out.stdout == ""
    assert "no CUDA device" in out.stderr


def test_chip_smoke_imports_no_jax_and_knows_the_training_path():
    code = ("import json, sys, chip_smoke as cs\n"
            "sites = cs.path_sites(cs.TRAIN_BATCH)\n"
            "print(json.dumps({'modules': sorted(sys.modules), 'sites': sites,\n"
            "                  'launches': cs.TRAIN_STEP_LAUNCHES, 'kernels': list(cs.KERNELS),\n"
            "                  'dw': cs.bound('temporal_dw', (8, 16, 56, 56, 144), 64),\n"
            "                  'dx': cs.bound('temporal_conv', (8, 16, 56, 56, 64), 144),\n"
            "                  'fused_sites': cs.fused_sites(),\n"
            "                  'k4': cs.fused_bound((8, 16, 56, 56, 64), 144, 64),\n"
            "                  'forward': cs.FORWARD_LAUNCHES}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=_ROOT, capture_output=True,
                         text=True, check=True, timeout=300)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    for mod in res["modules"]:
        root = mod.split(".")[0]
        assert root not in ("jax", "jaxlib", "flax", "optax", "orbax"), mod
        assert root != "fastvideotagging_tpu", mod
    assert res["kernels"] == ["spatial_conv", "temporal_conv", "temporal_dw", "fused_block"]
    # one step launches each forward kernel twice per site (forward + dx)
    # and K3 once per temporal site
    per_forward = {"spatial_conv": 0, "temporal_conv": 0}
    for _, kernel, xs, _, n in res["sites"]:
        assert xs[0] == 32
        per_forward[kernel] += n
    assert per_forward == {"spatial_conv": 13, "temporal_conv": 14}
    assert res["launches"] == {"spatial_conv": 26, "temporal_conv": 28, "temporal_dw": 14,
                               "fused_block": 0}
    # K4 takes the 13 stride-1 (2+1)D pairs of a forward; the fused engine
    # launches nothing else of the port's
    assert sum(n for *_, n in res["fused_sites"]) == 13
    assert res["forward"]["fused"] == {"spatial_conv": 0, "temporal_conv": 0,
                                       "temporal_dw": 0, "fused_block": 13}
    assert res["forward"]["cuda"]["fused_block"] == 0
    # stage 1 at 8 clips: the two GEMMs over the taps inside the frame
    # (56 + 55 + 55 per spatial axis) and inside [0, T) (16 + 15 + 15);
    # mid stays on chip
    k4_ms, k4_by = res["k4"]
    assert k4_by == "operations"
    flops = 2 * (8 * 16 * 166 * 166 * 64 * 144 + 8 * 3136 * 46 * 144 * 64)
    assert k4_ms == pytest.approx(flops / 989e12 * 1e3)
    # stage-1 temporal dw at 8 clips: x and g read once, dw written in f32,
    # 16 + 15 + 15 row-plane pairs over the three taps; bytes bound it
    rows = 8 * 16 * 3136
    ms, by = res["dw"]
    assert by == "bytes"
    assert ms == pytest.approx((2 * rows * (144 + 64) + 4 * 3 * 144 * 64) / 3.35e12 * 1e3)
    ops_ms = 2 * 8 * 3136 * (16 + 15 + 15) * 144 * 64 / 989e12 * 1e3
    assert ops_ms < ms
    # the dx of that conv is the forward's GEMM with C and Co swapped, over
    # the same 16 + 15 + 15 row-plane pairs
    assert res["dx"] == list(_bound_forward(rows, 3, 8 * 3136 * 46, 64, 144))


def _bound_forward(rows, taps, pairs, c, co):
    t_ops = 2.0 * pairs * c * co / 989e12
    t_bytes = 2.0 * (rows * (c + co) + taps * c * co) / 3.35e12
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def test_spatial_conv_argtypes_match_its_c_signature():
    """The ctypes binding of K1's entry point has one type per parameter of
    the C function, in the same kinds (pointers, 64-bit and 32-bit ints)."""
    import ctypes
    import re

    from fastvideotagging_tpu_torch.ops import conv2plus1d

    with open(os.path.join(_build.CSRC, "spatial_conv.cu")) as f:
        src = f.read()
    params = re.search(r"int fvt_spatial_conv_bf16\(([^)]*)\)", src).group(1).split(",")

    def kind(param):
        if "*" in param:
            return ctypes.c_void_p
        return ctypes.c_longlong if "long long" in param else ctypes.c_int

    assert conv2plus1d._K1_ARGTYPES == [kind(q) for q in params]


def test_fused_block_argtypes_match_its_c_signature():
    """The ctypes binding of K4's entry point has one type per parameter of
    the C function, in the same kinds (pointers, 64-bit and 32-bit ints)."""
    import ctypes
    import re

    from fastvideotagging_tpu_torch.ops import fused_block

    with open(os.path.join(_build.CSRC, "fused_block.cu")) as f:
        src = f.read()
    params = re.search(r"int fvt_fused_block_bf16\(([^)]*)\)", src).group(1).split(",")

    def kind(param):
        if "*" in param:
            return ctypes.c_void_p
        return ctypes.c_longlong if "long long" in param else ctypes.c_int

    assert fused_block._K4_ARGTYPES == [kind(q) for q in params]
    assert len(params) == 26


def test_temporal_dw_argtypes_match_its_c_signature():
    """The ctypes binding of K3's entry point has one type per parameter of
    the C function, in the same kinds (pointers, 64-bit and 32-bit ints)."""
    import ctypes
    import re

    from fastvideotagging_tpu_torch.ops import conv2plus1d

    with open(os.path.join(_build.CSRC, "temporal_dw.cu")) as f:
        src = f.read()
    params = re.search(r"int fvt_temporal_dw_bf16\(([^)]*)\)", src).group(1).split(",")

    def kind(param):
        if "*" in param:
            return ctypes.c_void_p
        return ctypes.c_longlong if "long long" in param else ctypes.c_int

    assert conv2plus1d._K3_ARGTYPES == [kind(q) for q in params]


def test_temporal_dw_is_built_with_its_wrappers_plan(tmp_path, monkeypatch):
    """K3's slab depth and loads in flight have one source,
    ops/conv2plus1d.py: nvcc gets them as -D flags, each launch passes the
    plan's values (which the kernel checks), and a changed plan is a new
    build."""
    from fastvideotagging_tpu_torch.ops import conv2plus1d

    plan = conv2plus1d.temporal_dw_plan((2, 8, 64, 144), 64, 3)
    flags = _build._flags("temporal_dw")
    assert flags[: len(_build.NVCC_FLAGS)] == _build.NVCC_FLAGS
    assert f"-DFVT_K3_ROWS={plan.tile_s}" in flags and f"-DFVT_K3_AHEAD={plan.ahead}" in flags
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    a = _build._so_path("temporal_dw")
    monkeypatch.setattr(conv2plus1d, "NVCC_DEFINES", ("-DFVT_K3_ROWS=64", "-DFVT_K3_AHEAD=2"))
    assert _build._so_path("temporal_dw") != a
