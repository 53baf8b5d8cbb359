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
            "fastvideotagging_tpu_torch.ops.arch_spec",
            "fastvideotagging_tpu_torch.ops.int8_conv",
            "fastvideotagging_tpu_torch.ops.int8_infer",
            "fastvideotagging_tpu_torch.evaluation.quantized",
            "fastvideotagging_tpu_torch.cli.serve",
            "fastvideotagging_tpu_torch.ops.library",
            "fastvideotagging_tpu_torch.evaluation.serving",
            "fastvideotagging_tpu_torch.cli.export",
            "fastvideotagging_tpu_torch.native",
            "fastvideotagging_tpu_torch.native.runner",
            "fastvideotagging_tpu_torch.evaluation.native_tagger",
            "fastvideotagging_tpu_torch.parallel",
            "fastvideotagging_tpu_torch.parallel.mesh",
            "fastvideotagging_tpu_torch.parallel.temporal",
            "fastvideotagging_tpu_torch.train.shardmap_step",
            "fastvideotagging_tpu_torch.train.time_sharded",
            "fastvideotagging_tpu_torch.evaluation.long_clip",
            "fastvideotagging_tpu_torch.ops.scopes",
            "fastvideotagging_tpu_torch.utils.profiling",
            "fastvideotagging_tpu_torch.utils.step_profiler",
            "fastvideotagging_tpu_torch.benchmarks.int8_serving",
            "fastvideotagging_tpu_torch.benchmarks.int8_s3d",
            "fastvideotagging_tpu_torch.benchmarks.int8_family",
            "fastvideotagging_tpu_torch.benchmarks.int8_inception",
            "fastvideotagging_tpu_torch.benchmarks.accuracy_kinetics_geom",
            "fastvideotagging_tpu_torch.examples",
            "fastvideotagging_tpu_torch.examples.train_synthetic",
            "fastvideotagging_tpu_torch.evaluation.graphed",
            "fastvideotagging_tpu_torch.benchmarks.int8_kinetics",
            "fastvideotagging_tpu_torch.benchmarks.native_serving",
            "fastvideotagging_tpu_torch.benchmarks.e2e_train",
            "fastvideotagging_tpu_torch.benchmarks.slowfast_step",
            "fastvideotagging_tpu_torch.benchmarks.scaleonly_step",
            "fastvideotagging_tpu_torch.benchmarks.remat_step"} <= set(res["imported"])
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


def test_accuracy_scripts_raise_without_cuda():
    """The int8 accuracy scripts, the Kinetics-geometry run, the int8
    throughput and the example run on the card unless told otherwise, and
    raise before they write any data."""
    _needs_no_card()
    from fastvideotagging_tpu_torch.benchmarks import (
        accuracy_kinetics_geom,
        int8_family,
        int8_inception,
        int8_s3d,
        int8_serving,
    )
    from fastvideotagging_tpu_torch.examples import train_synthetic

    cases = [lambda: int8_s3d.run(num_classes=2, epochs=5),
             lambda: int8_family.run_model("p3d_63", num_classes=2, epochs=5),
             lambda: int8_inception.accuracy("i3d", num_classes=2, epochs=5),
             lambda: int8_inception.serving_throughput("s3d"),
             lambda: int8_serving.serving_throughput(),
             lambda: accuracy_kinetics_geom.run(num_classes=2, epochs=5),
             lambda: train_synthetic.main(["--epochs", "1"])]
    for case in cases:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            case()


def test_parallel_entry_points_raise_without_cuda():
    """Joining a job, the mesh, the time mesh and a rank's device are the
    card's unless the caller asks for the CPU: without one they raise
    before any process group is made; NCCL takes only CUDA ranks."""
    _needs_no_card()
    import torch.distributed as dist

    from fastvideotagging_tpu_torch.evaluation.long_clip import make_time_mesh
    from fastvideotagging_tpu_torch.parallel import init_multihost, make_mesh
    from fastvideotagging_tpu_torch.parallel.mesh import rank_device

    for case in (lambda: init_multihost("127.0.0.1:1", 2, 0), make_mesh, make_time_mesh,
                 rank_device):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            case()
    with pytest.raises(ValueError, match="NCCL backend needs the ranks on CUDA"):
        init_multihost("127.0.0.1:1", 2, 0, backend="nccl", device="cpu")
    assert not dist.is_initialized()
    assert make_mesh(device="cpu").device.type == "cpu"


def test_export_entry_points_raise_without_cuda(tmp_path):
    """cli.export and the serving export run on the card unless told
    otherwise; an artifact exported with device='cpu' loads and runs on
    the host."""
    _needs_no_card()
    from fastvideotagging_tpu_torch.cli import export as cli_export
    from fastvideotagging_tpu_torch.evaluation import serving
    from fastvideotagging_tpu_torch.train.checkpoint import export_weights

    cfg = ExperimentConfig(model=ModelConfig(name="tiny3d", num_classes=3))
    state = get_model("tiny3d", num_classes=3, device="cpu").state_dict()
    weights = str(tmp_path / "w.pt")
    export_weights(weights, state)
    clips = np.zeros((1, 16, 128, 171, 3), np.uint8)
    cases = [lambda: cli_export.main(["--model", "tiny3d", "--num-classes", "3", "--weights",
                                      weights, "--out", str(tmp_path / "a")]),
             lambda: serving.make_serving_fn(cfg, state),
             lambda: serving.export_serving(cfg, state, 1),
             lambda: serving.quantize_for_serving(cfg, state, [clips])]
    for case in cases:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            case()
    assert not (tmp_path / "a").exists()
    run = serving.load_serving(serving.export_serving(cfg, state, 1, device="cpu"))
    assert run(clips).shape == (1, 3)


def test_kernel_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()
    assert _build.sources() == ["fused_block", "int8_conv", "spatial_conv", "temporal_dw",
                                "temporal_micro"]


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


def _public_names(path: str) -> set[str]:
    """The public top-level names a module of the JAX package defines or
    imports (read from its source: nothing of it is imported here)."""
    import ast

    with open(os.path.join(_ROOT, path)) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.ImportFrom) and node.module != "__future__":
            names.update(a.asname or a.name for a in node.names)
    return {n for n in names if not n.startswith("_") or n == "__version__"}


# Public names of the reference with no counterpart in the port, each with
# its reason.
DELIBERATE_OMISSIONS = {
    "utils.step_profiler": {
        # both parse XLA's HLO text: the port has no HLO; its step profiler
        # takes the convs from hooks on the model (ConvInventory)
        "parse_hlo": "HLO text",
        "parse_fusion_bytes": "HLO text (a fusion's tile-padded TPU bytes)",
    },
}


@pytest.mark.parametrize("module", ["", "models", "evaluation.quantized", "utils.profiling",
                                    "utils.step_profiler"])
def test_the_port_has_the_references_public_names(module):
    """Each public name of the JAX package's top level, of its ``models``,
    of ``evaluation.quantized`` and of the profiling tier exists in the
    port's counterpart, but for the deliberate omissions."""
    import importlib

    path = os.path.join("fastvideotagging_tpu", *module.split("."))
    path = os.path.join(path, "__init__.py") if os.path.isdir(os.path.join(_ROOT, path)) \
        else path + ".py"
    omitted = DELIBERATE_OMISSIONS.get(module, {})
    want = _public_names(path)
    assert set(omitted) <= want
    want -= set(omitted)
    port = importlib.import_module(".".join(filter(None, ["fastvideotagging_tpu_torch", module])))
    assert want and not sorted(n for n in want if not hasattr(port, n))
    if not module:
        import fastvideotagging_tpu_torch as pkg

        assert pkg.__version__ == "0.1.0" and set(pkg.__all__) >= want
        assert "r2plus1d18_ucf101" in pkg.PRESETS


def test_native_builds_are_keyed_and_raise_without_a_compiler(tmp_path, monkeypatch):
    """The runner and the op library build as the kernels do: into the
    build directory, under a name keyed on a hash of their sources and
    flags (an edited source or a changed flag is a new build), and a missing
    compiler raises."""
    import shutil

    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    cmd, out = _build._runner_job("cpu")
    assert out.startswith(str(tmp_path / "build")) and "fvt_native_runner-cpu-" in out
    assert os.path.join(_build.CSRC, "native_runner.cpp") in cmd
    assert _build._runner_job("cpu")[1] == out
    monkeypatch.setattr(_build, "CXX_FLAGS", _build.CXX_FLAGS + ("-g",))
    assert _build._runner_job("cpu")[1] != out
    monkeypatch.undo()
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    out = _build._runner_job("cpu")[1]
    assert _build._runner_job("cpu")[1] == out
    with open(csrc / "plans.h", "a") as f:
        f.write("// edited\n")
    assert _build._runner_job("cpu")[1] != out
    with pytest.raises(ValueError, match="'cpu' or 'cuda'"):
        _build._runner_job("tpu")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        _build.build_runner("cpu")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_op_library()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_native()
    assert not os.path.exists(tmp_path / "build")
