"""The port stands alone and its entry points refuse to run silently on the
host: importing every module of ``fastvideotagging_tpu_torch`` loads no JAX
stack and no module of the JAX package; with no CUDA card, an entry point
called without ``device='cpu'`` raises; a failed kernel build raises."""

import json
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
            "fastvideotagging_tpu_torch.models.convert"} <= set(res["imported"])
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


def test_kernel_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()
    assert _build.sources() == ["conv2plus1d"]


def test_kernel_build_is_keyed_on_source_hash(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    a = _build._so_path("conv2plus1d")
    assert a.startswith(str(tmp_path)) and a.endswith(".so")
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-lineinfo",))
    assert _build._so_path("conv2plus1d") != a


def test_tagger_rejects_wrong_tag_names():
    cfg = ExperimentConfig(model=ModelConfig(num_classes=3))
    state = get_model("r2plus1d_18", num_classes=3, device="cpu").state_dict()
    with pytest.raises(ValueError, match="2 tag names for 3 classes"):
        Tagger(cfg, state, tag_names=["a", "b"], device="cpu")
    with pytest.raises(RuntimeError, match="size mismatch"):
        Tagger(ExperimentConfig(model=ModelConfig(num_classes=4)), state, device="cpu")
    assert np.isfinite(state["fc.weight"].numpy()).all()
