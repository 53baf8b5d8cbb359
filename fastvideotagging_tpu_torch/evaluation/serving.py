"""Serving export: the inference function as one ``torch.export`` artifact
(the counterpart of ``fastvideotagging_tpu/evaluation/serving.py``).

``export_serving`` bakes the trained weights into a scores program (uint8
clips in, per-class scores out: the deterministic eval preprocess, the
backbone, sigmoid / softmax) and writes it with ``torch.export.save``. The
artifact is self-contained: ``load_serving`` runs it in any process that
has imported the port's op library (ops/library.py, which registers the
hand kernels as ``fvt::*`` ops), with no model code.

The program runs the hand kernels where the model runs them: the backbone
is built at ``cfg.model.kernels`` ('cuda' by default), so an artifact
exported on the card calls K1 / K2 (bf16) or Q1 / Q2 (int8) there, and one
exported with ``device='cpu'`` their plain versions. The JAX package builds
with ``backend="xla"`` for portability across XLA backends; this artifact
is for the device it was exported on. Its weights live on that device, so
loading it without a card raises.

``export_serving_native`` is the native-runner format (the counterpart of
the JAX package's ``export_serving_stablehlo``, raw StableHLO for its C++
PJRT runner): the same program compiled ahead of time by AOTInductor into
one package, ``serving.native.pt2``, that the C++ runner
(csrc/native_runner.cpp, driven by native/runner.py) loads and runs with no
Python in its process. Inductor compiles the glue (the uint8 preprocess,
eval BatchNorm, ReLU, the residual adds, the head), as XLA compiles the
reference's StableHLO; the hand kernels stay extern calls of the ``fvt::*``
ops, which the runner takes from the C++ op library (csrc/fvt_ops.cpp).
The package is compiled for the device it is exported on.
"""

from __future__ import annotations

import io

import numpy as np
import torch
from torch import nn
from torch.utils import _pytree as pytree

from fastvideotagging_tpu_torch._device import device_of, resolve_device
from fastvideotagging_tpu_torch.config import ExperimentConfig
from fastvideotagging_tpu_torch.evaluation.quantized import _resolved
from fastvideotagging_tpu_torch.models import heads
from fastvideotagging_tpu_torch.models.zoo import config_clip_shape, model_from_config
from fastvideotagging_tpu_torch.ops import _build
from fastvideotagging_tpu_torch.ops import library  # noqa: F401  (registers fvt::*)
from fastvideotagging_tpu_torch.ops.int8_infer import calibrate, int8_infer, quantize_variables
from fastvideotagging_tpu_torch.ops.preprocess import preprocess_eval_clip


NATIVE_PACKAGE = "serving.native.pt2"  # the native format's file in an export directory


class ServingFn(nn.Module):
    """(clips uint8 (N, T, H, W, 3)) -> scores f32 (N, K): the centre-crop,
    no-flip preprocess, the backbone, the head. With ``qpack`` (from
    ``quantize_for_serving``) the backbone is the int8 engine, in the
    spec's default mode unless ``dynamic`` says otherwise; the qpack's
    tensors are this module's buffers, so they bake into the exported
    program like the weights."""

    def __init__(self, cfg: ExperimentConfig, state_dict: dict, qpack=None,
                 device: str | torch.device = "cuda", dynamic: bool | None = None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.dtype = getattr(torch, cfg.model.compute_dtype)
        self.model = None
        if qpack is None:
            self.model = model_from_config(cfg.model, device=dev,
                                           clip_shape=config_clip_shape(cfg.data))
            self.model.load_state_dict(state_dict)
            self.model.eval()
            return
        # raises the informative coverage KeyError for models the engine
        # does not cover
        self.spec, self.float_blocks = _resolved(cfg.model.name, None)
        # spec default: dynamic per-batch scales where static calibration
        # measurably loses accuracy (the JAX package's INT8_S3D.json)
        self.dynamic = self.spec.default_dynamic if dynamic is None else dynamic
        leaves, self._qpack_tree = pytree.tree_flatten(qpack)
        for i, t in enumerate(leaves):
            # contiguous: the export saves a transposed view (the head's
            # kernel) with a warning
            self.register_buffer(f"qpack_{i}", t.to(dev).contiguous())
        self._n_leaves = len(leaves)

    def forward(self, frames_u8: torch.Tensor) -> torch.Tensor:
        d = self.cfg.data
        clips = preprocess_eval_clip(frames_u8, d.resize_hw, d.crop_hw, d.mean, d.std,
                                     out_dtype=self.dtype)
        return self.scores(clips)

    def scores(self, clips: torch.Tensor) -> torch.Tensor:
        """The backbone (or the int8 engine) and the head on preprocessed
        clips: the part a CUDA graph can capture (the preprocess copies its
        resize tables from the host on every call)."""
        if self.model is not None:
            logits = self.model(clips)
        else:
            qpack = pytree.tree_unflatten(
                [getattr(self, f"qpack_{i}") for i in range(self._n_leaves)], self._qpack_tree)
            logits = int8_infer(qpack, clips, self.spec, float_blocks=self.float_blocks,
                                dynamic=self.dynamic)
        return heads.predict_scores(logits, self.cfg.model.multilabel)


def make_serving_fn(cfg: ExperimentConfig, state_dict: dict, qpack=None,
                    device: str | torch.device = "cuda") -> ServingFn:
    """(clips uint8 (N, T, H, W, 3)) -> scores f32 (N, K): preprocess +
    forward + head, on ``device`` (the card unless the caller asks for the
    CPU). With ``qpack`` (from quantize_for_serving) the backbone runs
    through the int8 engine instead of the model."""
    return ServingFn(cfg, state_dict, qpack=qpack, device=device)


def quantize_for_serving(cfg: ExperimentConfig, state_dict: dict, calib_frames_u8,
                         device: str | torch.device = "cuda") -> dict:
    """-> qpack for the int8 serving export, on ``device``, calibrated on
    uint8 clip batches run through the same baked preprocess."""
    dev = resolve_device(device)
    d = cfg.data
    arch, _ = _resolved(cfg.model.name, None)
    variables = {k: v.to(dev) for k, v in state_dict.items()}
    dtype = getattr(torch, cfg.model.compute_dtype)
    calib = [preprocess_eval_clip(torch.as_tensor(np.asarray(frames)).to(dev), d.resize_hw,
                                  d.crop_hw, d.mean, d.std, out_dtype=dtype)
             for frames in calib_frames_u8]
    scales = calibrate(variables, calib, spec=arch)
    return quantize_variables(variables, scales, spec=arch)


def export_serving(cfg: ExperimentConfig, state_dict: dict, clip_batch: int,
                   path: str | None = None, qpack=None,
                   device: str | torch.device = "cuda") -> bytes:
    """``torch.export`` of the serving fn for a static (clip_batch, T, H, W,
    3) uint8 input, (H, W) the ship geometry (``source_hw or resize_hw``),
    saved with ``torch.export.save``; returns the artifact's bytes (also
    written to ``path`` if given)."""
    fn = make_serving_fn(cfg, state_dict, qpack=qpack, device=device)
    d = cfg.data
    h, w = d.source_hw or d.resize_hw
    example = torch.zeros((clip_batch, d.sampler.clip_len, h, w, 3), dtype=torch.uint8,
                          device=resolve_device(device))
    with torch.no_grad():
        program = torch.export.export(fn, (example,))
    program.example_inputs = None  # else the zeros it was traced on are saved with it
    buf = io.BytesIO()
    torch.export.save(program, buf)
    data = buf.getvalue()
    if path is not None:
        with open(path, "wb") as f:
            f.write(data)
    return data


def export_serving_native(cfg: ExperimentConfig, state_dict: dict, clip_batch: int, path: str,
                          qpack=None, device: str | torch.device = "cuda",
                          dynamic: bool | None = None) -> str:
    """The serving fn for a static (clip_batch, T, H, W, 3) uint8 input
    (``export_serving``'s program; ``dynamic`` picks the int8 engine's mode,
    the spec's default where None), compiled by AOTInductor for ``device``
    into the package at ``path``; returns ``path``."""
    dev = resolve_device(device)
    fn = ServingFn(cfg, state_dict, qpack=qpack, device=dev, dynamic=dynamic)
    d = cfg.data
    h, w = d.source_hw or d.resize_hw
    example = torch.zeros((clip_batch, d.sampler.clip_len, h, w, 3), dtype=torch.uint8,
                          device=dev)
    with torch.no_grad():
        program = torch.export.export(fn, (example,))
        # the package's C++ is compiled and linked by the g++ that builds the
        # runner and the op library (ops/_build.py), not one that $CXX may name
        return torch._inductor.aoti_compile_and_package(
            program, package_path=path, inductor_configs={"cpp.cxx": (None, _build._gxx())})


def load_serving(path_or_bytes):
    """Deserialize a serving artifact -> ``run(clips_u8) -> scores``: the
    clips (a tensor or an array) go to the artifact's device first."""
    src = io.BytesIO(path_or_bytes) if isinstance(path_or_bytes, bytes) else path_or_bytes
    program = torch.export.load(src)
    module = program.module()
    dev = device_of([program.state_dict, program.constants])

    def run(clips_u8) -> torch.Tensor:
        x = clips_u8 if torch.is_tensor(clips_u8) else torch.from_numpy(np.asarray(clips_u8))
        with torch.no_grad():
            return module(x.to(dev))

    run.program = program
    return run
