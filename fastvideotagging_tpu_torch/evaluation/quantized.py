"""int8 PTQ serving glue: calibrate and build an eval ``apply_fn`` (the
counterpart of ``fastvideotagging_tpu/evaluation/quantized.py``).

Bridges ops/int8_infer (the quantized engine) into the evaluation surface:
``make_int8_engine`` builds the engine's ``apply_fn(qpack, clips) ->
scores`` once (the qpack is an argument, so one engine serves any number
of recalibrations); on the card it replays one captured CUDA graph per
input shape (evaluation/graphed.py), as the JAX engine is one jitted
executable with the qpack traced, and a recalibrated qpack is copied into
the graph's static buffers, never recaptured. ``quantize_for`` produces a
qpack from calibration clips, and ``make_int8_apply`` does both. The apply_fn plugs into
``evaluate(..., apply_fn=...)`` / ``evaluate_video_scores`` with the qpack
as the ``variables`` argument. Coverage comes from the architecture specs
(ops/arch_spec.spec_for); each spec carries its mixed-precision bf16 tail
(``default_float_blocks``).
"""

from __future__ import annotations

from fastvideotagging_tpu_torch.evaluation.graphed import Graphed
from fastvideotagging_tpu_torch.models import heads
from fastvideotagging_tpu_torch.ops.arch_spec import COVERED_MODELS, spec_for  # noqa: F401
from fastvideotagging_tpu_torch.ops.int8_infer import calibrate, int8_infer, quantize_variables

# The stage depths of the r2plus1d family (coverage itself lives in
# arch_spec.spec_for).
STAGE_BLOCKS = {
    "r2plus1d_18": (2, 2, 2, 2),
    "r2plus1d_18_tpu": (2, 2, 2, 2),
    "r2plus1d_34": (3, 4, 6, 3),
    "r2plus1d_34_tpu": (3, 4, 6, 3),
}


def _resolved(model_name: str, float_blocks):
    """-> (ArchSpec, float_blocks tuple); raises the informative coverage
    KeyError for unsupported zoo names."""
    spec = spec_for(model_name)  # raises KeyError with the covered list
    fb = (spec.default_float_blocks if float_blocks is None
          else tuple(float_blocks))
    return spec, fb


def make_int8_engine(model_name: str, multilabel: bool = False,
                     float_blocks=None, dynamic: bool | None = None) -> Graphed:
    """-> ``apply_fn(qpack, clips) -> scores``: on the card one captured
    graph per input shape (``Graphed``; ``apply_fn.fn`` is the eager walk),
    on the CPU the walk itself.

    ``dynamic=None`` takes the spec's measured default: static calibrated
    scales for the residual families, dynamic per-batch scales where the
    JAX package measured the static ones to lose accuracy (i3d)."""
    spec, fb = _resolved(model_name, float_blocks)
    if dynamic is None:
        dynamic = spec.default_dynamic

    def apply_fn(qpack, clips):
        return heads.predict_scores(
            int8_infer(qpack, clips, spec, float_blocks=fb, dynamic=dynamic), multilabel)

    mode = "dynamic" if dynamic else "static"
    return Graphed(apply_fn, f"the {model_name} int8 engine ({mode})", reused=(0,))


def quantize_for(model_name: str, variables: dict, calib_clips, w_cols=None):
    """-> qpack for make_int8_engine's apply_fn.

    ``calib_clips``: iterable of preprocessed (K, T, ch, cw, 3) clip
    batches (e.g. ``preprocess_eval_clip`` outputs of a few videos).
    ``w_cols``: ``int8_infer.consumer_absmax`` of these weights, for a
    caller that requantizes often. Specs with ``default_site_margins`` (the
    Inception families) get per-site static headroom from the calibration
    batches' absmax spread."""
    spec, _ = _resolved(model_name, None)
    if spec.default_site_margins:
        scales, margins = calibrate(variables, calib_clips, spec=spec,
                                    return_margins=True)
        return quantize_variables(variables, scales, spec=spec,
                                  static_margin=margins, w_cols=w_cols)
    scales = calibrate(variables, calib_clips, spec=spec)
    return quantize_variables(variables, scales, spec=spec, w_cols=w_cols)


def make_int8_apply(model_name: str, variables: dict, calib_clips,
                    multilabel: bool = False, float_blocks=None,
                    dynamic: bool | None = None):
    """One-shot convenience: -> (qpack, apply_fn(qpack, clips)).

    For repeated requantization (per-video self-calibration), build the
    engine once with make_int8_engine and requantize with quantize_for."""
    qpack = quantize_for(model_name, variables, calib_clips)
    apply_fn = make_int8_engine(model_name, multilabel, float_blocks, dynamic)
    return qpack, apply_fn
