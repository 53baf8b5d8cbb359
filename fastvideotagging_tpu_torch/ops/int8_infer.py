"""int8 post-training-quantized inference engine (serving), spec-driven: the
counterpart of ``fastvideotagging_tpu/ops/int8_infer.py``, with its names.

Every engine here (the bf16 reference walk, calibration, the quantizer and
the int8 forward) is an interpreter over the declarative ``ops/arch_spec``
IR, so one walk serves every covered architecture. The weights are the
port's ``state_dict``; a spec path resolves to it through
``arch_spec.param`` (the rule of models/convert.py).

The scheme is the JAX engine's, number for number:

  * weights: symmetric int8, per-output-channel scales, quantized after
    folding in per-input-channel smoothing factors f_c = sqrt(A_c / W_c)
    (A_c the calibrated activation absmax of the channel, W_c the absmax of
    the consumer kernels' input channel), normalized to median 1 and
    clamped to [0.1, 10];
  * activations: x' = x / f_c, then one per-tensor scale: STATIC (the
    calibrated absmax with 2x headroom, the default) or DYNAMIC (the
    batch's amax, ``dynamic=True``);
  * each conv runs int8 x int8 -> int32 on the card's tensor cores (Q1,
    ops/int8_conv.py) with the epilogue relu?(f32(acc) * (w_scale * bn_scale
    * s) + bn_bias); each quantization point is Q2, or, where the next site
    alone reads a conv's output, that conv's epilogue: in the static mode
    the quantize itself (form (b)), in the dynamic mode the site's amax,
    leaving Q2 its quantize pass alone; a block's residual add, ReLU and the
    next quantize (or amax) are its last conv's epilogue (form (c)): the
    same steps, fused;
  * a multiply-add the JAX engine writes as ``a * b + c`` is one fused
    multiply-add here (``addcmul``, ``fmaf``), since XLA contracts it.
  * residual adds, pools and the head run in f32 (PyTorch ops, as they are
    XLA in the JAX engine);
  * mixed precision: ``float_blocks`` run in bf16 with exactly dequantized
    weights, each spec's measured default tail (r2plus1d: stage 4).

With a profiler's scopes on (ops/scopes.py), each conv runs under
``fvt/fwd/<conv id>`` and each quantize pass under ``fvt/quant/<site>``.

The bf16 walk (calibration, and the bf16 reference engine) feeds each
conv's f32 result to its BatchNorm affine unrounded, as the jitted JAX walk
does (``_walk_conv``). ``conv_f`` in the ``float_blocks`` takes the model's
routing: ``spatial_conv`` / ``temporal_conv`` of ops/conv2plus1d.py for the
(2+1)D factors (K1 and K2 on the stride-1 sites), ``conv3d_nthwc`` for the
rest.

A qpack is ``{"convs": {conv_id: {"w", "wk", "w_scale", "f_in", "mul",
"add", "bn_scale", "bn_bias"}}, "inv_f": {site: (C,)}, "s_static": {site:
0-d}, "gates": {...}, "head": [{"kernel", "bias"}]}`` of tensors on one
device; ``w`` is the JAX layout (kt, kh, kw, Cin, Cout) int8 and ``wk`` the
same weights laid out K-major for Q1, once per qpack.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from fastvideotagging_tpu_torch._device import device_of
from fastvideotagging_tpu_torch.ops import int8_conv, scopes
from fastvideotagging_tpu_torch.ops.arch_spec import (
    ArchSpec,
    Block,
    Branches,
    Conv,
    Fuse,
    MaxPool,
    Stream,
    Subsample,
    Sum,
    conv_id,
    iter_convs,
    param,
    param_key,
    r2plus1d_spec,
    tf_same_pads,
)
from fastvideotagging_tpu_torch.ops.conv2plus1d import conv3d_nthwc, spatial_conv, temporal_conv
from fastvideotagging_tpu_torch.ops.fused_block import fold_bn


def _subsample(x, node):
    """Subsample node semantics: time stride, then optional time-to-channel
    packing (Subsample.pack, the slowfast_r2plus1d_tpu fast pathway)."""
    y = x[:, ::node.stride]
    k = getattr(node, "pack", 1)
    if k > 1:
        n, t, h, w, c = y.shape
        y = y.reshape(n, t // k, k, h, w, c)
        y = torch.movedim(y, 2, 4).reshape(n, t // k, h, w, k * c)
    return y


def _conv_pads(x, w, node: Conv):
    """Per-dim (lo, hi) pads of a spec conv: symmetric k//2 (default) or
    TF-SAME resolved from the input's shape ('same_tf', i3d stem)."""
    if node.padding == "same_tf":
        return tuple(tf_same_pads(x.shape[1 + i], w.shape[i], node.strides[i])
                     for i in range(3))
    return tuple((k // 2, k // 2) for k in w.shape[:3])


def _quant_w(w):
    """(..., Cout) weights -> (int8 weights, per-out-channel f32 scales)."""
    w = w.to(torch.float32)
    absmax = w.abs().amax(dim=tuple(range(w.ndim - 1)))
    scale = torch.clamp_min(absmax, 1e-12) / 127.0
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale


def _gate_id(node: Conv) -> str:
    return ".".join(node.gate)


def _apply_gate(y, kernel, bias):
    """S3D-G self-gate epilogue: scale y per channel by sigmoid(Dense(f32
    spatiotemporal mean of y)), the gate cast to y's dtype."""
    pooled = y.float().mean(dim=(1, 2, 3))
    g = torch.sigmoid(pooled @ kernel.float() + bias.float()).to(y.dtype)
    return y * g[:, None, None, None, :]


def _dyn_quant(x, inv_f, slot=None):
    """Smooth + dynamically quantize: x' = x * inv_f, s = amax|x'|/127 ->
    (int8 q with channels padded to a multiple of 16, f32 0-d s): Q2's two
    passes, the amax and the scale in ``slot`` (``ScaleSlots.take``)."""
    return int8_conv.quantize_s8(x, inv_f, None, None, slot)


# ---------------------------------------------------------------------------
# The bf16 reference walk: one interpreter over the ArchSpec, shared by
# calibration (record=absmax) and the reference engine (record=identity).
# ---------------------------------------------------------------------------


def _bf16_conv(x, kernel, strides, pads=None):
    """A bf16 conv on NTHWC x with a (kt, kh, kw, Cin, Cout) kernel, routed
    as the model routes it: a 1 x k x k or k x 1 x 1 factor with symmetric
    pads goes to ``spatial_conv`` / ``temporal_conv`` (K1 / K2 where they
    take it), everything else to ``conv3d_nthwc``."""
    kt, kh, kw = kernel.shape[:3]
    pads = pads or tuple((k // 2, k // 2) for k in (kt, kh, kw))
    w = kernel.to(x.dtype)
    st, sh, sw = strides
    symmetric = all(lo == hi == k // 2 for (lo, hi), k in zip(pads, (kt, kh, kw)))
    if symmetric and kt == 1 and kh == kw > 1 and st == 1 and sh == sw:
        return spatial_conv(x, w[0], sh)
    if symmetric and kh == kw == 1 and kt > 1 and sh == sw == 1:
        return temporal_conv(x, w[:, 0, 0], st)
    if symmetric:
        return conv3d_nthwc(x, w, strides, tuple(lo for lo, _ in pads))
    (tl, th), (hl, hh), (wl, wh) = pads
    return conv3d_nthwc(F.pad(x, (0, 0, wl, wh, hl, hh, tl, th)), w, strides, (0, 0, 0))


def _walk_conv(x, kernel, strides, pads):
    """The bf16 walk's conv: x and the kernel rounded to bf16, the products
    exact and the sums in f32, and the f32 result returned unrounded.

    The JAX walk runs jitted, and XLA (which allows excess precision by
    default) hands its bf16 conv's f32 result to the affine that follows
    without the round trip through bf16 that the conv's type implies. A bf16
    conv here rounds there, so the two walks' activations drifted apart from
    the stem on (1-2 % of a channel's absmax by stage 1). On the card TF32
    holds bf16 values exactly, so cuDNN's f32 conv computes the same."""
    w = kernel.to(torch.bfloat16).float()
    x = x.to(torch.bfloat16).float()
    if all(lo == hi for lo, hi in pads):
        return conv3d_nthwc(x, w, strides, tuple(lo for lo, _ in pads))
    (tl, th), (hl, hh), (wl, wh) = pads
    return conv3d_nthwc(F.pad(x, (0, 0, wl, wh, hl, hh, tl, th)), w, strides, (0, 0, 0))


def _affine(x, scale, bias, relu=False):
    """x * scale + bias in f32 as one fused multiply-add (``addcmul``), as
    XLA contracts the JAX engine's; ReLU; back to x's dtype."""
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.addcmul(torch.as_tensor(bias, **f32), x.float(), torch.as_tensor(scale, **f32))
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype)


def _bn_of(variables, path, eps: float = 1e-5):
    """The folded (scale, bias) of the BatchNorm at ``path``."""
    key = param_key(path)
    try:
        gamma, beta = variables[f"{key}.scale"], variables[f"{key}.bias"]
        mean, var = variables[f"{key}.mean"], variables[f"{key}.var"]
    except KeyError as e:
        # name-only coverage gates admit e.g. norm='group' checkpoints; the
        # engine folds BN into the requant epilogue, so only batch/frozen
        # norm variants are servable
        raise ValueError(
            f"int8 engine: no BatchNorm stats at {'/'.join(path)} — the "
            f"checkpoint was not trained with norm='batch'/'frozen' "
            f"(GroupNorm models cannot fold norm into the requant "
            f"epilogue)") from e
    return fold_bn(gamma, beta, mean, var, eps=eps)


def _maxpool(y, node):
    """Window max over (T, H, W) with -inf padding (lax.reduce_window's)."""
    padding = node.padding
    if padding in ("SAME_TF", "SAME"):
        padding = tuple(tf_same_pads(y.shape[1 + i], node.window[i], node.strides[i])
                        for i in range(3))
    elif padding == "VALID":
        padding = ((0, 0),) * 3
    (tl, th), (hl, hh), (wl, wh) = padding
    yp = F.pad(y.permute(0, 4, 1, 2, 3), (wl, wh, hl, hh, tl, th), value=float("-inf"))
    out = F.max_pool3d(yp, node.window, node.strides)
    return out.permute(0, 2, 3, 4, 1).contiguous()


def _pooled(spec, env):
    """Stream env -> pre-dense feature. Multi-stream specs gap-pool each
    head stream and concatenate; linear specs pool the implicit "x" stream
    per head_pool."""
    if spec.head_streams:
        if spec.head_pool != "gap":
            raise ValueError("multi-stream heads require gap pooling")
        return torch.cat([env[s].float().mean(dim=(1, 2, 3)) for s in spec.head_streams],
                         dim=-1)
    x = env["x"]
    if spec.head_pool == "gap":
        return x.float().mean(dim=(1, 2, 3))
    if spec.head_pool == "gap_t2":
        # S3D head: f32 spatial mean -> temporal window-2 stride-1 mean ->
        # temporal mean
        m = x.float().mean(dim=(2, 3))
        if m.shape[1] > 1:
            m = (m[:, :-1] + m[:, 1:]) * 0.5
        return m.mean(dim=1)
    return x.reshape(x.shape[0], -1)


def _head(spec, y, dense_params):
    """Shared head on the pooled feature: gap -> f32 matmul chain; flatten
    -> model-dtype MLP."""
    for i, d in enumerate(spec.head):
        last = i == len(spec.head) - 1
        kernel, bias = dense_params[i]
        if last or spec.head_pool == "gap":
            y = y.float() @ kernel.float() + bias
        else:
            y = y.to(torch.bfloat16) @ kernel.to(torch.bfloat16) + bias
        if d.relu:
            y = torch.relu(y)
    return y.float()


def _dense_params(variables, spec):
    return [(param(variables, d.param + ("kernel",)), param(variables, d.param + ("bias",)))
            for d in spec.head]


@torch.inference_mode()
def spec_walk(spec: ArchSpec, variables, x, record):
    """bf16 eval-mode forward over the spec on the port's ``state_dict``;
    ``record(site, tensor)`` sees every conv input and returns the tensor
    to feed forward. With record=lambda n, t: t this IS the bf16 reference
    engine."""
    p = variables

    def conv(y, node: Conv):
        y = record(node.site, y)
        k = param(p, node.kernel)
        z = _walk_conv(y, k, node.strides, _conv_pads(y, k, node))
        if node.bn is not None:
            z = _affine(z, *_bn_of(variables, node.bn, node.bn_eps), relu=node.relu)
        else:
            bias = (param(p, node.bias).float() if node.bias is not None else 0.0)
            z = _affine(z, 1.0, bias, relu=node.relu)
        z = z.to(torch.bfloat16)
        if node.gate is not None:
            z = _apply_gate(z, param(p, node.gate + ("kernel",)),
                            param(p, node.gate + ("bias",)))
        return z

    def chain(y, nodes):
        for node in nodes:
            if isinstance(node, Conv):
                y = conv(y, node)
            elif isinstance(node, Sum):
                a = y
                for c in node.left:
                    a = conv(a, c)
                b = y if node.right_from == "input" else a
                for c in node.right:
                    b = conv(b, c)
                y = a + b
            else:
                raise TypeError(node)
        return y

    def run(y, nodes):
        for node in nodes:
            if isinstance(node, Conv):
                y = conv(y, node)
            elif isinstance(node, MaxPool):
                y = _maxpool(y, node)
            elif isinstance(node, Branches):
                y = torch.cat([run(y, br) for br in node.branches], dim=-1)
            elif isinstance(node, Block):
                residual = y
                z = chain(y, node.main)
                if node.down is not None:
                    residual = conv(residual, node.down)
                y = torch.relu(z.float() + residual.float()).to(torch.bfloat16)
            else:
                raise TypeError(node)
        return y

    env = {"x": _as_tensor(x, variables).to(torch.bfloat16)}
    for node in spec.nodes:
        if isinstance(node, Subsample):
            env[node.dst] = _subsample(env[node.src], node)
        elif isinstance(node, Stream):
            env[node.name] = run(env[node.name], node.nodes)
        elif isinstance(node, Fuse):
            env[node.dst] = torch.cat([env[node.dst], conv(env[node.src], node.conv)], dim=-1)
        else:
            env["x"] = run(env["x"], (node,))
    return _head(spec, _pooled(spec, env), _dense_params(variables, spec))


def _as_tensor(x, tree):
    """Clips as a tensor on the device of the weights (or the qpack)."""
    x = x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))
    return x.to(device_of(tree))


def _calibrate_sites(variables, x, spec: ArchSpec):
    """One calibration pass -> {site: (C,) f32 absmax} on the device."""
    sites = {}

    def record(name, t):
        sites[name] = t.float().abs().amax(dim=tuple(range(t.ndim - 1)))
        return t

    spec_walk(spec, variables, x, record)
    return sites


def calibrate(variables, batches, stage_blocks=(2, 2, 2, 2), spec=None,
              return_margins: bool = False, margin_base: float = 2.0,
              margin_cap: float = 8.0):
    """-> {site: (C,) f64 per-channel activation absmax/127} over batches.

    ``batches``: iterable of (B, T, H, W, 3) preprocessed clips (the same
    tensors the bf16 model consumes). ``spec`` selects the architecture
    (default: r2plus1d with ``stage_blocks``). One host copy a batch: the
    sites' absmax vectors, concatenated.

    ``return_margins=True`` -> (scales, {site: static headroom multiplier}):
    margin_base * (max over batches / median over batches) of the site's
    batch absmax, clipped to [margin_base, margin_cap] (the branch-site-aware
    static calibration)."""
    spec = spec or r2plus1d_spec(tuple(stage_blocks))
    maxima: dict[str, np.ndarray] = {}
    per_batch: dict[str, list] = {}

    for x in batches:
        sites = _calibrate_sites(variables, x, spec)
        flat = torch.cat([v.double() for v in sites.values()]).cpu().numpy()
        offsets = np.cumsum([0] + [v.numel() for v in sites.values()])
        for i, k in enumerate(sites):
            v = flat[offsets[i]:offsets[i + 1]]
            maxima[k] = v if k not in maxima else np.maximum(maxima[k], v)
            per_batch.setdefault(k, []).append(float(v.max()))
    scales = {k: np.maximum(v, 1e-12) / 127.0 for k, v in maxima.items()}
    if not return_margins:
        return scales
    margins = {}
    for k, vals in per_batch.items():
        arr = np.asarray(vals, np.float64)
        spread = arr.max() / max(float(np.median(arr)), 1e-12)
        margins[k] = float(np.clip(margin_base * spread, margin_base, margin_cap))
    return scales, margins


# ---------------------------------------------------------------------------
# Quantized pack + engine
# ---------------------------------------------------------------------------


def consumer_absmax(spec: ArchSpec, variables) -> dict[str, np.ndarray]:
    """{site: (C,) f64} the largest |weight| of each input channel over the
    kernels that read the site: the W_c of the smoothing factors. It depends
    on the weights alone, so a caller that requantizes often (``Tagger``,
    per video) computes it once."""
    cols: dict[str, np.ndarray] = {}
    for _key, c in iter_convs(spec):
        k = param(variables, c.kernel)  # (..., Cin, Cout): reduced where it lives
        col = k.abs().amax(dim=tuple(i for i in range(k.ndim) if i != k.ndim - 2))
        col = col.double().cpu().numpy()
        cols[c.site] = col if c.site not in cols else np.maximum(cols[c.site], col)
    return cols


def _smooth_factors(act_absmax, w_cols):
    """{site: (C,) smoothing factors f_c = sqrt(A_c / W_c)}, median-1.

    ``w_cols``: {site: (C,)} the consumer kernels' absmax per input channel
    (``consumer_absmax``; the reference takes the kernels themselves and
    reduces them here, to the same numbers). The engine computes x' = x /
    f_c before quantization and quantize_variables folds f_c into the
    consumer kernels' input-channel dim; the square root splits the channel
    disparity evenly between the activation and the int8 weight rows."""
    out = {}
    for site, amax in act_absmax.items():
        a = np.maximum(np.asarray(amax, np.float64) * 127.0, 1e-8)
        w_col = np.maximum(np.zeros_like(a), w_cols.get(site, 0.0))
        f = np.sqrt(a / np.maximum(w_col, 1e-8))
        f = f / np.median(f)
        # clamp: a DEAD calibration channel (A_c ~ 0) would get f ~ 0 and
        # the engine would multiply that channel's numerical junk by 1/f;
        # a 10x band captures all the useful equalization
        out[site] = np.asarray(np.clip(f, 0.1, 10.0), np.float64)
    return out


def quantize_variables(variables, act_scales, stage_blocks=(2, 2, 2, 2),
                       static_margin=2.0, spec=None, w_cols=None):
    """variables (the port's state_dict) + calibration -> qpack consumed by
    ``int8_infer``, on the weights' device.

    ``static_margin``: headroom multiplier on the calibrated static scales;
    a float applies globally, a dict {site: float}
    (calibrate(return_margins=True)) per site. Irrelevant to the dynamic
    mode. ``w_cols``: ``consumer_absmax(spec, variables)`` when the caller
    already has it."""
    spec = spec or r2plus1d_spec(tuple(stage_blocks))
    p = variables
    dev = device_of(variables)
    if w_cols is None:
        w_cols = consumer_absmax(spec, variables)
    factors = _smooth_factors(act_scales, w_cols)

    def conv_pack(node: Conv):
        k = param(p, node.kernel).float()
        if node.bn is not None:
            bn_scale, bn_bias = _bn_of(variables, node.bn, node.bn_eps)
        else:
            bn_scale = torch.ones((k.shape[-1],), dtype=torch.float32, device=dev)
            bn_bias = (param(p, node.bias).float() if node.bias is not None
                       else torch.zeros((k.shape[-1],), dtype=torch.float32, device=dev))
        f_in = torch.as_tensor(factors[node.site], dtype=torch.float32, device=dev)
        qw, w_scale = _quant_w(k * f_in[:, None])
        # the unfolded bf16 kernel for float blocks is recovered as
        # w * w_scale / f_in (deq_w in the engine)
        return {"w": qw, "wk": int8_conv.weight_layout(qw), "w_scale": w_scale, "f_in": f_in,
                "mul": w_scale * bn_scale, "add": bn_bias,
                "bn_scale": bn_scale, "bn_bias": bn_bias}

    def _margin(site):
        if isinstance(static_margin, dict):
            return float(static_margin[site])
        return float(static_margin)

    # static per-site scalar scales: x' = x / f_c has calibrated absmax
    # A_c / f_c; one scalar covers it
    s_static = {site: torch.tensor(np.float32(
        float(np.max(np.asarray(act_scales[site], np.float64) * 127.0 / factors[site]) / 127.0)
        * _margin(site)), device=dev) for site in factors}
    return {
        "inv_f": {k: torch.as_tensor(1.0 / v, dtype=torch.float32, device=dev)
                  for k, v in factors.items()},
        "s_static": s_static,
        "convs": {conv_id(c): conv_pack(c) for _k, c in iter_convs(spec)},
        # S3D-G self-gate Dense params (f32 epilogue; tiny, never quantized)
        "gates": {_gate_id(c): {
            "kernel": param(p, c.gate + ("kernel",)).float(),
            "bias": param(p, c.gate + ("bias",)).float()}
            for _k, c in iter_convs(spec) if c.gate is not None},
        "head": [{"kernel": k.float(), "bias": b.float()}
                 for k, b in _dense_params(variables, spec)],
    }


# The late blocks sit behind heavy main-path/residual cancellation, which
# amplifies any upstream quantization noise: kept bf16 by default.
DEFAULT_FLOAT_BLOCKS = ("stage4_block0", "stage4_block1")


class _Quantized(NamedTuple):
    """An activation that a fused epilogue wrote quantized for ``site``
    (with its scale ``s``), and in bf16 (``y``) where a consumer also reads
    it so, else None."""
    site: str
    q: torch.Tensor
    s: torch.Tensor
    y: torch.Tensor | None


class _Reduced(NamedTuple):
    """A bf16 activation ``y`` whose dynamic amax for ``site`` a fused
    epilogue reduced into ``slot``'s amax (dynamic mode)."""
    site: str
    y: torch.Tensor
    slot: tuple


@torch.inference_mode()
def int8_infer(qpack, x, spec: ArchSpec, float_blocks=None,
               dynamic: bool = False, residual: str = "dequant",
               debug_sites: bool = False):
    """Quantized forward over any ArchSpec. x: (B, T, H, W, 3) preprocessed
    f32/bf16 clips -> (B, K) f32 logits; with debug_sites=True -> (logits,
    {site: f32 reconstructed conv input}) for PTQ error attribution.

    ``float_blocks``: blocks run in bf16 with exactly dequantized int8
    weights; None -> the spec's default tail. ``dynamic``: per-tensor
    activation scales from each batch's amax (Q2's amax pass) instead of
    the calibrated static ones. ``residual``: 'dequant' (default)
    reconstructs the block input from its quantized form; 'exact' adds the
    unquantized input in f32.

    A conv whose output the next site alone reads (the next conv of its
    chain, or the next int8 block's ``in`` site) works for that site in its
    epilogue: in the static mode it quantizes the output (Q1's form (b)); in
    the dynamic mode, whose scale needs the whole tensor first, it reduces
    the site's amax, and Q2 runs its quantize pass alone. An int8 block's
    last conv adds the residual and applies the ReLU (form (c)), then
    quantizes for the next site or stores bf16 (and reduces the amax). The
    results are those of the separate steps, bit for bit. Q2's amax pass
    runs where no Q1 call alone produced a site's input: the network's
    input, after a pool, at a value several sites read. A dynamic forward
    takes its sites' amax and scale words from one ``ScaleSlots``."""
    if float_blocks is None:
        float_blocks = spec.default_float_blocks
    inv_f = qpack["inv_f"]
    sites = {}
    x = _as_tensor(x, qpack["inv_f"])
    slots = int8_conv.ScaleSlots(len(qpack["convs"]), x.device) if dynamic else None

    def record(site, q, s, c):
        if debug_sites:
            sites[site] = q[..., :c].float() * s / inv_f[site]

    def quant_site(y, site, reduced=None):
        """Q2 at ``site``; ``reduced``: the slot whose amax an epilogue
        reduced (the quantize pass alone)."""
        with scopes.site("quant", site):
            if reduced is not None:
                q, s = int8_conv.quantize_s8(y, inv_f[site], None, reduced[0], reduced)
            elif dynamic:
                q, s = _dyn_quant(y, inv_f[site], slots.take())
            else:
                q, s = int8_conv.quantize_s8(y, inv_f[site], qpack["s_static"][site])
        record(site, q, s, y.shape[-1])
        return q, s

    def take(v, site):
        """(q, s) of activation ``v`` at ``site``: the fused epilogue's where
        it wrote them for this site, Q2's quantize pass where it reduced the
        site's amax, else Q2 on the bf16 activation."""
        if isinstance(v, _Quantized) and v.site == site:
            return v.q, v.s
        if isinstance(v, _Reduced) and v.site == site:
            return quant_site(v.y, site, v.slot)
        return quant_site(bf16_of(v), site)

    def bf16_of(v):
        return v.y if isinstance(v, (_Quantized, _Reduced)) else v

    def sole_site(nxt):
        """(site, keep_bf16): the site that alone quantizes a value whose
        consumer is ``nxt`` (the next conv's, or the next int8 block's ``in``
        site, whose residual reads it back from the int8 q; with 'exact' it
        reads the bf16 too), or None where the value is needed otherwise."""
        if isinstance(nxt, Conv):
            return nxt.site, False
        if (isinstance(nxt, Block) and nxt.key not in float_blocks
                and isinstance(nxt.main[0], Conv)):
            return nxt.main[0].site, residual == "exact"
        return None

    def conv_q(q, s_dyn, node: Conv, out_f32=False, tail=None, to=None):
        """Q1 at ``node``: its output in bf16 (f32 with ``out_f32``); with
        ``tail``, a Residual, the block's tail and ReLU (form (c)); with
        ``to`` = (site, keep_bf16), a _Quantized for that site (forms (b),
        (c)), or in the dynamic mode a _Reduced (the bf16 output and the
        site's amax)."""
        with scopes.site("fwd", conv_id(node)):
            return _conv_q(q, s_dyn, node, out_f32, tail, to)

    def _conv_q(q, s_dyn, node, out_f32, tail, to):
        pack = qpack["convs"][conv_id(node)]
        w = pack["w"]
        gated = node.gate is not None
        args = (q, pack["wk"], w.shape[:3], pack["mul"], pack["add"], s_dyn, node.strides,
                _conv_pads(q, w, node))
        relu = node.relu if tail is None else True
        if to is not None and dynamic:
            slot = slots.take()
            y, _ = int8_conv.conv3d_s8(*args, relu=relu, residual=tail,
                                       amax=int8_conv.Amax(inv_f[to[0]], slot[0]))
            return _Reduced(to[0], y, slot)
        requant = None if to is None else int8_conv.Requant(
            inv_f[to[0]], qpack["s_static"][to[0]], to[1])
        out = int8_conv.conv3d_s8(*args, relu=relu, out_f32=out_f32 or gated, residual=tail,
                                  requant=requant)
        if to is not None:
            qn, sn, yb = out
            record(to[0], qn, sn, w.shape[-1])
            return _Quantized(to[0], qn, sn, yb)
        if gated:
            g = qpack["gates"][_gate_id(node)]
            out = _apply_gate(out, g["kernel"], g["bias"])
            if not out_f32:
                out = out.to(torch.bfloat16)
        return out

    def deq_w(pack):
        # undo the per-output-channel weight scale AND the folded-in
        # smoothing factors
        return (pack["w"].float() * pack["w_scale"] / pack["f_in"][:, None]).to(torch.bfloat16)

    def conv_f(xf, node: Conv):
        """bf16 conv with exactly dequantized int8 weights + affine."""
        pack = qpack["convs"][conv_id(node)]
        with scopes.site("fwd", conv_id(node)):
            w = deq_w(pack)
            acc = _bf16_conv(xf.to(torch.bfloat16), w, node.strides,
                             pads=_conv_pads(xf, w, node))
            y = _affine(acc, pack["bn_scale"], pack["bn_bias"], relu=node.relu)
            if node.gate is not None:
                g = qpack["gates"][_gate_id(node)]
                y = _apply_gate(y, g["kernel"], g["bias"])
        return y

    def chain_q(v, nodes, q_first=None, tail=None):
        """int8 chain; q_first short-circuits an already-quantized input
        for the first conv. The LAST conv of a block main chain (relu
        False) returns f32 for the residual add, or with ``tail`` =
        (Residual, to) runs the block's tail in its epilogue (form (c)); a
        conv followed by a conv quantizes for it (form (b), static mode) or
        reduces its amax (dynamic mode)."""
        for i, node in enumerate(nodes):
            last = i == len(nodes) - 1
            if isinstance(node, Conv):
                if q_first is not None and i == 0:
                    q, s_dyn = q_first
                else:
                    q, s_dyn = take(v, node.site)
                if last and tail is not None:
                    v = conv_q(q, s_dyn, node, tail=tail[0], to=tail[1])
                elif not last and node.gate is None and isinstance(nodes[i + 1], Conv):
                    v = conv_q(q, s_dyn, node, to=(nodes[i + 1].site, False))
                else:
                    v = conv_q(q, s_dyn, node, out_f32=(last and not node.relu))
            elif isinstance(node, Sum):
                a = chain_q(v, node.left)
                src = v if node.right_from == "input" else a
                b = chain_q(src, node.right)
                # the sum of the two bf16 branches in f32, handed to the next
                # quantize unrounded: XLA's excess precision in the jitted
                # JAX engine (rounded to bf16 first, 1 % of P3D's exp-site
                # values came out one quantum apart)
                v = bf16_of(a).float() + bf16_of(b).float()
            else:
                raise TypeError(node)
        return v

    def chain_f(y, nodes):
        for node in nodes:
            if isinstance(node, Conv):
                y = conv_f(y, node)
            elif isinstance(node, Sum):
                a = chain_f(y, node.left)
                b = chain_f(y if node.right_from == "input" else a, node.right)
                y = a + b
            else:
                raise TypeError(node)
        return y

    def block_q(v, node: Block, nxt):
        """An int8 block on activation ``v``; ``nxt`` its consumer."""
        in_site = node.main[0].site
        q_in, s_in = take(v, in_site)
        y = bf16_of(v)  # the bf16 block input: None where only its q is kept
        if node.down is not None:
            res = int8_conv.Residual("f32", conv_q(q_in, s_in, node.down, out_f32=True))
        elif residual == "dequant":
            # the residual from the quantized input: the block input is not
            # read again in bf16; its multiply and the add are one FMA
            res = int8_conv.Residual("dequant", q_in, inv_f[in_site], s_in)
        else:
            res = int8_conv.Residual("f32" if y.dtype == torch.float32 else "bf16", y)
        last = node.main[-1]
        if isinstance(last, Conv) and not last.relu and last.gate is None:
            return chain_q(v, node.main, q_first=(q_in, s_in), tail=(res, sole_site(nxt)))
        zf = chain_q(v, node.main, q_first=(q_in, s_in))
        return int8_conv.residual_tail(zf, res)

    def run(v, nodes):
        for i, node in enumerate(nodes):
            nxt = nodes[i + 1] if i + 1 < len(nodes) else None
            if isinstance(node, Conv):
                q, s_dyn = take(v, node.site)
                to = sole_site(nxt) if node.gate is None else None
                v = conv_q(q, s_dyn, node, to=to)
            elif isinstance(node, MaxPool):
                v = _maxpool(bf16_of(v).to(torch.bfloat16), node)
            elif isinstance(node, Branches):
                y = bf16_of(v)
                v = torch.cat([run(y, br).to(torch.bfloat16) for br in node.branches], dim=-1)
            elif isinstance(node, Block):
                if node.key not in float_blocks:
                    v = block_q(v, node, nxt)
                else:
                    y = bf16_of(v)
                    zf = chain_f(y, node.main).float()
                    z = zf + (conv_f(y, node.down) if node.down is not None else y).float()
                    v = torch.relu(z).to(torch.bfloat16)
            else:
                raise TypeError(node)
        return v

    env = {"x": x}
    nodes = spec.nodes
    i = 0
    while i < len(nodes):
        node = nodes[i]
        if isinstance(node, Subsample):
            env[node.dst] = _subsample(env[node.src], node)
        elif isinstance(node, Stream):
            env[node.name] = run(env[node.name], node.nodes)
        elif isinstance(node, Fuse):
            q, s_dyn = quant_site(env[node.src], node.conv.site)
            lat = conv_q(q, s_dyn, node.conv)
            env[node.dst] = torch.cat([env[node.dst].to(torch.bfloat16), lat], dim=-1)
        else:  # a run of the main stream's nodes, each seeing its consumer
            j = i
            while j < len(nodes) and not isinstance(nodes[j], (Subsample, Stream, Fuse)):
                j += 1
            env["x"] = run(env["x"], nodes[i:j])
            i = j
            continue
        i += 1

    logits = _head(spec, _pooled(spec, env), [(h["kernel"], h["bias"]) for h in qpack["head"]])
    return (logits, sites) if debug_sites else logits


def r2plus1d_int8_infer(qpack, x, stage_blocks=(2, 2, 2, 2), float_blocks=None,
                        dynamic: bool = False, residual: str = "dequant",
                        debug_sites: bool = False):
    """The r2plus1d walk via the spec; float_blocks=None uses the spec's
    measured bf16 tail."""
    spec = r2plus1d_spec(tuple(stage_blocks))
    fb = spec.default_float_blocks if float_blocks is None else tuple(float_blocks)
    return int8_infer(qpack, x, spec, float_blocks=fb, dynamic=dynamic,
                      residual=residual, debug_sites=debug_sites)


def reference_bf16_infer(variables, x, stage_blocks=(2, 2, 2, 2), spec=None):
    """The same layer walk in bf16 (calibration graph, record=identity)."""
    spec = spec or r2plus1d_spec(tuple(stage_blocks))
    return spec_walk(spec, variables, x, lambda n, t: t)
