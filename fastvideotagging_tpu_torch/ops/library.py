"""The port's serving kernels as ``torch.library`` ops (``fvt::*``).

The wrappers of ops/conv2plus1d.py and ops/int8_conv.py launch their
kernels through ``ctypes`` on ``data_ptr()``s, which a tracer cannot see
through: a FakeTensor has no data. Here each of them becomes an op of its
own with a fixed schema and a fake implementation that computes only its
outputs' shapes and dtypes, so that ``torch.export`` records the op in the
graph and the exported program calls it when it runs. The port's eager
paths go through the same ops (``spatial_conv`` / ``temporal_conv`` inside
K1's and K2's ``autograd.Function``s, ``conv3d_s8`` and ``quantize_s8`` of
ops/int8_conv.py): one route.

Each op is defined from its schema string in ``csrc/fvt_schemas.inc``,
the one source of the nine schemas, which csrc/fvt_ops.cpp also registers
in C++ for the native runner (evaluation/serving.py's AOTInductor
package), with one kernel for every device (``CompositeExplicitAutograd``):
the wrapper's route (``conv2plus1d._route``), where a CUDA tensor launches
the kernel or raises and a CPU tensor takes the plain version. Each wrapper
adds to its launch count where it launches its kernel, so the counts are of
executions, not traces. The kernels and plain versions are looked up in
their modules at each call. ``torch.library.custom_op`` would define the
same ops, but its Python layer cost several times the host time a call on
an H100's host (PERF.md, the serving export's dispatcher figures), which
the eager int8 forward pays 29 times.

The ops (importing this module registers them; the package
``fastvideotagging_tpu_torch.ops`` does, so does ``load_serving`` of
evaluation/serving.py, and nothing else of the model is needed):

- ``fvt::spatial_conv(x, w)``: K1's forward, x (N, H, W, C), w (k, k, C, Co).
- ``fvt::temporal_conv(x, w)``: K2's forward, x (B, T, S, C), w (k, C, Co).
- Q1 (``int8_conv.conv3d_s8``), one op for each output arity. Each takes
  the conv (q, wk, kernel_size, mul, add, s, strides, pads (T lo, T hi, H
  lo, ...), relu) and the block tail's residual (``res_kind`` '' for none,
  'dequant', 'f32' or 'bf16'; ``res``, ``res_inv_f``, ``res_s``):
  ``fvt::conv3d_s8`` -> y, bf16 or f32 (forms (a), (c));
  ``fvt::conv3d_s8_requant`` -> the next site's int8 (forms (b), (c));
  ``fvt::conv3d_s8_requant_bf16`` -> (int8, bf16 y);
  ``fvt::conv3d_s8_amax`` -> bf16 y, the next site's dynamic amax reduced
  into ``amax`` (mutated).
- Q2 (``int8_conv.quantize_s8``) -> int8: ``fvt::quantize_s8`` (static
  scale ``s``), ``fvt::quantize_s8_dynamic`` (the amax pass into ``amax``,
  then the quantize pass, its scale into ``scale``; both mutated) and
  ``fvt::quantize_s8_given`` (the quantize pass from an amax reduced
  already, its scale into ``scale``).

No op returns an input or a view of one: the scale that the Python
wrappers return beside an int8 output is the caller's own tensor.
"""

import os
import re

import torch

from fastvideotagging_tpu_torch.ops import _build
from fastvideotagging_tpu_torch.ops import conv2plus1d as k12
from fastvideotagging_tpu_torch.ops import int8_conv as q8

SCHEMA_FILE = os.path.join(_build.CSRC, "fvt_schemas.inc")


def read_schemas() -> dict[str, str]:
    """The ``FVT_SCHEMA("...")`` lines of ``SCHEMA_FILE``: {op name:
    schema}, in the file's order."""
    with open(SCHEMA_FILE) as f:
        schemas = re.findall(r'^FVT_SCHEMA\("([^"]+)"\)$', f.read(), re.M)
    return {s.split("(")[0]: s for s in schemas}


SCHEMAS = read_schemas()
_LIB = torch.library.Library("fvt", "DEF")  # the ops live as long as the process


def _op(name: str, fake):
    """Define ``fvt::<name>`` from its schema in ``SCHEMAS`` with the
    decorated function as its kernel on every device and ``fake`` as its
    fake implementation; -> the op."""
    schema = SCHEMAS[name]

    def register(kernel):
        _LIB.define(schema)
        _LIB.impl(name, kernel, "CompositeExplicitAutograd")
        torch.library.register_fake(f"fvt::{name}", fake, lib=_LIB)
        return getattr(torch.ops.fvt, name).default
    return register


def _conv_fake(x, w):
    return x.new_empty((*x.shape[:-1], w.shape[-1]))


@_op("spatial_conv", _conv_fake)
def spatial_conv(x, w):
    return k12._route(k12.spatial_conv_cuda, k12.spatial_conv_plain, x, w)


@_op("temporal_conv", _conv_fake)
def temporal_conv(x, w):
    return k12._route(k12.temporal_conv_cuda, k12.temporal_conv_plain, x, w)


def _pairs(pads):
    return tuple(zip(pads[0::2], pads[1::2]))


def _q1(q, wk, kernel_size, mul, add, s, strides, pads, relu, out_f32, res_kind, res,
        res_inv_f, res_s, requant=None, amax=None):
    """Q1's route on the ops' flat arguments, in the wrappers' form."""
    residual = q8.Residual(res_kind, res, res_inv_f, res_s) if res_kind else None
    return k12._route(q8.conv3d_s8_cuda, q8.conv3d_s8_plain, q, wk, tuple(kernel_size), mul,
                      add, s, tuple(strides), _pairs(pads), relu, out_f32, residual, requant,
                      amax)


def _q1_shape(q, wk, kernel_size, strides, pads):
    return q8._out_shape(q, kernel_size, strides, _pairs(pads), wk.shape[0])


def _q1_fake(q, wk, kernel_size, mul, add, s, strides, pads, relu, out_f32, *res):
    return q.new_empty(_q1_shape(q, wk, kernel_size, strides, pads),
                       dtype=torch.float32 if out_f32 else torch.bfloat16)


@_op("conv3d_s8", _q1_fake)
def conv3d_s8(q, wk, kernel_size, mul, add, s, strides, pads, relu, out_f32, res_kind, res,
              res_inv_f, res_s):
    return _q1(q, wk, kernel_size, mul, add, s, strides, pads, relu, out_f32, res_kind, res,
               res_inv_f, res_s)


def _requant_fake(q, wk, kernel_size, mul, add, s, strides, pads, *rest):
    shape = _q1_shape(q, wk, kernel_size, strides, pads)
    return q.new_empty((*shape[:-1], q8.padded_channels(shape[-1])))


@_op("conv3d_s8_requant", _requant_fake)
def conv3d_s8_requant(q, wk, kernel_size, mul, add, s, strides, pads, relu, res_kind, res,
                      res_inv_f, res_s, q_inv_f, q_s):
    return _q1(q, wk, kernel_size, mul, add, s, strides, pads, relu, False, res_kind, res,
               res_inv_f, res_s, requant=q8.Requant(q_inv_f, q_s))[0]


def _requant_bf16_fake(q, wk, kernel_size, mul, add, s, strides, pads, *rest):
    return (_requant_fake(q, wk, kernel_size, mul, add, s, strides, pads),
            _q1_fake(q, wk, kernel_size, mul, add, s, strides, pads, False, False))


@_op("conv3d_s8_requant_bf16", _requant_bf16_fake)
def conv3d_s8_requant_bf16(q, wk, kernel_size, mul, add, s, strides, pads, relu, res_kind, res,
                           res_inv_f, res_s, q_inv_f, q_s):
    qn, _, y = _q1(q, wk, kernel_size, mul, add, s, strides, pads, relu, False, res_kind, res,
                   res_inv_f, res_s, requant=q8.Requant(q_inv_f, q_s, keep_bf16=True))
    return qn, y


def _amax_fake(q, wk, kernel_size, mul, add, s, strides, pads, *rest):
    return _q1_fake(q, wk, kernel_size, mul, add, s, strides, pads, False, False)


@_op("conv3d_s8_amax", _amax_fake)
def conv3d_s8_amax(q, wk, kernel_size, mul, add, s, strides, pads, relu, res_kind, res,
                   res_inv_f, res_s, amax_inv_f, amax):
    return _q1(q, wk, kernel_size, mul, add, s, strides, pads, relu, False, res_kind, res,
               res_inv_f, res_s, amax=q8.Amax(amax_inv_f, amax))[0]


def _q2(y, inv_f, s=None, amax=None, slot=None):
    return k12._route(q8.quantize_s8_cuda, q8.quantize_s8_plain, y, inv_f, s, amax, slot)[0]


def _q2_fake(y, *rest):
    return y.new_empty((*y.shape[:-1], q8.padded_channels(y.shape[-1])), dtype=torch.int8)


@_op("quantize_s8", _q2_fake)
def quantize_s8(y, inv_f, s):
    return _q2(y, inv_f, s)


@_op("quantize_s8_dynamic", _q2_fake)
def quantize_s8_dynamic(y, inv_f, amax, scale):
    return _q2(y, inv_f, slot=(amax, scale))


@_op("quantize_s8_given", _q2_fake)
def quantize_s8_given(y, inv_f, amax, scale):
    return _q2(y, inv_f, amax=amax, slot=(amax, scale))


OPS = (spatial_conv, temporal_conv, conv3d_s8, conv3d_s8_requant, conv3d_s8_requant_bf16,
       conv3d_s8_amax, quantize_s8, quantize_s8_dynamic, quantize_s8_given)
