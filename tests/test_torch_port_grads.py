"""Gradients of the port's (2+1)D conv ops against the JAX package's.

The port's ``spatial_conv`` / ``temporal_conv`` go through their
``torch.autograd.Function``s on the CPU as on the card (plain versions of
the kernels on CPU tensors), so the flipped, channel-transposed weights of
the dx route and both weight gradients are exercised here. The JAX side is
``jax.grad`` of ``ops.conv2plus1d.spatial_conv`` / ``temporal_conv`` with its
Pallas kernels in interpret mode (forward, dx and the temporal dw), as
tests/test_ops_pallas.py runs them. Inputs and the cotangent come from a
numpy seed; f32; tolerance 1e-3 (tests/test_ops_pallas.py:65-68, :111-114).
``temporal_dw_plain`` is also held to the Pallas ``_temporal_dw`` directly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvideotagging_tpu.ops import conv2plus1d as jops
from fastvideotagging_tpu_torch.ops import conv2plus1d as tops

TOL = 1e-3


def _inputs(x_shape, w_shape, co, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=x_shape).astype(np.float32)
    w = (rng.normal(size=w_shape) / np.sqrt(np.prod(w_shape[:-1]))).astype(np.float32)
    return x, w, rng


def _both_grads(jfn, tfn, x, w, stride, rng):
    """(dx, dw) of sum(conv(x, w) * gy) from the JAX package and the port."""
    y_shape = jax.eval_shape(lambda a, b: jfn(a, b, stride=stride), x, w).shape
    gy = rng.normal(size=y_shape).astype(np.float32)
    jdx, jdw = jax.grad(lambda a, b: (jfn(a, b, stride=stride) * gy).sum(),
                        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    y = tfn(xt, wt, stride=stride)
    assert tuple(y.shape) == tuple(y_shape)
    y.backward(torch.from_numpy(gy))
    return (np.asarray(jdx), np.asarray(jdw)), (xt.grad.numpy(), wt.grad.numpy())


@pytest.mark.parametrize("shape,co,k,stride", [
    ((1, 2, 8, 8, 32), 32, 3, 1),     # the shape of tests/test_ops_pallas.py
    ((1, 2, 8, 8, 45), 40, 3, 1),     # ragged C = 45
    ((2, 1, 6, 7, 33), 24, 5, 1),     # ragged C = 33, k = 5
    ((1, 2, 9, 8, 64), 40, 3, 2),     # stride 2: the library conv's own autograd
    ((1, 2, 8, 8, 3), 16, 7, 2),      # C < 32 (the stem): the library conv
    ((1, 2, 8, 8, 16), 8, 3, 1),      # C < 32 at stride 1: the library conv
])
def test_spatial_conv_grads_match_jax(shape, co, k, stride):
    x, w, rng = _inputs(shape, (k, k, shape[-1], co), co)
    before = dict(tops.launch_counts)
    (jdx, jdw), (tdx, tdw) = _both_grads(jops.spatial_conv, tops.spatial_conv,
                                         x, w, stride, rng)
    np.testing.assert_allclose(tdx, jdx, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tdw, jdw, rtol=TOL, atol=TOL)
    assert tops.launch_counts == before  # CPU tensors launch nothing


@pytest.mark.parametrize("shape,co,k,stride", [
    ((2, 4, 4, 4, 32), 32, 3, 1),     # the shape of tests/test_ops_pallas.py
    ((1, 4, 3, 5, 45), 64, 3, 1),     # the stem's temporal conv: C = 45
    ((1, 5, 4, 4, 33), 24, 5, 1),     # ragged C = 33, k = 5
    ((2, 2, 3, 3, 48), 40, 3, 1),     # T = 2: each outer tap has one row pair
    ((1, 8, 4, 4, 64), 32, 3, 2),     # stride 2: the library conv's own autograd
    ((1, 4, 4, 4, 16), 8, 3, 1),      # C < 32: the library conv
    ((1, 1, 4, 4, 64), 32, 3, 1),     # T = 1: the library conv
])
def test_temporal_conv_grads_match_jax(shape, co, k, stride):
    x, w, rng = _inputs(shape, (k, shape[-1], co), co, seed=1)
    (jdx, jdw), (tdx, tdw) = _both_grads(jops.temporal_conv, tops.temporal_conv,
                                         x, w, stride, rng)
    np.testing.assert_allclose(tdx, jdx, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tdw, jdw, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("shape,co,k", [
    ((2, 4, 6, 45), 19, 3), ((1, 5, 8, 33), 24, 5), ((3, 2, 1, 40), 8, 3),
    ((1, 3, 4, 32), 16, 5),           # T = 3 < k: the outermost taps pair one row
])
def test_temporal_dw_plain_matches_pallas_dw(shape, co, k):
    rng = np.random.default_rng(2)
    x = rng.normal(size=shape).astype(np.float32)
    g = rng.normal(size=shape[:3] + (co,)).astype(np.float32)
    ref = np.asarray(jops._temporal_dw(jnp.asarray(x), jnp.asarray(g), k))
    got = tops.temporal_dw_plain(torch.from_numpy(x), torch.from_numpy(g), k)
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape == (k, shape[-1], co)
    np.testing.assert_allclose(got.numpy(), ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("shape,co,k", [((3, 7, 9, 45), 21, 3), ((2, 5, 5, 36), 8, 5)])
def test_spatial_dw_matches_jax_spatial_dw(shape, co, k):
    rng = np.random.default_rng(3)
    x = rng.normal(size=shape).astype(np.float32)
    g = rng.normal(size=shape[:3] + (co,)).astype(np.float32)
    ref = np.asarray(jops._spatial_dw(jnp.asarray(x), jnp.asarray(g), k))
    got = tops.spatial_dw(torch.from_numpy(x), torch.from_numpy(g), k)
    assert tuple(got.shape) == ref.shape == (k, k, shape[-1], co)
    np.testing.assert_allclose(got.numpy(), ref, rtol=TOL, atol=TOL)


def test_backward_takes_noncontiguous_grads_and_honours_needs_input_grad():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(1, 3, 4, 5, 32)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(3, 32, 16)).astype(np.float32) / 10)
    gy = torch.from_numpy(rng.normal(size=(1, 3, 5, 4, 16)).astype(np.float32))
    xr, wr = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    tops.temporal_conv(xr, wr).backward(gy.transpose(2, 3))  # a strided cotangent
    xc, wc = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    tops.temporal_conv(xc, wc).backward(gy.transpose(2, 3).contiguous())
    assert torch.equal(xr.grad, xc.grad) and torch.equal(wr.grad, wc.grad)
    # only w needs a gradient: the input's stays None
    wo = w.clone().requires_grad_(True)
    tops.temporal_conv(x, wo).sum().backward()
    assert x.grad is None and wo.grad is not None
    # only x needs one
    xo = x.clone().requires_grad_(True)
    tops.spatial_conv(xo, torch.from_numpy(
        rng.normal(size=(3, 3, 32, 8)).astype(np.float32))).sum().backward()
    assert xo.grad is not None and torch.isfinite(xo.grad).all()


def test_dw_kernel_wrapper_rejects_cpu_tensors_and_split_covers_the_rows():
    x = torch.zeros((1, 4, 4, 32), dtype=torch.bfloat16)
    before = dict(tops.launch_counts)
    with pytest.raises(ValueError, match="CUDA"):
        tops.temporal_dw_cuda(x, torch.zeros((1, 4, 4, 8), dtype=torch.bfloat16), 3)
    assert tops.launch_counts == before
    # the split K3 is launched with: chunks of whole slabs (tile_s rows of
    # the (b, s) pairs at one t) that cover every slab, the last chunk not
    # empty
    for shape, co, k in [((8, 16, 3136, 45), 64, 3), ((32, 16, 3136, 144), 64, 3),
                         ((8, 2, 49, 1152), 512, 3), ((3, 2, 1, 33), 8, 3),
                         ((1, 7, 300, 64), 64, 5), ((1, 5, 51, 40), 24, 3),
                         ((1, 5, 52, 40), 24, 3)]:
        plan = tops.temporal_dw_plan(shape, co, k)
        b, t, s, _ = shape
        assert plan.steps == -(-b * s // plan.tile_s) * t and plan.chunks >= 1
        assert plan.chunks * plan.steps_per_chunk >= plan.steps
        assert plan.steps > (plan.chunks - 1) * plan.steps_per_chunk
