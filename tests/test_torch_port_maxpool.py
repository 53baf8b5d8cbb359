"""The port's max pool (ops/maxpool_grad.py) against the JAX package's
``max_pool_nthwc``: values and gradients of every lowering ('sas', 'sep',
'mask', 'sepmask') at the window / stride / padding kinds the zoo uses
('VALID', TF-'SAME', explicit pads), on tie-free inputs and on inputs with
ties built on purpose (small integers: every window holds several equal
maxima). Values equal exactly; gradients within 1e-6 (f32: the mask
modes divide by the tie count, the others route the whole cotangent).
'sas' and 'sep' send a window's cotangent to its first maximal element in
(t, h, w) order on both sides, so ties agree too."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from fastvideotagging_tpu.ops import maxpool_grad as jmp
from fastvideotagging_tpu_torch.ops import maxpool_grad as tmp
from test_torch_port_zoo_p3d import one_thread  # noqa: F401

CASES = [
    ((3, 3, 3), (1, 1, 1), ((1, 1), (1, 1), (1, 1))),  # S3D's branch pool
    ((2, 2, 2), (2, 2, 2), "VALID"),  # C3D pool2-4, S3D pool4
    ((1, 3, 3), (1, 2, 2), "SAME"),  # I3D's stem pools
    ((2, 3, 3), (2, 2, 2), ((0, 0), (1, 1), (1, 1))),  # P3D's stem pool
    ((3, 3, 3), (2, 2, 2), "SAME"),  # I3D's pool3 on odd sizes
    ((2, 2, 2), (2, 2, 2), ((0, 0), (1, 1), (1, 1))),  # C3D pool5
]
MODES = ("sas", "sep", "mask", "sepmask")


def _inputs(ties: bool):
    rng = np.random.default_rng(7)
    shape = (2, 5, 7, 6, 3)
    if ties:
        return rng.integers(0, 3, size=shape).astype(np.float32)
    return rng.permutation(np.prod(shape)).reshape(shape).astype(np.float32) / 100.0


@pytest.mark.parametrize("ties", [False, True], ids=["tie_free", "ties"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", range(len(CASES)))
def test_values_and_grads_match_jax(case, mode, ties):
    window, strides, padding = CASES[case]
    x = _inputs(ties)

    def jfn(a):
        return jmp.max_pool_nthwc(a, window, strides, padding, grad=mode)

    y = jax.jit(jfn)(x)
    ct = np.random.default_rng(8).normal(size=y.shape).astype(np.float32)
    jg = jax.jit(lambda a, c: jax.vjp(jfn, a)[1](c)[0])(x, ct)
    xt = torch.from_numpy(x).requires_grad_(True)
    yt = tmp.max_pool_nthwc(xt, window, strides, padding, grad=mode)
    assert yt.shape == y.shape
    np.testing.assert_array_equal(yt.detach().numpy(), np.asarray(y))
    yt.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg), rtol=0, atol=1e-6)
    # the cotangent's mass is conserved: every window sends it somewhere
    assert xt.grad.sum().item() == pytest.approx(float(ct.sum()), abs=1e-3)


def test_mask_mode_splits_ties_evenly():
    x = torch.zeros((1, 2, 2, 2, 1), requires_grad=True)
    tmp.max_pool_nthwc(x, (2, 2, 2), (2, 2, 2), grad="mask").sum().backward()
    assert torch.equal(x.grad, torch.full_like(x, 1 / 8))
    x.grad = None
    tmp.max_pool_nthwc(x, (2, 2, 2), (2, 2, 2), grad="sas").sum().backward()
    assert x.grad.flatten().tolist() == [1.0] + [0.0] * 7  # the first tied element


def test_bf16_values_equal_every_mode():
    x = torch.from_numpy(_inputs(False)).to(torch.bfloat16)
    ref = tmp.max_pool_nthwc(x, (3, 3, 3), (2, 2, 2), "SAME", grad="sas")
    for mode in MODES:
        assert torch.equal(tmp.max_pool_nthwc(x, (3, 3, 3), (2, 2, 2), "SAME", grad=mode), ref)
    assert ref.dtype == torch.bfloat16 and ref.is_contiguous()


def test_resolve_pads_and_sep_dims_match_jax():
    for shape in ((4, 7, 8), (5, 6, 6)):
        for window, strides, padding in CASES:
            assert tmp.resolve_pads(shape, window, strides, padding) == jmp.resolve_pads(
                shape, window, strides, padding)
            pads = tmp.resolve_pads(shape, window, strides, padding)
            assert tmp._sep_dims(window, strides, pads) == jmp._sep_dims(window, strides, pads)
    with pytest.raises(ValueError, match="unknown padding"):
        tmp.resolve_pads((4, 4, 4), (2, 2, 2), (2, 2, 2), "FULL")
    with pytest.raises(ValueError, match="unknown maxpool grad mode"):
        tmp.max_pool_nthwc(torch.zeros(1, 2, 2, 2, 1), (2, 2, 2), grad="scan")


_DEFAULTS = ("import json; from fastvideotagging_tpu_torch.ops import maxpool_grad as m; "
             "print(json.dumps([m.DEFAULT_GRAD, m.EVAL_DEFAULT]))")


def test_phase_dependent_default_and_environment_overrides(monkeypatch):
    """'sep' in train mode and 'sas' in eval by default; FVT_MAXPOOL_GRAD and
    FVT_MAXPOOL_EVAL, the JAX package's names, override them at import."""
    calls = []
    real = tmp._reduce_max
    monkeypatch.setattr(tmp, "_reduce_max", lambda x, w, s, p: calls.append(w) or real(x, w, s, p))
    x = torch.zeros((1, 4, 4, 4, 2))
    tmp.max_pool_nthwc(x, (1, 3, 3), (1, 2, 2), "SAME", train=False)
    assert calls == [(1, 3, 3)]
    calls.clear()
    tmp.max_pool_nthwc(x, (1, 3, 3), (1, 2, 2), "SAME", train=True)
    assert calls == [(1, 3, 1), (1, 1, 3)]  # T is 1-wide, unstrided, unpadded: skipped
    assert tmp.DEFAULT_GRAD == os.environ.get("FVT_MAXPOOL_GRAD", "sep")
    assert tmp.EVAL_DEFAULT == os.environ.get("FVT_MAXPOOL_EVAL", "sas")
    env = dict(os.environ)
    env.update(FVT_MAXPOOL_GRAD="mask", FVT_MAXPOOL_EVAL="sep")
    out = subprocess.run([sys.executable, "-c", _DEFAULTS], capture_output=True, text=True,
                         check=True, env=env)
    assert out.stdout.strip() == '["mask", "sep"]'
