"""The port's int8 engine against the JAX package's on the walks no other
test covers, on the CPU.

One name of each walk: ``c3d`` (biases, no BatchNorm, a flatten head),
``p3d_63`` (the ``Sum`` nodes of P3D-B and P3D-C), ``s3d_g`` (Inception
branches and the self-gates), ``slowfast_r2plus1d`` (two streams, the
subsample and the laterals) and ``i3d`` (the TF-SAME stem; static here, its
dynamic walk is tests/test_torch_port_int8_dynamic.py's). Each at the
smallest clip its strides allow, one clip, 5 classes, seeded random
weights with perturbed BatchNorm statistics (``_perturbed``'s rule, with
numpy); the port calibrates and quantizes (``quantize_for``), and both
engines run on that one qpack, static and dynamic:

- every int8 site's reconstructed input bitwise equal to the JAX engine's
  (``debug_sites``), but for a site that a bf16 tail block feeds
  (``AFTER_BF16_TAIL``), held to one quantum;
- the logits within ``LOGIT_TOL`` = 5e-2 (tests/test_torch_port_int8.py's)
  of the largest |logit| with the same top-1: the logits of these random
  deep networks reach 1e2-1e4, and the bf16 tails (``float_blocks``) round
  in other places than XLA's fused graph.

The P3D case found the port adding a Sum's two bf16 branches in bf16 where
the jitted JAX engine hands their f32 sum to the next quantize (XLA's
excess precision): 1 % of the exp sites' values were one quantum apart
before ops/int8_infer.py took the sum in f32.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvideotagging_tpu.ops import arch_spec as jspec
from fastvideotagging_tpu.ops import int8_infer as ji
from fastvideotagging_tpu_torch import get_model
from fastvideotagging_tpu_torch.evaluation.quantized import quantize_for
from fastvideotagging_tpu_torch.ops import arch_spec as tspec
from fastvideotagging_tpu_torch.ops import int8_infer as ti

LOGIT_TOL = 5e-2
CLASSES = 5
# name: clip (T, H, W); C3D's five pools need T >= 16
CLIPS = {"c3d": (16, 32, 32), "p3d_63": (8, 32, 32), "s3d_g": (8, 32, 32),
         "slowfast_r2plus1d": (8, 32, 32), "i3d": (8, 32, 32)}
# int8 sites whose input a bf16 tail block computes: its bf16 convs round
# where XLA keeps f32 (K1 / K2 write bf16), so these are held to one quantum
# (SlowFast's last lateral reads the fast stream's bf16 stage 4: 5.9 % of
# its values one quantum apart), the others bit for bit
AFTER_BF16_TAIL = {"slowfast_r2plus1d": ("fast.out",)}
CASES = [(name, dynamic) for name in CLIPS for dynamic in (False, True)
         if not (name == "i3d" and dynamic)]


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _perturbed_state(model):
    """The model's state_dict with each BatchNorm's running mean drawn from
    N(0, 0.05) and its variance from 1 + U(-0.2, 0.2), seeded by the
    buffer's name."""
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    for name, v in sd.items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("mean", "var") and v.dtype == torch.float32:
            rng = np.random.default_rng(zlib.crc32(name.encode()))
            draw = (rng.normal(0, 0.05, v.shape) if leaf == "mean"
                    else 1.0 + rng.uniform(-0.2, 0.2, v.shape))
            sd[name] = torch.from_numpy(draw.astype(np.float32))
    return sd


def _jax_qpack(qp):
    """The port's qpack as the JAX engine's (the same values; no ``wk``)."""
    def conv(pack):
        return {k: jnp.asarray(v.numpy()) for k, v in pack.items() if k != "wk"}

    def tree(v):
        if torch.is_tensor(v):
            return jnp.asarray(v.numpy())
        if isinstance(v, dict):
            return {k: tree(x) for k, x in v.items()}
        return [tree(x) for x in v]
    return {"convs": {cid: conv(p) for cid, p in qp["convs"].items()},
            **{k: tree(v) for k, v in qp.items() if k != "convs"}}


def _family(name):
    t, h, w = CLIPS[name]
    kw = {"clip_shape": (t, h, w)} if name == "c3d" else {}
    model = get_model(name, num_classes=CLASSES, device="cpu",
                      generator=torch.Generator().manual_seed(0), **kw)
    sd = _perturbed_state(model)
    x = np.random.default_rng(3).standard_normal((1, t, h, w, 3)).astype(np.float32)
    qp = quantize_for(name, sd, [torch.from_numpy(x)])
    return x, qp, _jax_qpack(qp)


@pytest.fixture(scope="module")
def families():
    """Each family's clip and qpacks, made once for its two modes."""
    return {}


@pytest.mark.parametrize("name,dynamic", CASES,
                         ids=[f"{n}-{'dynamic' if d else 'static'}" for n, d in CASES])
def test_family_walk_matches_jax(families, name, dynamic):
    if name not in families:
        families[name] = _family(name)
    x, qp, jq = families[name]
    spec = tspec.spec_for(name)
    want_logits, want_sites = jax.device_get(ji.int8_infer(
        jq, jnp.asarray(x), jspec.spec_for(name), dynamic=dynamic, debug_sites=True))
    got_logits, got_sites = ti.int8_infer(qp, torch.from_numpy(x), spec, dynamic=dynamic,
                                          debug_sites=True)
    assert set(got_sites) == set(want_sites) and got_sites
    for site, want in want_sites.items():
        got, want = got_sites[site].numpy(), np.asarray(want)
        if site in AFTER_BF16_TAIL.get(name, ()):
            quantum = np.abs(want).max() / 127.0 + np.abs(got).max() / 127.0
            assert np.abs(got - want).max() <= quantum, (name, site)
        else:
            np.testing.assert_array_equal(got, want, err_msg=f"{name} {site}")
    got, want = got_logits.numpy(), np.asarray(want_logits)
    assert got.shape == (1, CLASSES) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_TOL * np.abs(want).max())
    assert (got.argmax(-1) == want.argmax(-1)).all()
