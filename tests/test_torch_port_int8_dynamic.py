"""The port's dynamic int8 walk on I3D's spec against the JAX package's, on
the CPU.

I3D is the covered family whose int8 default is the dynamic mode
(``default_dynamic``). One clip of 8x32x32 (the arch-spec tests' clip
size; every stage keeps a spatial extent), 5 classes, perturbed BatchNorm
statistics, the JAX package's calibration and qpack (``qpack_from_jax``):

- the walk reduces a site's amax in Q1's epilogue only where one Q1 call
  alone produces the site's input (a conv followed by a conv: ``conv2.out``
  and each Inception's ``b1`` and ``b2``), and keeps Q2's two passes where
  none does: the network's input, after a pool (``pool1``, each ``pool``
  branch) and at a value several sites read (each Inception's ``in``, read
  by three branches), counted on the plain versions;
- every site's reconstructed input equals the JAX dynamic engine's bit for
  bit, and the logits agree within 1e-5 of the largest (the head's f32
  means and matmul reduce in another order than XLA's).
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_int8 import _perturbed

from fastvideotagging_tpu.models import get_model as jget_model
from fastvideotagging_tpu.ops import arch_spec as jspec
from fastvideotagging_tpu.ops import int8_infer as ji
from fastvideotagging_tpu_torch.models.convert import qpack_from_jax
from fastvideotagging_tpu_torch.ops import arch_spec as tspec
from fastvideotagging_tpu_torch.ops import int8_conv
from fastvideotagging_tpu_torch.ops import int8_infer as ti

CLIP = (1, 8, 32, 32, 3)
INCEPTIONS = ("mixed3b", "mixed3c", "mixed4b", "mixed4c", "mixed4d", "mixed4e", "mixed4f",
              "mixed5b", "mixed5c")


@pytest.fixture(scope="module")
def i3d():
    model = jget_model("i3d", num_classes=5)
    x = np.random.default_rng(7).standard_normal(CLIP).astype(np.float32)
    variables = _perturbed(jax.jit(model.init, static_argnames="train")(
        jax.random.PRNGKey(0), jnp.asarray(x), train=False))
    spec = jspec.spec_for("i3d")
    jq = ji.quantize_variables(variables, ji.calibrate(variables, [jnp.asarray(x)], spec=spec),
                               spec=spec)
    return x, jq


def test_i3d_dynamic_walk_matches_jax(i3d, monkeypatch):
    x, jq = i3d
    spec = tspec.spec_for("i3d")
    assert spec.default_dynamic
    want_logits, want_sites = jax.device_get(
        ji.int8_infer(jq, jnp.asarray(x), jspec.spec_for("i3d"), dynamic=True, debug_sites=True))
    qp = qpack_from_jax(jax.device_get(jq))
    site_of = {id(t): site for site, t in qp["inv_f"].items()}
    q1_amax, two_pass, given = [], collections.Counter(), collections.Counter()
    plain_q1, plain_q2 = int8_conv.conv3d_s8_plain, int8_conv.quantize_s8_plain

    def q1(*a):
        if a[-1] is not None:  # the Amax: the next site's inv_f
            q1_amax.append(site_of[id(a[-1].inv_f)])
        return plain_q1(*a)

    def q2(y, inv_f, s=None, amax=None, slot=None):
        assert s is None  # the dynamic mode has no static scale
        (two_pass if amax is None else given)[site_of[id(inv_f)]] += 1
        return plain_q2(y, inv_f, s, amax, slot)

    monkeypatch.setattr(int8_conv, "conv3d_s8_plain", q1)
    monkeypatch.setattr(int8_conv, "quantize_s8_plain", q2)
    got_logits, got_sites = ti.int8_infer(qp, torch.from_numpy(x), spec, dynamic=True,
                                          debug_sites=True)
    fused = ["conv2.out"] + [f"{m}.{b}" for m in INCEPTIONS for b in ("b1", "b2")]
    assert sorted(q1_amax) == sorted(fused)
    assert given == collections.Counter(fused)
    assert two_pass == collections.Counter(
        {"input": 1, "pool1": 1, **{f"{m}.in": 3 for m in INCEPTIONS},
         **{f"{m}.pool": 1 for m in INCEPTIONS}})
    # 57 convs: 57 Q2 calls, 38 with the amax pass, 19 amaxes in Q1's epilogue
    assert (sum(two_pass.values()), sum(given.values())) == (38, 19)
    assert set(got_sites) == set(want_sites) and len(got_sites) == 3 + 4 * len(INCEPTIONS)
    for site, want in want_sites.items():
        np.testing.assert_array_equal(got_sites[site].numpy(), np.asarray(want), err_msg=site)
    got, want = got_logits.numpy(), np.asarray(want_logits)
    assert got.shape == (1, 5) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    assert (got.argmax(-1) == want.argmax(-1)).all()
