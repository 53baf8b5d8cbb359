"""The port's int8 serving engine against the JAX package's, on the CPU.

r2plus1d_18 at SHAPE = (2, 8, 32, 32, 3) with 12 classes and perturbed
BatchNorm statistics (the JAX package's tests/test_int8_infer.py setup,
seeded with numpy), the same variables in both packages
(``from_jax_variables``):

- specs: ``spec_for(name)`` of both packages equal as plain data, field by
  field, for every covered name;
- the bf16 walk (``record`` the identity) against the JAX
  ``reference_bf16_infer`` (atol 1.5e-1, the JAX test's) and against the
  port's own model in eval mode;
- calibration covers every conv-input site, the "input" site's absmax
  bitwise equal to JAX's;
- the qpack against JAX's: from each package's own calibration (the bf16
  walks round at different places) ``s_static`` within rtol 1e-2 and
  ``inv_f`` within rtol 1e-2 on the live channels of the stem and stage 1
  and at the median channel of every site; from the same calibration
  ``inv_f``, ``s_static`` and ``w_scale`` within rtol 1e-6 and the int8
  weights equal in at least 99.9 % of entries and at most 1 apart;
- the engine on one qpack (``qpack_from_jax``), static and dynamic: logits
  within 5e-2 of JAX's with the same top-1, the ``debug_sites`` tensors
  equal in at least 99.5 % of elements and at most one quantum apart;
- Q1's and Q2's plain versions against the JAX engine's int8 conv and
  quantize at every r2plus1d_18 site geometry (and a TF-SAME one) at
  narrow widths: int32 sums and int8 values exact;
- Q1's fused epilogue forms (b: the next site's quantize; c: a block's
  residual, ReLU and quantize or bf16 store; a bf16 output with the next
  site's dynamic amax) bit for bit against the unfused chain of plain steps
  at r2plus1d_18's site geometries;
- Q2 from an amax given (the one Q1's epilogue reduces) against the JAX
  engine's ``_dyn_quant``;
- the launches a static and a dynamic forward make (28 Q1 and 1 Q2 static,
  the other quantizes fused into Q1; 28 Q1, 26 Q2 and 1 amax pass dynamic,
  the other amaxes reduced in Q1's epilogue), counted on the plain
  versions;
- Q1's plan at every Q1 call of a static r2plus1d_18 forward at B = 8 and
  32 and at every conv geometry of the covered models;
- the JAX tests' own checks: ``calibrate(return_margins=True)``, the
  margin-dict ``quantize_variables``, the GroupNorm ``ValueError``.
"""

import dataclasses
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvideotagging_tpu.models import get_model as jget_model
from fastvideotagging_tpu.ops import arch_spec as jspec
from fastvideotagging_tpu.ops import int8_infer as ji
from fastvideotagging_tpu_torch import get_model
from fastvideotagging_tpu_torch.models.convert import from_jax_variables, qpack_from_jax
from fastvideotagging_tpu_torch.ops import arch_spec as tspec
from fastvideotagging_tpu_torch.ops import int8_conv
from fastvideotagging_tpu_torch.ops import int8_infer as ti

STAGE_BLOCKS = (2, 2, 2, 2)
SHAPE = (2, 8, 32, 32, 3)
CLASSES = 12
WALK_ATOL = 1.5e-1  # the JAX test's bound for its walk against model.apply
LOGIT_TOL = 5e-2


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _perturbed(variables):
    """Non-trivial running statistics (seeded by the leaf's path), so the
    BatchNorm fold is exercised."""
    def perturb(path, leaf):
        name = jax.tree_util.keystr(path)
        rng = np.random.default_rng(zlib.crc32(name.encode()))
        if "mean" in name:
            return jnp.asarray(rng.normal(0, 0.05, leaf.shape), leaf.dtype)
        return jnp.asarray(1.0 + rng.uniform(-0.2, 0.2, leaf.shape), leaf.dtype)

    stats = jax.tree_util.tree_map_with_path(perturb, variables["batch_stats"])
    return {"params": variables["params"], "batch_stats": stats}


@pytest.fixture(scope="module")
def setup():
    """One JAX init, one JAX calibration and qpack, shared by the module."""
    model = jget_model("r2plus1d_18", num_classes=CLASSES)
    x = np.random.default_rng(1).standard_normal(SHAPE).astype(np.float32)
    variables = _perturbed(jax.jit(model.init, static_argnames="train")(
        jax.random.PRNGKey(0), jnp.asarray(x), train=False))
    jscales = ji.calibrate(variables, [jnp.asarray(x)], STAGE_BLOCKS)
    jqpack = ji.quantize_variables(variables, jscales, STAGE_BLOCKS)
    sd = from_jax_variables(jax.device_get(variables))
    return dict(variables=variables, x=x, sd=sd, jscales=jscales, jqpack=jqpack)


def _astuple(spec):
    return dataclasses.astuple(spec)


@pytest.mark.parametrize("name", jspec.COVERED_MODELS)
def test_spec_equals_jax(name):
    assert tspec.COVERED_MODELS == jspec.COVERED_MODELS
    got, want = tspec.spec_for(name), jspec.spec_for(name)
    assert _astuple(got) == _astuple(want)
    got_convs = [(k, dataclasses.astuple(c), tspec.conv_id(c)) for k, c in tspec.iter_convs(got)]
    want_convs = [(k, dataclasses.astuple(c), jspec.conv_id(c)) for k, c in jspec.iter_convs(want)]
    assert got_convs == want_convs


def test_spec_for_unknown_name_raises():
    with pytest.raises(KeyError, match="covers"):
        tspec.spec_for("tiny3d")


def test_param_resolves_every_path(setup):
    """Every kernel, norm and Dense path of r2plus1d_18's spec resolves in
    the port's state_dict, the Dense kernel as its weight transposed."""
    sd, p = setup["sd"], setup["variables"]["params"]
    spec = tspec.spec_for("r2plus1d_18")
    for _k, c in tspec.iter_convs(spec):
        np.testing.assert_array_equal(tspec.param(sd, c.kernel).numpy(),
                                      np.asarray(ji._get(p, c.kernel)))
        assert f"{tspec.param_key(c.bn)}.mean" in sd
    for d in spec.head:
        np.testing.assert_array_equal(tspec.param(sd, d.param + ("kernel",)).numpy(),
                                      np.asarray(ji._get(p, d.param)["kernel"]))
    assert tspec.param_key(("stem_bn1", "BatchNorm_0", "scale")) == "stem_bn1.scale"


def test_bf16_walk_matches_jax_reference(setup):
    want = np.asarray(jax.jit(lambda v, x: ji.reference_bf16_infer(v, x, STAGE_BLOCKS))(
        setup["variables"], jnp.asarray(setup["x"])))
    got = ti.reference_bf16_infer(setup["sd"], torch.from_numpy(setup["x"]), STAGE_BLOCKS)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=WALK_ATOL)


def test_bf16_walk_matches_port_model(setup):
    model = get_model("r2plus1d_18", num_classes=CLASSES, device="cpu")
    model.load_state_dict(setup["sd"])
    model.eval()
    with torch.inference_mode():
        want = model(torch.from_numpy(setup["x"])).float()
    got = ti.reference_bf16_infer(model.state_dict(), torch.from_numpy(setup["x"]))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=WALK_ATOL)


def _all_sites():
    want = {"input", "stem_mid"}
    for stage, n in enumerate(STAGE_BLOCKS):
        for b in range(n):
            key = f"stage{stage + 1}_block{b}"
            want |= {f"{key}.in", f"{key}.conv1.mid", f"{key}.conv2.in", f"{key}.conv2.mid"}
    return want


def test_calibration_covers_every_conv_input_site(setup):
    scales = ti.calibrate(setup["sd"], [torch.from_numpy(setup["x"])], STAGE_BLOCKS)
    assert set(scales) == set(setup["jscales"]) == _all_sites()
    for k, v in scales.items():
        assert v.ndim == 1 and v.shape == setup["jscales"][k].shape and (v > 0).all()
    # the input site sees the clips themselves (cast to bf16 by both walks)
    np.testing.assert_array_equal(scales["input"], np.asarray(setup["jscales"]["input"]))


def test_qpack_matches_jax(setup):
    sd, jq = setup["sd"], setup["jqpack"]
    own_scales = ti.calibrate(sd, [torch.from_numpy(setup["x"])])
    own = ti.quantize_variables(sd, own_scales)
    for site in jq["inv_f"]:
        np.testing.assert_allclose(own["s_static"][site].numpy(),
                                   np.asarray(jq["s_static"][site]), rtol=1e-2)
        # inv_f = 1 / f, f = sqrt(A_c / W_c): A_c of a channel is the bf16
        # walk's absmax, whose rounding the two packages take at different
        # places; by stage 2 a channel's A_c differs by up to ~7 % (the
        # near-dead ones by more), so past stage 1 the median channel is
        # held to rtol 1e-2 and every channel to the clamp band
        got, want = own["inv_f"][site].numpy(), np.asarray(jq["inv_f"][site])
        rel = np.abs(got - want) / want
        a_own, a_jax = own_scales[site], np.asarray(setup["jscales"][site])
        live = np.minimum(a_own, a_jax) >= 0.05 * np.median(a_jax)  # not near-dead
        if site in ("input", "stem_mid") or site.startswith("stage1_"):
            assert rel[live].max() <= 1e-2, site
        assert np.median(rel) <= 1e-2, site
        assert ((got >= 0.1 - 1e-6) & (got <= 10 + 1e-5)).all(), site
    # from the same calibration, the quantizer's numbers and weights
    same = ti.quantize_variables(sd, setup["jscales"])
    for site in jq["inv_f"]:
        np.testing.assert_allclose(same["inv_f"][site].numpy(), np.asarray(jq["inv_f"][site]),
                                   rtol=1e-6)
    assert set(same["convs"]) == set(jq["convs"])
    for cid, pack in same["convs"].items():
        jp = jq["convs"][cid]
        np.testing.assert_allclose(pack["w_scale"].numpy(), np.asarray(jp["w_scale"]), rtol=1e-6)
        for key in ("mul", "add", "f_in"):
            np.testing.assert_allclose(pack[key].numpy(), np.asarray(jp[key]), rtol=1e-5,
                                       atol=1e-6)
        w, jw = pack["w"].numpy().astype(np.int32), np.asarray(jp["w"]).astype(np.int32)
        assert (w == jw).mean() >= 0.999 and np.abs(w - jw).max() <= 1, cid
        np.testing.assert_array_equal(pack["wk"].numpy(), int8_conv.weight_layout(pack["w"]))
    for site in jq["s_static"]:
        np.testing.assert_allclose(same["s_static"][site].numpy(),
                                   np.asarray(jq["s_static"][site]), rtol=1e-6)
    for h, jh in zip(same["head"], jq["head"]):
        np.testing.assert_array_equal(h["kernel"].numpy(), np.asarray(jh["kernel"]))


@pytest.fixture(scope="module")
def engines(setup):
    """Both engines on the JAX qpack, static and dynamic, with debug sites."""
    qp = qpack_from_jax(jax.device_get(setup["jqpack"]))
    x = setup["x"]
    out = {}
    for dynamic in (False, True):
        want = ji.r2plus1d_int8_infer(setup["jqpack"], jnp.asarray(x), STAGE_BLOCKS,
                                      dynamic=dynamic, debug_sites=True)
        got = ti.r2plus1d_int8_infer(qp, torch.from_numpy(x), STAGE_BLOCKS, dynamic=dynamic,
                                     debug_sites=True)
        out[dynamic] = (jax.device_get(want), got, qp)
    return out


@pytest.mark.parametrize("dynamic", [False, True], ids=["static", "dynamic"])
def test_engine_logits_match_jax(engines, dynamic):
    (want, _), (got, _), _ = engines[dynamic]
    got = got.numpy()
    assert got.shape == (SHAPE[0], CLASSES) and np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=LOGIT_TOL)
    assert (got.argmax(-1) == np.asarray(want).argmax(-1)).all()


@pytest.mark.parametrize("dynamic", [False, True], ids=["static", "dynamic"])
def test_engine_sites_match_jax(engines, dynamic):
    """Each site's reconstructed input is q * s / inv_f: the two engines'
    equal in >= 99.5 % of elements and at most one quantum apart."""
    (_, jsites), (_, sites), qp = engines[dynamic]
    float_sites = {f"stage4_block{b}.{s}" for b in range(2)
                   for s in ("in", "conv1.mid", "conv2.in", "conv2.mid")}
    assert set(sites) == set(jsites) == _all_sites() - float_sites
    for name, j in jsites.items():
        j, t = np.asarray(j), sites[name].numpy()
        quantum = np.abs(j).max() / 127.0 + np.abs(t).max() / 127.0  # s / inv_f <= amax / 127
        assert (t == j).mean() >= 0.995, name
        assert np.abs(t - j).max() <= quantum, name


def _jax_conv_i8(q, w, strides, pads):
    return np.asarray(ji._conv_i8(jnp.asarray(q), jnp.asarray(w), strides, pads))


# r2plus1d_18's int8 site geometries at narrow widths, and I3D's TF-SAME
# stem: (x shape (N,T,H,W,C), kernel (kt,kh,kw), strides, Co, padding)
SITES = [
    ("stem_spatial", (2, 4, 12, 12, 3), (1, 7, 7), (1, 2, 2), 8, None),
    ("stem_temporal", (2, 4, 6, 6, 45), (3, 1, 1), (1, 1, 1), 16, None),
    ("spatial", (2, 4, 6, 6, 16), (1, 3, 3), (1, 1, 1), 24, None),
    ("temporal", (2, 4, 6, 6, 24), (3, 1, 1), (1, 1, 1), 16, None),
    ("entry_spatial", (2, 4, 6, 6, 16), (1, 3, 3), (1, 2, 2), 23, None),
    ("entry_temporal", (2, 4, 3, 3, 23), (3, 1, 1), (2, 1, 1), 32, None),
    ("downsample", (2, 4, 6, 6, 16), (1, 1, 1), (2, 2, 2), 32, None),
    ("tf_same", (2, 5, 7, 8, 3), (3, 7, 7), (2, 2, 2), 8, "same_tf"),
]


@pytest.mark.parametrize("name,xs,kernel,strides,co,padding", SITES, ids=[s[0] for s in SITES])
def test_q1_plain_matches_jax_conv_i8(name, xs, kernel, strides, co, padding):
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    q = rng.integers(-127, 128, size=xs, dtype=np.int8)
    w = rng.integers(-127, 128, size=kernel + (xs[-1], co), dtype=np.int8)
    node = tspec.Conv("s", ("k", "kernel"), strides, padding=padding)
    pads = ti._conv_pads(q, w, node)
    want = _jax_conv_i8(q, w, strides, pads)
    assert want.dtype == np.int32
    qp = int8_conv.quantize_s8_plain(torch.from_numpy(q).float(), torch.ones(xs[-1]),
                                     torch.tensor(1.0))[0]
    assert qp.shape[-1] == int8_conv.padded_channels(xs[-1])
    wk = int8_conv.weight_layout(torch.from_numpy(w))
    acc = int8_conv.conv3d_s8_accumulate(qp, wk, kernel, strides, pads)
    np.testing.assert_array_equal(acc.numpy().astype(np.int64), want.astype(np.int64))
    # the whole plain version: the epilogue of the JAX engine's conv_q
    mul = torch.from_numpy(rng.uniform(0.5, 2.0, co).astype(np.float32)) * 1e-3
    add = torch.from_numpy(rng.normal(0, 1, co).astype(np.float32))
    s = torch.tensor(0.37, dtype=torch.float32)
    got = int8_conv.conv3d_s8_plain(qp, wk, kernel, mul, add, s, strides, pads, relu=True,
                                    out_f32=True)
    # the JAX engine's conv_q epilogue, compiled (XLA fuses its multiply-add)
    ref = jax.jit(lambda acc, m, s, a: jnp.maximum(acc.astype(jnp.float32) * (m * s) + a, 0.0))(
        want, mul.numpy(), np.float32(0.37), add.numpy())
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    ident = int8_conv.conv3d_s8(qp, wk, kernel, torch.ones(co), torch.zeros(co),
                                torch.tensor(1.0), strides, pads, out_f32=True)
    np.testing.assert_array_equal(ident.numpy(), want.astype(np.float32))


@pytest.mark.parametrize("xs", [(2, 4, 6, 6, 45), (2, 3, 5, 5, 64), (3, 7, 3)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_q2_plain_matches_jax_quantize(xs, dtype):
    rng = np.random.default_rng(len(xs) * 7 + xs[-1])
    y = torch.from_numpy(rng.normal(0, 3, xs).astype(np.float32)).to(dtype)
    inv_f = torch.from_numpy(rng.uniform(0.1, 10, xs[-1]).astype(np.float32))
    yj = jnp.asarray(y.float().numpy()).astype(jnp.bfloat16 if dtype == torch.bfloat16
                                                 else jnp.float32)
    # static: the JAX engine's quant_site expression
    s = np.float32(0.05)
    want = np.asarray(jnp.clip(jnp.round(yj.astype(jnp.float32) * (jnp.asarray(inv_f.numpy())
                                                                     / s)),
                               -127, 127).astype(jnp.int8))
    q, s_out = int8_conv.quantize_s8(y, inv_f, torch.tensor(s))
    cp = int8_conv.padded_channels(xs[-1])
    assert q.shape == xs[:-1] + (cp,) and q.dtype == torch.int8 and float(s_out) == s
    np.testing.assert_array_equal(q[..., :xs[-1]].numpy(), want)
    assert not q[..., xs[-1]:].any()
    # dynamic: the JAX engine's _dyn_quant, compiled as the engine compiles it
    jq, js = jax.jit(ji._dyn_quant)(yj, jnp.asarray(inv_f.numpy()))
    q, s_out = int8_conv.quantize_s8(y, inv_f)
    np.testing.assert_array_equal(q[..., :xs[-1]].numpy(), np.asarray(jq))
    assert float(s_out) == float(js)
    # dynamic from an amax given (Q1's epilogue reduces it), the quantize
    # pass alone; and the two passes into a forward's slot
    amax = (y.float() * inv_f).abs().amax()
    slots = int8_conv.ScaleSlots(2, "cpu")
    given = slots.take()
    given[0].copy_(amax)
    q, s_out = int8_conv.quantize_s8(y, inv_f, None, given[0], given)
    np.testing.assert_array_equal(q[..., :xs[-1]].numpy(), np.asarray(jq))
    assert float(s_out) == float(js) and s_out.data_ptr() == given[1].data_ptr()
    assert not q[..., xs[-1]:].any()
    two = slots.take()
    q2, s2 = int8_conv.quantize_s8(y, inv_f, None, None, two)
    assert torch.equal(q2, q) and torch.equal(s2, s_out) and torch.equal(two[0], amax)


# Q1's fused epilogue forms at r2plus1d_18's site geometries, B = 1: (name,
# q shape (N,T,H,W,C), kernel, strides, Co, relu, residual, requant). Form
# (b): the conv's ReLU, then the next site's quantize (requant False; True
# keeps the bf16 too, the 'exact' residual's need). Form (c): the block's
# residual ('dequant': its input's q; 'f32': a downsample conv's output;
# 'bf16': its bf16 input), ReLU, then the quantize (requant) or the bf16
# store alone (requant None: the last int8 block before a float one).
# requant 'amax': the bf16 output of form (a) or (c) and the next site's
# dynamic amax (the dynamic mode's fused walk).
FUSED = [
    ("b_stem_spatial", (1, 4, 12, 12, 3), (1, 7, 7), (1, 2, 2), 45, True, None, False),
    ("b_stem_temporal", (1, 4, 6, 6, 45), (3, 1, 1), (1, 1, 1), 16, True, None, False),
    ("b_spatial", (1, 4, 6, 6, 16), (1, 3, 3), (1, 1, 1), 24, True, None, False),
    ("b_entry_spatial", (1, 4, 6, 6, 16), (1, 3, 3), (1, 2, 2), 23, True, None, False),
    ("b_entry_temporal", (1, 4, 3, 3, 23), (3, 1, 1), (2, 1, 1), 32, True, None, True),
    ("c_dequant", (1, 4, 6, 6, 24), (3, 1, 1), (1, 1, 1), 16, True, "dequant", False),
    ("c_dequant_odd", (1, 4, 6, 6, 24), (3, 1, 1), (1, 1, 1), 45, True, "dequant", False),
    ("c_dequant_bf16", (1, 4, 6, 6, 24), (3, 1, 1), (1, 1, 1), 16, True, "dequant", None),
    ("c_downsample", (1, 4, 3, 3, 23), (3, 1, 1), (2, 1, 1), 32, True, "f32", False),
    ("c_downsample_bf16", (1, 4, 3, 3, 23), (3, 1, 1), (2, 1, 1), 32, True, "f32", None),
    ("c_exact", (1, 4, 6, 6, 24), (3, 1, 1), (1, 1, 1), 16, True, "bf16", True),
    ("a_amax_stem_spatial", (1, 4, 12, 12, 3), (1, 7, 7), (1, 2, 2), 45, True, None, "amax"),
    ("a_amax_entry_temporal", (1, 4, 3, 3, 23), (3, 1, 1), (2, 1, 1), 32, True, None, "amax"),
    ("c_dequant_amax", (1, 4, 6, 6, 24), (3, 1, 1), (1, 1, 1), 45, True, "dequant", "amax"),
    ("c_downsample_amax", (1, 4, 3, 3, 23), (3, 1, 1), (2, 1, 1), 32, True, "f32", "amax"),
    ("c_exact_amax", (1, 4, 6, 6, 24), (3, 1, 1), (1, 1, 1), 16, True, "bf16", "amax"),
]


def _unfused(q, wk, kernel, mul, add, s, strides, pads, relu, res, requant):
    """The int8 engine's separate steps: Q1's plain version (bf16 out, or
    f32 and no ReLU before a residual), the block tail's ops, Q2's (for an
    ``Amax``, its amax pass into a forward's slot)."""
    co = wk.shape[0]
    if res is None:
        y = int8_conv.conv3d_s8_plain(q, wk, kernel, mul, add, s, strides, pads, relu, False)
    else:
        zf = int8_conv.conv3d_s8_plain(q, wk, kernel, mul, add, s, strides, pads, False, True)
        if res.kind == "dequant":
            z = torch.addcmul(zf, res.t[..., :co].float(), res.s / res.inv_f)
        else:
            z = zf + res.t.float()
        y = torch.relu(z).to(torch.bfloat16)
    if requant is None:
        return y
    if isinstance(requant, int8_conv.Amax):
        slot = int8_conv.ScaleSlots(1, "cpu").take()
        int8_conv.quantize_s8_plain(y, requant.inv_f, None, None, slot)
        return y, slot[0]
    qn, sn = int8_conv.quantize_s8_plain(y, requant.inv_f, requant.s)
    return qn, sn, y


@pytest.mark.parametrize("name,xs,kernel,strides,co,relu,res_kind,requant", FUSED,
                         ids=[f[0] for f in FUSED])
def test_q1_fused_forms_match_the_unfused_chain(name, xs, kernel, strides, co, relu, res_kind,
                                                requant):
    """Each fused epilogue form of Q1's plain version equals the chain of
    separate plain steps it replaces, bit for bit: the int8 q (its channels
    past Co zero), the scale, the bf16 output where one is kept; the next
    site's amax against Q2's amax pass on the bf16 output."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    c = xs[-1]
    y_in = torch.from_numpy(rng.normal(0, 2, xs).astype(np.float32)).to(torch.bfloat16)
    q, _ = int8_conv.quantize_s8_plain(y_in, torch.from_numpy(
        rng.uniform(0.1, 3, c).astype(np.float32)), torch.tensor(0.05))
    w = torch.from_numpy(rng.integers(-127, 128, size=kernel + (c, co), dtype=np.int8))
    wk = int8_conv.weight_layout(w)
    pads = tuple((k // 2, k // 2) for k in kernel)
    mul = torch.from_numpy(rng.uniform(0.5, 2.0, co).astype(np.float32)) * 1e-3
    add = torch.from_numpy(rng.normal(0, 1, co).astype(np.float32))
    s = torch.tensor(0.037, dtype=torch.float32)
    out_shape = int8_conv._out_shape(q, kernel, strides, pads, co)
    res = None
    if res_kind == "dequant":  # the block input's q and its site's inv_f and scale
        t = torch.from_numpy(rng.normal(0, 2, out_shape).astype(np.float32)).to(torch.bfloat16)
        inv_f = torch.from_numpy(rng.uniform(0.1, 3, co).astype(np.float32))
        q_in, s_in = int8_conv.quantize_s8_plain(t, inv_f, torch.tensor(0.04))
        res = int8_conv.Residual("dequant", q_in, inv_f, s_in)
    elif res_kind == "f32":  # a downsample conv on the block input, 2x2x2 strided
        qb = torch.from_numpy(rng.integers(-127, 128, size=(1, 4, 6, 6, 16), dtype=np.int8))
        wd = int8_conv.weight_layout(torch.from_numpy(
            rng.integers(-127, 128, size=(1, 1, 1, 16, co), dtype=np.int8)))
        r = int8_conv.conv3d_s8_plain(qb, wd, (1, 1, 1), mul, add, s, (2, 2, 2),
                                      ((0, 0),) * 3, False, True)
        assert r.shape == out_shape
        res = int8_conv.Residual("f32", r)
    elif res_kind == "bf16":
        res = int8_conv.Residual("bf16", torch.from_numpy(
            rng.normal(0, 2, out_shape).astype(np.float32)).to(torch.bfloat16))
    rq = None
    next_inv_f = torch.from_numpy(rng.uniform(0.1, 3, co).astype(np.float32))
    if requant == "amax":
        rq = int8_conv.Amax(next_inv_f)
    elif requant is not None:
        rq = int8_conv.Requant(next_inv_f, torch.tensor(0.06), requant)
    want = _unfused(q, wk, kernel, mul, add, s, strides, pads, relu, res, rq)
    calls = dict(int8_conv.launch_counts)
    fused = dict(amax=rq) if requant == "amax" else dict(requant=rq)
    got = int8_conv.conv3d_s8(q, wk, kernel, mul, add, s, strides, pads, relu=relu,
                              residual=res, **fused)
    assert int8_conv.launch_counts == calls  # the plain version: no kernel launch
    if rq is None:
        assert got.dtype == torch.bfloat16 and torch.equal(got, want)
        return
    if requant == "amax":
        (gy, ga), (wy, wa) = got, want
        assert gy.dtype == torch.bfloat16 and torch.equal(gy, wy)
        assert ga.shape == () and ga > 0 and torch.equal(ga, wa)
        # into a slot that holds a partial max: the larger of the two
        slot = int8_conv.ScaleSlots(1, "cpu").take()
        slot[0].fill_(float(wa) * 2)
        int8_conv.conv3d_s8(q, wk, kernel, mul, add, s, strides, pads, relu=relu, residual=res,
                            amax=rq._replace(out=slot[0]))
        assert float(slot[0]) == float(wa) * 2
        with pytest.raises(ValueError):  # an f32 output takes no amax
            int8_conv.conv3d_s8(q, wk, kernel, mul, add, s, strides, pads, out_f32=True,
                                amax=rq)
        return
    (gq, gs, gy), (wq, ws, wy) = got, want
    assert gq.dtype == torch.int8 and gq.shape[-1] == int8_conv.padded_channels(co)
    assert torch.equal(gq, wq) and torch.equal(gs, ws) and not gq[..., co:].any()
    assert (gy is None) == (not requant)
    if requant:
        assert torch.equal(gy, wy)
    # the kernel's arguments: a residual or requant of the wrong form is refused
    with pytest.raises(ValueError):
        int8_conv.conv3d_s8(q, wk, kernel, mul, add, s, strides, pads, out_f32=True,
                            requant=rq)


@pytest.mark.parametrize("dynamic", [False, True], ids=["static", "dynamic"])
def test_engine_launches_per_forward(setup, engines, monkeypatch, dynamic):
    """r2plus1d_18 with stage 4 in bf16: 28 Q1 calls (2 stem, 4 a block of
    stages 1-3, the 2 downsamples). Q2: static 1 call (the input site; every
    other static quantize is the epilogue of the conv before it, forms (b)
    and (c)), dynamic 26 (a block's input is quantized once for conv1 and
    the downsample), of which 1 runs the amax pass (the input site; every
    other dynamic amax is reduced in the epilogue of the conv before it);
    counted on the plain versions (the kernels' counts move on the card
    only)."""
    calls = {"q1": 0, "q2": 0, "amax": 0}

    def q1(*a, **k):
        calls["q1"] += 1
        return plain_q1(*a, **k)

    def q2(y, inv_f, s=None, amax=None, slot=None):
        calls["q2"] += 1
        calls["amax"] += s is None and amax is None
        return plain_q2(y, inv_f, s, amax, slot)

    plain_q1, plain_q2 = int8_conv.conv3d_s8_plain, int8_conv.quantize_s8_plain
    monkeypatch.setattr(int8_conv, "conv3d_s8_plain", q1)
    monkeypatch.setattr(int8_conv, "quantize_s8_plain", q2)
    qp = engines[False][2]
    ti.r2plus1d_int8_infer(qp, torch.from_numpy(setup["x"]), dynamic=dynamic)
    assert calls == {"q1": 28, "q2": 26 if dynamic else 1, "amax": 1 if dynamic else 0}
    assert int8_conv.launch_counts == {"conv3d_s8": 0, "quantize_s8": 0, "quantize_s8_amax": 0}


def test_int8_engine_deterministic_and_residual_modes(engines, setup):
    qp = engines[False][2]
    x = torch.from_numpy(setup["x"])
    a = ti.r2plus1d_int8_infer(qp, x)
    assert torch.equal(a, ti.r2plus1d_int8_infer(qp, x))
    exact = ti.r2plus1d_int8_infer(qp, x, residual="exact")
    want = ji.r2plus1d_int8_infer(setup["jqpack"], jnp.asarray(setup["x"]), residual="exact")
    np.testing.assert_allclose(exact.numpy(), np.asarray(want), rtol=0, atol=LOGIT_TOL)
    full = ti.r2plus1d_int8_infer(qp, x, float_blocks=())
    assert np.isfinite(full.numpy()).all()


def test_calibrate_site_margins(setup):
    sd, x = setup["sd"], torch.from_numpy(setup["x"])
    scales_only = ti.calibrate(sd, [x, x], STAGE_BLOCKS)
    scales, margins = ti.calibrate(sd, [x, x], STAGE_BLOCKS, return_margins=True)
    assert set(margins) == set(scales) == set(scales_only)
    for k in scales:
        np.testing.assert_array_equal(scales[k], scales_only[k])
        assert margins[k] == 2.0  # identical batches: spread exactly 1
    _, m2 = ti.calibrate(sd, [x, 3.0 * x], STAGE_BLOCKS, return_margins=True)
    assert m2["input"] > margins["input"]
    assert all(2.0 <= v <= 8.0 for v in m2.values())


def test_quantize_variables_site_margin_dict(setup):
    sd, x = setup["sd"], torch.from_numpy(setup["x"])
    scales, margins = ti.calibrate(sd, [x, 0.5 * x], STAGE_BLOCKS, return_margins=True)
    q_global = ti.quantize_variables(sd, scales, STAGE_BLOCKS, static_margin=2.0)
    q_site = ti.quantize_variables(sd, scales, STAGE_BLOCKS, static_margin=margins)
    for site, m in margins.items():
        np.testing.assert_allclose(q_site["s_static"][site].numpy(),
                                   q_global["s_static"][site].numpy() * m / 2.0, rtol=1e-6)
    assert np.isfinite(ti.r2plus1d_int8_infer(q_site, x).numpy()).all()
    # the precomputed consumer absmax gives the same qpack
    cols = ti.consumer_absmax(tspec.r2plus1d_spec(STAGE_BLOCKS), sd)
    q_cols = ti.quantize_variables(sd, scales, STAGE_BLOCKS, w_cols=cols)
    for site in q_global["inv_f"]:
        assert torch.equal(q_cols["inv_f"][site], q_global["inv_f"][site])


def test_bn_of_groupnorm_checkpoint_fails_with_reason():
    with pytest.raises(ValueError, match="norm='batch'"):
        ti._bn_of({"stem.s.scale": torch.tensor(1.0)}, ("stem", "s"))


@pytest.mark.parametrize("name", ["fvt_conv3d_s8", "fvt_quantize_s8"])
def test_int8_argtypes_match_the_c_signatures(name):
    """The ctypes bindings of Q1's and Q2's entry points have one type per
    parameter of the C functions, in the same kinds (a mismatch would show
    only on the card); Q1's takes the amax output and its factors into
    ``ConvArgs``, Q2's its mode (static, dynamic, amax given)."""
    import ctypes
    import os
    import re

    from fastvideotagging_tpu_torch.ops import _build

    with open(os.path.join(_build.CSRC, "int8_conv.cu")) as f:
        src = f.read()
    params = re.search(rf"int {name}\(([^)]*)\)", src).group(1).split(",")

    def kind(p):
        if "*" in p:
            return ctypes.c_void_p
        return ctypes.c_longlong if "long long" in p else ctypes.c_int

    want = int8_conv._Q1_ARGTYPES if name == "fvt_conv3d_s8" else int8_conv._Q2_ARGTYPES
    assert want == [kind(p) for p in params]
    names = [p.split()[-1].lstrip("*") for p in params]
    if name == "fvt_conv3d_s8":
        assert names[12:14] == ["amax", "amax_inv_f"]  # after q_s, before n
        struct = re.search(r"struct ConvArgs \{([^}]*)\}", src).group(1)
        assert re.search(r"unsigned\* amax;", struct)
        assert re.search(r"const float\* amax_inv_f;", struct)
    else:
        assert names[10] == "mode"
        assert (int8_conv._Q2_STATIC, int8_conv._Q2_DYNAMIC, int8_conv._Q2_GIVEN) == (0, 1, 2)
        assert re.search(r"enum Q2Mode \{ kQ2Static = 0, kQ2Dynamic = 1, kQ2Given = 2 \};", src)


def _record_q1(qp, x, monkeypatch):
    """Q1's calls of one static forward, in order: (rows, Co, taps, cp,
    output bytes an element, output bytes a row). Q1 is replaced by a stub
    that returns zeros of its output's form, so the forward runs at full
    size on the CPU."""
    calls = []

    def stub(q, wk, kernel, mul, add, s, strides, pads, relu=False, out_f32=False,
             residual=None, requant=None):
        co = wk.shape[0]
        shape = int8_conv._out_shape(q, tuple(kernel), strides, pads, co)
        rows = int(np.prod(shape[:-1]))
        taps = kernel[0] * kernel[1] * kernel[2]
        if requant is not None:
            cp = int8_conv.padded_channels(co)
            calls.append((rows, co, taps, q.shape[-1], 1, cp))
            y = torch.zeros(shape, dtype=torch.bfloat16) if requant.keep_bf16 else None
            return torch.zeros(shape[:-1] + (cp,), dtype=torch.int8), requant.s, y
        es = 4 if out_f32 else 2
        calls.append((rows, co, taps, q.shape[-1], es, co * es))
        return torch.zeros(shape, dtype=torch.float32 if out_f32 else torch.bfloat16)

    monkeypatch.setattr(int8_conv, "conv3d_s8", stub)
    ti.r2plus1d_int8_infer(qp, x)
    return calls


def _check_plan(plan, rows, co, taps, cp, es, row_bytes):
    from fastvideotagging_tpu_torch.ops.conv2plus1d import SMEM_LIMIT, SMEM_PER_SM, SMS

    assert plan.bn in (64, 128, 144) and plan.col_tiles == -(-co // plan.bn)
    assert plan.row_tiles == -(-rows // 128) and plan.slices == -(-taps * cp // 128)
    assert 4 <= plan.stages <= 6 and plan.smem_bytes <= SMEM_LIMIT
    assert 2 * plan.smem_bytes > SMEM_PER_SM  # one block an SM (setmaxnreg's register split)
    assert plan.smem_bytes == int8_conv._q1_smem(plan.bn, plan.stages, es, plan.staged)
    assert plan.staged == (row_bytes % 16 == 0) and plan.grid == min(plan.tiles, SMS)
    if plan.stages < 6:  # the ring took what shared memory there was
        assert int8_conv._q1_smem(plan.bn, plan.stages + 1, es, plan.staged) > SMEM_LIMIT


def test_conv_s8_plan_at_the_r2plus1d_sites(engines, monkeypatch):
    """Q1's plan: K1's column rule over wgmma .s8's N = 64 / 128 / 144, and a
    narrower tile where the row tiles are fewer than the SMs and it finishes
    sooner (waves x the tile's cost); 4-6 ring stages in at most 232,448
    bytes, more than half an SM's shared memory; the output staged for TMA
    stores where its rows are whole 16-byte boxes. Held at every Q1 call of
    a static r2plus1d_18 forward at B = 8 and 32 (16x112x112) and at every
    conv geometry of the covered models."""
    bns = {co: int8_conv.conv_s8_plan(8 * 16 * 56 * 56, co, 9, 64).bn
           for co in (45, 64, 128, 144, 230, 256, 288, 460, 576)}
    assert bns == {45: 64, 64: 64, 128: 128, 144: 144, 230: 128, 256: 128, 288: 144,
                   460: 128, 576: 144}
    # 8 row tiles: Co = 576 in 9 tiles of 64 (one wave) rather than 4 of 144
    plan = int8_conv.conv_s8_plan(1000, 576, 27, 48)
    assert (plan.bn, plan.col_tiles, plan.row_tiles, plan.grid) == (64, 9, 8, 72)
    assert plan.slices == -(-27 * 48 // 128)
    qp = engines[False][2]
    for b in (8, 32):
        x = torch.zeros((b, 16, 112, 112, 3))
        calls = _record_q1(qp, x, monkeypatch)
        assert len(calls) == 28
        # int8 out (forms b, c) but at the downsamples (f32) and the last
        # int8 block's tail (bf16 before stage 4)
        assert [c[4] for c in calls].count(1) == 25 and [c[4] for c in calls].count(4) == 2
        for rows, co, taps, cp, es, row_bytes in calls:
            plan = int8_conv.conv_s8_plan(rows, co, taps, cp, es, row_bytes)
            _check_plan(plan, rows, co, taps, cp, es, row_bytes)
            assert plan.staged  # every r2plus1d_18 output row is whole 16-byte boxes
            if rows >= 132 * 128:  # enough row tiles: K1's rule
                assert plan.bn == int8_conv.conv_s8_plan(1 << 24, co, taps, cp).bn
        if b == 8:  # stage 3's 6272 rows (49 row tiles): 128 columns in one wave of 98
            assert {c[1]: int8_conv.conv_s8_plan(*c).bn for c in calls if c[0] == 6272} == {
                256: 128, 576: 128}
            assert int8_conv.conv_s8_plan(6272, 128, 1, 128, 4, 512).bn == 64  # 49 -> 98
    # every conv geometry of the covered models, at four output-row counts
    from fastvideotagging_tpu_torch import get_model

    geometries = set()
    for name in tspec.COVERED_MODELS:
        with torch.device("meta"):
            sd = get_model(name, num_classes=4, device="meta").state_dict()
        for _k, c in tspec.iter_convs(tspec.spec_for(name)):
            k = tspec.param(sd, c.kernel)
            geometries.add((k.shape[-1], k.shape[0] * k.shape[1] * k.shape[2],
                            int8_conv.padded_channels(k.shape[3])))
    assert len(geometries) > 100
    for co, taps, cp in sorted(geometries):
        for rows in (1000, 6272, 50176, 401408):
            for es, row_bytes in ((1, int8_conv.padded_channels(co)), (2, 2 * co), (4, 4 * co)):
                plan = int8_conv.conv_s8_plan(rows, co, taps, cp, es, row_bytes)
                _check_plan(plan, rows, co, taps, cp, es, row_bytes)


def test_recorded_int8_accuracy_gate():
    """The port's benchmarks/INT8_SERVING.json (recorded on the card by
    ``benchmarks.int8_serving``) shows the int8 engine within 2 points of
    bf16 top-1 on the hard benchmark: the JAX package's gate
    (tests/test_int8_infer.py)."""
    import json
    import os

    import fastvideotagging_tpu_torch.benchmarks as benchmarks

    with open(os.path.join(os.path.dirname(benchmarks.__file__), "INT8_SERVING.json")) as f:
        rec = json.load(f)
    assert rec["bf16_top1"] - rec["int8_top1"] <= 0.02 + 1e-9
    assert rec["int8_top1"] >= 0.90
    assert rec["device"] == "cuda" and rec["card"] and rec["epochs"] == 60
