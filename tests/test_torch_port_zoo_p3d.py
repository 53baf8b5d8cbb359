"""The port's C3D and P3D-63 against the JAX package's, and the helpers
that the other zoo parity files share (tests/test_torch_port_zoo_*.py).

Each model is built by the port's zoo from a seed, its 1-D leaves (norm
scales, biases and statistics, conv and dense biases) perturbed so that no
affine is the identity, and carried to the JAX package with
``to_jax_variables`` (the way back, ``from_jax_variables``, is checked
bitwise on every model). Full widths at small clips.

- Eval mode, f32: logits within 1e-4 of the largest |logit|.
- Train mode, f64 on both sides (the heads stay f32): logits within 1e-4 of
  the largest |logit|, and every updated BatchNorm statistic within 1e-4
  of its largest |value|. In f32 the train-mode forward of these deep nets
  is ill-conditioned at clips this small (batch statistics over a few
  samples per channel amplify a summation-order difference: P3D-63, S3D
  and I3D disagree by 2e-4 to 1e-3 in f32 at 2x16x32x32 and at 4x16x64x64,
  and by under 1e-6 in f64), and the point is the algorithm.
- Whole train steps of P3D-63 and C3D: tests/test_torch_port_zoo_steps.py.

Each JAX program compiles once (module-scoped fixtures).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvideotagging_tpu.models import zoo as jzoo
from fastvideotagging_tpu_torch.models import zoo as tzoo
from fastvideotagging_tpu_torch.models.convert import from_jax_variables, to_jax_variables

NUM_CLASSES = 7
REL_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The torch side on one thread: with several test workers on the
    machine more threads only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def port_model(name, clip, dtype=torch.float32, **kw):
    """The port's ``name`` and the same weights as JAX variables. ``clip``
    (B, T, H, W, 3) sizes C3D's fc6. The model is built on the meta device
    and given seeded weights: kernels normal with variance 2 / fan-in (the
    zoo's truncated-normal init takes seconds a model on one thread), 1-D
    leaves at their kind's init (scales and variances 1, the rest 0) plus
    uniform(0, 0.1), so that no affine is the identity."""
    if name in tzoo.CLIP_SHAPED:
        kw["clip_shape"] = clip[1:4]
    with torch.device("meta"):
        tm = tzoo._REGISTRY[name](num_classes=NUM_CLASSES, dtype=dtype, dropout=0.0, **kw)
    gen = torch.Generator().manual_seed(0)
    rng = np.random.default_rng(1)
    state = {}
    for key, v in tm.state_dict().items():
        if v.ndim == 1:
            base = torch.ones if key.endswith((".scale", ".var")) else torch.zeros
            state[key] = base(v.shape) + torch.from_numpy(
                rng.uniform(0.0, 0.1, v.shape).astype(np.float32))
        else:  # conv kernels (..., Cin, Cout), dense weights (Cout, Cin)
            fan_in = math.prod(v.shape[:-1]) if key.endswith(".kernel") else v.shape[1]
            state[key] = torch.randn(v.shape, generator=gen) * math.sqrt(2.0 / fan_in)
    tm.load_state_dict(state, assign=True)
    tm.eval()
    variables = to_jax_variables(tm.state_dict(), tm)
    back = from_jax_variables(variables)
    assert set(back) == set(tm.state_dict())
    assert all(torch.equal(back[k], v) for k, v in tm.state_dict().items())
    return tm, variables


def clip_input(clip, seed=0):
    return np.random.default_rng(seed).normal(size=clip).astype(np.float32)


def worst(got: dict, ref: dict):
    """Largest |got - ref| over the tensors, each relative to the largest
    |value| of its reference, and its key."""
    return max(((np.abs(got[k] - ref[k]).max() / max(np.abs(ref[k]).max(), 1e-30), k)
                for k in ref), default=(0.0, None))


class Pair:
    """One zoo name on both sides at one clip: the eval forward in f32 and
    the train-mode forward in f64, each JAX program compiled once."""

    def __init__(self, name, clip, **kw):
        self.name, self.clip, self.kw = name, clip, kw
        self.tm, self.variables = port_model(name, clip, **kw)
        self.x = clip_input(clip)

    def _jax(self, dtype):
        jkw = {k: v for k, v in self.kw.items() if k != "backend"}
        return jzoo.get_model(self.name, num_classes=NUM_CLASSES, dtype=dtype, dropout=0.0,
                              **jkw)

    def check_eval(self):
        jm = self._jax(jnp.float32)
        ref = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(self.variables, self.x))
        with torch.inference_mode():
            got = self.tm.eval()(torch.from_numpy(self.x)).numpy()
        assert got.shape == ref.shape == (self.clip[0], NUM_CLASSES)
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, ref, rtol=0, atol=REL_TOL * np.abs(ref).max())

    def check_train(self):
        with jax.enable_x64(True):
            jm = self._jax(jnp.float64)
            x = self.x.astype(np.float64)
            ref, upd = jax.jit(lambda v, x: jm.apply(v, x, train=True, mutable=["batch_stats"]))(
                self.variables, x)
            ref = np.asarray(ref)
            stats = {k: v.numpy() for k, v in from_jax_variables(
                {"batch_stats": jax.tree.map(np.asarray, dict(upd).get("batch_stats", {}))}
            ).items()}
        # the f64 twin, built on the meta device (no init) and given the weights
        kw = dict(self.kw, **({"clip_shape": self.clip[1:4]}
                              if self.name in tzoo.CLIP_SHAPED else {}))
        with torch.device("meta"):
            tm = tzoo._REGISTRY[self.name](num_classes=NUM_CLASSES, dtype=torch.float64,
                                           dropout=0.0, **kw)
        tm.load_state_dict({k: v.clone() for k, v in self.tm.state_dict().items()},
                           assign=True)
        with torch.no_grad():
            got = tm.train()(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=REL_TOL * np.abs(ref).max())
        sd = {k: v.numpy() for k, v in tm.state_dict().items()}
        assert set(stats) == {k for k in sd if k.endswith((".mean", ".var"))}
        err, key = worst({k: sd[k] for k in stats}, stats)
        assert err <= REL_TOL, (key, err)
        moved = [k for k in stats if not np.array_equal(stats[k],
                                                        self.tm.state_dict()[k].numpy())]
        assert len(moved) == len(stats)  # batch kinds: every statistic moved
        return tm


def pair_fixture(name, clip, **kw):
    @pytest.fixture(scope="module")
    def fixture():
        return Pair(name, clip, **kw)
    return fixture


# --------------------------------------------------------------------------
# C3D and P3D-63
# --------------------------------------------------------------------------

# C3D at its smallest clip, 16x16x16 (five pools): pool5 1x1x1 -> fc6 512
c3d = pair_fixture("c3d", (1, 16, 16, 16, 3))
p3d63 = pair_fixture("p3d_63", (1, 8, 32, 32, 3))


def test_c3d_eval_logits_match_jax(c3d):
    c3d.check_eval()
    assert c3d.tm.fc6.in_features == 512


def test_c3d_train_mode_logits_match_jax(c3d):
    c3d.check_train()


def routed_sites(model, x, monkeypatch):
    """(spatial, temporal) plain-version calls of one eval forward of the
    'cuda' route on the CPU: the sites ops/conv2plus1d.py gives K1 / K2."""
    from fastvideotagging_tpu_torch.ops import conv2plus1d as ops

    calls = {"spatial": 0, "temporal": 0}

    def counted(kind, fn):
        def wrapper(*a):
            calls[kind] += 1
            return fn(*a)
        return wrapper

    monkeypatch.setattr(ops, "spatial_conv_plain", counted("spatial", ops.spatial_conv_plain))
    monkeypatch.setattr(ops, "temporal_conv_plain", counted("temporal", ops.temporal_conv_plain))
    with torch.inference_mode():
        model.eval()(torch.from_numpy(x))
    return calls["spatial"], calls["temporal"]


def test_p3d63_eval_logits_match_jax(p3d63, monkeypatch):
    p3d63.check_eval()
    # the routing at this clip (T = 8 after the stem pool; H = 8, 4, 2, 1 by
    # stage): K2 takes the 16 temporal factors, K1 the spatial ones of
    # stages 1-2 only (K1 needs H, W >= 3)
    assert routed_sites(p3d63.tm, p3d63.x, monkeypatch) == (7, 16)


def test_p3d63_train_mode_logits_and_stats_match_jax(p3d63):
    p3d63.check_train()


def test_canonical_geometries_and_widths():
    """C3D's fc6 at the canonical 16x112x112 is 8192 (the paper's pool5 of
    512x1x4x4); P3D's stage widths and block cycle follow the JAX module."""
    from fastvideotagging_tpu_torch.models.c3d import pool5_shape
    from fastvideotagging_tpu_torch.models.p3d import P3D

    assert pool5_shape((16, 112, 112)) == (1, 4, 4)  # fc6 takes 8192
    assert pool5_shape((16, 16, 16)) == (1, 1, 1)
    with pytest.raises(ValueError, match="too small"):
        tzoo.get_model("c3d", device="cpu", clip_shape=(8, 112, 112))
    for name, blocks in (("p3d_63", (3, 4, 6, 3)), ("p3d_131", (3, 4, 23, 3)),
                         ("p3d_199", (3, 8, 36, 3))):
        assert jzoo.get_model(name).stage_blocks == blocks
    m = P3D(stage_blocks=(1, 1, 1, 1), num_classes=3)
    assert [getattr(m, n).block_type for n in m.block_names] == ["A", "B", "C", "A"]
    assert m.stage4_block0.expand.kernel.shape == (1, 1, 1, 512, 2048)
