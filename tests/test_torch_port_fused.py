"""The port's fused block (K4's plain version and routing) and fused serving
engine against the JAX package's, on the CPU.

The JAX side runs its Pallas kernel in interpret mode, as its own tests do
(tests/test_fused_block.py, tests/test_fused_infer.py). Inputs are made with
numpy from a seed and handed to both. Tolerances are the JAX tests': 2e-3
for the block in f32 (summation order), 5e-2 with equal argmax for the
engine, which computes in bf16 whatever the input dtype.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from fastvideotagging_tpu.models.r2plus1d import R2Plus1D as JR2Plus1D
from fastvideotagging_tpu.ops import fused_block as jfused
from fastvideotagging_tpu.ops.fused_infer import r2plus1d_fused_infer as j_engine
from fastvideotagging_tpu_torch import get_model
from fastvideotagging_tpu_torch.models.convert import from_jax_variables
from fastvideotagging_tpu_torch.models.layers import r2plus1d_mid_channels
from fastvideotagging_tpu_torch.ops import conv2plus1d as ops
from fastvideotagging_tpu_torch.ops import fused_block as tfused
from fastvideotagging_tpu_torch.ops.fused_infer import r2plus1d_fused_infer as t_engine

BLOCK_TOL = 2e-3
ENGINE_TOL = 5e-2


def _block_inputs(shape, m, co, k, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = rng.standard_normal(shape).astype(dtype)
    w_sp = (rng.standard_normal((k, k, c, m)) / np.sqrt(k * k * c)).astype(dtype)
    w_tmp = (rng.standard_normal((k, m, co)) / np.sqrt(k * m)).astype(dtype)
    gamma = (np.abs(rng.standard_normal(m)) + 0.5).astype(np.float32)
    beta = (rng.standard_normal(m) * 0.1 + 0.2).astype(np.float32)
    mean = (rng.standard_normal(m) * 0.1).astype(np.float32)
    var = (np.abs(rng.standard_normal(m)) + 0.5).astype(np.float32)
    return x, w_sp, w_tmp, (gamma, beta, mean, var)


@pytest.mark.parametrize("shape,m,co,k", [
    ((2, 4, 8, 8, 32), 48, 32, 3),      # the two cases of tests/test_fused_block.py
    ((1, 6, 16, 12, 64), 64, 48, 3),
    ((2, 1, 8, 8, 40), 50, 24, 3),      # ragged widths, T = 1: only the centre tap
    ((1, 2, 8, 8, 40), 50, 24, 3),      # T = 2: one halo frame on each side
])
def test_fused_block_matches_jax(shape, m, co, k):
    x, w_sp, w_tmp, bn = _block_inputs(shape, m, co, k)
    js, jb = jfused.fold_bn(*(jnp.asarray(a) for a in bn))
    ref = np.asarray(jfused.conv2plus1d_fused(jnp.asarray(x), jnp.asarray(w_sp), js, jb,
                                              jnp.asarray(w_tmp)))
    ts, tb = tfused.fold_bn(*(torch.from_numpy(a) for a in bn))
    ops.reset_launch_counts()
    got = tfused.conv2plus1d_fused(torch.from_numpy(x), torch.from_numpy(w_sp), ts, tb,
                                   torch.from_numpy(w_tmp))
    assert ops.launch_counts["fused_block"] == 0  # a CPU tensor takes the plain version
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=BLOCK_TOL, atol=BLOCK_TOL)


@pytest.mark.parametrize("t", [1, 2, 5])
def test_fused_block_plain_is_the_composed_convs_in_f64(t):
    """In f64 the plain version equals spatial conv -> affine -> ReLU ->
    temporal conv with zero-padded T: a frame outside [0, T) contributes
    zero to the temporal conv, not ReLU(bias)."""
    x, w_sp, w_tmp, bn = _block_inputs((2, t, 6, 5, 8), 10, 4, 3, seed=1, dtype=np.float64)
    scale, bias = tfused.fold_bn(*(torch.from_numpy(a) for a in bn))
    got = tfused.fused_block_plain(torch.from_numpy(x), torch.from_numpy(w_sp), scale, bias,
                                   torch.from_numpy(w_tmp))
    assert got.dtype == torch.float64
    xc = torch.from_numpy(x).permute(0, 4, 1, 2, 3)
    y = F.conv3d(xc, torch.from_numpy(w_sp).permute(3, 2, 0, 1)[:, :, None], padding=(0, 1, 1))
    y = torch.relu(y * scale.double()[:, None, None, None] + bias.double()[:, None, None, None])
    y = F.conv3d(y, torch.from_numpy(w_tmp).permute(2, 1, 0)[..., None, None], padding=(1, 0, 0))
    np.testing.assert_allclose(got.numpy(), y.permute(0, 2, 3, 4, 1).numpy(), rtol=1e-12,
                               atol=1e-12)


def test_fold_bn_matches_jax_and_identity():
    rng = np.random.default_rng(2)
    m = 37
    bn = (rng.standard_normal(m).astype(np.float32), rng.standard_normal(m).astype(np.float32),
          rng.standard_normal(m).astype(np.float32),
          (np.abs(rng.standard_normal(m)) + 0.1).astype(np.float32))
    js, jb = jfused.fold_bn(*(jnp.asarray(a) for a in bn))
    ts, tb = tfused.fold_bn(*(torch.from_numpy(a) for a in bn))
    assert ts.dtype == tb.dtype == torch.float32
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-6, atol=1e-6)
    scale, bias = tfused.fold_bn(torch.ones(8), torch.zeros(8), torch.zeros(8),
                                 torch.ones(8) - 1e-5)
    np.testing.assert_allclose(scale.numpy(), 1.0, atol=1e-4)
    np.testing.assert_allclose(bias.numpy(), 0.0, atol=1e-6)


def test_rejects_unsupported():
    x = torch.zeros((1, 4, 8, 8, 8))  # C < MIN_C
    with pytest.raises(ValueError, match="fused block requires"):
        tfused.conv2plus1d_fused(x, torch.zeros((3, 3, 8, 16)), torch.zeros(16),
                                 torch.zeros(16), torch.zeros((3, 16, 8)))
    x = torch.zeros((1, 4, 8, 8, 32))  # even k
    with pytest.raises(ValueError, match="fused block requires"):
        tfused.conv2plus1d_fused(x, torch.zeros((2, 2, 32, 16)), torch.zeros(16),
                                 torch.zeros(16), torch.zeros((2, 16, 8)))
    # a kernel size whose k-frame ring fits no block's shared memory even at
    # the smallest tile (a wide M now takes more mid-channel groups instead)
    assert tfused.fused_plan((1, 4, 32, 32, 32), 25, 64, 64) is None
    assert not tfused.fused_supported((1, 4, 32, 32, 32), 25, 64, 64)
    assert tfused.fused_plan((1, 4, 8, 8, 32), 3, 4096, 64).groups == 64


@pytest.mark.parametrize("b", [8, 32])
def test_fused_supported_at_every_r2plus1d18_site(b):
    """The four stride-1 pair shapes of r2plus1d_18 at 16x112x112; the
    plan's shared memory stays within the 227 KB a block may use."""
    t, hw = 16, 56
    for stage in range(4):
        c = 64 * 2 ** stage
        if stage:
            t, hw = t // 2, hw // 2
        m = r2plus1d_mid_channels(c, c)
        shape = (b, t, hw, hw, c)
        assert tfused.fused_supported(shape, 3, m, c), shape
        plan = tfused.fused_plan(shape, 3, m, c)
        assert plan.bm in (64, 128) and plan.groups * plan.mg >= m
        assert plan.smem_bytes <= ops.SMEM_LIMIT
    # stage 4's mid channels go in groups, each block computing its own
    # group's mid once: no block recomputes mid for a Co split
    plan = tfused.fused_plan((8, 2, 7, 7, 512), 3, 1152, 512)
    assert plan.grid == plan.row_tiles * plan.groups and plan.groups > 1
    # the plan fills the card it is given: with fewer SMs, fewer blocks
    assert tfused.fused_plan((8, 2, 7, 7, 512), 3, 1152, 512, sms=16).grid < plan.grid


def _engine_case(stage_blocks=(1, 1), num_classes=7, shape=(2, 4, 32, 32, 3)):
    model = JR2Plus1D(stage_blocks=stage_blocks, num_classes=num_classes, dtype=jnp.float32)
    x = np.array(jax.random.normal(jax.random.PRNGKey(1), shape))
    variables = jax.jit(model.init, static_argnames="train")(
        jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    # perturb BN stats so folding is non-trivially exercised
    variables = jax.tree.map(lambda a: np.asarray(a) + 0.05 if a.ndim == 1 else np.asarray(a),
                             variables)
    return model, variables, x


@pytest.fixture(scope="module")
def engine_case():
    model, variables, x = _engine_case()
    ref = np.asarray(jax.jit(lambda v, x: model.apply(v, x, train=False))(variables, x))
    j_out = np.asarray(j_engine(variables, jnp.asarray(x), stage_blocks=(1, 1)))
    return from_jax_variables(variables), x, ref, j_out


def test_engine_matches_jax_engine(engine_case):
    state, x, _, j_out = engine_case
    ops.reset_launch_counts()
    got = t_engine(state, torch.from_numpy(x), stage_blocks=(1, 1))
    assert ops.launch_counts["fused_block"] == 0  # CPU: the plain version
    assert got.dtype == torch.float32 and tuple(got.shape) == j_out.shape
    np.testing.assert_allclose(got.numpy(), j_out, rtol=ENGINE_TOL, atol=ENGINE_TOL)
    assert (np.argmax(got.numpy(), -1) == np.argmax(j_out, -1)).all()


def test_engine_matches_jax_model_apply(engine_case):
    state, x, ref, _ = engine_case
    got = t_engine(state, torch.from_numpy(x), stage_blocks=(1, 1)).numpy()
    np.testing.assert_allclose(got, ref, rtol=ENGINE_TOL, atol=ENGINE_TOL)
    assert (np.argmax(got, -1) == np.argmax(ref, -1)).all()


def test_engine_deterministic(engine_case):
    state, x, _, _ = engine_case
    a = t_engine(state, torch.from_numpy(x), stage_blocks=(1, 1))
    b = t_engine(state, torch.from_numpy(x), stage_blocks=(1, 1))
    assert torch.equal(a, b)


def test_engine_refuses_blocks_it_does_not_walk():
    """r2plus1d_34 weights: the default (2, 2, 2, 2) would run an 18-layer
    network on them and return wrong logits, so it raises, naming the
    blocks; with their own stage_blocks the engine matches the model."""
    model = get_model("r2plus1d_34", num_classes=5, device="cpu", dtype=torch.float32,
                      generator=torch.Generator().manual_seed(0))
    state = model.state_dict()
    rng = torch.Generator().manual_seed(1)
    for name, v in state.items():  # move the BN statistics off the identity
        if name.endswith((".mean", ".var")):
            v += torch.rand(v.shape, generator=rng) * 0.1
    model.load_state_dict(state)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 4, 32, 32, 3))
                         .astype(np.float32))
    with pytest.raises(ValueError, match=r"not walked \['stage1_block2'"):
        t_engine(state, x)
    with pytest.raises(ValueError, match=r"missing \['stage3_block2'"):
        t_engine({k: v for k, v in state.items() if not k.startswith("stage3_block2.")}, x,
                 stage_blocks=(3, 4, 6, 3))
    got = t_engine(state, x, stage_blocks=(3, 4, 6, 3))
    with torch.inference_mode():
        ref = model(x)
    assert got.shape == ref.shape == (2, 5)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=ENGINE_TOL, atol=ENGINE_TOL)
