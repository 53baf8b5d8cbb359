"""The port's R(2+1)D against the JAX package's, with the JAX weights
carried across by models/convert.py.

Reduced depth (one block per stage) at B=1, 16x64x64 in f32: every stride-1
(2+1)D conv of every stage stays kernel-eligible (stage 4 has T=2, H=4), so
the port's kernel route (plain versions on CPU tensors) is exercised at every
stage. JAX runs its plain XLA convs. BN stats are perturbed so eval BN is not
the identity. Logits agree within 1e-4 of the largest |logit| (f32,
summation order only).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvideotagging_tpu.models import heads as jheads
from fastvideotagging_tpu.models import layers as jlayers
from fastvideotagging_tpu.models.r2plus1d import R2Plus1D as JR2Plus1D
from fastvideotagging_tpu_torch import get_model, list_models, model_from_config
from fastvideotagging_tpu_torch.config import ModelConfig
from fastvideotagging_tpu_torch.models import heads as theads
from fastvideotagging_tpu_torch.models import layers as tlayers
from fastvideotagging_tpu_torch.models.convert import from_jax_variables
from fastvideotagging_tpu_torch.models.r2plus1d import R2Plus1D as TR2Plus1D

REL_TOL = 1e-4


def _jax_and_port(tpu_variant: bool, backend: str = "cuda"):
    jkw = dict(mid_channels_fn=jlayers.mxu_aligned_mid_channels, stem_mid=128) \
        if tpu_variant else {}
    tkw = dict(mid_channels_fn=tlayers.mxu_aligned_mid_channels, stem_mid=128) \
        if tpu_variant else {}
    jm = JR2Plus1D(stage_blocks=(1, 1, 1, 1), num_classes=7, dtype=jnp.float32, **jkw)
    x = np.random.default_rng(0).normal(size=(1, 16, 64, 64, 3)).astype(np.float32)
    variables = jax.jit(jm.init, static_argnames="train")(jax.random.PRNGKey(0), x,
                                                          train=False)
    rng = np.random.default_rng(1)
    variables = jax.tree.map(
        lambda a: np.asarray(a) + (rng.uniform(0.0, 0.1, a.shape).astype(np.float32)
                                   if a.ndim == 1 else 0.0), variables)
    ref = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(variables, x))
    tm = TR2Plus1D(stage_blocks=(1, 1, 1, 1), num_classes=7, dtype=torch.float32,
                   backend=backend, **tkw).eval()
    tm.load_state_dict(from_jax_variables(variables))  # strict: every key maps
    return jm, variables, tm, x, ref


@pytest.mark.parametrize("tpu_variant", [False, True], ids=["r2plus1d_18", "r2plus1d_18_tpu"])
def test_reduced_depth_logits_match_jax(tpu_variant):
    _, _, tm, x, ref = _jax_and_port(tpu_variant)
    with torch.inference_mode():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (1, 7) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=REL_TOL * np.abs(ref).max())


def test_torch_backend_and_features_match_jax():
    jm, variables, tm, x, ref = _jax_and_port(False, backend="torch")
    with torch.inference_mode():
        got = tm(torch.from_numpy(x)).numpy()
        feats = tm(torch.from_numpy(x), features_only=True).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=REL_TOL * np.abs(ref).max())
    jfeats = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False,
                                                      features_only=True))(variables, x))
    assert feats.shape == jfeats.shape == (1, 2, 4, 4, 512)
    np.testing.assert_allclose(feats, jfeats, rtol=0, atol=REL_TOL * np.abs(jfeats).max())


def test_param_count_golden_400():
    # counted as tests/test_models.py:89-97 counts (params, not BN stats):
    # per-conv mid channels, not torchvision's per-block M (31,505,325)
    model = get_model("r2plus1d_18", num_classes=400, device="cpu")
    assert sum(p.numel() for p in model.parameters()) == 33_370_839


def test_state_dict_keys_match_jax_tree():
    model = get_model("r2plus1d_18_tpu", num_classes=4, device="cpu")
    jm = JR2Plus1D(stage_blocks=(2, 2, 2, 2), num_classes=4,
                   mid_channels_fn=jlayers.mxu_aligned_mid_channels, stem_mid=128)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            jnp.zeros((1, 4, 32, 32, 3)), train=False))
    mapped = from_jax_variables(jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes))
    state = model.state_dict()
    assert set(mapped) == set(state)
    assert all(tuple(mapped[k].shape) == tuple(state[k].shape) for k in state)


def test_mid_channel_rules_equal():
    for cin, cout in [(64, 64), (64, 128), (128, 256), (256, 512), (512, 512), (3, 45)]:
        assert tlayers.r2plus1d_mid_channels(cin, cout) == jlayers.r2plus1d_mid_channels(cin, cout)
        assert (tlayers.mxu_aligned_mid_channels(cin, cout)
                == jlayers.mxu_aligned_mid_channels(cin, cout))
    assert tlayers.symmetric_padding((3, 7, 1)) == tuple(
        p for p, _ in jlayers.symmetric_padding((3, 7, 1)))


def test_pool_and_heads_match_jax():
    x = np.random.default_rng(2).normal(size=(2, 3, 4, 5, 6)).astype(np.float32)
    np.testing.assert_allclose(
        tlayers.global_avg_pool_3d(torch.from_numpy(x)).numpy(),
        np.asarray(jlayers.global_avg_pool_3d(jnp.asarray(x))), rtol=1e-6, atol=1e-6)
    logits = np.random.default_rng(3).normal(size=(3, 9)).astype(np.float32) * 4
    for multilabel in (True, False):
        np.testing.assert_allclose(
            theads.predict_scores(torch.from_numpy(logits), multilabel).numpy(),
            np.asarray(jheads.predict_scores(jnp.asarray(logits), multilabel)),
            rtol=1e-6, atol=1e-6)


def test_zoo_registry_and_config():
    # the JAX zoo's 16 names (tests/test_torch_port_zoo_resnets.py compares)
    assert {"r2plus1d_18", "r2plus1d_18_tpu", "r2plus1d_34", "r2plus1d_34_tpu", "tiny3d",
            "c3d", "p3d_63", "s3d", "i3d"} <= set(list_models())
    with pytest.raises(ValueError, match="unknown model"):
        get_model("c4d", device="cpu")
    m = model_from_config(ModelConfig(name="r2plus1d_34", num_classes=3, kernels="torch",
                                      compute_dtype="float32"), device="cpu")
    assert m.stage_blocks == (3, 4, 6, 3) and m.dtype == torch.float32 and not m.training
    with pytest.raises(ValueError, match="kernels backend"):
        model_from_config(ModelConfig(kernels="pallas"), device="cpu")
    with pytest.raises(ValueError, match="norm kind"):
        model_from_config(ModelConfig(norm="layer"), device="cpu")
    # train mode runs (batch statistics) and moves the running averages
    before = m.stem_bn1.mean.clone()
    out = m.train()(torch.ones(2, 4, 32, 32, 3))
    assert out.shape == (2, 3) and not torch.equal(m.stem_bn1.mean, before)


def test_seeded_init_is_deterministic():
    def build():
        return get_model("r2plus1d_18", num_classes=5, device="cpu",
                         generator=torch.Generator().manual_seed(7)).state_dict()
    a, b = build(), build()
    assert all(torch.equal(a[k], b[k]) for k in a)
    # he_normal: truncated at 2 std, variance 2/fan_in
    w = a["stage2_block1.conv1.spatial.kernel"]
    fan_in = 9 * 128
    assert abs(w.std().item() - (2.0 / fan_in) ** 0.5) < 0.05 * (2.0 / fan_in) ** 0.5
