"""The norm variants 'group' and 'scaleonly' (models/layers.py ``Norm``,
``scaled_ws``) on r2plus1d_18 and tiny3d against the JAX package's, with
the harness and tolerances of tests/test_torch_port_zoo_p3d.py (eval
logits in f32, train-mode logits in f64, 1x8x32x32 clips, full widths),
and the semantics tests/test_norm_variants.py holds the JAX modules to:
no statistics, train == eval, batch independence (group), SkipInit and
weight standardization (scaleonly)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvideotagging_tpu.models import layers as jlayers
from fastvideotagging_tpu_torch.models import layers as tlayers
from fastvideotagging_tpu_torch.models import zoo as tzoo
from test_torch_port_zoo_p3d import one_thread, pair_fixture  # noqa: F401

r18_group = pair_fixture("r2plus1d_18", (1, 8, 32, 32, 3), norm="group")
r18_scaleonly = pair_fixture("r2plus1d_18", (1, 8, 32, 32, 3), norm="scaleonly")
tiny_group = pair_fixture("tiny3d", (2, 8, 16, 16, 3), norm="group")
tiny_scaleonly = pair_fixture("tiny3d", (2, 8, 16, 16, 3), norm="scaleonly")
PAIRS = ["r18_group", "r18_scaleonly", "tiny_group", "tiny_scaleonly"]


@pytest.mark.parametrize("pair", PAIRS)
def test_eval_logits_match_jax(pair, request):
    request.getfixturevalue(pair).check_eval()


@pytest.mark.parametrize("pair", PAIRS)
def test_train_mode_logits_match_jax_and_equal_eval(pair, request):
    p = request.getfixturevalue(pair)
    tm = p.check_train()
    assert not list(tm.buffers())  # no statistics anywhere
    with torch.no_grad():
        train = tm(torch.from_numpy(p.x.astype(np.float64)))
        tm.eval()
        assert torch.equal(train, tm(torch.from_numpy(p.x.astype(np.float64))))


def test_group_norm_is_batch_independent_and_named_like_flax(tiny_group):
    tm = tiny_group.tm.eval()
    x = torch.from_numpy(tiny_group.x)
    with torch.no_grad():
        full, half = tm(x), tm(x[:1])
    torch.testing.assert_close(full[:1], half, rtol=1e-5, atol=1e-6)
    assert "GroupNorm_0" in tiny_group.variables["params"]["bn1"]
    assert tlayers._num_groups(45) == jlayers._num_groups(45) == 15
    assert all(tlayers._num_groups(c) == jlayers._num_groups(c) for c in range(1, 600))


def test_scaleonly_starts_blocks_as_identity_and_standardizes_kernels():
    m = tzoo.get_model("r2plus1d_18", num_classes=5, norm="scaleonly", device="cpu")
    for block in ("stage1_block0", "stage3_block1"):
        assert float(getattr(m, block).bn2.scale.abs().max()) == 0.0
        assert float(getattr(m, block).bn1.scale.abs().min()) == 1.0
    assert m.stage1_block0.conv1.spatial.ws and m.stage2_block0.downsample.ws
    with torch.device("meta"):  # no init: only the flags are read
        batch = tzoo._REGISTRY["r2plus1d_18"](num_classes=5)
    assert not batch.stem_spatial.ws and not batch.stage2_block0.downsample.ws
    k = np.random.default_rng(0).normal(size=(3, 1, 1, 24, 16)).astype(np.float32)
    np.testing.assert_allclose(tlayers.scaled_ws(torch.from_numpy(k)).numpy(),
                               np.asarray(jlayers.scaled_ws(jnp.asarray(k))),
                               rtol=1e-5, atol=1e-6)


def test_unknown_norm_kind_raises():
    with pytest.raises(ValueError, match="unknown norm kind"):
        tlayers.Norm(8, kind="layer")
    with pytest.raises(ValueError, match="scale_init"):
        tlayers.Norm(8, kind="scaleonly", scale_init="half")
