"""The port's r3d_18, mc3_18 and both SlowFast variants against the JAX
package's (the harness and tolerances of tests/test_torch_port_zoo_p3d.py):
eval logits in f32, train-mode logits and updated statistics in f64, at
2x16x32x32 clips with full widths; and the zoo's registry, keyword
handling and parameter counts against the JAX zoo's."""

import numpy as np
import pytest
import torch

from fastvideotagging_tpu.models import zoo as jzoo
from fastvideotagging_tpu_torch.models import zoo as tzoo
from test_torch_port_zoo_p3d import one_thread, pair_fixture  # noqa: F401

r3d = pair_fixture("r3d_18", (1, 8, 32, 32, 3))
mc3 = pair_fixture("mc3_18", (1, 8, 32, 32, 3))
slowfast = pair_fixture("slowfast_r2plus1d", (1, 8, 32, 32, 3))
slowfast_tpu = pair_fixture("slowfast_r2plus1d_tpu", (1, 8, 32, 32, 3))


@pytest.mark.parametrize("pair", ["r3d", "mc3", "slowfast", "slowfast_tpu"])
def test_eval_logits_match_jax(pair, request):
    request.getfixturevalue(pair).check_eval()


@pytest.mark.parametrize("pair", ["r3d", "mc3", "slowfast", "slowfast_tpu"])
def test_train_mode_logits_and_stats_match_jax(pair, request):
    request.getfixturevalue(pair).check_train()


def test_mc3_keeps_time_after_stage1(mc3):
    feats = {}
    mc3.tm.stage2_block0.register_forward_hook(lambda m, i, o: feats.setdefault("s2", o))
    with torch.no_grad():
        mc3.tm(torch.from_numpy(mc3.x))
    assert feats["s2"].shape[1] == 8  # 'no_t' stages stride (1, 2, 2)


def test_registry_equals_the_jax_zoo():
    assert tzoo.list_models() == jzoo.list_models()
    assert len(tzoo.list_models()) == 16


# tests/test_models.py's golden counts at 400 classes
_GOLDEN = {"r3d_18": 33_371_472, "mc3_18": 11_695_440, "s3d": 8_320_048, "i3d": 12_697_264}


@pytest.mark.parametrize("name", sorted(_GOLDEN))
def test_param_counts_equal_the_jax_goldens(name):
    with torch.device("meta"):  # shapes only: no init
        m = tzoo._REGISTRY[name](num_classes=400)
    assert sum(p.numel() for p in m.parameters()) == _GOLDEN[name]


def test_keyword_handling_follows_the_jax_zoo():
    """backend is dropped by the full-3D families; norm variants raise on
    the models without them; SlowFast's channel sharding and a clip length
    not divisible by alpha raise; dropout is drawn from the generator."""
    for name in ("c3d", "p3d_63", "slowfast_r2plus1d", "slowfast_r2plus1d_tpu"):
        with pytest.raises(ValueError, match="norm='batch'"):
            tzoo.get_model(name, num_classes=5, norm="group", device="cpu")
    with torch.device("meta"):
        m = tzoo._REGISTRY["i3d"](num_classes=3, backend="torch", norm="group")
    assert not list(m.buffers())  # GroupNorm: no statistics
    with pytest.raises(NotImplementedError, match="item 7"):
        tzoo.get_model("slowfast_r2plus1d", num_classes=3, shard_axis="model", device="cpu")
    sf = tzoo.get_model("slowfast_r2plus1d", num_classes=3, device="cpu")
    with pytest.raises(ValueError, match="divisible by alpha"):
        sf(torch.zeros(1, 6, 16, 16, 3))
    with pytest.raises(TypeError):
        tzoo.get_model("p3d_63", num_classes=3, remat="full", device="cpu")
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 8, 16, 16, 3))
                         .astype(np.float32))
    sf = tzoo.get_model("slowfast_r2plus1d", num_classes=3, dtype=torch.float32,
                        device="cpu", generator=torch.Generator().manual_seed(0)).train()
    with torch.no_grad():
        a = sf(x, generator=torch.Generator().manual_seed(1))
        b = sf(x, generator=torch.Generator().manual_seed(1))
        c = sf(x, generator=torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)
