"""Pretrained weights in the port: the six torch-layout converters of
models/torch_import.py against the torch reference modules of
tests/test_torch_import.py (eval logits of the converted port model equal
the torch model's, in f32 within the tolerances that file holds the JAX
package to), their strict key accounting, ``zoo.load_pretrained`` (a head
of another class count re-initialized, every other tensor loaded bitwise;
a shape mismatch raises without ``reinit_head``), and ``cli.train
--pretrained`` on the CPU."""

import json

import numpy as np
import pytest
import torch

from fastvideotagging_tpu_torch.models import torch_import as ti
from fastvideotagging_tpu_torch.models import zoo as tzoo
from fastvideotagging_tpu_torch.train.checkpoint import export_weights
from test_torch_port_zoo_p3d import one_thread  # noqa: F401
from test_torch_import import (
    _VIDEORESNET_CONVS,
    TorchC3D,
    TorchI3D,
    TorchP3D,
    TorchR2Plus1D,
    TorchS3D,
    TorchVideoResNet3D,
    _randomize_bn_stats,
)


def _c3d():
    tm = TorchC3D(num_classes=7)
    tm.fc6 = torch.nn.Linear(512, 4096)  # pool5 is 512x1x1x1 at 16x16x16
    return tm


# name -> (torch module factory, NCTHW input, converter, port kwargs, atol)
CASES = {
    "r2plus1d_18": (lambda: TorchR2Plus1D(num_classes=7), (2, 3, 4, 32, 32),
                    ti.convert_r2plus1d_state_dict, {}, 2e-4),
    "c3d": (_c3d, (1, 3, 16, 16, 16), ti.convert_c3d_state_dict,
            {"clip_shape": (16, 16, 16)}, 2e-3),
    "p3d_63": (lambda: TorchP3D(num_classes=7), (2, 3, 8, 32, 32),
               ti.convert_p3d_state_dict, {}, 2e-3),
    "r3d_18": (lambda: TorchVideoResNet3D(_VIDEORESNET_CONVS["r3d_18"], num_classes=7),
               (2, 3, 4, 32, 32), ti.convert_videoresnet_state_dict, {}, 2e-4),
    "mc3_18": (lambda: TorchVideoResNet3D(_VIDEORESNET_CONVS["mc3_18"], num_classes=7),
               (2, 3, 4, 32, 32), ti.convert_videoresnet_state_dict, {}, 2e-4),
    "s3d": (lambda: TorchS3D(num_classes=7), (1, 3, 16, 32, 32),
            ti.convert_s3d_state_dict, {}, 2e-4),
    "i3d": (lambda: TorchI3D(num_classes=7), (1, 3, 16, 32, 32),
            ti.convert_i3d_state_dict, {}, 2e-4),
}


def _torch_model(name, seed=0):
    gen = torch.Generator().manual_seed(seed)
    make, shape, *_ = CASES[name]
    with torch.no_grad():
        torch.manual_seed(seed)
        tm = make()
        _randomize_bn_stats(tm, gen)
        tm.eval()
        x = torch.randn(shape, generator=gen)
        return tm, x, tm(x)


@pytest.mark.parametrize("name", sorted(CASES))
def test_converted_weights_reproduce_torch_logits(name):
    tm, x, ref = _torch_model(name)
    *_, convert, kw, atol = CASES[name]
    state = convert(tm.state_dict())
    with torch.device("meta"):  # no init: the converter fills every tensor
        model = tzoo._REGISTRY[name](num_classes=7, dtype=torch.float32, dropout=0.0, **kw)
    model.load_state_dict(state, assign=True)  # strict
    model.eval()
    with torch.inference_mode():
        got = model(x.permute(0, 2, 3, 4, 1).contiguous())  # NCTHW -> NTHWC
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=2e-4, atol=atol)
    n_port = sum(p.numel() for p in model.parameters())
    assert n_port == sum(p.numel() for p in tm.parameters())


@pytest.mark.parametrize("name", sorted(CASES))
def test_strict_key_accounting(name):
    make, _, convert, *_ = CASES[name]
    sd = dict(make().state_dict())
    first = next(k for k in sd if k.endswith(".weight"))
    missing = {k: v for k, v in sd.items() if k != first}
    with pytest.raises(KeyError, match="missing"):
        convert(missing)
    with pytest.raises(ValueError, match="unconsumed"):
        convert(dict(sd, **{"extra.weight": torch.zeros(1)}))
    # BatchNorm's step counters are not weights
    assert set(convert(dict(sd, **{"x.num_batches_tracked": torch.tensor(3)})))


def test_load_pretrained_from_pth_onto_another_class_count(tmp_path):
    tm, _, _ = _torch_model("mc3_18")
    path = str(tmp_path / "mc3.pth")
    torch.save({"state_dict": tm.state_dict()}, path)  # a common wrapper
    model, state = tzoo.load_pretrained("mc3_18", path, num_classes=4, device="cpu")
    want = ti.convert_videoresnet_state_dict(tm.state_dict())
    assert set(state) == set(want)
    for k, v in state.items():
        if k.startswith("fc."):
            assert v.shape[0] == 4
        else:
            assert torch.equal(v, want[k]), k
            assert torch.equal(model.state_dict()[k], v), k
    # the head is the model's own seeded init (seed 0 by default)
    fresh = tzoo.get_model("mc3_18", num_classes=4, device="cpu",
                           generator=torch.Generator().manual_seed(0))
    assert torch.equal(state["fc.weight"], fresh.fc.weight.detach())
    with pytest.raises(ValueError, match="shape mismatch at fc"):
        tzoo.load_pretrained("mc3_18", path, num_classes=4, reinit_head=False, device="cpu")
    # the same class count loads the head too
    _, same = tzoo.load_pretrained("mc3_18", path, num_classes=7, device="cpu")
    assert torch.equal(same["fc.weight"], want["fc.weight"])


def test_load_pretrained_takes_the_ports_own_exports(tmp_path):
    """An export of the port loads as it is (C3D's head is fc8); a weights
    file of another model raises."""
    with torch.device("meta"):
        shapes = tzoo._REGISTRY["c3d"](num_classes=5, clip_shape=(16, 16, 16)).state_dict()
    gen = torch.Generator().manual_seed(0)
    src = {k: torch.randn(v.shape, generator=gen) for k, v in shapes.items()}
    path = str(tmp_path / "c3d.pt")
    export_weights(path, src)
    model, state = tzoo.load_pretrained("c3d", path, num_classes=3, device="cpu",
                                        clip_shape=(16, 16, 16))
    for k, v in src.items():
        if not k.startswith("fc8."):
            assert torch.equal(state[k], v), k
    assert state["fc8.weight"].shape == (3, 4096)
    with pytest.raises(ValueError, match="do not match"):
        tzoo.load_pretrained("tiny3d", path, num_classes=3, device="cpu")
    with pytest.raises(ValueError, match="no torch-weight converter"):
        ti.load_torch_variables("s3d_g", path)


def test_cli_train_pretrained_on_the_cpu(tmp_path):
    """cli.train --pretrained with tiny3d flags: a 5-class export onto 3
    classes; fit starts from the export (head re-initialized) and trains."""
    from fastvideotagging_tpu_torch.cli import train as cli_train
    from fastvideotagging_tpu_torch.data.packed import write_pack_from_arrays
    from fastvideotagging_tpu_torch.data.synthetic import make_frames
    from fastvideotagging_tpu_torch.train import fit as fit_module

    pack = str(tmp_path / "t.fvtpack")
    write_pack_from_arrays([(f"v{i}.mp4", i % 3, (), make_frames(i, 8, 40, 56))
                            for i in range(3)], pack, (40, 56))
    src = tzoo.get_model("tiny3d", num_classes=5, device="cpu",
                         generator=torch.Generator().manual_seed(3))
    weights = str(tmp_path / "w.pt")
    export_weights(weights, src.state_dict())
    loaded = {}
    real = fit_module._apply_pretrained

    def spy(state, variables):
        real(state, variables)
        loaded.update({k: v.clone() for k, v in state.model.state_dict().items()})

    metrics = str(tmp_path / "m.jsonl")
    argv = ["--model", "tiny3d", "--num-classes", "3", "--train-list", pack,
            "--resize", "40", "56", "--crop", "32", "32", "--clip-len", "4",
            "--batch-size", "3", "--epochs", "1", "--log-every", "1", "--num-workers", "1",
            "--checkpoint-dir", "", "--metrics-jsonl", metrics, "--compute-dtype", "float32",
            "--device", "cpu", "--pretrained", weights]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fit_module, "_apply_pretrained", spy)
        state = cli_train.main(argv)
    assert state.step == 1
    for k, v in src.state_dict().items():
        if not k.startswith("fc."):
            assert torch.equal(loaded[k], v), k
    assert loaded["fc.weight"].shape == (3, 32)
    with open(metrics) as f:
        assert np.isfinite(json.loads(f.readline())["loss"])
    with pytest.raises(FileNotFoundError):
        cli_train.main(argv[:-1] + [str(tmp_path / "none.pt")])
