"""Repeatable training on the card (marker ``gpu``): csrc/maxpool_grad.cu
against its plain version, bit for bit, at every max pool of the train-mode
forwards of s3d, i3d, c3d and p3d_63 at B = 64 (8x32x32; C3D 16x32x32,
``benchmarks/repeat_train.py::pool_calls``), post-ReLU inputs with ties,
two launches equal; and two short ``fit`` runs of s3d from one seed equal
bit for bit in every parameter and BatchNorm statistic.

Skipped without a CUDA card (decided inside the fixture). On the card,
from the repository root:

    python -m pytest --noconftest -m gpu tests/test_torch_port_repeatable_gpu.py -q
"""

import pytest
import torch

from fastvideotagging_tpu_torch.benchmarks import repeat_train as rt
from fastvideotagging_tpu_torch.ops import maxpool_grad as mp

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("model", rt.POOLED)
def test_kernel_equals_plain_at_every_train_pool_site(cuda, model):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    calls = rt.pool_calls(model, cuda)
    assert calls
    before = mp.launch_counts["maxpool_grad"]
    for call in dict.fromkeys(calls):
        x, y, ct = rt.site_inputs(call, gen)
        args = (x, y, ct, *call[2:])
        dx, dx2 = mp.maxpool_grad_cuda(*args), mp.maxpool_grad_cuda(*args)
        ref = mp.maxpool_grad_plain(*args)
        assert dx.dtype == x.dtype == torch.bfloat16 and dx.shape == x.shape
        assert torch.equal(dx, ref), call
        assert torch.equal(dx, dx2), call
    assert mp.launch_counts["maxpool_grad"] - before == 2 * len(dict.fromkeys(calls))


def test_two_short_fits_are_equal(cuda, tmp_path):
    pack = rt.motion_packs(str(tmp_path))
    before = mp.launch_counts["maxpool_grad"]
    f = rt.two_fits("s3d", pack, cuda)
    assert f["equal"], f
    assert mp.launch_counts["maxpool_grad"] - before == 2 * rt.FIT_EPOCHS * len(
        rt.pool_calls("s3d", cuda))
