"""The port's ``Norm`` in train mode against the JAX package's (Flax
BatchNorm): output, the new running mean / var (biased batch variance,
momentum 0.9) and the gradients w.r.t. x, scale and bias, from the same
numpy-seeded input, parameters and cotangent.

f32: outputs and statistics within 1e-5, gradients within 1e-4 of the
largest |value| per tensor (summation order). In bf16 the statistics are
still taken in f32 and only the output is rounded: within 2^-7 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvideotagging_tpu.models.layers import Norm as JNorm
from fastvideotagging_tpu_torch.models.layers import Norm as TNorm

SHAPE = (3, 4, 5, 6, 10)  # (B, T, H, W, C)


def _setup(kind, dtype_name="float32", seed=0):
    rng = np.random.default_rng(seed)
    c = SHAPE[-1]
    x = (rng.normal(size=SHAPE) * 2.0 + rng.normal(size=(c,))).astype(np.float32)
    params = {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
              "bias": rng.normal(size=c).astype(np.float32)}
    stats = {"mean": rng.normal(size=c).astype(np.float32),
             "var": rng.uniform(0.5, 2.0, c).astype(np.float32)}
    gy = rng.normal(size=SHAPE).astype(np.float32)
    jm = JNorm(kind=kind, use_running_average=False, dtype=getattr(jnp, dtype_name))
    variables = {"params": {"BatchNorm_0": params}, "batch_stats": {"BatchNorm_0": stats}}
    tm = TNorm(c, kind=kind, dtype=getattr(torch, dtype_name)).train()
    tm.load_state_dict({k: torch.from_numpy(v) for k, v in {**params, **stats}.items()})
    return jm, variables, tm, x, gy


def _jax_train(jm, variables, x, gy):
    def f(params, x):
        y, mutated = jm.apply({"params": params, "batch_stats": variables["batch_stats"]},
                              x, mutable=["batch_stats"])
        return (y.astype(jnp.float32) * gy).sum(), (y, mutated)
    (_, (y, mutated)), (gp, gx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        variables["params"], jnp.asarray(x))
    stats = mutated.get("batch_stats", variables["batch_stats"])["BatchNorm_0"]
    return (np.asarray(y.astype(jnp.float32)), {k: np.asarray(v) for k, v in stats.items()},
            np.asarray(gx), {k: np.asarray(v) for k, v in gp["BatchNorm_0"].items()})


def _torch_train(tm, x, gy):
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tm(xt)
    (y.float() * torch.from_numpy(gy)).sum().backward()
    return (y.detach().float().numpy(),
            {"mean": tm.mean.numpy().copy(), "var": tm.var.numpy().copy()},
            xt.grad.numpy(), {"scale": tm.scale.grad.numpy(), "bias": tm.bias.grad.numpy()})


def _close(got, ref, tol):
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * np.abs(ref).max())


def test_batch_norm_train_output_matches_flax():
    jm, variables, tm, x, gy = _setup("batch")
    jy, _, _, _ = _jax_train(jm, variables, x, gy)
    ty, _, _, _ = _torch_train(tm, x, gy)
    assert ty.shape == jy.shape == SHAPE
    _close(ty, jy, 1e-5)
    # batch statistics, not the running ones: per-channel mean ~ bias
    assert np.abs(ty.mean(axis=(0, 1, 2, 3)) - tm.bias.detach().numpy()).max() < 1e-4


def test_batch_norm_train_running_stats_match_flax():
    jm, variables, tm, x, gy = _setup("batch")
    _, jstats, _, _ = _jax_train(jm, variables, x, gy)
    _, tstats, _, _ = _torch_train(tm, x, gy)
    _close(tstats["mean"], jstats["mean"], 1e-5)
    _close(tstats["var"], jstats["var"], 1e-5)
    # by hand: 0.9 * old + 0.1 * batch, with the BIASED batch variance
    old = variables["batch_stats"]["BatchNorm_0"]
    flat = x.reshape(-1, SHAPE[-1]).astype(np.float64)
    np.testing.assert_allclose(tstats["mean"], 0.9 * old["mean"] + 0.1 * flat.mean(0),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tstats["var"], 0.9 * old["var"] + 0.1 * flat.var(0, ddof=0),
                               rtol=1e-4, atol=1e-4)
    unbiased = 0.9 * old["var"] + 0.1 * flat.var(0, ddof=1)
    assert np.abs(tstats["var"] - unbiased).max() > 1e-4  # what nn.BatchNorm3d would keep


def test_batch_norm_train_grads_match_flax():
    jm, variables, tm, x, gy = _setup("batch")
    _, _, jgx, jgp = _jax_train(jm, variables, x, gy)
    _, _, tgx, tgp = _torch_train(tm, x, gy)
    _close(tgx, jgx, 1e-4)
    _close(tgp["scale"], jgp["scale"], 1e-4)
    _close(tgp["bias"], jgp["bias"], 1e-4)


def test_frozen_norm_trains_scale_and_bias_on_running_averages():
    jm, variables, tm, x, gy = _setup("frozen")
    jy, jstats, jgx, jgp = _jax_train(jm, variables, x, gy)
    ty, tstats, tgx, tgp = _torch_train(tm, x, gy)
    _close(ty, jy, 1e-5)
    _close(tgx, jgx, 1e-4)
    _close(tgp["scale"], jgp["scale"], 1e-4)
    _close(tgp["bias"], jgp["bias"], 1e-4)
    old = variables["batch_stats"]["BatchNorm_0"]
    for k in ("mean", "var"):  # the buffers never move
        np.testing.assert_array_equal(tstats[k], old[k])
        np.testing.assert_array_equal(jstats[k], old[k])


def test_batch_norm_eval_uses_and_keeps_running_averages():
    jm, variables, tm, x, _ = _setup("batch")
    ref = np.asarray(JNorm(kind="batch", use_running_average=True, dtype=jnp.float32)
                     .apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x)).numpy()
    _close(got, ref, 1e-5)
    np.testing.assert_array_equal(tm.mean.numpy(), variables["batch_stats"]["BatchNorm_0"]["mean"])


def test_batch_norm_train_bf16_takes_statistics_in_f32():
    jm, variables, tm, x, gy = _setup("batch", "bfloat16")
    xb = np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    jy, jstats, _, _ = _jax_train(jm, variables, jnp.asarray(xb).astype(jnp.bfloat16), gy)
    xt = torch.from_numpy(xb).to(torch.bfloat16)
    ty = tm(xt)
    assert ty.dtype == torch.bfloat16
    _close(ty.detach().float().numpy(), jy, 2.0 ** -7)
    _close(tm.mean.numpy(), jstats["mean"], 1e-5)
    _close(tm.var.numpy(), jstats["var"], 1e-5)


@pytest.mark.parametrize("kind", ["group", "scaleonly"])
def test_unported_norm_kinds_raise(kind):
    """Once unported, these kinds now build: scale and bias, no statistics
    (tests/test_torch_port_norms.py holds them against the JAX package);
    an unknown kind still raises."""
    norm = TNorm(8, kind=kind)
    assert set(norm.state_dict()) == {"scale", "bias"}
    with pytest.raises(ValueError, match="unknown norm kind"):
        TNorm(8, kind=kind + "_x")
