"""Whole train steps of P3D-63 and C3D against the JAX package's, in
float64 (as tests/test_torch_port_train.py does for R(2+1)D): the port's
``make_train_step`` through K1-K3's autograd Functions (their plain
versions on the CPU) and the max pool's separable backward, the JAX
package's through XLA. The clips are bitwise equal on both sides (exact
normalization constants, no resize beyond the crop)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvideotagging_tpu import config as jconfig
from fastvideotagging_tpu.models import zoo as jzoo
from fastvideotagging_tpu.train import loop as jloop
from fastvideotagging_tpu.train import lr as jlr
from fastvideotagging_tpu.train.state import TrainState as JTrainState
from fastvideotagging_tpu_torch import config as tconfig
from fastvideotagging_tpu_torch.models.convert import from_jax_variables
from fastvideotagging_tpu_torch.train import loop as tloop
from fastvideotagging_tpu_torch.train.state import create_train_state
from test_torch_port_zoo_p3d import NUM_CLASSES, one_thread, port_model, worst  # noqa: F401

# (resize, crop) of each model's steps: C3D at its smallest clip (16x16:
# pool5 1x1x1), P3D-63 there too (K1 takes stage 1 at 4x4, K2 every stage)
_STEP_GEOMETRY = {"c3d": ((20, 24), (16, 16)), "p3d_63": ((20, 24), (16, 16))}


def _step_cfgs(name):
    resize, crop = _STEP_GEOMETRY[name]
    out = []
    for mod, kernels in ((jconfig, "xla"), (tconfig, "cuda")):
        out.append(mod.ExperimentConfig(
            model=mod.ModelConfig(name=name, num_classes=NUM_CLASSES, dropout=0.0,
                                  kernels=kernels, compute_dtype="float64"),
            # mean 0.5 and std 64/255 make the normalization (x - 127.5) / 64,
            # exact: both sides feed their models identical clips
            data=mod.DataConfig(resize_hw=resize, crop_hw=crop,
                                mean=(0.5, 0.5, 0.5), std=(64 / 255,) * 3),
            train=mod.TrainConfig(batch_size=4, base_lr=0.05, lr_steps=(1,),
                                  weight_decay=1e-3)))
    return out


def _step_batch(name, seed):
    (h, w), (ch, cw) = _STEP_GEOMETRY[name]
    rng = np.random.default_rng(seed)
    return {
        "frames": rng.integers(0, 256, size=(4, 16, h, w, 3), dtype=np.uint8),
        "labels": (np.arange(4) % NUM_CLASSES).astype(np.int32),
        "crop_tops": rng.integers(0, h - ch + 1, size=(4,)).astype(np.int32),
        "crop_lefts": rng.integers(0, w - cw + 1, size=(4,)).astype(np.int32),
        "flips": rng.uniform(size=(4,)) < 0.5,
        "weights": np.array([1, 1, 1, 0], np.float32),
    }


@pytest.mark.parametrize("name", ["p3d_63", "c3d"])
def test_train_step_matches_jax_f64(name):
    """One step of both ``make_train_step``s from the same weights, in f64:
    loss within 1e-4 relative; params and statistics within 1e-3 of the
    largest |value| per tensor; what each tensor moved by within 1e-2 of
    its largest |movement| (the first bound alone would not see a wrong
    update). One step: a second one amplifies the f32 rounding of the
    updated params (the params stay f32) by up to 1e4 in P3D-63's BatchNorm
    over 32 samples a channel in stage 4, so it would test the
    conditioning, not the port."""
    with jax.enable_x64(True):
        jcfg, tcfg = _step_cfgs(name)
        crop = _STEP_GEOMETRY[name][1]
        tm, variables = port_model(name, (1, 16, *crop, 3), dtype=torch.float64)
        jm = jzoo.get_model(name, num_classes=NUM_CLASSES, dtype=jnp.float64, dropout=0.0)
        jstate = JTrainState.create(apply_fn=jm.apply, params=variables["params"],
                                    batch_stats=variables.get("batch_stats", {}),
                                    tx=jlr.make_optimizer(jcfg.train, 2))
        tstate = create_train_state(tcfg, 2, device="cpu", model=tm)
        start = {k: v.numpy().copy() for k, v in tm.state_dict().items()}
        jstep = jloop.make_train_step(jm, jcfg, donate=False)
        tstep = tloop.make_train_step(tstate.model, tcfg)
        for i in range(1):
            batch = _step_batch(name, i)
            jstate, jmet = jstep(jstate, batch, jax.random.PRNGKey(i))
            tstate, tmet = tstep(tstate, batch)
            assert float(tmet["loss"]) == pytest.approx(float(jmet["loss"]), rel=1e-4)
            ref = {k: v.numpy() for k, v in from_jax_variables(jax.tree.map(
                np.asarray, {"params": jstate.params,
                             "batch_stats": jstate.batch_stats})).items()}
            got = {k: v.numpy() for k, v in tstate.model.state_dict().items()}
            assert set(got) == set(ref)
            err, key = worst(got, ref)
            assert err <= 1e-3, (i, key, err)
            moved = {k: ref[k] - start[k] for k in ref}
            err, key = worst({k: got[k] - start[k] for k in ref}, moved)
            assert err <= 1e-2, (i, key, err)
