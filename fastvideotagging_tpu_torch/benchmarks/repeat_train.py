"""Repeatable training on the card: two trainings of one recipe from one
seed, compared tensor by tensor, and the train step's time.

For each model (s3d, i3d, c3d and p3d_63, the families with a max pool,
and r2plus1d_18, which has none):

* ``fit`` twice from one seed on one seeded motion set (FIT_CLASSES classes
  of FIT_VIDEOS train videos, written as packs; B = 64, one step an epoch,
  FIT_EPOCHS epochs), then the two final state_dicts, parameters and
  BatchNorm statistics, compared: equal bit for bit, or how many tensors
  differ and by how much;
* ``--time-only``, in place of the trainings: the train step
  (``make_train_step``) of each pooled family at ``int8_hard_config``'s
  B = 64 on seeded uint8 clips, timed by ``utils/profiling.py::window_ms``
  (the fastest of WINDOWS windows of ITERS steps after one not kept);
  ``--split``: the step timed three ways in turns (``step_split``), which
  tells the deterministic mode's costs apart.

``pool_calls`` lists the max pools (each 1-D pool of 'sep') of a model's
train-mode forward at B = 64, the sites at which chip_smoke.py and the GPU
tests hold csrc/maxpool_grad.cu against its plain version.

Each model takes its record's recipe (``RECIPES``): the accuracy geometry
8x32x32, C3D its record's 16x32x32 at stride 1 (at 8 frames its pool5 is
empty), grad clip 1.0 for the Inception families and C3D.

    python -m fastvideotagging_tpu_torch.benchmarks.repeat_train --out chiprun_out/REPEAT.json
    python -m fastvideotagging_tpu_torch.benchmarks.repeat_train --time-only

Without ``--split`` it calls only ``fit``, ``make_train_step``,
``create_train_state`` and ``window_ms``, whose signatures older checkouts
of the repo share, so the same file run from such a checkout (copied into
its package) measures that tree: a tree before the deterministic training
gives its trainings' spread and its step times. Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import shutil
import tempfile
import time

import numpy as np
import torch

from fastvideotagging_tpu_torch._device import resolve_device
from fastvideotagging_tpu_torch.benchmarks.accuracy_hard import VIDEO_HW, _packs
from fastvideotagging_tpu_torch.benchmarks.int8_family import FAMILY_RECIPES
from fastvideotagging_tpu_torch.benchmarks.int8_serving import int8_hard_config
from fastvideotagging_tpu_torch.benchmarks.kernel_micro import card
from fastvideotagging_tpu_torch.data import synthetic_motion
from fastvideotagging_tpu_torch.models.zoo import config_clip_shape, model_from_config
from fastvideotagging_tpu_torch.ops import maxpool_grad
from fastvideotagging_tpu_torch.train import loop
from fastvideotagging_tpu_torch.train.fit import fit
from fastvideotagging_tpu_torch.train.loop import make_train_step
from fastvideotagging_tpu_torch.train.state import create_train_state
from fastvideotagging_tpu_torch.utils.profiling import window_ms

POOLED = ("s3d", "i3d", "c3d", "p3d_63")
MODELS = POOLED + ("r2plus1d_18",)
RECIPES = {"s3d": dict(clip_grad_norm=1.0), "i3d": dict(clip_grad_norm=1.0),
           "c3d": {k: v for k, v in FAMILY_RECIPES["c3d"].items() if k != "base_lr"},
           "p3d_63": {}, "r2plus1d_18": {}}
BATCH = 64
FIT_CLASSES, FIT_VIDEOS, FIT_EPOCHS = 4, 16, 5  # 64 videos: one step an epoch
ITERS, WINDOWS = 5, 3


def pool_calls(model_name: str, device: torch.device, batch: int = BATCH) -> list[tuple]:
    """(x shape, dtype, window, strides, pads) of each max pool of the
    recipe's train-mode forward at ``batch`` clips (its backward's
    ``maxpool_grad`` calls), in forward order."""
    cfg = recipe_config(model_name)
    model = model_from_config(cfg.model, device=device,
                              generator=torch.Generator().manual_seed(0),
                              clip_shape=config_clip_shape(cfg.data)).train()
    d = cfg.data
    x = torch.zeros((batch, d.sampler.clip_len, *d.crop_hw, 3), device=device)
    calls, real = [], maxpool_grad._reduce_max

    def spy(a, window, strides, pads):
        calls.append((tuple(a.shape), a.dtype, window, strides, pads))
        return real(a, window, strides, pads)

    maxpool_grad._reduce_max = spy
    try:
        with torch.enable_grad():
            model(x)
    finally:
        maxpool_grad._reduce_max = real
    return calls


def site_inputs(call: tuple, gen: torch.Generator) -> tuple:
    """(x, y, ct) at a ``pool_calls`` site: x post-ReLU normals (a third of
    them are ties at 0, as in a network), y its pool, ct normals."""
    shape, dtype, window, strides, pads = call
    dev = gen.device
    x = torch.relu(torch.randn(shape, generator=gen, device=dev) + 0.5).to(dtype)
    y = maxpool_grad._reduce_max(x, window, strides, pads)
    ct = torch.randn(y.shape, generator=gen, device=dev).to(dtype)
    return x, y, ct


def recipe_config(model_name: str, epochs: int = FIT_EPOCHS, num_classes: int = FIT_CLASSES,
                  seed: int = 0):
    """The model's record recipe at B = 64 (``int8_hard_config``)."""
    base_lr = FAMILY_RECIPES["c3d"]["base_lr"] if model_name == "c3d" else 0.05
    return int8_hard_config(model_name, num_classes, epochs, BATCH, base_lr, seed,
                            **RECIPES[model_name])


def motion_packs(root: str, num_classes: int = FIT_CLASSES, seed: int = 0) -> str:
    """The seeded motion set's train pack under ``root``."""
    train, _ = _packs(root, synthetic_motion.iter_motion_videos(
        num_classes, train_per_class=FIT_VIDEOS, eval_per_class=1, seed=seed), None, VIDEO_HW)
    return train


def compare(a: dict, b: dict) -> dict:
    """Two state_dicts tensor by tensor: equal bit for bit, or the count of
    tensors that differ and the largest |difference|."""
    diff = [(a[k].float() - b[k].float()).abs().max().item()
            for k in a if not torch.equal(a[k], b[k])]
    return dict(equal=not diff, tensors=len(a), differing=len(diff),
                max_abs_diff=max(diff, default=0.0))


def two_fits(model_name: str, train_pack: str, device: torch.device,
             epochs: int = FIT_EPOCHS) -> dict:
    """``fit`` twice on ``train_pack`` from the recipe's seed, the final
    state_dicts compared (``compare``), each fit's seconds."""
    cfg = recipe_config(model_name, epochs)
    states, seconds = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        state = fit(cfg, train_pack, device=device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        seconds.append(round(time.perf_counter() - t0, 2))
        states.append({k: v.detach().clone() for k, v in state.model.state_dict().items()})
        del state
    return dict(compare(*states), steps=epochs, fit_seconds=seconds)


def seeded_batch(cfg, device: torch.device, seed: int = 0) -> dict:
    """One train batch of seeded uint8 frames at the config's shapes, on
    ``device``."""
    rng = np.random.default_rng(seed)
    d = cfg.data
    b, t = cfg.train.batch_size, d.sampler.clip_len
    h, w = d.source_hw
    room = (d.resize_hw[0] - d.crop_hw[0] + 1, d.resize_hw[1] - d.crop_hw[1] + 1)
    batch = dict(
        frames=rng.integers(0, 256, size=(b, t, h, w, 3), dtype=np.uint8),
        labels=rng.integers(0, cfg.model.num_classes, size=(b,)).astype(np.int32),
        crop_tops=rng.integers(0, room[0], size=(b,)).astype(np.int32),
        crop_lefts=rng.integers(0, room[1], size=(b,)).astype(np.int32),
        flips=np.zeros((b,), dtype=bool), weights=np.ones((b,), dtype=np.float32))
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def step_ms(model_name: str, device: torch.device, iters: int = ITERS,
            windows: int = WINDOWS) -> dict:
    """The recipe's train step at B = 64 on ``seeded_batch``: ms a step,
    the fastest window and every window."""
    cfg = recipe_config(model_name, epochs=40, num_classes=50)
    state = create_train_state(cfg, 1, device=device,
                               generator=torch.Generator().manual_seed(0))
    step = make_train_step(state.model, cfg)
    batch = seeded_batch(cfg, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    ms = window_ms({"step": lambda: step(state, batch, gen)}, iters, windows,
                   cuda=device.type == "cuda")["step"]
    d, s = cfg.data, cfg.data.sampler
    return dict(ms=min(ms), window_ms=ms, batch=BATCH,
                clip=f"{s.clip_len}x{d.crop_hw[0]}x{d.crop_hw[1]}")


def step_split(model_name: str, device: torch.device) -> dict:
    """The step as the port runs it ('port'), then with deterministic
    mode's fill of uninitialized memory off ('no_fill', torch.utils.
    deterministic.fill_uninitialized_memory), then with no deterministic
    mode at all ('gather_only': the max pools' gather backward, cuDNN's and
    cuBLAS's default algorithms), then as the port again; a diagnostic of
    where a slower step goes, not a way to train."""
    fill = torch.utils.deterministic.fill_uninitialized_memory
    real = loop.deterministic
    out = {"port": step_ms(model_name, device)}
    try:
        torch.utils.deterministic.fill_uninitialized_memory = False
        out["no_fill"] = step_ms(model_name, device)
        torch.utils.deterministic.fill_uninitialized_memory = fill
        loop.deterministic = lambda dev: contextlib.nullcontext()
        out["gather_only"] = step_ms(model_name, device)
    finally:
        torch.utils.deterministic.fill_uninitialized_memory = fill
        loop.deterministic = real
    out["port_again"] = step_ms(model_name, device)
    return out


def run(models=MODELS, mode: str = "fits", device: str = "cuda") -> dict:
    """``mode``: 'fits' (``two_fits``), 'time' (``step_ms``) or 'split'
    (``step_split``); the last two for the pooled families only."""
    dev = resolve_device(device)
    root = tempfile.mkdtemp(prefix="fvt_repeat_")
    try:
        pack = motion_packs(root) if mode == "fits" else None
        out = {}
        for m in models:
            if mode == "fits":
                out[m] = {"fits": two_fits(m, pack, dev)}
            elif m in POOLED:
                out[m] = {"step": step_ms(m, dev)} if mode == "time" else {
                    "split": step_split(m, dev)}
            else:
                continue
            print(f"[repeat_train] {m}: {out[m]}", flush=True)
        return {"benchmark": "repeat_train", "results": out, "device": str(dev),
                "card": card() if dev.type == "cuda" else None}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--models", nargs="+", default=list(MODELS))
    p.add_argument("--time-only", action="store_true",
                   help="time each pooled family's train step at B = 64, train nothing")
    p.add_argument("--split", action="store_true",
                   help="time each pooled family's step three ways (step_split), train nothing")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    mode = "split" if args.split else "time" if args.time_only else "fits"
    result = run(args.models, mode, args.device)
    line = json.dumps(result, indent=2)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return result


if __name__ == "__main__":
    main()
