"""End-to-end offline demo: generate videos -> train -> evaluate -> tag
(the port of the JAX package's ``examples/train_synthetic.py``).

Runs on the card, or on the host with ``--device cpu``, with no external
data:

    python -m fastvideotagging_tpu_torch.examples.train_synthetic [--model tiny3d] \\
        [--epochs 10] [--source pack]

Generates a tiny synthetic action dataset (class = motion direction and
speed), trains with the full pipeline (loader workers -> uint8 batches ->
preprocess on the device -> train step), evaluates with multi-clip
aggregation, exports the weights, and tags a video with ``Tagger`` built
from the exported file. ``--source mp4`` (the default) writes ``.mp4``
files as the JAX file does (needs cv2); ``pack`` writes the same frames
into an ``.fvtpack``, for a machine without cv2.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

from fastvideotagging_tpu_torch._device import resolve_device
from fastvideotagging_tpu_torch.config import (
    ClipSamplerConfig,
    DataConfig,
    ExperimentConfig,
    ModelConfig,
    ParallelConfig,
    TrainConfig,
)
from fastvideotagging_tpu_torch.data import synthetic
from fastvideotagging_tpu_torch.data.packed import Pack, PackedDataset, write_pack_from_arrays
from fastvideotagging_tpu_torch.data.pipeline import ClipDataset
from fastvideotagging_tpu_torch.data.ucf101 import load_video_list
from fastvideotagging_tpu_torch.evaluation.evaluate import evaluate
from fastvideotagging_tpu_torch.evaluation.tagger import Tagger, iter_pack_tags
from fastvideotagging_tpu_torch.train.checkpoint import export_weights, load_weights
from fastvideotagging_tpu_torch.train.fit import fit

SOURCE_HW = (64, 80)
VIDEOS_PER_CLASS = 2
NUM_FRAMES = 32


def demo_config(model: str, classes: int, epochs: int, batch: int, root: str) -> ExperimentConfig:
    """The JAX file's config, field for field (``kernels`` takes the port's
    default)."""
    return ExperimentConfig(
        model=ModelConfig(name=model, num_classes=classes, compute_dtype="float32"),
        data=DataConfig(source_hw=SOURCE_HW, resize_hw=(56, 72), crop_hw=(48, 48),
                        sampler=ClipSamplerConfig(clip_len=8, stride=2, eval_mode="dense"),
                        num_workers=4),
        train=TrainConfig(batch_size=batch, num_epochs=epochs, base_lr=0.03,
                          weight_decay=0.0, log_every=2, checkpoint_dir=f"{root}/ckpt"),
        parallel=ParallelConfig(data_parallel=1),
    )


def make_source(root: str, classes: int, source: str):
    """The dataset under ``root``: video records (mp4) or a pack path."""
    if source == "mp4":
        return load_video_list(synthetic.make_dataset(
            root, num_classes=classes, videos_per_class=VIDEOS_PER_CLASS,
            num_frames=NUM_FRAMES, height=SOURCE_HW[0], width=SOURCE_HW[1]), root=root)
    items = ((f"class_{k}/v_{k}_{i}.mp4", k, (),
              synthetic.make_frames(k, NUM_FRAMES, *SOURCE_HW, seed=i))
             for k in range(classes) for i in range(VIDEOS_PER_CLASS))
    path = os.path.join(root, "train.fvtpack")
    write_pack_from_arrays(items, path, SOURCE_HW)
    return path


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", default="tiny3d")
    p.add_argument("--classes", type=int, default=4)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--source", choices=["mp4", "pack"], default="mp4")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    with tempfile.TemporaryDirectory() as root:
        print(f"generating synthetic dataset in {root} ...")
        src = make_source(root, args.classes, args.source)
        cfg = demo_config(args.model, args.classes, args.epochs, args.batch, root)
        state = fit(cfg, src, device=dev)

        ds = (ClipDataset(src, cfg.data, mode="eval") if args.source == "mp4"
              else PackedDataset(src, cfg.data, mode="eval"))
        metrics = evaluate(state.model, state.model.state_dict(), ds, cfg, clip_batch=4)
        print("eval:", json.dumps(metrics))

        export_weights(f"{root}/weights", state.model.state_dict())
        tagger = Tagger(cfg, load_weights(f"{root}/weights"),
                        tag_names=[f"action_{i}" for i in range(args.classes)],
                        clip_batch=4, device=dev)
        if args.source == "mp4":
            results = tagger.tag(src[0].path, threshold=0.0, top_k=3)
        else:
            results = next(iter_pack_tags(tagger, Pack(src), threshold=0.0, top_k=3))[1]
        tagged = [(r.tag, round(r.score, 3)) for r in results]
        print("tag(video):", tagged)
    return {"eval": metrics, "tags": tagged, "steps": int(state.step), "device": str(dev)}


if __name__ == "__main__":
    main()
