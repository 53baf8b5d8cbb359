"""The port's hard accuracy benchmark on the card, as committed: r2plus1d_18
trained by the port (``fastvideotagging_tpu_torch.benchmarks.accuracy_hard``)
on the 50 motion classes and the 24-tag multi-label set, held to the JAX
package's thresholds (tests/test_synthetic_motion.py): top-1 >= 0.85 and mAP
>= 0.9; multi-label mAP >= 0.85, macro-F1 >= 0.75, top-2 exact set >= 0.7.
Each record names its route and the card it ran on."""

import json
import os

import pytest

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "fastvideotagging_tpu_torch", "benchmarks")


def _record(name):
    path = os.path.join(BENCH, name)
    assert os.path.exists(path), (
        f"{name} missing: run python -m fastvideotagging_tpu_torch.benchmarks.accuracy_hard "
        f"--source pack on the card with --out {path}")
    with open(path) as f:
        r = json.load(f)
    assert r["source"] in ("mp4", "pack")
    assert r["device"].startswith("cuda") and r["card"] and "," in r["card"], r
    return r


def test_recorded_port_benchmark_meets_the_reference_threshold():
    r = _record("ACCURACY_HARD.json")
    assert r["model"] == "r2plus1d_18" and r["num_classes"] >= 50
    assert r["top1"] >= 0.85, r
    assert r["mAP"] >= 0.9, r


def test_recorded_port_tagging_benchmark_meets_the_reference_threshold():
    r = _record("ACCURACY_TAGGING.json")
    assert r["model"].startswith("r2plus1d_18") and r["num_tags"] >= 24
    assert r["objects_per_video"] >= 2
    assert r["mAP"] >= 0.85, r
    assert r["macro_f1"] >= 0.75, r
    assert r["top2_exact_set"] >= 0.7, r


@pytest.mark.parametrize("name", ["ACCURACY_HARD.json", "ACCURACY_TAGGING.json"])
def test_recorded_run_is_the_reference_recipe(name):
    """720 steps (60 epochs of 12 at B = 64; the JAX record's run) and 2070
    (90 epochs of 23), seed 0, the full sets."""
    r = _record(name)
    if name == "ACCURACY_HARD.json":
        assert (r["epochs"], r["steps"], r["train_videos"], r["eval_videos"]) == (60, 720, 800, 200)
    else:
        assert (r["epochs"], r["steps"], r["train_videos"], r["eval_videos"]) == (
            90, 2070, 1500, 200)
    assert r["seed"] == 0
