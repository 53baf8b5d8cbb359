"""Metrics: top-k accuracy, loss averaging, per-tag P/R.

A copy of ``fastvideotagging_tpu/train/metrics.py`` (numpy only). The
device-side metric math stays inside the train step; this module holds the
host-side accumulators and the multi-label per-tag statistics.
"""

from __future__ import annotations

import numpy as np


class RunningMean:
    """Weighted running average of host scalars (loss, accuracy)."""

    def __init__(self):
        self.total = 0.0
        self.weight = 0.0

    def update(self, value: float, weight: float = 1.0) -> None:
        self.total += float(value) * weight
        self.weight += weight

    @property
    def value(self) -> float:
        return self.total / self.weight if self.weight > 0 else float("nan")

    def reset(self) -> None:
        self.total = 0.0
        self.weight = 0.0


def topk_accuracy(scores: np.ndarray, labels: np.ndarray, k: int = 1) -> float:
    """Fraction of rows whose label is in the top-k scores. scores (N,K)."""
    scores = np.asarray(scores)
    labels = np.asarray(labels)
    topk = np.argsort(-scores, axis=-1)[:, :k]
    return float((topk == labels[:, None]).any(axis=1).mean())


def per_tag_precision_recall(
    scores: np.ndarray, multihot: np.ndarray, threshold: float = 0.5
) -> dict[str, np.ndarray]:
    """Per-tag precision/recall/F1 at a score threshold. scores (N,K)."""
    pred = np.asarray(scores) >= threshold
    true = np.asarray(multihot) >= 0.5
    tp = (pred & true).sum(axis=0).astype(np.float64)
    fp = (pred & ~true).sum(axis=0).astype(np.float64)
    fn = (~pred & true).sum(axis=0).astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        precision = np.where(tp + fp > 0, tp / (tp + fp), 0.0)
        recall = np.where(tp + fn > 0, tp / (tp + fn), 0.0)
        f1 = np.where(precision + recall > 0,
                      2 * precision * recall / (precision + recall), 0.0)
    return {"precision": precision, "recall": recall, "f1": f1,
            "support": true.sum(axis=0)}


def mean_average_precision(scores: np.ndarray, multihot: np.ndarray) -> float:
    """Macro mAP over tags with at least one positive."""
    scores = np.asarray(scores)
    true = np.asarray(multihot) >= 0.5
    aps = []
    for k in range(scores.shape[1]):
        t = true[:, k]
        if not t.any():
            continue
        order = np.argsort(-scores[:, k], kind="stable")
        t_sorted = t[order]
        cum_tp = np.cumsum(t_sorted)
        precision_at = cum_tp / (np.arange(len(t_sorted)) + 1)
        aps.append((precision_at * t_sorted).sum() / t_sorted.sum())
    return float(np.mean(aps)) if aps else float("nan")
