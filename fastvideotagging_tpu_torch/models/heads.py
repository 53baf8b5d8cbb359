"""Losses and output heads (counterpart of
``fastvideotagging_tpu/models/heads.py``).

Both losses compute in float32 whatever the model's compute dtype and reduce
by a weighted mean over the batch: ``weights`` masks padding examples (0/1
per example), and the sum is divided by ``max(sum(weights), 1)``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          weights: torch.Tensor | None = None) -> torch.Tensor:
    """Single-label CE. logits (B, K), labels (B,) int."""
    losses = F.cross_entropy(logits.float(), labels.long(), reduction="none")
    return _weighted_mean(losses, weights)


def sigmoid_bce(logits: torch.Tensor, multihot: torch.Tensor,
                weights: torch.Tensor | None = None) -> torch.Tensor:
    """Multi-label sigmoid BCE. logits (B, K), multihot (B, K) {0,1}; the
    mean over classes is taken first."""
    losses = F.binary_cross_entropy_with_logits(
        logits.float(), multihot.float(), reduction="none").mean(dim=-1)
    return _weighted_mean(losses, weights)


def _weighted_mean(losses: torch.Tensor, weights: torch.Tensor | None) -> torch.Tensor:
    if weights is None:
        return losses.mean()
    weights = weights.float()
    return (losses * weights).sum() / torch.clamp(weights.sum(), min=1.0)


def predict_scores(logits: torch.Tensor, multilabel: bool) -> torch.Tensor:
    """Logits -> per-class scores: sigmoid (multilabel) or softmax, in f32."""
    logits = logits.float()
    return torch.sigmoid(logits) if multilabel else torch.softmax(logits, dim=-1)
