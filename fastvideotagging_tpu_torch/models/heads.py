"""Output heads (counterpart of ``fastvideotagging_tpu/models/heads.py``).

The losses wait for the training slice."""

from __future__ import annotations

import torch


def predict_scores(logits: torch.Tensor, multilabel: bool) -> torch.Tensor:
    """Logits -> per-class scores: sigmoid (multilabel) or softmax, in f32."""
    logits = logits.float()
    return torch.sigmoid(logits) if multilabel else torch.softmax(logits, dim=-1)
