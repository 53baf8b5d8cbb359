"""C3D backbone (Tran et al. ICCV'15), the counterpart of
``fastvideotagging_tpu/models/c3d.py``.

8x conv3d(3x3x3, biased) + ReLU, 5x maxpool3d (the first spatial only), 2x
FC-4096 with dropout, classifier ``fc8``. No norm layers (paper-faithful).
Every conv is a full 3D conv, so C3D runs no hand kernel: ``F.conv3d``, as
the JAX package runs it in XLA.

Flax's ``Dense`` infers ``fc6``'s input size from its input; ``nn.Linear``
is told it: ``clip_shape`` (T, H, W) gives pool5's geometry. The canonical
16x112x112 clip -> pool5 1x4x4x512 -> 8192. The flatten is NTHWC's
(T, H, W, C) order, as in the JAX model.
"""

from __future__ import annotations

import torch
from torch import nn

from fastvideotagging_tpu_torch.models.layers import Conv3D, dense, dropout, max_pool_3d

_CONVS = (("conv1", 64), ("conv2", 128), ("conv3a", 256), ("conv3b", 256),
          ("conv4a", 512), ("conv4b", 512), ("conv5a", 512), ("conv5b", 512))
# pool5 pads spatially (7 -> 4 at 112 input), symmetrically as torch/MXNet
# do, so the classic-C3D checkpoint import stays exact.
_POOL5_PADS = ((0, 0), (1, 1), (1, 1))


def pool5_shape(clip_shape) -> tuple[int, int, int]:
    """(T, H, W) of pool5's output for a (T, H, W) clip."""
    t, h, w = clip_shape
    t, h, w = t, h // 2, w // 2  # pool1 (1, 2, 2)
    for _ in range(3):  # pool2-4 (2, 2, 2), VALID
        t, h, w = t // 2, h // 2, w // 2
    return tuple((n + lo + hi - 2) // 2 + 1 for n, (lo, hi) in zip((t, h, w), _POOL5_PADS))


class C3D(nn.Module):
    def __init__(self, num_classes: int = 101, dropout: float = 0.5,
                 dtype: torch.dtype = torch.bfloat16, clip_shape=(16, 112, 112),
                 generator: torch.Generator | None = None):
        super().__init__()
        if not 0.0 <= dropout < 1.0:
            raise ValueError(f"dropout must be in [0, 1), got {dropout}")
        self.dtype = dtype
        self.dropout = dropout
        self.clip_shape = tuple(clip_shape)
        cin = 3
        for name, features in _CONVS:
            self.add_module(name, Conv3D(cin, features, (3, 3, 3), use_bias=True,
                                         dtype=dtype, generator=generator))
            cin = features
        t, h, w = pool5_shape(self.clip_shape)
        if min(t, h, w) < 1:
            raise ValueError(f"clip {self.clip_shape} is too small for C3D's five pools")
        self.fc6 = dense(512 * t * h * w, 4096, generator)
        self.fc7 = dense(4096, 4096, generator)
        self.fc8 = dense(4096, num_classes, generator)

    def _dense(self, fc: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        """Flax ``Dense(dtype=self.dtype)``: input, kernel and bias in the
        compute dtype."""
        return nn.functional.linear(x.to(self.dtype), fc.weight.to(self.dtype),
                                    fc.bias.to(self.dtype))

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        """``generator`` (on x's device) draws the train-mode dropout masks."""
        train = self.training
        x = x.to(self.dtype)
        x = torch.relu(self.conv1(x))
        x = max_pool_3d(x, (1, 2, 2), train=train)
        x = torch.relu(self.conv2(x))
        x = max_pool_3d(x, (2, 2, 2), train=train)
        x = torch.relu(self.conv3b(torch.relu(self.conv3a(x))))
        x = max_pool_3d(x, (2, 2, 2), train=train)
        x = torch.relu(self.conv4b(torch.relu(self.conv4a(x))))
        x = max_pool_3d(x, (2, 2, 2), train=train)
        x = torch.relu(self.conv5b(torch.relu(self.conv5a(x))))
        x = max_pool_3d(x, (2, 2, 2), padding=_POOL5_PADS, train=train)
        x = x.reshape(x.shape[0], -1)
        if x.shape[1] != self.fc6.in_features:
            raise ValueError(
                f"pool5 gives {x.shape[1]} features, fc6 takes {self.fc6.in_features}: "
                f"build C3D with this clip's clip_shape (it has {self.clip_shape})")
        x = dropout(torch.relu(self._dense(self.fc6, x)), self.dropout, train, generator)
        x = dropout(torch.relu(self._dense(self.fc7, x)), self.dropout, train, generator)
        return self.fc8(x.float())
