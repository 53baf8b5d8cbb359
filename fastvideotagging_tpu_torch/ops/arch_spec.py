"""Architecture helpers (the counterpart of part of
``fastvideotagging_tpu/ops/arch_spec.py``).

Only ``tf_same_pads`` is ported, for I3D's TF-SAME convs and pools; the
rest of that module (the conv-site IR behind the int8 engine) is
ROADMAP.md Queue A item 5.
"""

from __future__ import annotations


def tf_same_pads(size: int, k: int, s: int) -> tuple[int, int]:
    """TF-SAME padding for one dim: out = ceil(size/s), the extra pixel on
    the high side (TensorFlow semantics; i3d). For stride 1 and odd k this
    equals the symmetric k//2; it differs only on strided even inputs."""
    out = -(-size // s)
    pad = max((out - 1) * s + k - size, 0)
    return (pad // 2, pad - pad // 2)
