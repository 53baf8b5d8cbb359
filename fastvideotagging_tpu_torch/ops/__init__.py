"""Device ops: preprocess and the factorized (2+1)D conv kernels.

Importing the package registers the serving kernels' custom ops
(``fvt::*``, ops/library.py), which the wrappers call."""

from fastvideotagging_tpu_torch.ops import library  # noqa: F401
