"""The native serving tier (the counterpart of ``fastvideotagging_tpu/native/``).

``native.runner`` builds and drives the C++ runner (csrc/native_runner.cpp),
which runs the serving program's AOTInductor package
(``evaluation.serving.export_serving_native``) with no Python in its
process. The reference package's ``native/__init__.py`` is its host
data plane (``framepack.c``: the C resize and clip packing, and their numpy
fallbacks); that part is not ported yet (ROADMAP.md Queue A item 6: which
resize tier is the spec comes first, Queue C item 1).
"""
