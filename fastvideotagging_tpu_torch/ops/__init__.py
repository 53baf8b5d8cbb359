"""Device ops: preprocess and the factorized (2+1)D conv kernels."""
