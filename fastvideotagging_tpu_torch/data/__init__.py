"""Host data path: clip sampling, decode, resize, synthetic frames."""
