"""Runnable examples of the port (``python -m
fastvideotagging_tpu_torch.examples.<name>``)."""
