"""Command-line entry points (``python -m fastvideotagging_tpu_torch.cli.train``)."""
