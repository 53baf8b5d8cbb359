"""Benchmarks of the port that run on the card (``kernel_micro``: the
temporal conv's kernel designs against the library conv)."""
