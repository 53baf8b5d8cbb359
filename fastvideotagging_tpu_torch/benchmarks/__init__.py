"""Benchmarks of the port that run on the card (``kernel_micro``: the
temporal conv's kernel designs against the library conv; ``accuracy_hard``:
r2plus1d_18 trained end to end on the hard synthetic motion task)."""
