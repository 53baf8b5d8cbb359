"""Benchmarks of the port that run on the card (``kernel_micro``: the
temporal conv's kernel designs against the library conv; ``accuracy_hard``:
a zoo backbone trained end to end on the hard synthetic motion task;
``accuracy_kinetics_geom``: s3d trained at the Kinetics clip shape;
``int8_serving``, ``int8_s3d``, ``int8_family``, ``int8_inception``: the
int8 engine's top-1 on trained weights and its serving throughput)."""
