# The drivers of the port (the counterparts of the reference's
# ``examples/``): ``python -m repro_torch.examples.<name>``, on the CUDA
# card unless ``--device cpu``.
