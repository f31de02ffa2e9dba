"""Multi-device runs of the port (counterpart of `bisinger_tpu/parallel/`):
the `data` axis, one process per card (`mesh.py`); the `seq` axis,
long-form synthesis with each rank's frames widened by a halo
(`sequence.py`); the `pipe` axis, the DiffNet's layers in stages
(`pipeline.py`); the `model` axis, tensor parallelism of the DiffNet, the
PitchExtractor and the HiFi-GAN's MRF pairs (`tensor.py`). The meshes are
`groups.py`'s."""
