"""Multi-device runs of the port (counterpart of `bisinger_tpu/parallel/`):
the `data` axis, one process per card (`mesh.py`); the `seq` axis,
long-form synthesis with each rank's frames widened by a halo
(`sequence.py`); the `pipe` axis, the DiffNet's layers in stages
(`pipeline.py`). Tensor parallelism is not ported (ROADMAP Queue 1 item 3)."""
