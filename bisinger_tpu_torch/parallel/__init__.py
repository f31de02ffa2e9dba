"""Multi-device training of the port (counterpart of `bisinger_tpu/parallel/`):
the `data` axis, one process per card (`mesh.py`). Tensor, sequence and
pipeline parallelism are not ported (ROADMAP Queue 1 item 5)."""
