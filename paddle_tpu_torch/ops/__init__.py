"""Kernels of the port (``ops/cuda``), the counterparts of
``paddle_tpu/ops/pallas``."""
