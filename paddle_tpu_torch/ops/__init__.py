"""Ops of the port: plain ops on the GPT path (``linalg``, ``math``) and
the CUDA kernels (``cuda``)."""
from .linalg import matmul
from .math import add

__all__ = ["add", "matmul"]
