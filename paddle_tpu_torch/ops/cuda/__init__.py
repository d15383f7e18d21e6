"""Hand-written CUDA kernels for Hopper (``csrc/*.cu``, built at first
use by ``_build``) with their wrappers and plain PyTorch versions."""
