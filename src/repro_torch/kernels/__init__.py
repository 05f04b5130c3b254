"""Hand-written CUDA kernels for Hopper (``csrc/``), their wrappers, their
plain PyTorch versions and the oracles they are held against."""


class KernelShapeError(ValueError):
    """Host-side kernel argument/shape contract violation."""
