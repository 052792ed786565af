"""Hand-written Hopper (sm_90a) CUDA kernels of the port, each beside its
plain PyTorch version; ``ops`` is the dispatching public API and
``build`` compiles ``csrc/*.cu`` with nvcc at first use."""
from . import ops

__all__ = ["ops"]
