"""Hand-written CUDA kernels for Hopper (sm_90a): flash-attention prefill and
paged decode attention (page tables consumed in-kernel).  ``ops`` holds the
model-layout wrappers with their launch counters, ``ref`` the plain PyTorch
versions, ``build`` compiles ``csrc/*.cu`` with nvcc at first use.  Importing
this package builds nothing and imports no ``triton``."""
from . import ops, ref

__all__ = ["ops", "ref"]
