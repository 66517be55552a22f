"""Hand-written CUDA kernels for Hopper (sm_90a): flash-attention prefill,
paged decode attention (page tables consumed in-kernel), the Mamba2 SSD
chunk scan and the RG-LRU linear recurrence.  ``ops`` holds the
model-layout wrappers with their launch counters, ``ref`` the plain PyTorch
versions, ``build`` compiles ``csrc/*.cu`` with nvcc at first use.  Importing
this package builds nothing and imports no ``triton``."""
from . import ops, ref

__all__ = ["ops", "ref"]
