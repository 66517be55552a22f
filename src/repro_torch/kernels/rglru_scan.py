"""RG-LRU linear recurrence — the CUDA kernel in ``csrc/rglru_scan.cu``.

Replaces the Pallas TPU kernel ``repro.kernels.rglru_scan.rglru_scan_kernel``:
``h_t = a_t h_{t-1} + b_t`` over (B, S, L) f32, with an optional ``h0``
folded in as ``a_0 h0``.  A CTA of ``WARPS`` warps owns one row and 32
channels and splits S across its warps: in each super-chunk of
``WARPS * SEG`` steps every warp folds its ``SEG`` steps into an aggregate,
the aggregates are folded onto the CTA's carry in shared memory, and every
warp re-walks its steps from its true incoming state (one pass, no global
scratch); see the source for the design and its bound.  The plain PyTorch
version is ``ref.ref_rglru``; ``ref.ref_rglru_segmented`` repeats the
kernel's sum order.

Layout: a, b (B, S, L) f32 contiguous; h0 (B, L) f32 -> y (B, S, L) f32.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build

WARPS = 16      # csrc WARPS: segments per super-chunk
SEG = 16        # csrc SEG: steps per segment
_P = ctypes.c_void_p
_I = ctypes.c_int


def smem_blocks():
    """Shared-memory working set per CTA, for ``MemoryPlanner.check_smem``
    (csrc ``rglru_scan_smem_bytes``): each warp's (P, Y) aggregate per
    lane, double-buffered by super-chunk parity."""
    return [((2, WARPS, 32, 2), np.dtype("float32"))]


def _fn():
    lib = build.library("rglru_scan")
    fn = lib.rglru_scan
    if fn.argtypes is None:
        fn.argtypes = [_P] * 4 + [_I] * 3 + [_P]
        fn.restype = _I
        lib.rglru_scan_error_string.argtypes = [_I]
        lib.rglru_scan_error_string.restype = ctypes.c_char_p
    return lib, fn


def rglru_scan_kernel(a, b, h0=None):
    """Launch the kernel on CUDA tensors; returns a new y.  Raises
    ``ValueError`` on inputs the kernel does not take."""
    if a.dim() != 3 or b.shape != a.shape:
        raise ValueError(f"a {tuple(a.shape)} / b {tuple(b.shape)}: need two "
                         "(B, S, L) tensors of one shape")
    bsz, s, l = a.shape
    if h0 is not None and tuple(h0.shape) != (bsz, l):
        raise ValueError(f"h0 {tuple(h0.shape)} is not (B, L) = {(bsz, l)}")
    for name, t in (("a", a), ("b", b), ("h0", h0)):
        if t is None:
            continue
        if t.device.type != "cuda" or t.device != a.device:
            raise ValueError(f"{name} must lie on a's CUDA device, got {t.device}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32, got {t.dtype}")
    y = torch.empty_like(a)
    lib, fn = _fn()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(a.data_ptr(), b.data_ptr(),
                 None if h0 is None else h0.data_ptr(), y.data_ptr(),
                 bsz, s, l, stream)
    if err:
        raise RuntimeError("rglru_scan launch failed: "
                           f"{lib.rglru_scan_error_string(err).decode()}")
    return y
