"""RG-LRU linear recurrence — the CUDA kernel in ``csrc/rglru_scan.cu``.

Replaces the Pallas TPU kernel ``repro.kernels.rglru_scan.rglru_scan_kernel``:
``h_t = a_t h_{t-1} + b_t`` over (B, S, L) f32, with an optional ``h0``
folded in as ``a_0 h0``.  One thread per (row, channel) walks S with h in a
register and its next loads in flight; see the source for the design and its
bound.  The plain PyTorch version is ``ref.ref_rglru``.

Layout: a, b (B, S, L) f32 contiguous; h0 (B, L) f32 -> y (B, S, L) f32.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

_P = ctypes.c_void_p
_I = ctypes.c_int


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
