"""Mamba2 SSD chunk scan — the CUDA kernels in ``csrc/ssd_scan.cu``.

Replaces the Pallas TPU kernel ``repro.kernels.ssd_scan.ssd_scan_kernel``:
per chunk, the decay-masked intra-chunk ``C B^T`` term, the incoming
state's term and the (H, P, N) f32 state recurrence.  Three launches per
call, chunk-parallel on the tensor cores (split TF32, f32 accuracy): every
chunk's own state and each chunk's ``C B^T`` once per group, then the short
recurrence over the chunks, then every chunk's outputs; see the source for
the design and its bound.  The plain PyTorch version is ``ref.ssd_chunk_scan``
(the core of ``ref.ssd_chunked``); ``ref.ssd_chunk_scan_split`` repeats the
kernels' decomposition; the oracle is ``ref.ref_ssd``.

Layout: x (B, S, H, P) f32, already scaled by dt; dta (B, S, H) f32
log-decays; b/c (B, S, G, N) f32 or bf16 -> y (B, S, H, P) f32 (no D skip),
h_final (B, H, P, N) f32.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build

CHUNK = 64                      # tokens per chunk inside the kernels (csrc: Q)
HEAD_DIM = 64                   # head dim P (csrc: P)
STATE = 128                     # state size N (csrc: N)
SHAPES = ((HEAD_DIM, STATE, 1),)  # (P, N, G) the kernels are instantiated for
LAUNCHES = ("chunk", "pass", "output")  # in order, csrc: ssd_scan_smem_bytes(i)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int


def smem_blocks(launch: str):
    """Shared-memory working set per CTA of one of the ``LAUNCHES``, for
    ``MemoryPlanner.check_smem`` (csrc: CHUNK_SMEM, none, OUT_SMEM)."""
    f32 = np.dtype("float32")
    return {"chunk": [((CHUNK, STATE + 8), f32),          # B rows
                      ((CHUNK, STATE + 8), f32)],         # C rows, or x rows and decays
            "pass": [],                                   # registers only
            "output": [((CHUNK, STATE + 4), f32),         # C rows
                       ((HEAD_DIM, STATE + 4), f32),      # the incoming state h[p][n]
                       ((CHUNK, HEAD_DIM + 8), f32),      # x rows
                       ((CHUNK, CHUNK + 4), f32),         # masked, decayed C B^T
                       ((CHUNK,), f32)]}[launch]          # cum


def _fn():
    lib = build.library("ssd_scan")
    fn = lib.ssd_scan
    if fn.argtypes is None:
        fn.argtypes = [_P] * 9 + [_I] * 7 + [_P]
        fn.restype = _I
        lib.ssd_scan_error_string.argtypes = [_I]
        lib.ssd_scan_error_string.restype = ctypes.c_char_p
    return lib, fn


def ssd_scan_kernel(x, dta, b_mat, c_mat):
    """Launch the three kernels on CUDA tensors; returns new (y, h_final)
    tensors.  Raises ``ValueError`` on inputs the kernels do not take."""
    bsz, s, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    if (p, n, g) not in SHAPES:
        raise ValueError(f"(P, N, G) = {(p, n, g)} not in {SHAPES}")
    if tuple(dta.shape) != (bsz, s, h) or tuple(b_mat.shape) != (bsz, s, g, n) \
            or c_mat.shape != b_mat.shape or h % g:
        raise ValueError(f"shapes x {tuple(x.shape)}, dta {tuple(dta.shape)}, "
                         f"b {tuple(b_mat.shape)}, c {tuple(c_mat.shape)} do "
                         "not match")
    if s == 0:
        raise ValueError("empty sequence")
    for name, t in (("x", x), ("dta", dta), ("b_mat", b_mat), ("c_mat", c_mat)):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"{name} must lie on x's CUDA device, got {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if x.dtype != torch.float32 or dta.dtype != torch.float32:
        raise ValueError(f"x and dta must be float32, got {x.dtype}/{dta.dtype}")
    if b_mat.dtype not in DTYPE_CODES or c_mat.dtype != b_mat.dtype:
        raise ValueError(f"b/c dtypes {b_mat.dtype}/{c_mat.dtype}: need one of "
                         f"{list(DTYPE_CODES)} for both")
    y = torch.empty_like(x)
    h_fin = torch.empty((bsz, h, p, n), dtype=torch.float32, device=x.device)
    nc = -(-s // CHUNK)
    f32 = dict(dtype=torch.float32, device=x.device)
    states = torch.empty((bsz, nc, h, p, n), **f32)     # s_c, then h entering c
    cb = torch.empty((bsz, nc, g, CHUNK, CHUNK), **f32)
    cum = torch.empty((bsz, nc, h, CHUNK), **f32)
    lib, fn = _fn()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), dta.data_ptr(), b_mat.data_ptr(),
                 c_mat.data_ptr(), y.data_ptr(), h_fin.data_ptr(),
                 states.data_ptr(), cb.data_ptr(), cum.data_ptr(), bsz, s, h,
                 g, p, n, DTYPE_CODES[b_mat.dtype], stream)
    if err:
        raise RuntimeError("ssd_scan launch failed: "
                           f"{lib.ssd_scan_error_string(err).decode()}")
    return y, h_fin
