"""Mamba2 SSD chunk scan — the CUDA kernels in ``csrc/ssd_scan.cu``.

Replaces the Pallas TPU kernel ``repro.kernels.ssd_scan.ssd_scan_kernel``:
per chunk, the decay-masked intra-chunk ``C B^T`` term, the incoming
state's term and the (H, P, N) f32 state recurrence.  Three launches per
call, chunk-parallel on the tensor cores (split TF32, f32 accuracy): every
chunk's own state and each chunk's ``C B^T`` once per group, then the short
recurrence over the chunks, then every chunk's outputs; see the source for
the design and its bound.  Every head dim P that is a multiple of 8 up to
64, every state size N that is one up to 256 and every G that divides H
runs, on the instance of padded width (64, 128) or (64, 256)
(:func:`instance`): the kernels zero-fill the rows and columns past the true
sizes as they stage them, so x, B and C are passed as they are.  The plain
PyTorch version is ``ref.ssd_chunk_scan`` (the core of
``ref.ssd_chunked``); ``ref.ssd_chunk_scan_split`` repeats the kernels'
decomposition; the oracle is ``ref.ref_ssd``.

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
HEAD_DIM = 64                   # the head dim's padded width, the largest P (csrc: P)
STATES = (128, 256)             # the state size's padded widths (csrc: Inst<N>)
LAUNCHES = ("chunk", "pass", "output")  # in order, csrc: ssd_scan_smem_bytes(i)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int


def instance(p: int, n: int, g: int, h: int) -> tuple[int, int]:
    """The padded (P, N) of the instance that runs head dim ``p``, state
    size ``n`` and ``g`` groups over ``h`` heads (csrc: ``instance``):
    (64, 128) for n <= 128, (64, 256) above.  Raises ``ValueError`` outside
    the rule."""
    if p % 8 or not 8 <= p <= HEAD_DIM or n % 8 or not 8 <= n <= STATES[-1] \
            or g < 1 or h % g:
        raise ValueError(f"(P, N, G) = {(p, n, g)} over {h} heads: the SSD kernels "
                         f"take P a multiple of 8 up to {HEAD_DIM}, N a multiple "
                         f"of 8 up to {STATES[-1]} and G a divisor of H")
    return HEAD_DIM, next(w for w in STATES if n <= w)


def smem_blocks(launch: str, p: int, n: int):
    """Shared-memory working set per CTA of one of the ``LAUNCHES`` of the
    instance that runs head dim ``p`` and state size ``n``, for
    ``MemoryPlanner.check_smem`` (csrc: CHUNK_SMEM, none, OUT_SMEM)."""
    pw, nw = instance(p, n, 1, 1)
    f32 = np.dtype("float32")
    return {"chunk": [((CHUNK, nw + 8), f32),             # B rows
                      ((CHUNK, nw + 8), f32)],            # C rows, or x rows and decays
            "pass": [],                                   # registers only
            "output": [((CHUNK, nw + 4), f32),            # C rows
                       ((pw, nw + 4), f32),               # the incoming state h[p][n]
                       ((CHUNK, pw + 8), f32),            # x rows
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
    instance(p, n, g, h)
    if tuple(dta.shape) != (bsz, s, h) or tuple(b_mat.shape) != (bsz, s, g, n) \
            or c_mat.shape != b_mat.shape:
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
