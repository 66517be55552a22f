"""Paged decode attention — the CUDA kernel in ``csrc/paged_attention.cu``.

Replaces the Pallas TPU kernel ``repro.kernels.paged_attention.
paged_attention_decode``: single-token GQA attention read straight off the
paged KV pool, with the per-request page-table row consumed inside the
kernel (no gather, no contiguous copy).  One CTA per (batch row, kv head)
walks the row's pages up to its position; see the source for the design and
its bound.  The plain PyTorch version is ``ref.ref_paged_attention``.

Layout: q (B, KV, G, hd); k/v pools (P, page_tokens, KV, hd);
tables (B, n_pages_per_req) int32; positions (B,) int32 -> out (B, KV, G, hd).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build

TILE = 32                       # tokens staged per tile (csrc: TILE)
HEAD_DIMS = (64,)               # head dims the kernel is instantiated for
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int


def smem_blocks(group: int, hd: int):
    """Shared-memory working set per CTA, for ``MemoryPlanner.check_smem``."""
    f32 = np.dtype("float32")
    return [((group, hd), f32),               # scaled q rows
            ((group, hd), f32),               # acc
            ((TILE, hd + 1), f32),            # k tile
            ((TILE, hd + 1), f32),            # v tile
            ((group, TILE), f32),             # scores / probs
            ((3, group), f32)]                # m, l, correction


def _fn():
    lib = build.library("paged_attention")
    fn = lib.paged_attention_decode
    if fn.argtypes is None:
        fn.argtypes = [_P] * 6 + [_I] * 8 + [_P]
        fn.restype = _I
        lib.paged_attention_error_string.argtypes = [_I]
        lib.paged_attention_error_string.restype = ctypes.c_char_p
    return lib, fn


def paged_attention_decode(q, k_pages, v_pages, tables, positions):
    """Launch the kernel on CUDA tensors; returns a new (B, KV, G, hd) tensor.
    Raises ``ValueError`` on inputs the kernel does not take."""
    b, kv, g, hd = q.shape
    p, pt, kv_k, hd_k = k_pages.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    if (kv_k, hd_k) != (kv, hd) or v_pages.shape != k_pages.shape:
        raise ValueError(f"pool {tuple(k_pages.shape)} / {tuple(v_pages.shape)} "
                         f"does not match q {tuple(q.shape)}")
    if tables.dim() != 2 or tables.shape[0] != b or tuple(positions.shape) != (b,):
        raise ValueError(f"tables {tuple(tables.shape)} / positions "
                         f"{tuple(positions.shape)} do not match batch {b}")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("tables", tables), ("positions", positions)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} must lie on q's CUDA device, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in DTYPE_CODES or k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}/{k_pages.dtype}/{v_pages.dtype}: "
                         f"need one of {list(DTYPE_CODES)} for all three")
    if tables.dtype != torch.int32 or positions.dtype != torch.int32:
        raise ValueError("tables and positions must be int32")
    out = torch.empty_like(q)
    lib, fn = _fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                 tables.data_ptr(), positions.data_ptr(), out.data_ptr(),
                 b, kv, g, hd, p, pt, tables.shape[1], DTYPE_CODES[q.dtype],
                 stream)
    if err:
        raise RuntimeError("paged_attention_decode launch failed: "
                           f"{lib.paged_attention_error_string(err).decode()}")
    return out
