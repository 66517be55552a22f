"""Paged decode attention — the CUDA kernel in ``csrc/paged_attention.cu``.

Replaces the Pallas TPU kernel ``repro.kernels.paged_attention.
paged_attention_decode``: single-token GQA attention read straight off the
paged KV pool, with the per-request page-table row consumed inside the
kernel (no gather, no contiguous copy).  Split-KV in one launch: CTA
(b, kv head, s) takes tokens s*CHUNK .. s*CHUNK+CHUNK-1 of the row and
writes a partial (acc, m, l) to scratch; the last CTA of each (b, kv head)
combines them, known from an int32 completion counter that it resets.  The
counters carry state from one launch to the next, so no two launches that
may overlap share them: eager launches use one buffer per (device, stream),
and a launch captured into a CUDA graph gets a buffer of its own, zeroed
inside the graph and kept alive with it.  The grid comes from host shapes
alone, so ``positions`` is never read on the host.  See the source for the
design and its bound.  Every head dim that is a multiple of 8 from 8 to
256 runs, on the smallest instance of width 64, 128 or 256 that holds it
(:func:`instance`): the kernel zero-fills the columns past the true hd as it
stages them and scales by 1/sqrt(hd) of the true hd, so q and the pools are
passed as they are.  The plain PyTorch version is
``ref.ref_paged_attention``; ``ref.ref_paged_attention_split`` repeats the
kernel's per-chunk algebra.

Layout: q (B, KV, G, hd); k/v pools (P, page_tokens, KV, hd);
tables (B, n_pages_per_req) int32; positions (B,) int32 -> out (B, KV, G, hd).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build

CHUNK = 64                      # tokens per CTA (csrc: CHUNK)
WIDTHS = (64, 128, 256)         # the instances' widths (csrc: instance)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
# per (device, stream): B * KV int32 completion counters, zero between
# launches (the last CTA of each row resets its own).  Launches on one stream
# run in order, so they may share a buffer; launches on two streams may not.
_counters: dict[tuple[torch.device, int], torch.Tensor] = {}
# one buffer per captured launch, held for the life of the process and so of
# every graph that replays it: graphs replayed on two streams never share one
_graph_counters: list[torch.Tensor] = []


def instance(hd: int) -> int:
    """The width of the instance that runs head dim ``hd`` (csrc:
    ``instance``): the smallest of ``WIDTHS`` that holds it, in either
    dtype.  Raises ``ValueError`` outside the rule."""
    if hd % 8 or not 8 <= hd <= WIDTHS[-1]:
        raise ValueError(f"head dim {hd}: the paged kernel takes a multiple of 8 "
                         f"from 8 to {WIDTHS[-1]}")
    return next(w for w in WIDTHS if hd <= w)


def smem_blocks(group: int, hd: int, dtype=torch.float32):
    """Shared-memory working set per CTA of the instance that runs head dim
    ``hd``, for ``MemoryPlanner.check_smem`` (csrc:
    ``paged_attention_smem_bytes``): the chunk's K and V rows padded by 16
    bytes, in the pool's dtype (bf16 counted as its 2-byte storage), then
    f32 scaled q rows, scores and each row's (m, l)."""
    hd = instance(hd)
    store = np.dtype("uint16") if dtype == torch.bfloat16 else np.dtype("float32")
    row = hd + 16 // store.itemsize
    f32 = np.dtype("float32")
    return [((CHUNK, row), store),            # k chunk
            ((CHUNK, row), store),            # v chunk
            ((group, hd), f32),               # scaled q rows
            ((group, CHUNK), f32),            # scores, then probs
            ((2, group), f32)]                # m, l


def n_splits(maxp: int, page_tokens: int) -> int:
    """CTAs per (batch row, kv head): chunks of CHUNK over the table's reach."""
    return -(-maxp * page_tokens // CHUNK)


def _counters_for(device: torch.device, n: int) -> torch.Tensor:
    """Completion counters for a launch of ``n`` (row, kv head) pairs on the
    current stream of ``device``.  While that stream is being captured into
    a CUDA graph the launch gets a buffer of its own: ``torch.zeros`` is
    captured too, so every replay starts from zeros."""
    if torch.cuda.is_current_stream_capturing():
        c = torch.zeros(n, dtype=torch.int32, device=device)
        _graph_counters.append(c)
        return c
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    c = _counters.get(key)
    if c is None or c.numel() < n:
        c = torch.zeros(n, dtype=torch.int32, device=device)
        _counters[key] = c
    return c


def _fn():
    lib = build.library("paged_attention")
    fn = lib.paged_attention_decode
    if fn.argtypes is None:
        fn.argtypes = [_P] * 8 + [_I] * 8 + [_P]
        fn.restype = _I
        lib.paged_attention_error_string.argtypes = [_I]
        lib.paged_attention_error_string.restype = ctypes.c_char_p
    return lib, fn


def paged_attention_decode(q, k_pages, v_pages, tables, positions):
    """Launch the kernel on CUDA tensors; returns a new (B, KV, G, hd) tensor.
    Raises ``ValueError`` on inputs the kernel does not take."""
    b, kv, g, hd = q.shape
    p, pt, kv_k, hd_k = k_pages.shape
    instance(hd)
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
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("the pools need 16-byte alignment for the 16-byte copies")
    if q.dtype not in DTYPE_CODES or k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}/{k_pages.dtype}/{v_pages.dtype}: "
                         f"need one of {list(DTYPE_CODES)} for all three")
    if tables.dtype != torch.int32 or positions.dtype != torch.int32:
        raise ValueError("tables and positions must be int32")
    out = torch.empty_like(q)
    maxp = tables.shape[1]
    part = torch.empty((b * kv, n_splits(maxp, pt), g * (hd + 2)),
                       dtype=torch.float32, device=q.device)
    lib, fn = _fn()
    with torch.cuda.device(q.device):
        counters = _counters_for(q.device, b * kv)
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                 tables.data_ptr(), positions.data_ptr(), out.data_ptr(),
                 part.data_ptr(), counters.data_ptr(), b, kv, g, hd, p, pt,
                 maxp, DTYPE_CODES[q.dtype], stream)
    if err:
        raise RuntimeError("paged_attention_decode launch failed: "
                           f"{lib.paged_attention_error_string(err).decode()}")
    return out
