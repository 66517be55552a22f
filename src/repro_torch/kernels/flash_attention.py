"""Flash-attention forward — the CUDA kernel in ``csrc/flash_attention.cu``.

Replaces the Pallas TPU kernel ``repro.kernels.flash_attention.
flash_attention_bhsd``: causal, sliding-window and k-padding masks by
position with ``q_offset``, GQA by ``h // group`` with no repeated K/V,
online softmax in f32.  One CTA per (batch * head, query tile) stages
32-key K/V tiles through shared memory and skips key tiles wholly in the
causal future or before the window.  Head dim 64 runs two threads per query
row (64 rows per CTA, static shared memory); head dim 256 runs eight threads
per row, each owning a slice of q and of the output (32 rows per CTA, 64 KB
of dynamic shared memory); see the source for both designs and their bound.
The plain PyTorch version is ``ref.ref_attention_bhsd``.

Layout: q (B, H, Sq, D); k/v (B, KV, Sk, D) -> out (B, H, Sq, D).  Any
strides are taken as long as the last dimension is contiguous (at D=256 also
multiples of 8 elements on 16-byte aligned tensors, for its vector loads),
so the model's (B, S, H, D) tensors are passed as transposed views, not
copies.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build

BLOCK_K = 32                    # keys per tile (csrc: BK, W_BK)
HEAD_DIMS = (64, 256)           # head dims the kernel is instantiated for
WIDE = 256                      # head dims from here run the wide design
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int


def smem_blocks(d: int):
    """Shared-memory working set per CTA, for ``MemoryPlanner.check_smem``
    (csrc: ``flash_attention_smem_bytes``): f32 K and V tiles, rows padded by
    one float in the D=64 design, unpadded float4 rows in the wide one."""
    f32 = np.dtype("float32")
    row = d if d >= WIDE else d + 1
    return [((BLOCK_K, row), f32),            # k tile
            ((BLOCK_K, row), f32)]            # v tile


def _fn():
    lib = build.library("flash_attention")
    fn = lib.flash_attention_bhsd
    if fn.argtypes is None:
        fn.argtypes = [_P] * 5 + [_I] * 10 + [_P]
        fn.restype = _I
        lib.flash_attention_error_string.argtypes = [_I]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib, fn


def flash_attention_bhsd(q, k, v, *, causal=True, window=0, q_offset=0):
    """Launch the kernel on CUDA tensors; returns out with q's shape and
    strides.  Raises ``ValueError`` on inputs the kernel does not take."""
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    if k.shape != (b, kv, sk, d) or v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if kv == 0 or h % kv:
        raise ValueError(f"{h} heads do not group over {kv} kv heads")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} must lie on q's CUDA device, got {t.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} needs a contiguous last dimension")
        if d >= WIDE and (t.data_ptr() % 16 or any(x % 8 for x in t.stride()[:3])):
            raise ValueError(f"{name} needs 16-byte alignment and strides in "
                             f"multiples of 8 elements at head dim {d}")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}/{k.dtype}/{v.dtype}: need one of "
                         f"{list(DTYPE_CODES)} for all three")
    out = torch.empty_like(q)
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, out) for s in t.stride()[:3]))
    lib, fn = _fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 ctypes.addressof(strides), b, h, kv, sq, sk, d, int(causal),
                 int(window), int(q_offset), DTYPE_CODES[q.dtype], stream)
    if err:
        raise RuntimeError("flash_attention_bhsd launch failed: "
                           f"{lib.flash_attention_error_string(err).decode()}")
    return out
