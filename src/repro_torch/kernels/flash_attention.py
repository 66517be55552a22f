"""Flash-attention forward — the CUDA kernels in ``csrc/flash_attention.cu``.

Replaces the Pallas TPU kernel ``repro.kernels.flash_attention.
flash_attention_bhsd``: causal, sliding-window and k-padding masks by
position with ``q_offset``, GQA by ``h // group`` with no repeated K/V,
online softmax in f32, key tiles wholly in the causal future or before the
window skipped.  The launcher dispatches on dtype, with no fallback between
designs: bf16 runs on the tensor cores (wgmma; one warpgroup per 64 query
rows, 64-key K/V tiles through a two-stage cp.async ring in shared memory,
P rounded to bf16 for the P·V product), f32 on the CUDA cores (the width-64
design, and the wide one at widths 128 and 256, f32 throughout); see the
source for the designs and their bound.  Every head dim that is a multiple
of 8 from 8 to 256 runs, on the smallest instance of width 64, 128 or 256
that holds it (:func:`instance`): the kernel zero-fills the columns past the
true D as it stages them and scales by 1/sqrt(D) of the true D, so q, k and
v are passed as they are, never padded or copied.  The plain PyTorch version
is ``ref.ref_attention_bhsd``.

Layout: q (B, H, Sq, D); k/v (B, KV, Sk, D) -> out (B, H, Sq, D).  Any
strides are taken as long as the last dimension is contiguous (for bf16
and for the wide f32 design also multiples of 8 elements on 16-byte aligned
tensors, for the 16-byte copies), so the model's (B, S, H, D) tensors are
passed as transposed views, not copies.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build

BLOCK_K = 32                    # f32 designs: keys per tile (csrc: BK, W_BK)
TC_ROWS = 64                    # bf16 design: query rows and keys per tile
TC_STAGES = 2                   # bf16 design: K/V tiles in flight
TC_ALIGN = 1024                 # bf16 design: slack to align the swizzle atoms
WIDTHS = (64, 128, 256)         # the instances' widths (csrc: instance)
WIDE = 128                      # f32 instances from this width run the wide design
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int


def instance(d: int) -> int:
    """The width of the instance that runs head dim ``d`` (csrc:
    ``instance``): the smallest of ``WIDTHS`` that holds it, in either
    dtype.  Raises ``ValueError`` outside the rule."""
    if d % 8 or not 8 <= d <= WIDTHS[-1]:
        raise ValueError(f"head dim {d}: the flash kernels take a multiple of 8 "
                         f"from 8 to {WIDTHS[-1]}")
    return next(w for w in WIDTHS if d <= w)


def smem_blocks(d: int, dtype=torch.float32):
    """Shared-memory working set per CTA of the instance that runs head dim
    ``d``, for ``MemoryPlanner.check_smem`` (csrc:
    ``flash_attention_smem_bytes``).  f32: K and V tiles, rows padded by one
    float in the width-64 design, unpadded float4 rows in the wide one.
    bf16: the Q tile, the two-stage K/V ring, and the slack that aligns the
    1 KB swizzle atoms (bf16 counted as its 2-byte storage)."""
    d = instance(d)
    if dtype == torch.bfloat16:
        bf16 = np.dtype("uint16")
        return [((TC_ROWS, d), bf16),                     # q tile
                ((TC_STAGES, TC_ROWS, d), bf16),          # k ring
                ((TC_STAGES, TC_ROWS, d), bf16),          # v ring
                ((TC_ALIGN,), np.dtype("uint8"))]         # atom alignment
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
    width = instance(d)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} must lie on q's CUDA device, got {t.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} needs a contiguous last dimension")
        vec = t.dtype == torch.bfloat16 or width >= WIDE
        if vec and (t.data_ptr() % 16 or any(x % 8 for x in t.stride()[:3])):
            raise ValueError(f"{name} needs 16-byte alignment and strides in "
                             f"multiples of 8 elements ({t.dtype}, head dim {d})")
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
