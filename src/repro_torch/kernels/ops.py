"""The kernels in model-native layouts (port of ``repro.kernels.ops``).

Each wrapper checks its CTA's shared-memory working set against the Hopper
per-block budget with the paper's planner, then dispatches on the tensors'
device: CPU tensors go to the plain PyTorch version in ``ref``, CUDA tensors
to the CUDA kernel, and any other device raises.  There is no fallback from
the kernel to the plain version.  ``<wrapper>.launches`` counts kernel
launches (plain-version calls do not count), so a run can show that its main
path went through the kernels.
"""
from __future__ import annotations

from ..core.planner import MemoryPlanner
from . import flash_attention as _fa
from . import paged_attention as _pa
from .ref import ref_attention_bhsd, ref_paged_attention


def _check_smem(blocks, what: str) -> None:
    check = MemoryPlanner.check_smem(blocks)
    if not check["fits"]:
        raise ValueError(f"{what} working set exceeds shared memory: {check}")


def _device_type(t) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel or plain version for device {t.device}")
    return t.device.type


def flash_attention(q, k, v, *, causal=True, window=0, q_offset=0):
    """Model layout q: (B,S,KV,G,hd); k/v: (B,S,KV,hd) -> ctx (B,S,KV,G,hd)."""
    b, s, kv, g, hd = q.shape
    _check_smem(_fa.smem_blocks(hd), "flash attention")
    qh = q.reshape(b, s, kv * g, hd).transpose(1, 2)
    kh = k.transpose(1, 2)
    vh = v.transpose(1, 2)
    if _device_type(q) == "cpu":
        out = ref_attention_bhsd(qh, kh, vh, causal=causal, window=window,
                                 q_offset=q_offset)
    else:
        out = _fa.flash_attention_bhsd(qh, kh, vh, causal=causal,
                                       window=window, q_offset=q_offset)
        flash_attention.launches += 1
    return out.transpose(1, 2).reshape(b, s, kv, g, hd)


def paged_attention(q, k_pages, v_pages, tables, positions):
    """Decode layout q: (B,KV,G,hd); pools (P,pt,KV,hd); tables (B,maxp);
    positions (B,) -> ctx (B,KV,G,hd).  The page table is consumed inside
    the kernel — no gather, no contiguous copy."""
    _, kv, g, hd = q.shape
    _check_smem(_pa.smem_blocks(g, hd), "paged attention")
    if _device_type(q) == "cpu":
        return ref_paged_attention(q, k_pages, v_pages, tables, positions)
    out = _pa.paged_attention_decode(q, k_pages, v_pages, tables, positions)
    paged_attention.launches += 1
    return out


flash_attention.launches = 0
paged_attention.launches = 0
WRAPPERS = (flash_attention, paged_attention)


def reset_launches() -> None:
    for fn in WRAPPERS:
        fn.launches = 0
