"""The kernels in model-native layouts (port of ``repro.kernels.ops``).

Each wrapper checks its CTA's shared-memory working set against the Hopper
per-block budget with the paper's planner, then dispatches on the tensors'
device: CPU tensors go to the plain PyTorch version in ``ref``, CUDA tensors
to the CUDA kernel, and any other device raises.  There is no fallback from
the kernel to the plain version.  No kernel has a backward, so a wrapper
refuses (``ValueError``) a tensor that requires grad while grad mode is on,
on every device: its output would come back detached and the gradient would
be lost without an error.  A wrapper refuses a DTensor (``TypeError``): it
never gathers one nor runs the plain version in its place; under a mesh
the model calls it through ``local_map``, which hands it each rank's
plain shards.  ``<wrapper>.launches`` counts kernel
launches (plain-version calls do not count), so a run can show that its main
path went through the kernels; a launch captured into a CUDA graph counts
once per replay (``CapturedLaunches``).
"""
from __future__ import annotations

import torch

from ..core.planner import MemoryPlanner
from . import flash_attention as _fa
from . import paged_attention as _pa
from . import rglru_scan as _rg
from . import ssd_scan as _ssd
from .ref import ref_attention_bhsd, ref_paged_attention, ref_rglru, ssd_chunked


def _check_smem(blocks, what: str) -> None:
    check = MemoryPlanner.check_smem(blocks)
    if not check["fits"]:
        raise ValueError(f"{what} working set exceeds shared memory: {check}")


def _refuse_autograd(what: str, *tensors) -> None:
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise ValueError(f"{what}: the kernel has no backward and an input requires "
                         "grad; call it under torch.no_grad() or train with "
                         "RunOpts(attention_impl='full', use_kernels=False)")


def _refuse_dtensor(what: str, *tensors) -> None:
    from torch.distributed.tensor import DTensor
    if any(isinstance(t, DTensor) for t in tensors):
        raise TypeError(f"{what}: a DTensor argument; call the kernel on each rank's "
                        "local shards (torch.distributed.tensor.experimental.local_map, "
                        "as runtime.mesh_ctx.run_local does)")


def _device_type(t) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel or plain version for device {t.device}")
    return t.device.type


def _in_model_layout(fn, q, k, v, **kw):
    """Run a (B,H,S,D) attention ``fn`` on the model's layout q:
    (B,S,KV,G,hd), k/v: (B,S,KV,hd) -> ctx (B,S,KV,G,hd), through views."""
    b, s, kv, g, hd = q.shape
    out = fn(q.reshape(b, s, kv * g, hd).transpose(1, 2), k.transpose(1, 2),
             v.transpose(1, 2), **kw)
    return out.transpose(1, 2).reshape(b, s, kv, g, hd)


def flash_attention(q, k, v, *, causal=True, window=0, q_offset=0):
    """Model layout q: (B,S,KV,G,hd); k/v: (B,S,KV,hd) -> ctx (B,S,KV,G,hd)."""
    _refuse_dtensor("flash_attention", q, k, v)
    _refuse_autograd("flash_attention", q, k, v)
    _check_smem(_fa.smem_blocks(q.shape[-1], q.dtype), "flash attention")
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    if _device_type(q) == "cpu":
        return flash_attention_plain(q, k, v, **kw)
    out = _in_model_layout(_fa.flash_attention_bhsd, q, k, v, **kw)
    flash_attention.launches += 1
    return out


def flash_attention_plain(q, k, v, *, causal=True, window=0, q_offset=0):
    """The flash kernel's plain version in the model layout, on any device:
    what the wrapper runs for CPU tensors and what the kernel is held
    against on the card."""
    return _in_model_layout(ref_attention_bhsd, q, k, v, causal=causal,
                            window=window, q_offset=q_offset)


def paged_attention(q, k_pages, v_pages, tables, positions):
    """Decode layout q: (B,KV,G,hd); pools (P,pt,KV,hd); tables (B,maxp);
    positions (B,) -> ctx (B,KV,G,hd).  The page table is consumed inside
    the kernel — no gather, no contiguous copy."""
    _refuse_dtensor("paged_attention", q, k_pages, v_pages, tables, positions)
    _refuse_autograd("paged_attention", q, k_pages, v_pages)
    _, kv, g, hd = q.shape
    _check_smem(_pa.smem_blocks(g, hd, q.dtype), "paged attention")
    if _device_type(q) == "cpu":
        return ref_paged_attention(q, k_pages, v_pages, tables, positions)
    out = _pa.paged_attention_decode(q, k_pages, v_pages, tables, positions)
    paged_attention.launches += 1
    return out


def ssd_scan(x, dt, a_log, b_mat, c_mat, d_skip, *, chunk=128):
    """``ref.ssd_chunked`` with the CUDA kernel as its chunk scan for CUDA
    tensors: x (B,S,H,P), dt (B,S,H) softplus'd, a_log (H,), b/c (B,S,G,N),
    d_skip (H,).  Returns (y f32, h_final f32).

    The dt scaling and ``dta = dt * A`` happen before the scan and the D
    skip after it, as in the reference's wrapper.  ``chunk`` is the plain
    version's chunk length; the kernels scan in chunks of their own
    (``ssd_scan.CHUNK``), which changes the result only by rounding.  One
    call is three launches and counts one in ``ssd_scan.launches``."""
    _refuse_dtensor("ssd_scan", x, dt, a_log, b_mat, c_mat, d_skip)
    _refuse_autograd("ssd_scan", x, dt, a_log, b_mat, c_mat, d_skip)
    for launch in _ssd.LAUNCHES:
        _check_smem(_ssd.smem_blocks(launch), f"ssd scan ({launch})")
    if _device_type(x) == "cpu":
        return ssd_chunked(x, dt, a_log, b_mat, c_mat, d_skip, chunk=chunk)
    return ssd_chunked(x, dt, a_log, b_mat, c_mat, d_skip, scan=_ssd_kernel)


def _ssd_kernel(xdt, dta, b_mat, c_mat, *, chunk, h0):
    del chunk, h0           # the kernel's own chunks, from a zero state
    out = _ssd.ssd_scan_kernel(xdt, dta, b_mat.contiguous(), c_mat.contiguous())
    ssd_scan.launches += 1
    return out


def rglru_scan(a, b, h0=None, *, block=256):
    """``h_t = a_t h_{t-1} + b_t`` over a, b (B,S,L) with optional h0 (B,L)
    -> y (B,S,L) f32.  ``block`` is the plain version's block length; the
    kernel splits S into segments of its own (``rglru_scan.SEG`` steps, one
    per warp), folds their aggregates in order and re-walks each from its
    carry (``ref.ref_rglru_segmented``), which changes the result only by
    rounding."""
    _refuse_dtensor("rglru_scan", a, b, h0)
    _refuse_autograd("rglru_scan", a, b, h0)
    _check_smem(_rg.smem_blocks(), "rglru scan")
    if _device_type(a) == "cpu":
        return ref_rglru(a, b, h0, block=block)
    out = _rg.rglru_scan_kernel(a.contiguous(), b.contiguous(),
                                None if h0 is None else h0.float().contiguous())
    rglru_scan.launches += 1
    return out


flash_attention.launches = 0
paged_attention.launches = 0
ssd_scan.launches = 0
rglru_scan.launches = 0
WRAPPERS = (flash_attention, paged_attention, ssd_scan, rglru_scan)


def reset_launches() -> None:
    for fn in WRAPPERS:
        fn.launches = 0


class CapturedLaunches:
    """Launch accounting for one CUDA graph.  A wrapper counts in Python, so
    a replayed graph would count nothing, and its capture, which runs
    nothing, would count once.  Around the capture (``with
    CapturedLaunches() as rec:``) this takes each wrapper's count before
    and after, keeps the difference as the graph's launches (``counts``) and
    puts the counters back; ``replayed()`` then adds them once per
    replay."""

    def __enter__(self):
        self._before = [fn.launches for fn in WRAPPERS]
        return self

    def __exit__(self, *exc) -> None:
        self.counts = {}
        for fn, before in zip(WRAPPERS, self._before):
            self.counts[fn.__name__] = fn.launches - before
            fn.launches = before

    def replayed(self) -> None:
        for fn in WRAPPERS:
            fn.launches += self.counts[fn.__name__]
