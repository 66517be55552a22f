"""Port kernels vs the reference: the plain PyTorch versions (what the
``repro_torch.kernels.ops`` wrappers run for CPU tensors) against the JAX
package's Pallas kernels in interpret mode and its ``ref.py`` oracles, on
the same numpy-seeded inputs.  Tolerance: max-abs 2e-5 in f32 and 2e-2 in
bf16, the reference's own (tests/test_paged_attention.py).

The CUDA kernels themselves cannot run here (no card, no nvcc): they are
held against these same plain versions on the card by ``chip_smoke.py``.
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels import ref as tref

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# jitted once per shape: interpret-mode Pallas is slow to trace
_pallas_paged = jax.jit(functools.partial(jops.paged_attention, interpret=True))
_oracle_paged = jax.jit(jref.ref_paged_attention)
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _both(a: np.ndarray, dtype: str):
    return jnp.asarray(a, JDT[dtype]), torch.from_numpy(a).to(TDT[dtype])


def _err(jax_out, torch_out) -> float:
    return float(np.abs(np.asarray(jax_out, np.float32)
                        - torch_out.float().numpy()).max())


def _paged_case(seed, b, kv, g, hd, pt, maxp, positions=None):
    """Per-row pages disjoint, fragmented (non-monotonic), table tails
    zero-padded exactly like the engine's rows, a few unreferenced pages."""
    rng = np.random.default_rng(seed)
    n_pool = b * maxp + 3
    if positions is None:
        positions = rng.integers(0, maxp * pt, size=b)
    positions = np.asarray(positions, np.int32)
    order = rng.permutation(n_pool)
    tables = np.zeros((b, maxp), np.int32)
    used = 0
    for i in range(b):
        need = math.ceil((int(positions[i]) + 1) / pt)
        tables[i, :need] = order[used:used + need]
        used += need
    q = rng.standard_normal((b, kv, g, hd)).astype(np.float32)
    kp = rng.standard_normal((n_pool, pt, kv, hd)).astype(np.float32)
    vp = rng.standard_normal((n_pool, pt, kv, hd)).astype(np.float32)
    return q, kp, vp, tables, positions


def _check_paged(case, dtype):
    q, kp, vp, tables, positions = case
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, dtype) for a in (q, kp, vp))
    jt, jpos = jnp.asarray(tables), jnp.asarray(positions)
    tt, tpos = torch.from_numpy(tables), torch.from_numpy(positions)
    out = tops.paged_attention(tq, tk, tv, tt, tpos)
    assert out.shape == tq.shape and out.dtype == tq.dtype
    pallas = _pallas_paged(jq, jk, jv, jt, jpos)
    oracle = _oracle_paged(jq, jk, jv, jt, jpos)
    assert _err(pallas, out) < TOL[dtype]
    assert _err(oracle, out) < TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b", [1, 3, 8])
def test_paged_plain_matches_pallas_and_ref(b, dtype):
    """qwen2-0.5b's head grouping (KV=2, G=7) over the runner's bucket ladder."""
    _check_paged(_paged_case(17 * b, b, kv=2, g=7, hd=16, pt=8, maxp=3), dtype)


def test_paged_partial_and_boundary_positions():
    """First token, one full page, first token of the next page, full table."""
    pt, maxp = 4, 5
    for pos in (0, pt - 1, pt, maxp * pt - 1):
        case = _paged_case(100 + pos, 4, kv=2, g=7, hd=16, pt=pt, maxp=maxp,
                           positions=[pos, 0, maxp * pt - 1, pos])
        _check_paged(case, "float32")


FLASH_CASES = [
    # (b, s, kv, g, hd, causal, window, dtype)
    (1, 37, 2, 7, 16, True, 0, "float32"),
    (2, 64, 2, 7, 32, True, 0, "bfloat16"),
    (1, 48, 2, 7, 16, True, 16, "float32"),
]


@pytest.mark.parametrize("b,s,kv,g,hd,causal,window,dtype", FLASH_CASES)
def test_flash_plain_matches_pallas_and_ref(b, s, kv, g, hd, causal, window, dtype):
    rng = np.random.default_rng(s * 7 + hd)
    q = rng.standard_normal((b, s, kv, g, hd)).astype(np.float32)
    k = rng.standard_normal((b, s, kv, hd)).astype(np.float32)
    v = rng.standard_normal((b, s, kv, hd)).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, dtype) for a in (q, k, v))
    out = tops.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert out.shape == tq.shape and out.dtype == tq.dtype
    pallas = jops.flash_attention(jq, jk, jv, causal=causal, window=window,
                                  block_q=16, block_k=16, interpret=True)
    assert _err(pallas, out) < TOL[dtype]
    bh = lambda x: x.reshape(b, s, kv * g, hd).transpose(0, 2, 1, 3)
    oracle = jref.ref_attention_bhsd(bh(jq), jk.transpose(0, 2, 1, 3),
                                     jv.transpose(0, 2, 1, 3), causal=causal,
                                     window=window)
    plain = tref.ref_attention_bhsd(tq.reshape(b, s, kv * g, hd).transpose(1, 2),
                                    tk.transpose(1, 2), tv.transpose(1, 2),
                                    causal=causal, window=window)
    assert _err(oracle, plain) < TOL[dtype]


def test_flash_q_offset_window():
    """Queries at positions 24..31 against 32 keys with a window of 8 —
    the decode-style offset the reference's kernel supports."""
    rng = np.random.default_rng(5)
    q = rng.standard_normal((1, 14, 8, 16)).astype(np.float32)
    k = rng.standard_normal((1, 2, 32, 16)).astype(np.float32)
    v = rng.standard_normal((1, 2, 32, 16)).astype(np.float32)
    kw = dict(causal=True, window=8, q_offset=24)
    want = jref.ref_attention_bhsd(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), **kw)
    got = tref.ref_attention_bhsd(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), **kw)
    assert _err(want, got) < TOL["float32"]


def test_cpu_dispatch_counts_no_launch():
    """CPU tensors take the plain version: no kernel launch is counted."""
    tops.reset_launches()
    q, kp, vp, tables, positions = _paged_case(1, 2, kv=2, g=7, hd=16, pt=8, maxp=2)
    tops.paged_attention(torch.from_numpy(q), torch.from_numpy(kp),
                         torch.from_numpy(vp), torch.from_numpy(tables),
                         torch.from_numpy(positions))
    x = torch.zeros(1, 8, 2, 7, 16)
    tops.flash_attention(x, torch.zeros(1, 8, 2, 16), torch.zeros(1, 8, 2, 16))
    assert tops.paged_attention.launches == 0
    assert tops.flash_attention.launches == 0


def test_wrappers_raise_off_cpu_and_cuda():
    """No fallback: a device with neither kernel nor plain path raises."""
    x = torch.zeros(1, 8, 2, 7, 16, device="meta")
    kv = torch.zeros(1, 8, 2, 16, device="meta")
    with pytest.raises(ValueError, match="device"):
        tops.flash_attention(x, kv, kv)


def test_kernel_launchers_reject_cpu_tensors():
    """The CUDA launchers validate before building anything: CPU tensors are
    refused with a ValueError, never run through a plain version."""
    q, kp, vp, tables, positions = (torch.from_numpy(a) for a in
                                    _paged_case(2, 1, kv=2, g=7, hd=64, pt=8, maxp=2))
    with pytest.raises(ValueError, match="CUDA"):
        tpa.paged_attention_decode(q, kp, vp, tables, positions)
    with pytest.raises(ValueError, match="head dim"):
        tpa.paged_attention_decode(q[..., :16], kp[..., :16], vp[..., :16],
                                   tables, positions)
    x = torch.zeros(1, 14, 8, 64)
    kv = torch.zeros(1, 2, 8, 64)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_bhsd(x, kv, kv)
    with pytest.raises(ValueError, match="head dim"):
        tfa.flash_attention_bhsd(torch.zeros(1, 14, 8, 48),
                                 torch.zeros(1, 2, 8, 48),
                                 torch.zeros(1, 2, 8, 48))


def test_smem_budget_guard():
    """The wrappers check each CTA's working set against the 227 KB Hopper
    budget with the paper's planner, as the reference checks VMEM."""
    from repro_torch.core.planner import SMEM_BYTES, MemoryPlanner
    ok = MemoryPlanner.check_smem(tpa.smem_blocks(7, 64))
    assert ok["fits"] and ok["budget"] == SMEM_BYTES == 227 * 1024
    huge = torch.zeros(1, 1, 1024, 64)
    with pytest.raises(ValueError, match="shared memory"):
        tops.paged_attention(huge, torch.zeros(4, 8, 1, 64),
                             torch.zeros(4, 8, 1, 64),
                             torch.zeros(1, 1, dtype=torch.int32),
                             torch.zeros(1, dtype=torch.int32))
