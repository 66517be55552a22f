"""Port kernels vs the reference: the plain PyTorch versions (what the
``repro_torch.kernels.ops`` wrappers run for CPU tensors) against the JAX
package's Pallas kernels in interpret mode and its ``ref.py`` oracles, on
the same numpy-seeded inputs.  Tolerance: max-abs 2e-5 in f32 and 2e-2 in
bf16, the reference's own (tests/test_paged_attention.py).

The CUDA kernels themselves cannot run here (no card, no nvcc): they are
held against these same plain versions on the card by ``chip_smoke.py`` and
by the tests marked ``cuda`` below, which skip without a card.  The
split-KV paged kernel's algebra is held here through its plain twin
``ref.ref_paged_attention_split``.
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b", [1, 3])
def test_paged_plain_matches_pallas_and_ref_at_head_dim_128(b, dtype):
    """phi4-mini-3.8b's head dim (128) and grouping (G=3)."""
    _check_paged(_paged_case(29 * b, b, kv=2, g=3, hd=128, pt=8, maxp=3), dtype)


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
    # phi4-mini-3.8b's head dim and grouping
    (1, 40, 2, 3, 128, True, 0, "float32"),
    (1, 33, 1, 3, 128, True, 16, "bfloat16"),
    # whisper-small's encoder (non-causal) and decoder (causal), one query
    # head per KV head (G = 1)
    (2, 40, 3, 1, 64, False, 0, "float32"),
    (1, 37, 4, 1, 16, False, 0, "bfloat16"),
    (2, 33, 3, 1, 64, True, 0, "float32"),
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


def _wrapper_calls():
    """(name, call(requires_grad)) for each kernel wrapper at a small shape;
    the flag marks the first tensor input as requiring grad."""
    def flash(rg):
        q = torch.zeros(1, 8, 2, 7, 16, requires_grad=rg)
        return tops.flash_attention(q, torch.zeros(1, 8, 2, 16), torch.zeros(1, 8, 2, 16))

    def paged(rg):
        q, kp, vp, tables, positions = (torch.from_numpy(a) for a in
                                        _paged_case(1, 2, kv=2, g=7, hd=16, pt=8, maxp=2))
        return tops.paged_attention(q.requires_grad_(rg), kp, vp, tables, positions)

    def ssd(rg):
        x = torch.zeros(1, 8, 2, 4, requires_grad=rg)
        return tops.ssd_scan(x, torch.ones(1, 8, 2), torch.zeros(2),
                             torch.zeros(1, 8, 1, 4), torch.zeros(1, 8, 1, 4),
                             torch.zeros(2), chunk=4)

    def rglru(rg):
        a = torch.full((1, 8, 4), 0.5, requires_grad=rg)
        return tops.rglru_scan(a, torch.ones(1, 8, 4))

    return [("flash_attention", flash), ("paged_attention", paged),
            ("ssd_scan", ssd), ("rglru_scan", rglru)]


@pytest.mark.parametrize("name,call", _wrapper_calls(), ids=lambda v: v if isinstance(v, str) else "")
def test_wrappers_refuse_inputs_that_require_grad(name, call):
    """No kernel has a backward: with grad mode on, an input that requires
    grad is refused before dispatch (its output would come back detached).
    Under no_grad, or without requires_grad, the same call runs."""
    with pytest.raises(ValueError, match="no backward"):
        call(True)
    call(False)
    with torch.no_grad():
        call(True)


def test_loss_fn_refuses_kernel_run_opts():
    """Training rejects RunOpts naming a kernel path, for the same reason."""
    from repro_torch.configs import get_config
    from repro_torch.models import RunOpts, Transformer
    cfg = get_config("qwen2-0.5b").smoke()
    tokens = {"tokens": torch.zeros(1, 9, dtype=torch.int32)}
    for opts in (RunOpts(), RunOpts(attention_impl="kernel", use_kernels=False),
                 RunOpts(attention_impl="full", use_kernels=True)):
        model = Transformer(cfg, opts, device="cpu")
        with pytest.raises(ValueError, match="no backward"):
            model.loss_fn(model.init(torch.Generator().manual_seed(0)), tokens)


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


SPLIT_POSITIONS = [0, 7, 8, 31, 32, 63, 64, 95]


@pytest.mark.parametrize("chunk", [8, 32, 64, 128])
def test_paged_split_algebra_matches_ref_and_pallas(chunk):
    """The split-KV kernel's per-chunk (acc, m, l) and combine, in plain
    PyTorch, against the gather-then-softmax version and the Pallas kernel
    in interpret mode: f32 at 1e-6.  A 96-token table reach in chunks of 8,
    32, 64 (ragged last chunk) and 128 (one chunk past the reach); positions
    on and across chunk edges leave trailing chunks empty, and position 0
    leaves every chunk but the first empty."""
    case = _paged_case(3, len(SPLIT_POSITIONS), kv=2, g=7, hd=16, pt=8, maxp=12,
                       positions=SPLIT_POSITIONS)
    q, kp, vp, tables, positions = (torch.from_numpy(a) for a in case)
    got = tref.ref_paged_attention_split(q, kp, vp, tables, positions, chunk)
    want = tref.ref_paged_attention(q, kp, vp, tables, positions)
    assert got.shape == q.shape and got.dtype == q.dtype
    assert float((got - want).abs().max()) < 1e-6
    pallas = _pallas_paged(*(jnp.asarray(a) for a in case))
    assert _err(pallas, got) < 1e-6


def test_paged_split_algebra_at_head_dim_128():
    """The split algebra at phi4-mini-3.8b's head dim and grouping, chunks
    of 64 as in the kernel, against the Pallas kernel (interpret mode) and
    the gather-then-softmax version: f32 at 1e-6."""
    case = _paged_case(5, len(SPLIT_POSITIONS), kv=2, g=3, hd=128, pt=8, maxp=12,
                       positions=SPLIT_POSITIONS)
    q, kp, vp, tables, positions = (torch.from_numpy(a) for a in case)
    got = tref.ref_paged_attention_split(q, kp, vp, tables, positions, tpa.CHUNK)
    want = tref.ref_paged_attention(q, kp, vp, tables, positions)
    assert float((got - want).abs().max()) < 1e-6
    assert _err(_pallas_paged(*(jnp.asarray(a) for a in case)), got) < 1e-6


def test_paged_split_empty_chunks_contribute_zero():
    """Position 0 in chunks of 8: seven empty partials (m = NEG_INF, l = 0)
    beside one holding a single token, so the output is that token's v row."""
    case = _paged_case(4, 2, kv=2, g=7, hd=16, pt=8, maxp=8, positions=[0, 0])
    q, kp, vp, tables, positions = (torch.from_numpy(a) for a in case)
    got = tref.ref_paged_attention_split(q, kp, vp, tables, positions, 8)
    v0 = vp[tables[:, 0].long(), 0]                                  # (B,KV,hd)
    assert torch.equal(got, v0[:, :, None, :].expand_as(got))


def test_smem_accounting_by_dtype():
    """Both attention kernels report their working set per dtype: f32 keeps
    the CUDA-core designs' tiles, bf16 flash reports the Q tile, the
    two-stage K/V ring and the atom-alignment slack; paged reports its
    64-token K/V chunk with 16-byte row padding in the pool's dtype."""
    from repro_torch.core.planner import MemoryPlanner
    fp = MemoryPlanner.smem_footprint
    assert fp(tfa.smem_blocks(64)) == fp(tfa.smem_blocks(64, torch.float32)) == 2 * 32 * 65 * 4
    assert fp(tfa.smem_blocks(64, torch.bfloat16)) == 5 * 64 * 64 * 2 + 1024
    assert fp(tfa.smem_blocks(256, torch.bfloat16)) == 5 * 64 * 256 * 2 + 1024
    assert MemoryPlanner.check_smem(tfa.smem_blocks(256, torch.bfloat16))["fits"]
    fixed = 4 * (7 * 64 + 7 * 64 + 2 * 7)
    assert fp(tpa.smem_blocks(7, 64, torch.bfloat16)) == 2 * 64 * 72 * 2 + fixed
    assert fp(tpa.smem_blocks(7, 64, torch.float32)) == 2 * 64 * 68 * 4 + fixed
    assert tpa.n_splits(129, 8) == 17 and tpa.n_splits(1, 8) == 1


def test_smem_accounting_at_head_dim_128():
    """phi4-mini-3.8b's instances: bf16 flash keeps the tensor-core design's
    Q tile and two-stage K/V ring (two 64-column swizzle blocks wide), f32
    flash runs the wide design with unpadded rows, and paged decode at G=3
    stages 128-column rows padded by 16 bytes."""
    from repro_torch.core.planner import MemoryPlanner
    fp = MemoryPlanner.smem_footprint
    assert 128 in tfa.HEAD_DIMS and 128 in tpa.HEAD_DIMS
    assert fp(tfa.smem_blocks(128, torch.bfloat16)) == 5 * 64 * 128 * 2 + 1024 == 82944
    assert fp(tfa.smem_blocks(128, torch.float32)) == 2 * 32 * 128 * 4
    fixed = 4 * (3 * 128 + 3 * 64 + 2 * 3)
    assert fp(tpa.smem_blocks(3, 128, torch.bfloat16)) == 2 * 64 * 136 * 2 + fixed == 37144
    assert fp(tpa.smem_blocks(3, 128, torch.float32)) == 2 * 64 * 132 * 4 + fixed == 69912


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: run on the card with "
                    "`python -m pytest -m cuda tests`")


@pytest.mark.cuda
@pytest.mark.parametrize("d,h,kv,sq,window,q_offset", [
    (64, 14, 2, 37, 0, 0), (64, 14, 2, 200, 0, 0), (64, 14, 2, 300, 100, 0),
    (64, 14, 2, 40, 0, 77), (256, 16, 1, 37, 2048, 0), (256, 16, 1, 300, 100, 0),
    (256, 16, 1, 130, 2048, 2100)])
def test_flash_tensor_core_kernel_matches_plain_version_on_the_card(
        card, d, h, kv, sq, window, q_offset):
    """bf16 flash on the tensor cores against the plain version (2e-2):
    ragged Sq, windows, offsets, through the model layout's strided views."""
    g = torch.Generator(device="cuda").manual_seed(sq + d)
    sk = sq + q_offset
    q = torch.randn(1, sq, kv, h // kv, d, generator=g, device="cuda").bfloat16()
    k = torch.randn(1, sk, kv, d, generator=g, device="cuda").bfloat16()
    v = torch.randn(1, sk, kv, d, generator=g, device="cuda").bfloat16()
    kw = dict(causal=True, window=window, q_offset=q_offset)
    before = tops.flash_attention.launches
    got = tops.flash_attention(q, k, v, **kw)
    want = tops.flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert tops.flash_attention.launches == before + 1
    assert got.shape == q.shape and got.dtype == torch.bfloat16
    assert float((got.float() - want.float()).abs().max()) < 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [("bfloat16", 2e-2), ("float32", 1e-4)])
@pytest.mark.parametrize("b,sq,causal", [(1, 1500, False), (8, 1500, False),
                                         (2, 4, True), (2, 448, True)])
def test_flash_kernels_at_whisper_layout_match_plain_version_on_the_card(
        card, dtype, tol, b, sq, causal):
    """whisper-small's layout (12 heads over 12 KV heads, G = 1, D=64): the
    encoder's non-causal self-attention over its 1500 frames (the last
    64-key tile and the last query tile hold 28) and the decoder's causal
    one at prompt lengths, in both designs, through the model layout's
    strided views."""
    g = torch.Generator(device="cuda").manual_seed(b * sq)
    q = torch.randn(b, sq, 12, 1, 64, generator=g, device="cuda").to(TDT[dtype])
    k = torch.randn(b, sq, 12, 64, generator=g, device="cuda").to(TDT[dtype])
    v = torch.randn(b, sq, 12, 64, generator=g, device="cuda").to(TDT[dtype])
    before = tops.flash_attention.launches
    got = tops.flash_attention(q, k, v, causal=causal)
    want = tops.flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert tops.flash_attention.launches == before + 1
    assert got.shape == q.shape and got.dtype == q.dtype
    assert float((got.float() - want.float()).abs().max()) < tol


@pytest.mark.cuda
def test_flash_tensor_core_kernel_refuses_unaligned_views_on_the_card(card):
    """The 16-byte copies need 16-byte aligned tensors and strides in
    multiples of 8 elements: anything else is refused, never copied."""
    base = torch.zeros(1, 14, 64, 72, device="cuda", dtype=torch.bfloat16)
    kv = torch.zeros(1, 2, 64, 64, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):
        tfa.flash_attention_bhsd(base[..., 1:65], kv, kv)         # misaligned
    odd = torch.zeros(1, 14, 64, 68, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 8"):
        tfa.flash_attention_bhsd(odd[..., :64], kv, kv)           # stride 68


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [("bfloat16", 2e-2), ("float32", 1e-4)])
@pytest.mark.parametrize("positions", [
    [0], [64], [0, 1, 63, 64, 65, 127, 128, 700]])
def test_split_paged_kernel_matches_plain_version_on_the_card(card, dtype, tol, positions):
    """Split-KV paged decode against the gather-then-softmax version: B=1
    and 8, position 0, positions on and across the 64-token chunk edges,
    fragmented non-monotonic tables, and two calls in a row (the last CTA
    of each row must leave its counter at 0 for the next launch)."""
    case = _paged_case(11, len(positions), kv=2, g=7, hd=64, pt=8, maxp=96,
                       positions=positions)
    q, kp, vp, tables, pos = (torch.from_numpy(a).cuda() for a in case)
    q, kp, vp = (t.to(TDT[dtype]) for t in (q, kp, vp))
    want = tref.ref_paged_attention(q, kp, vp, tables, pos)
    before = tops.paged_attention.launches
    for _ in range(2):
        got = tops.paged_attention(q, kp, vp, tables, pos)
        torch.cuda.synchronize()
        assert float((got.float() - want.float()).abs().max()) < tol
    assert tops.paged_attention.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [("bfloat16", 2e-2), ("float32", 1e-4)])
@pytest.mark.parametrize("sq,window,q_offset", [
    (37, 0, 0), (300, 0, 0), (300, 100, 0), (40, 0, 77)])
def test_flash_kernels_at_head_dim_128_match_plain_version_on_the_card(
        card, dtype, tol, sq, window, q_offset):
    """phi4-mini-3.8b's layout (24 heads over 8, D=128): bf16 on the tensor
    cores, f32 on the wide CUDA-core design, through the model layout's
    strided views."""
    g = torch.Generator(device="cuda").manual_seed(sq + q_offset)
    sk = sq + q_offset
    q = torch.randn(1, sq, 8, 3, 128, generator=g, device="cuda").to(TDT[dtype])
    k = torch.randn(1, sk, 8, 128, generator=g, device="cuda").to(TDT[dtype])
    v = torch.randn(1, sk, 8, 128, generator=g, device="cuda").to(TDT[dtype])
    kw = dict(causal=True, window=window, q_offset=q_offset)
    before = tops.flash_attention.launches
    got = tops.flash_attention(q, k, v, **kw)
    want = tops.flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert tops.flash_attention.launches == before + 1
    assert got.shape == q.shape and got.dtype == q.dtype
    assert float((got.float() - want.float()).abs().max()) < tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [("bfloat16", 2e-2), ("float32", 1e-4)])
@pytest.mark.parametrize("positions", [[0], [0, 1, 63, 64, 65, 127, 128, 700]])
def test_split_paged_kernel_at_head_dim_128_matches_plain_version_on_the_card(
        card, dtype, tol, positions):
    """phi4-mini-3.8b's decode shape (8 kv heads, G=3, hd=128) at B=1 and 8,
    chunk edges and position 0, two calls in a row."""
    case = _paged_case(13, len(positions), kv=8, g=3, hd=128, pt=8, maxp=96,
                       positions=positions)
    q, kp, vp, tables, pos = (torch.from_numpy(a).cuda() for a in case)
    q, kp, vp = (t.to(TDT[dtype]) for t in (q, kp, vp))
    want = tref.ref_paged_attention(q, kp, vp, tables, pos)
    for _ in range(2):
        got = tops.paged_attention(q, kp, vp, tables, pos)
        torch.cuda.synchronize()
        assert float((got.float() - want.float()).abs().max()) < tol


def _two_paged_inputs(dtype):
    """Two decode batches of one shape (so of one counter count) with other
    contents, long enough that each launch spreads over many chunks."""
    out = []
    for seed in (21, 22):
        case = _paged_case(seed, 8, kv=2, g=7, hd=64, pt=8, maxp=128,
                           positions=[1023, 1000, 990, 700, 900, 1010, 800, 1020])
        q, kp, vp, tables, pos = (torch.from_numpy(a).cuda() for a in case)
        q, kp, vp = (t.to(TDT[dtype]) for t in (q, kp, vp))
        out.append(((q, kp, vp, tables, pos),
                    tref.ref_paged_attention(q, kp, vp, tables, pos)))
    return out


@pytest.mark.cuda
def test_split_paged_kernel_on_two_streams_at_once_on_the_card(card):
    """Two streams each launch the split kernel on other inputs, queued
    behind a GPU sleep so that both launches are in flight together: each
    stream's launches have completion counters of their own, so each
    result equals its plain version."""
    cases = _two_paged_inputs("bfloat16")
    tops.paged_attention(*cases[0][0])                 # build, counters of this stream
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for _ in range(3):
        torch.cuda.synchronize()
        outs = []
        for s, (args, _) in zip(streams, cases):
            with torch.cuda.stream(s):
                torch.cuda._sleep(20_000_000)           # ~10 ms: both queues fill first
                outs.append([tops.paged_attention(*args) for _ in range(4)])
        torch.cuda.synchronize()
        for (_, want), got in zip(cases, outs):
            for o in got:
                assert float((o.float() - want.float()).abs().max()) < 2e-2
    device = cases[0][0][0].device
    assert {(device, s.cuda_stream) for s in streams} <= set(tpa._counters)


@pytest.mark.cuda
def test_split_paged_kernel_in_two_cuda_graphs_on_the_card(card):
    """Two CUDA graphs, each capturing one launch of the split kernel on
    other inputs, replayed back to back and then at once on two streams:
    each captured launch has counters of its own, zeroed inside its graph,
    so every replay equals its plain version."""
    cases = _two_paged_inputs("float32")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):                       # build and warm up off capture
        for args, _ in cases:
            tops.paged_attention(*args)
    torch.cuda.current_stream().wait_stream(side)
    graphs, outs = [], []
    held = len(tpa._graph_counters)
    for args, _ in cases:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            outs.append(tops.paged_attention(*args))
        graphs.append(graph)
    assert len(tpa._graph_counters) == held + 2
    for _ in range(3):
        for graph in graphs:
            graph.replay()
        torch.cuda.synchronize()
        for (_, want), got in zip(cases, outs):
            assert float((got - want).abs().max()) < 1e-4
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for _ in range(3):
        torch.cuda.synchronize()
        for s, graph in zip(streams, graphs):
            with torch.cuda.stream(s):
                torch.cuda._sleep(20_000_000)
                graph.replay()
        torch.cuda.synchronize()
        for (_, want), got in zip(cases, outs):
            assert float((got - want).abs().max()) < 1e-4


@pytest.mark.cuda
def test_local_mapped_kernels_on_the_one_card_mesh_match_the_bare_kernels(card):
    """Under the one-card (1, 1) mesh (a world-size-1 NCCL group over a
    HashStore) the model's ``local_map``'d flash prefill and paged decode at
    qwen2's layout (14 heads over 2, hd 64, bf16) give the bare kernels'
    outputs (flash exactly, split-KV paged within bf16's 2e-2), each one
    launch; a DTensor is refused by the wrapper."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import one_card_mesh
    from repro_torch.models import attention as attn
    from repro_torch.runtime import mesh_ctx

    g = torch.Generator(device="cuda").manual_seed(5)
    q = torch.randn(2, 256, 2, 7, 64, generator=g, device="cuda").bfloat16()
    k = torch.randn(2, 256, 2, 64, generator=g, device="cuda").bfloat16()
    v = torch.randn(2, 256, 2, 64, generator=g, device="cuda").bfloat16()
    case = _paged_case(12, 8, kv=2, g=7, hd=64, pt=16, maxp=64,
                       positions=[0, 15, 16, 100, 255, 511, 700, 1000])
    qd, kp, vp, tables, pos = (torch.from_numpy(a).cuda() for a in case)
    qd, kp, vp = (t.bfloat16() for t in (qd, kp, vp))
    want_flash = tops.flash_attention(q, k, v)
    want_paged = tops.paged_attention(qd, kp, vp, tables, pos)
    mesh = one_card_mesh()
    try:
        with mesh_ctx.use_mesh(mesh):
            before = (tops.flash_attention.launches, tops.paged_attention.launches)
            got_flash = attn.attend(attn._shard_q(q), attn._shard_kv(k),
                                    attn._shard_kv(v))
            got_paged = attn.attend_paged_decode(attn._shard_q(qd[:, None]), kp, vp,
                                                 tables, pos)
            torch.cuda.synchronize()
            assert (tops.flash_attention.launches, tops.paged_attention.launches) == (
                before[0] + 1, before[1] + 1)
            assert hasattr(got_flash, "device_mesh") and hasattr(got_paged, "device_mesh")
            assert torch.equal(got_flash.to_local(), want_flash)
            # split-KV: the last CTA of a row folds the chunks in arrival order
            assert float((got_paged.to_local()[:, 0].float() - want_paged.float())
                         .abs().max()) < 2e-2
            with pytest.raises(TypeError, match="DTensor"):
                tops.flash_attention(attn._shard_q(q), k, v)
    finally:
        dist.destroy_process_group()
