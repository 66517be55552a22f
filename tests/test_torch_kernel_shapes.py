"""The three CUDA kernels at every shape their rules take: each wrapper's
rule (``instance``: which head dims and SSD shapes run, on which padded
instance, within the shared-memory budget), the refusals outside it, the
plain versions at the padded shapes against the reference's Pallas kernels
in interpret mode, and the serving CLI at mamba2-130m's tiny preset (SSD at
P = 64, N = 64) against the reference's CLI on the same weights.

Tolerance against the reference: f32, max-abs 1e-5 of max(1, max|want|)
(the same arithmetic in another framework); 1e-4 for the SSD kernels' own
decomposition against the sequential oracle (another chunking, as in
``test_torch_ssm.py``).  The tests marked ``cuda`` hold
each kernel against its plain version on the card at the shapes
``chip_smoke.py``'s ``[shapes]`` phase runs, with the tolerances of the
kernels' own card tests (``test_torch_kernels.py``, ``test_torch_ssm.py``):
attention bf16 2e-2 and f32 1e-4 max-abs, SSD 1e-4 of the scale against the
plain chunked scan; they skip without a card.
"""
import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core.planner import MemoryPlanner
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd_scan as tssd
from repro_torch.models import ssm as tssm

REL = 1e-5
DTYPES = (torch.float32, torch.bfloat16)
CARD_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
SSD_CARD_REL = 1e-4     # another chunk length (test_torch_ssm.REL_CHUNKING)
_pallas_paged = jax.jit(functools.partial(jops.paged_attention, interpret=True))
_pallas_ssd = jax.jit(jops.ssd_scan, static_argnames=("chunk", "interpret"))


def _rel(want, got) -> float:
    want = np.asarray(want, np.float32)
    got = got.detach().float().cpu().numpy()
    return float(np.abs(want - got).max() / max(1.0, np.abs(want).max()))


def _fits(blocks) -> bool:
    return MemoryPlanner.check_smem(blocks)["fits"]


# --------------------------------------------------------------------------
# the rules
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_flash_rule_takes_every_multiple_of_8_up_to_256(dtype):
    """D from 1 to 300: a multiple of 8 from 8 to 256 runs on the smallest
    of the 64, 128 and 256 instances that holds it, within the budget;
    anything else raises, naming the rule."""
    for d in range(1, 301):
        if d % 8 == 0 and d <= 256:
            width = tfa.instance(d)
            assert width == min(w for w in (64, 128, 256) if d <= w), d
            assert _fits(tfa.smem_blocks(d, dtype)), d
            assert tfa.smem_blocks(d, dtype) == tfa.smem_blocks(width, dtype)
        else:
            with pytest.raises(ValueError, match="multiple of 8 from 8 to 256"):
                tfa.instance(d)


@pytest.mark.parametrize("group", [1, 4, 7, 12])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_paged_rule_takes_every_multiple_of_8_up_to_256(dtype, group):
    """hd from 1 to 300 at G query rows per kv head: a multiple of 8 from 8
    to 256 runs on the 64, 128 or 256 instance, within the budget."""
    for hd in range(1, 301):
        if hd % 8 == 0 and hd <= 256:
            width = tpa.instance(hd)
            assert width == min(w for w in (64, 128, 256) if hd <= w), hd
            assert _fits(tpa.smem_blocks(group, hd, dtype)), (hd, group)
            assert tpa.smem_blocks(group, hd, dtype) == tpa.smem_blocks(group, width, dtype)
        else:
            with pytest.raises(ValueError, match="multiple of 8 from 8 to 256"):
                tpa.instance(hd)


@pytest.mark.parametrize("p_range", [range(1, 37), range(37, 73)], ids=["p1-36", "p37-72"])
def test_ssd_rule_on_a_grid(p_range):
    """(P, N) over P up to 72 and N up to 264: P a multiple of 8 up to 64
    and N one up to 256 run on the (64, 128) or (64, 256) instance, every
    launch within the budget; the rest raise, naming the rule."""
    for p in p_range:
        for n in range(1, 265):
            if p % 8 == 0 and p <= 64 and n % 8 == 0 and n <= 256:
                assert tssd.instance(p, n, 1, 1) == (64, 128 if n <= 128 else 256)
                for launch in tssd.LAUNCHES:
                    assert _fits(tssd.smem_blocks(launch, p, n)), (p, n, launch)
            else:
                with pytest.raises(ValueError, match="the SSD kernels take"):
                    tssd.instance(p, n, 1, 1)


def test_ssd_rule_takes_every_group_that_divides_the_heads():
    for h in range(1, 33):
        for g in range(1, 33):
            if h % g == 0:
                assert tssd.instance(64, 128, g, h) == (64, 128)
            else:
                with pytest.raises(ValueError, match="G a divisor of H"):
                    tssd.instance(64, 128, g, h)


def test_padded_instances_working_sets():
    """The instances' working sets as the sources size them: flash bf16 at
    D=80 is the width-128 tensor-core design (Q tile, two-stage K/V ring,
    1 KB alignment), f32 at D=16 the width-64 design's padded rows; paged
    at hd=256 stages 256-column rows padded by 16 bytes; the SSD's (64,
    256) instance holds 132 KB in the chunk kernel and 165 KB in the
    output kernel, one CTA an SM."""
    fp = MemoryPlanner.smem_footprint
    assert fp(tfa.smem_blocks(80, torch.bfloat16)) == 5 * 64 * 128 * 2 + 1024
    assert fp(tfa.smem_blocks(16, torch.float32)) == 2 * 32 * 65 * 4
    assert fp(tfa.smem_blocks(160, torch.float32)) == 2 * 32 * 256 * 4
    fixed = 4 * (4 * 256 + 4 * 64 + 2 * 4)
    assert fp(tpa.smem_blocks(4, 256, torch.bfloat16)) == 2 * 64 * 264 * 2 + fixed
    assert fp(tpa.smem_blocks(4, 256, torch.float32)) == 2 * 64 * 260 * 4 + fixed
    assert fp(tssd.smem_blocks("chunk", 64, 256)) == 2 * 64 * 264 * 4 == 135168
    assert fp(tssd.smem_blocks("output", 64, 256)) == 4 * (
        64 * 260 + 64 * 260 + 64 * 72 + 64 * 68 + 64) == 169216
    assert fp(tssd.smem_blocks("output", 16, 16)) == fp(tssd.smem_blocks("output", 64, 128))


def _flash_args(d):
    return [torch.zeros(1, 4, 8, d), torch.zeros(1, 2, 8, d), torch.zeros(1, 2, 8, d)]


def _paged_args(hd):
    return [torch.zeros(1, 2, 2, hd), torch.zeros(3, 8, 2, hd), torch.zeros(3, 8, 2, hd),
            torch.zeros(1, 2, dtype=torch.int32), torch.zeros(1, dtype=torch.int32)]


def _ssd_args(p, n, g, h):
    return [torch.zeros(1, 8, h, p), torch.zeros(1, 8, h), torch.zeros(1, 8, g, n),
            torch.zeros(1, 8, g, n)]


@pytest.mark.parametrize("launcher,args,rule", [
    *((tfa.flash_attention_bhsd, _flash_args(d), "head dim") for d in (4, 12, 44, 264)),
    *((tpa.paged_attention_decode, _paged_args(hd), "head dim") for hd in (4, 12, 100, 264)),
    *((tssd.ssd_scan_kernel, _ssd_args(*s), "the SSD kernels take")
      for s in ((12, 16, 1, 2), (72, 64, 1, 2), (64, 264, 1, 2), (64, 20, 1, 2),
                (16, 16, 3, 4))),
], ids=lambda v: getattr(v, "__name__", None))
def test_launchers_refuse_shapes_outside_the_rule(launcher, args, rule):
    """A shape outside the rule raises its ``ValueError`` before anything is
    checked or built: never padded, copied or sent to the plain version."""
    with pytest.raises(ValueError, match=rule):
        launcher(*args)


def test_cpu_tensors_outside_the_rule_run_the_plain_version():
    """The wrappers check the working set only of a shape some instance
    takes: on the CPU, where the plain version runs, any shape does."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((1, 9, 2, 2, 12), (1, 9, 2, 12), (1, 9, 2, 12)))
    assert torch.equal(tops.flash_attention(q, k, v), tops.flash_attention_plain(q, k, v))
    qp, kp, vp = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                  for s in ((1, 2, 2, 12), (3, 8, 2, 12), (3, 8, 2, 12)))
    tables, pos = torch.tensor([[2, 0]], dtype=torch.int32), torch.tensor([9], dtype=torch.int32)
    assert torch.equal(tops.paged_attention(qp, kp, vp, tables, pos),
                       tref.ref_paged_attention(qp, kp, vp, tables, pos))
    x = torch.from_numpy(rng.standard_normal((1, 9, 2, 12)).astype(np.float32))
    dt = torch.full((1, 9, 2), 0.5)
    bc = torch.from_numpy(rng.standard_normal((1, 9, 1, 12)).astype(np.float32))
    y, h = tops.ssd_scan(x, dt, torch.zeros(2), bc, bc, torch.ones(2))
    assert y.shape == x.shape and h.shape == (1, 2, 12, 12) and torch.isfinite(y).all()


# --------------------------------------------------------------------------
# the plain versions at the padded shapes against the reference's kernels
# --------------------------------------------------------------------------


@pytest.mark.parametrize("window,q_offset", [(0, 0), (8, 0), (0, 24)],
                         ids=["causal", "window8", "q_offset24"])
@pytest.mark.parametrize("d", [8, 16, 40, 80])
def test_flash_plain_at_padded_head_dims_matches_pallas(d, window, q_offset):
    """The plain version (what the wrapper runs for CPU tensors) against the
    reference's flash kernel in interpret mode, f32, 2 kv heads of 2."""
    rng = np.random.default_rng(d + window + q_offset)
    sq = 37
    sk = sq + q_offset
    q = rng.standard_normal((1, sq, 2, 2, d)).astype(np.float32)
    k = rng.standard_normal((1, sk, 2, d)).astype(np.float32)
    v = rng.standard_normal((1, sk, 2, d)).astype(np.float32)
    kw = dict(causal=True, window=window, q_offset=q_offset)
    got = tops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), **kw)
    want = jops.flash_attention(*(jnp.asarray(a) for a in (q, k, v)), **kw,
                                block_q=16, block_k=16, interpret=True)
    assert got.shape == q.shape
    assert _rel(want, got) < REL


def _paged_case(seed, hd, positions, kv=2, g=4, pt=8, maxp=12):
    rng = np.random.default_rng(seed)
    b = len(positions)
    n_pool = b * maxp + 3
    order = rng.permutation(n_pool)
    tables = np.zeros((b, maxp), np.int32)
    used = 0
    for i, p in enumerate(positions):
        need = p // pt + 1
        tables[i, :need] = order[used:used + need]
        used += need
    q = rng.standard_normal((b, kv, g, hd)).astype(np.float32)
    kp = rng.standard_normal((n_pool, pt, kv, hd)).astype(np.float32)
    vp = rng.standard_normal((n_pool, pt, kv, hd)).astype(np.float32)
    return q, kp, vp, tables, np.asarray(positions, np.int32)


@pytest.mark.parametrize("hd", [16, 80, 256])
def test_paged_plain_at_padded_head_dims_matches_pallas(hd):
    """The plain version against the reference's paged kernel in interpret
    mode and its oracle, f32, ragged last pages, fragmented tables."""
    case = _paged_case(hd, hd, [0, 7, 8, 50, 95])
    got = tops.paged_attention(*(torch.from_numpy(a) for a in case))
    jcase = [jnp.asarray(a) for a in case]
    assert _rel(_pallas_paged(*jcase), got) < REL
    assert _rel(jref.ref_paged_attention(*jcase), got) < REL


def _ssd_inputs(b, s, h, p, g, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)) - 1.0)).astype(np.float32)
    a_log = np.linspace(-3.0, 1.0, h).astype(np.float32)
    bm = rng.standard_normal((b, s, g, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, g, n)).astype(np.float32)
    d = rng.standard_normal(h).astype(np.float32)
    return x, dt, a_log, bm, cm, d


SSD_SHAPES = [(16, 16, 1), (64, 64, 1), (32, 64, 2)]


@pytest.mark.parametrize("p,n,g", SSD_SHAPES)
def test_ssd_plain_at_padded_shapes_matches_pallas(p, n, g):
    """The wrapper's plain version against the reference's wrapper around
    its SSD kernel in interpret mode: 4 heads, 45 tokens over chunks of 16
    (a ragged last chunk), f32."""
    args = _ssd_inputs(1, 45, 4, p, g, n, seed=p + n + g)
    jy, jh = _pallas_ssd(*(jnp.asarray(a) for a in args), chunk=16, interpret=True)
    ty, th = tops.ssd_scan(*(torch.from_numpy(a) for a in args), chunk=16)
    assert _rel(jy, ty) < REL and _rel(jh, th) < REL


@pytest.mark.parametrize("p,n,g", SSD_SHAPES)
def test_ssd_kernels_decomposition_at_padded_shapes_matches_the_oracle(p, n, g):
    """The CUDA kernels' own decomposition in plain PyTorch
    (``ref.ssd_chunk_scan_split``, chunks of the kernels' 64) against the
    reference's sequential oracle: 150 tokens, f32, 1e-4 of the scale
    (another chunking)."""
    x, dt, a_log, bm, cm, _ = _ssd_inputs(1, 150, 4, p, g, n, seed=p * n + g)
    dta = (dt * -np.exp(a_log)).astype(np.float32)
    xdt = (x * dt[..., None]).astype(np.float32)
    jy, jh = jref.ref_ssd(*(jnp.asarray(a) for a in (xdt, dta, bm, cm)))
    ty, th = tref.ssd_chunk_scan_split(*(torch.from_numpy(a) for a in (xdt, dta, bm, cm)),
                                       chunk=tssd.CHUNK)
    assert _rel(jy, ty) < 1e-4 and _rel(jh, th) < 1e-4


# --------------------------------------------------------------------------
# the serving CLI at the reduced preset (SSD at P = 64, N = 64)
# --------------------------------------------------------------------------


def test_serve_cli_at_mamba2_tiny_matches_the_reference_cli(monkeypatch):
    """``launch.serve.main`` at mamba2-130m's tiny preset, the CLI's default
    size (ssm_state min(128, 64) = 64), against the reference's
    ``repro.launch.serve.main`` with the same arguments: the port serves the
    reference CLI's weights (``init(PRNGKey(0))``, bridged) and prompts
    (``randint(PRNGKey(rid))``), and every greedy token stream is equal."""
    from repro.launch import serve as jserve
    from repro_torch.launch import serve as tserve
    from repro_torch.models import Transformer, params_from_jax
    from repro_torch.serving import GenRequest

    seen = {}

    class Recorded(jserve.ServeEngine):
        def __init__(self, model, params, **kw):
            super().__init__(model, params, **kw)
            seen["ref"] = self

    argv = ["--arch", "mamba2-130m", "--preset", "tiny"]
    monkeypatch.setattr(jserve, "ServeEngine", Recorded)
    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    jserve.main()
    ref = seen["ref"]
    np_tree = jax.tree.map(np.asarray, ref.params)
    monkeypatch.setattr(Transformer, "init_loaded",
                        lambda self, gen: self.load(params_from_jax(np_tree)))

    def drive(eng, live):
        vocab = eng.model.cfg.vocab_size
        same = [GenRequest(rid=r.rid, prompt=torch.tensor(np.asarray(
                    jax.random.randint(jax.random.PRNGKey(r.rid), (len(r.prompt),), 0,
                                       vocab)), dtype=torch.int32),
                           gen_len=r.gen_len, arrival=r.arrival) for r in live]
        return eng.run(same)

    eng = tserve.main([*argv, "--device", "cpu"], run=drive)
    cfg = eng.model.cfg
    assert (cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_groups) == (64, 64, 1)
    assert tssd.instance(64, 64, 1, cfg.ssm_heads) == (64, 128)
    want = {rid: [int(t) for t in toks] for rid, toks in ref.completed.items()}
    assert len(want) == 8 and eng.completed == want


# --------------------------------------------------------------------------
# on the card: each kernel against its plain version at the [shapes] cases
# --------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: run on the card with "
                    "`python -m pytest -m cuda tests`")


FLASH_CARD_CASES = [
    *((d, 512, 0, 0, True) for d in (16, 40, 80, 96, 112, 160)),
    (96, 1024, 0, 0, True), (16, 512, 8, 64, True), (80, 512, 0, 0, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("d,sq,window,q_offset,causal", FLASH_CARD_CASES)
def test_flash_kernel_at_padded_head_dims_matches_plain_version_on_the_card(
        card, d, sq, window, q_offset, causal, dtype):
    """B=1, 32 heads over 8 (phi-2's D = 80 and Phi-3-mini's D = 96 at 32
    heads), through the model layout's strided views; at D = 80 a scale
    from the instance's 128 instead of the true D would miss by far more
    than the tolerance."""
    g = torch.Generator(device="cuda").manual_seed(d * sq + window)
    sk = sq + q_offset
    q = torch.randn(1, sq, 8, 4, d, generator=g, device="cuda").to(dtype)
    k = torch.randn(1, sk, 8, d, generator=g, device="cuda").to(dtype)
    v = torch.randn(1, sk, 8, d, generator=g, device="cuda").to(dtype)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    before = tops.flash_attention.launches
    got = tops.flash_attention(q, k, v, **kw)
    want = tops.flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert tops.flash_attention.launches == before + 1
    assert got.shape == q.shape and got.dtype == dtype
    assert float((got.float() - want.float()).abs().max()) < CARD_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("hd", [16, 80, 96, 256])
def test_paged_kernel_at_padded_head_dims_matches_plain_version_on_the_card(card, hd, dtype):
    """B=8, 8 kv heads of 4, 16-token pages, positions up to 1039 on and
    across the 64-token chunk edges, two calls in a row."""
    case = _paged_case(hd + 1, hd, [0, 15, 63, 64, 100, 513, 1000, 1039], kv=8, g=4,
                       pt=16, maxp=65)
    q, kp, vp, tables, pos = (torch.from_numpy(a).cuda() for a in case)
    q, kp, vp = (t.to(dtype) for t in (q, kp, vp))
    want = tref.ref_paged_attention(q, kp, vp, tables, pos)
    before = tops.paged_attention.launches
    for _ in range(2):
        got = tops.paged_attention(q, kp, vp, tables, pos)
        torch.cuda.synchronize()
        assert float((got.float() - want.float()).abs().max()) < CARD_TOL[dtype]
    assert tops.paged_attention.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("p,n,g,s", [(16, 16, 1, 512), (64, 64, 1, 512), (64, 64, 1, 37),
                                     (32, 64, 2, 512), (64, 128, 8, 512), (64, 256, 1, 512)])
def test_ssd_kernels_at_padded_shapes_match_plain_version_on_the_card(card, p, n, g, s,
                                                                      dtype):
    """24 heads, B=1; Codestral Mamba's (64, 128, 8) and the width-256
    instance among them; B/C in f32 and bf16."""
    x, dt, a_log, bm, cm, d = (torch.from_numpy(a).cuda()
                               for a in _ssd_inputs(1, s, 24, p, g, n, seed=p + n + s))
    bm, cm = bm.to(dtype), cm.to(dtype)
    before = tops.ssd_scan.launches
    y, h = tops.ssd_scan(x, dt, a_log, bm, cm, d, chunk=256)
    wy, wh = tssm.ssd_chunked(x, dt, a_log, bm, cm, d, chunk=256)
    torch.cuda.synchronize()
    assert tops.ssd_scan.launches == before + 1
    assert _rel(wy.cpu().numpy(), y) < SSD_CARD_REL and _rel(wh.cpu().numpy(), h) < SSD_CARD_REL


@pytest.mark.cuda
def test_cuda_tensors_outside_the_rule_raise_on_the_card(card):
    """No fallback: a CUDA tensor outside a kernel's rule raises the rule's
    ``ValueError`` from the wrapper, never reaching the plain version."""
    z = functools.partial(torch.zeros, device="cuda")
    with pytest.raises(ValueError, match="multiple of 8 from 8 to 256"):
        tops.flash_attention(z(1, 8, 2, 2, 44), z(1, 8, 2, 44), z(1, 8, 2, 44))
    with pytest.raises(ValueError, match="multiple of 8 from 8 to 256"):
        tops.paged_attention(z(1, 2, 2, 12), z(3, 8, 2, 12), z(3, 8, 2, 12),
                             z(1, 2, dtype=torch.int32), z(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="the SSD kernels take"):
        tops.ssd_scan(z(1, 8, 2, 12), z(1, 8, 2), z(2), z(1, 8, 1, 16), z(1, 8, 1, 16), z(2))
