"""The SSD slice against the reference: the port's ``ssd_chunked``,
``ssd_decode``, ``ref_ssd`` and ``ops.ssd_scan`` (whose plain version runs
for these CPU tensors), and the mamba2 blocks, on the same numpy-seeded
inputs.  The reference's ``ops.ssd_scan`` runs its Pallas kernel in
interpret mode (tests/conftest.py sets it).

Tolerances, in f32: max-abs error at most 2e-5 of max|y| (or of max|h|).
Both sides compute the same chunked algorithm in f32, but XLA and PyTorch
order the einsum and cumsum sums differently; observed errors are ~5e-7 of
the scale.  Comparisons across chunk lengths get 1e-4 of the scale: a
chunking changes which terms go through the decayed state and which through
the quadratic form, so the rounding differs more (the algorithm is exact for
any chunking).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import ssd_scan as jssd_kernel
from repro.models import RunOpts as JRunOpts
from repro.models import Transformer as JTransformer
from repro.models import ssm as jssm
from repro_torch.configs import get_config as tget_config
from repro_torch.core.planner import MemoryPlanner
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd_scan as tssd
from repro_torch.models import RunOpts as TRunOpts
from repro_torch.models import Transformer as TTransformer
from repro_torch.models import params_from_jax
from repro_torch.models import ssm as tssm
from torch_port_utils import ref_params

REL = 2e-5          # same algorithm, other sum order
REL_CHUNKING = 1e-4  # another chunk length

# the reference's functions, jitted (eager JAX dispatch is ~10x slower here)
J_SSD_CHUNKED = jax.jit(jssm.ssd_chunked, static_argnames=("chunk",))
J_SSD_SCAN = jax.jit(jops.ssd_scan, static_argnames=("chunk", "interpret"))
J_REF_SSD = jax.jit(jref.ref_ssd)
J_SSD_KERNEL = jax.jit(jssd_kernel.ssd_scan_kernel, static_argnames=("chunk", "interpret"))
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
J_SSD_DECODE = jax.jit(jssm.ssd_decode)
J_PREFILL = jax.jit(jssm.mamba2_block_prefill, static_argnums=(2, 3),
                    static_argnames=("chunk",))
J_BLOCK = jax.jit(jssm.mamba2_block, static_argnums=(2, 3),
                  static_argnames=("chunk",))
J_DECODE = jax.jit(jssm.mamba2_block_decode, static_argnums=(3, 4))


# --------------------------------------------------------------------------
# helpers shared with the mamba2 cases of test_torch_model / test_torch_serving
# --------------------------------------------------------------------------


def mamba2_cfgs(dtype: str = "float32", **over):
    """(reference, port) smoke configs of mamba2-130m: 2 layers, d_model 64,
    8 SSD heads of 16, state 16, G = 1."""
    return (jget_config("mamba2-130m").smoke().with_overrides(dtype=dtype, **over),
            tget_config("mamba2-130m").smoke().with_overrides(dtype=dtype, **over))


def mamba2_models(dtype: str = "float32", *, seed: int = 0, use_kernels=True,
                  ssd_chunk: int = 8, **over):
    """(jax model, jax params, port model, port params) on the same weights,
    zero-initialised leaves randomised.  ``use_kernels`` selects the kernel
    route on both sides (the reference's Pallas SSD kernel in interpret mode
    for ``forward``; the port's wrapper, plain for CPU tensors)."""
    jcfg, tcfg = mamba2_cfgs(dtype, **over)
    jparams, np_tree = ref_params(jcfg, seed)
    jm = JTransformer(jcfg, JRunOpts(use_kernels=use_kernels, ssd_chunk=ssd_chunk))
    tm = TTransformer(tcfg, TRunOpts(use_kernels=use_kernels, ssd_chunk=ssd_chunk),
                      device="cpu")
    return jm, jparams, tm, tm.load(params_from_jax(np_tree))


def ssd_inputs(bsz, s, h, p, g, n, seed=0):
    """x, dt (softplus'd), a_log, b, c, d_skip as numpy f32; the heads'
    decays range from slow (A ~ -0.05) to fast (A ~ -3)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bsz, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((bsz, s, h)) - 1.0)).astype(np.float32)
    a_log = np.linspace(-3.0, 1.0, h).astype(np.float32)
    b = rng.standard_normal((bsz, s, g, n)).astype(np.float32)
    c = rng.standard_normal((bsz, s, g, n)).astype(np.float32)
    d = rng.standard_normal(h).astype(np.float32)
    return x, dt, a_log, b, c, d


def rel_err(want, got) -> float:
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    return float(np.abs(want - got).max() / max(1.0, np.abs(want).max()))


@pytest.fixture
def cuda_device():
    """The card, decided when the test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: run on the card with "
                    "`python -m pytest -m cuda tests`")
    return torch.device("cuda")


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


# (B, S, H, P, G, N, chunk): ragged tail, S < chunk, S = 1, G > 1, several chunks
SSD_CASES = [(2, 37, 4, 8, 1, 16, 16), (1, 5, 4, 8, 1, 16, 16),
             (1, 1, 2, 8, 1, 16, 8), (2, 29, 4, 8, 2, 16, 8),
             (1, 64, 6, 16, 3, 8, 16)]


# --------------------------------------------------------------------------
# the SSD functions
# --------------------------------------------------------------------------


@pytest.mark.parametrize("case", SSD_CASES, ids=str)
def test_ssd_chunked_matches_reference(case):
    *shape, chunk = case
    args = ssd_inputs(*shape)
    jy, jh = J_SSD_CHUNKED(*_j(*args), chunk=chunk)
    ty, th = tssm.ssd_chunked(*_t(*args), chunk=chunk)
    assert ty.dtype == th.dtype == torch.float32
    assert tuple(ty.shape) == jy.shape and tuple(th.shape) == jh.shape
    assert rel_err(jy, ty) < REL and rel_err(jh, th) < REL


@pytest.mark.parametrize("case", SSD_CASES, ids=str)
def test_ops_ssd_scan_matches_reference_kernel(case):
    """The port's wrapper (plain version for CPU tensors) against the
    reference's wrapper around its Pallas kernel (interpret mode)."""
    *shape, chunk = case
    args = ssd_inputs(*shape, seed=1)
    before = tops.ssd_scan.launches
    jy, jh = J_SSD_SCAN(*_j(*args), chunk=chunk)
    ty, th = tops.ssd_scan(*_t(*args), chunk=chunk)
    assert rel_err(jy, ty) < REL and rel_err(jh, th) < REL
    assert tops.ssd_scan.launches == before        # CPU: no kernel launch


@pytest.mark.parametrize("case", SSD_CASES[:4], ids=str)
def test_ref_ssd_matches_reference_oracle_and_chunk_scan(case):
    *shape, chunk = case
    x, dt, a_log, b, c, _ = ssd_inputs(*shape, seed=2)
    dta = (dt * -np.exp(a_log)).astype(np.float32)
    xdt = (x * dt[..., None]).astype(np.float32)
    jy, jh = J_REF_SSD(*_j(xdt, dta, b, c))
    ty, th = tref.ref_ssd(*_t(xdt, dta, b, c))
    assert rel_err(jy, ty) < REL and rel_err(jh, th) < REL
    cy, ch = tref.ssd_chunk_scan(*_t(xdt, dta, b, c), chunk=chunk)
    assert rel_err(jy, cy) < REL_CHUNKING and rel_err(jh, ch) < REL_CHUNKING


# (B, S, H, P, G, N): ragged tails over several chunks, S < chunk, S = 1, G > 1
SPLIT_CASES = [(2, 37, 4, 8, 1, 16), (1, 5, 4, 8, 1, 16), (1, 1, 2, 8, 1, 16),
               (2, 29, 4, 8, 2, 16), (1, 150, 6, 16, 3, 8)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk", [8, 16, 64])
@pytest.mark.parametrize("case", SPLIT_CASES, ids=str)
def test_split_scan_matches_reference_oracle_and_kernel(case, chunk, dtype):
    """The CUDA kernels' decomposition (chunk states, C B^T once per group,
    the pass over the chunks, the outputs; ``ref.ssd_chunk_scan_split``)
    against the reference's sequential oracle ``ref_ssd`` and its Pallas
    kernel in interpret mode (chunk 16), B/C in f32 and in bf16 (rounded
    once, the same on both sides): 1e-4 of the scale, another chunking."""
    x, dt, a_log, b, c, _ = ssd_inputs(*case, seed=8)
    dta = (dt * -np.exp(a_log)).astype(np.float32)
    xdt = (x * dt[..., None]).astype(np.float32)
    jb, jc = (jnp.asarray(m).astype(JDT[dtype]) for m in (b, c))
    tb, tc = (torch.from_numpy(m).to(TDT[dtype]) for m in (b, c))
    y, h = tref.ssd_chunk_scan_split(*_t(xdt, dta), tb, tc, chunk=chunk)
    assert y.dtype == h.dtype == torch.float32 and tuple(y.shape) == x.shape
    jy, jh = J_REF_SSD(*_j(xdt, dta), jb, jc)
    assert rel_err(jy, y) < REL_CHUNKING and rel_err(jh, h) < REL_CHUNKING
    ky, kh = J_SSD_KERNEL(*_j(xdt, dta), jb, jc, chunk=16, interpret=True)
    assert rel_err(ky, y) < REL_CHUNKING and rel_err(kh, h) < REL_CHUNKING


def test_split_scan_carries_an_initial_state():
    """Step 3 starts from ``h0``: against the oracle from the same state."""
    x, dt, a_log, b, c, _ = ssd_inputs(2, 21, 4, 8, 2, 16, seed=9)
    h0 = np.random.default_rng(9).standard_normal((2, 4, 8, 16)).astype(np.float32)
    dta = (dt * -np.exp(a_log)).astype(np.float32)
    xdt = (x * dt[..., None]).astype(np.float32)
    jy, jh = J_REF_SSD(*_j(xdt, dta, b, c), h0=jnp.asarray(h0))
    y, h = tref.ssd_chunk_scan_split(*_t(xdt, dta, b, c), chunk=8, h0=torch.from_numpy(h0))
    assert rel_err(jy, y) < REL_CHUNKING and rel_err(jh, h) < REL_CHUNKING


@pytest.mark.parametrize("chunk", [4, 16, 64, 256])
def test_chunk_length_changes_only_rounding(chunk):
    """The algorithm is exact for any chunking, which lets the CUDA kernel
    scan in chunks of its own (``ssd_scan.CHUNK``) whatever ``chunk`` the
    plain version is given."""
    x, dt, a_log, b, c, d = ssd_inputs(1, 150, 4, 8, 1, 16, seed=3)
    want_y, want_h = tssm.ssd_chunked(*_t(x, dt, a_log, b, c, d), chunk=tssd.CHUNK)
    y, h = tssm.ssd_chunked(*_t(x, dt, a_log, b, c, d), chunk=chunk)
    assert rel_err(want_y.numpy(), y) < REL_CHUNKING
    assert rel_err(want_h.numpy(), h) < REL_CHUNKING


def test_ssd_chunked_with_initial_state_matches_reference():
    x, dt, a_log, b, c, d = ssd_inputs(2, 21, 4, 8, 2, 16, seed=4)
    h0 = np.random.default_rng(4).standard_normal((2, 4, 8, 16)).astype(np.float32)
    jy, jh = J_SSD_CHUNKED(*_j(x, dt, a_log, b, c, d), chunk=8, h0=jnp.asarray(h0))
    ty, th = tssm.ssd_chunked(*_t(x, dt, a_log, b, c, d), chunk=8,
                              h0=torch.from_numpy(h0))
    assert rel_err(jy, ty) < REL and rel_err(jh, th) < REL


@pytest.mark.parametrize("g", [1, 2])
def test_ssd_decode_matches_reference(g):
    x, dt, a_log, b, c, d = ssd_inputs(3, 1, 4, 8, g, 16, seed=5)
    h0 = np.random.default_rng(5).standard_normal((3, 4, 8, 16)).astype(np.float32)
    args = (h0, x[:, 0], dt[:, 0], a_log, b[:, 0], c[:, 0], d)
    jh, jy = J_SSD_DECODE(*_j(*args))
    th, ty = tssm.ssd_decode(*_t(*args))
    assert rel_err(jy, ty) < REL and rel_err(jh, th) < REL


def test_decode_continues_the_chunked_scan():
    """Prefill state + one decode step equals the scan over S + 1 tokens."""
    x, dt, a_log, b, c, d = ssd_inputs(2, 20, 4, 8, 1, 16, seed=6)
    t = _t(x, dt, a_log, b, c, d)
    y_all, h_all = tssm.ssd_chunked(*t, chunk=8)
    _, h_pre = tssm.ssd_chunked(t[0][:, :-1], t[1][:, :-1], t[2], t[3][:, :-1],
                                t[4][:, :-1], t[5], chunk=8)
    h_new, y_last = tssm.ssd_decode(h_pre, t[0][:, -1], t[1][:, -1], t[2],
                                    t[3][:, -1], t[4][:, -1], t[5])
    assert rel_err(y_all[:, -1].numpy(), y_last) < REL_CHUNKING
    assert rel_err(h_all.numpy(), h_new) < REL_CHUNKING


# --------------------------------------------------------------------------
# the kernel's launcher and working set (what runs without a card)
# --------------------------------------------------------------------------


def test_smem_working_set_fits_and_matches_the_source():
    """Each of the three launches' working sets fits and equals the
    source's: csrc/ssd_scan.cu CHUNK_SMEM = 2 Q (N+8) floats (B rows; C
    rows, or x rows and decays), none for the pass, OUT_SMEM = (Q (N+4) +
    P (N+4) + Q (P+8) + Q (Q+4) + Q) floats."""
    q, p, n = tssd.CHUNK, tssd.HEAD_DIM, tssd.STATES[0]
    want = {"chunk": 4 * 2 * q * (n + 8), "pass": 0,
            "output": 4 * (q * (n + 4) + p * (n + 4) + q * (p + 8) + q * (q + 4) + q)}
    assert want == {"chunk": 69632, "pass": 0, "output": 103680}
    for launch in tssd.LAUNCHES:
        check = MemoryPlanner.check_smem(tssd.smem_blocks(launch, p, n))
        assert check["fits"] and check["bytes"] == want[launch], launch


def test_launcher_refuses_what_the_kernel_does_not_take():
    """Shape and device checks raise before anything is built."""
    x, dt, a_log, b, c, _ = ssd_inputs(1, 8, 2, 12, 1, 16)
    dta = torch.from_numpy(dt * -np.exp(a_log))
    with pytest.raises(ValueError, match="the SSD kernels take"):
        tssd.ssd_scan_kernel(torch.from_numpy(x), dta, *_t(b, c))
    x64 = torch.zeros(1, 8, 2, 64)
    bc = torch.zeros(1, 8, 1, 128)
    with pytest.raises(ValueError, match="CUDA"):
        tssd.ssd_scan_kernel(x64, torch.zeros(1, 8, 2), bc, bc)
    with pytest.raises(ValueError, match="no kernel or plain version"):
        tops.ssd_scan(x64.to("meta"), torch.zeros(1, 8, 2, device="meta"),
                      torch.zeros(2, device="meta"), bc.to("meta"), bc.to("meta"),
                      torch.zeros(2, device="meta"))


@pytest.mark.cuda
def test_ssd_kernel_matches_plain_version_on_the_card(cuda_device):
    """Run on the card by ``python -m pytest -m cuda tests``: the kernel
    against its plain version at mamba2-130m's widths, ragged length."""
    x, dt, a_log, b, c, d = ssd_inputs(2, 300, 24, 64, 1, 128, seed=7)
    args = [a.to(cuda_device) for a in _t(x, dt, a_log, b, c, d)]
    for dtype in (torch.float32, torch.bfloat16):
        args[3], args[4] = args[3].to(dtype), args[4].to(dtype)
        before = tops.ssd_scan.launches
        y, h = tops.ssd_scan(*args)
        wy, wh = tssm.ssd_chunked(*args, chunk=256)
        torch.cuda.synchronize()
        assert tops.ssd_scan.launches == before + 1
        assert rel_err(wy.cpu().numpy(), y.cpu()) < REL_CHUNKING
        assert rel_err(wh.cpu().numpy(), h.cpu()) < REL_CHUNKING


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bsz,s", [(1, 37), (1, 512), (1, 1024), (2, 1024)])
def test_ssd_kernels_match_split_and_plain_versions_on_the_card(cuda_device, bsz, s,
                                                                dtype):
    """The three launches against the plain chunked scan (chunk 256: another
    chunking, 1e-4 of the scale) and against their own decomposition in
    plain PyTorch (chunk 64: another sum order only, 2e-5), at mamba2-130m's
    widths: a ragged short prompt, serving lengths and a batch of two."""
    x, dt, a_log, b, c, _ = ssd_inputs(bsz, s, 24, 64, 1, 128, seed=s + bsz)
    dta = (dt * -np.exp(a_log)).astype(np.float32)
    xdt = (x * dt[..., None]).astype(np.float32)
    xdt, dta, b, c = (t.to(cuda_device) for t in _t(xdt, dta, b, c))
    b, c = b.to(dtype), c.to(dtype)
    y, h = tssd.ssd_scan_kernel(xdt, dta, b, c)
    py, ph = tref.ssd_chunk_scan(xdt, dta, b, c, chunk=256)
    sy, sh = tref.ssd_chunk_scan_split(xdt, dta, b, c, chunk=tssd.CHUNK)
    torch.cuda.synchronize()
    assert rel_err(py.cpu().numpy(), y.cpu()) < REL_CHUNKING
    assert rel_err(ph.cpu().numpy(), h.cpu()) < REL_CHUNKING
    assert rel_err(sy.cpu().numpy(), y.cpu()) < REL
    assert rel_err(sh.cpu().numpy(), h.cpu()) < REL


# --------------------------------------------------------------------------
# the mamba2 blocks
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def m2():
    return mamba2_models()


@pytest.mark.parametrize("s", [1, 3, 19], ids=lambda s: f"S={s}")
def test_mamba2_block_prefill_matches_reference(m2, s):
    """Prompts shorter than the conv width (K = 4) left-pad the conv state."""
    jm, jp, tm, tp = m2
    cfg = jm.cfg
    rng = np.random.default_rng(10 + s)
    x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    jl = {k: v[0] for k, v in jp["pattern"]["0"].items() if k != "norm"}
    tl = tp["layers"][0]
    jout, jst = J_PREFILL(jnp.asarray(x), jl, cfg, jnp.float32, chunk=8)
    tout, tst = tssm.mamba2_block_prefill(torch.from_numpy(x), tl, tm.cfg,
                                          torch.float32, chunk=8, use_kernel=True)
    assert rel_err(jout, tout) < REL
    assert tuple(tst["conv"].shape) == jst["conv"].shape == (2, cfg.conv_width - 1,
                                                             cfg.d_inner + 2 * cfg.ssm_state)
    assert rel_err(jst["conv"], tst["conv"]) < REL
    assert rel_err(jst["ssm"], tst["ssm"]) < REL
    # mamba2_block is the same computation without the state
    jy = J_BLOCK(jnp.asarray(x), jl, cfg, jnp.float32, chunk=8)
    assert rel_err(jy, tssm.mamba2_block(torch.from_numpy(x), tl, tm.cfg,
                                         torch.float32, chunk=8)) < REL


def test_mamba2_block_decode_matches_reference(m2):
    jm, jp, tm, tp = m2
    cfg = jm.cfg
    rng = np.random.default_rng(11)
    conv_dim = cfg.d_inner + 2 * cfg.ssm_state
    state = {"conv": rng.standard_normal((3, cfg.conv_width - 1, conv_dim)).astype(np.float32),
             "ssm": rng.standard_normal((3, cfg.ssm_heads, cfg.ssm_head_dim,
                                         cfg.ssm_state)).astype(np.float32)}
    x = rng.standard_normal((3, cfg.d_model)).astype(np.float32)
    jl = {k: v[1] for k, v in jp["pattern"]["0"].items() if k != "norm"}
    jout, jst = J_DECODE(jnp.asarray(x), {k: jnp.asarray(v) for k, v in state.items()},
                                         jl, cfg, jnp.float32)
    tout, tst = tssm.mamba2_block_decode(torch.from_numpy(x),
                                         {k: torch.from_numpy(v) for k, v in state.items()},
                                         tp["layers"][1], tm.cfg, torch.float32)
    assert rel_err(jout, tout) < REL
    assert rel_err(jst["conv"], tst["conv"]) < REL and rel_err(jst["ssm"], tst["ssm"]) < REL
