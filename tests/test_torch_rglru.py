"""The RG-LRU slice against the reference: the port's plain scan
(``ref.ref_rglru``, what ``ops.rglru_scan`` runs for CPU tensors), its gates,
its one-token step and the three Griffin recurrent blocks, on the same
numpy-seeded inputs.  The reference's ``ops.rglru_scan`` runs its Pallas
kernel in interpret mode (tests/conftest.py sets it).

Tolerances, in f32: max-abs error at most 1e-5 of max|y|.  Both sides
compute the same recurrence in f32, in other orders (the reference
sequentially or by XLA's associative scan, the port by a Hillis-Steele scan
in blocks, or in the CUDA kernel's segmented order); observed errors are
~1e-7 of the scale.  The GeGLU check uses
the same tolerance and shows it is tight enough to tell the tanh gelu the
reference uses from PyTorch's default erf gelu.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_config as jget_config
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import layers as jlayers
from repro.models import rglru as jrglru
from repro_torch.configs import get_config as tget_config
from repro_torch.core.planner import MemoryPlanner
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rglru_scan as trg
from repro_torch.models import layers as tlayers
from repro_torch.models import params_from_jax
from repro_torch.models import rglru as trglru
from torch_port_utils import ref_params

REL = 1e-5

J_REF_RGLRU = jax.jit(jref.ref_rglru)
J_RGLRU_SCAN = jax.jit(jops.rglru_scan, static_argnames=("block", "interpret"))
J_GATES = jax.jit(jrglru._gates)
J_STEP = jax.jit(jrglru.rglru_step)
J_BLOCK = jax.jit(jrglru.recurrent_block, static_argnums=(2, 3),
                  static_argnames=("use_kernel",))
J_PREFILL = jax.jit(jrglru.recurrent_block_prefill, static_argnums=(2, 3))
J_DECODE = jax.jit(jrglru.recurrent_block_decode, static_argnums=(3, 4))


def rel_err(want, got) -> float:
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    return float(np.abs(want - got).max() / max(1.0, np.abs(want).max()))


def scan_inputs(bsz, s, lru, seed=0):
    """a in (0, 1) as the gates make it (exp of -8 softplus(1) r), b, h0."""
    rng = np.random.default_rng(seed)
    r = 1 / (1 + np.exp(-rng.standard_normal((bsz, s, lru))))
    a = np.exp(-8.0 * np.log1p(np.e) * r).astype(np.float32)
    b = rng.standard_normal((bsz, s, lru)).astype(np.float32)
    h0 = rng.standard_normal((bsz, lru)).astype(np.float32)
    return a, b, h0


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.fixture
def cuda_device():
    """The card, decided when the test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: run on the card with "
                    "`python -m pytest -m cuda tests`")
    return torch.device("cuda")


# --------------------------------------------------------------------------
# the scan: plain version, wrapper, oracle
# --------------------------------------------------------------------------

# (B, S, L, block, h0): S not a multiple of the block, S = 1, S < block
SCAN_CASES = [(2, 300, 64, 256, True), (1, 1, 32, 256, True),
              (2, 37, 16, 8, False), (1, 513, 8, 256, False),
              (3, 19, 24, 0, True)]


@pytest.mark.parametrize("case", SCAN_CASES, ids=str)
def test_ref_rglru_matches_reference_oracle(case):
    bsz, s, lru, block, with_h0 = case
    a, b, h0 = scan_inputs(bsz, s, lru, seed=s)
    h0 = h0 if with_h0 else None
    want = J_REF_RGLRU(jnp.asarray(a), jnp.asarray(b),
                       None if h0 is None else jnp.asarray(h0))
    got = tref.ref_rglru(*_t(a, b), None if h0 is None else torch.from_numpy(h0),
                         block=block)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert rel_err(want, got) < REL


@pytest.mark.parametrize("case", SCAN_CASES, ids=str)
def test_ops_rglru_scan_matches_reference_kernel(case):
    """The port's wrapper (plain version for CPU tensors) against the
    reference's wrapper around its Pallas kernel (interpret mode)."""
    bsz, s, lru, block, with_h0 = case
    a, b, h0 = scan_inputs(bsz, s, lru, seed=s + 1)
    h0 = h0 if with_h0 else None
    before = tops.rglru_scan.launches
    want = J_RGLRU_SCAN(jnp.asarray(a), jnp.asarray(b),
                        None if h0 is None else jnp.asarray(h0),
                        block=block or 256, interpret=True)
    got = tops.rglru_scan(*_t(a, b), None if h0 is None else torch.from_numpy(h0),
                          block=block)
    assert rel_err(want, got) < REL
    assert tops.rglru_scan.launches == before        # CPU: no kernel launch


@pytest.mark.parametrize("block", [1, 4, 64, 256, 0])
def test_block_length_changes_only_rounding(block):
    """The scan is exact for any blocking, which lets the CUDA kernel scan
    in segments of its own whatever block the plain version is given."""
    a, b, h0 = scan_inputs(2, 150, 16, seed=3)
    want = tref.ref_rglru(*_t(a, b, h0), block=0)
    assert rel_err(want.numpy(), tref.ref_rglru(*_t(a, b, h0), block=block)) < REL


# (B, S, L, h0, seg) for the kernel's segmented order: S = 1, S < one
# segment, one short of / at / one past a super-chunk of WARPS * SEG steps,
# S = 301 (ragged in segments and super-chunks), B = 2; and a small segment
# so that short S crosses many segments
SUPER = trg.WARPS * trg.SEG
SEGMENTED_CASES = [(1, 1, 40, True, trg.SEG), (1, 1, 40, False, trg.SEG),
                   (2, 19, 40, True, trg.SEG), (1, SUPER - 1, 40, False, trg.SEG),
                   (2, SUPER, 40, True, trg.SEG), (1, SUPER + 1, 40, True, trg.SEG),
                   (2, SUPER + 1, 40, False, trg.SEG), (2, 301, 40, True, trg.SEG),
                   (2, 301, 40, False, trg.SEG), (2, 37, 16, True, 4)]


@pytest.mark.parametrize("case", SEGMENTED_CASES, ids=str)
def test_segmented_rendition_matches_reference(case):
    """``ref.ref_rglru_segmented`` (the CUDA kernel's order: segment
    aggregates, the carry fold, the re-walk) against the reference's
    sequential oracle and its Pallas kernel in interpret mode."""
    bsz, s, lru, with_h0, seg = case
    a, b, h0 = scan_inputs(bsz, s, lru, seed=s + 11)
    h0 = h0 if with_h0 else None
    jh0 = None if h0 is None else jnp.asarray(h0)
    got = tref.ref_rglru_segmented(*_t(a, b), None if h0 is None else torch.from_numpy(h0),
                                   seg=seg)
    assert got.dtype == torch.float32 and tuple(got.shape) == (bsz, s, lru)
    assert rel_err(J_REF_RGLRU(jnp.asarray(a), jnp.asarray(b), jh0), got) < REL
    assert rel_err(J_RGLRU_SCAN(jnp.asarray(a), jnp.asarray(b), jh0, block=256,
                                interpret=True), got) < REL


def test_smem_working_set_fits_and_matches_the_source():
    """The launcher's constants are the source's (csrc/rglru_scan.cu WARPS
    and SEG), and its shared-memory working set, (P, Y) per (parity, warp,
    lane), fits and equals SMEM_BYTES = 2 WARPS 32 2 floats."""
    src = (Path(trg.__file__).parent / "csrc" / "rglru_scan.cu").read_text()
    consts = dict(re.findall(r"constexpr int (WARPS|SEG) = (\d+);", src))
    assert {k: int(v) for k, v in consts.items()} == {"WARPS": trg.WARPS, "SEG": trg.SEG}
    check = MemoryPlanner.check_smem(trg.smem_blocks())
    assert check["fits"] and check["bytes"] == 2 * trg.WARPS * 32 * 2 * 4 == 8192


def test_launcher_refuses_what_the_kernel_does_not_take():
    """Shape, dtype and device checks raise before anything is built."""
    a, b, h0 = _t(*scan_inputs(1, 8, 16))
    with pytest.raises(ValueError, match="CUDA"):
        trg.rglru_scan_kernel(a, b, h0)
    with pytest.raises(ValueError, match="one shape"):
        trg.rglru_scan_kernel(a, b[:, :4])
    with pytest.raises(ValueError, match="h0"):
        trg.rglru_scan_kernel(a, b, h0[:, :8])
    with pytest.raises(ValueError, match="no kernel or plain version"):
        tops.rglru_scan(a.to("meta"), b.to("meta"))


# (B, S, L) at the kernel's edges: recurrentgemma-9b's width at S = 1, a
# short prompt, one super-chunk exactly, a length ragged in segments and
# super-chunks (B = 2), the longest serving prompt; and an L that is no
# multiple of the CTA's 32 channels
CARD_CASES = [(2, 301, 4096), (1, 1, 4096), (1, 37, 4096), (1, SUPER, 4096),
              (1, 2600, 4096), (2, 301, 4004), (1, SUPER + 1, 4004)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES, ids=str)
def test_rglru_kernel_matches_plain_version_on_the_card(cuda_device, case):
    """Run on the card by ``python -m pytest -m cuda tests``: one launch
    of the kernel against its plain version and its segmented rendition,
    with and without h0."""
    bsz, s, lru = case
    a, b, h0 = (t.to(cuda_device) for t in _t(*scan_inputs(bsz, s, lru, seed=7)))
    for h in (None, h0):
        before = tops.rglru_scan.launches
        y = tops.rglru_scan(a, b, h)
        torch.cuda.synchronize()
        assert tops.rglru_scan.launches == before + 1
        assert tuple(y.shape) == (bsz, s, lru)
        assert rel_err(tref.ref_rglru(a, b, h).cpu().numpy(), y.cpu()) < REL
        assert rel_err(tref.ref_rglru_segmented(a, b, h, seg=trg.SEG).cpu().numpy(),
                       y.cpu()) < REL


# --------------------------------------------------------------------------
# gates, step and the recurrent blocks at recurrentgemma-9b's smoke size
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def rec_layer():
    """(reference config, port config, reference rec-layer params, port
    rec-layer params): the first rec block of the smoke model (lru 64 over
    4 gate blocks of 16), zero-initialised leaves randomised."""
    jcfg = jget_config("recurrentgemma-9b").smoke()
    tcfg = tget_config("recurrentgemma-9b").smoke()
    jparams, np_tree = ref_params(jcfg, seed=2)
    jl = jax.tree.map(lambda x: x[0], jparams["pattern"]["0"])
    return jcfg, tcfg, jl, params_from_jax(np_tree)["layers"][0]


def test_gates_match_reference(rec_layer):
    jcfg, _, jl, tl = rec_layer
    x = np.random.default_rng(20).standard_normal((2, 7, jcfg.lru_width)).astype(np.float32)
    j_log_a, j_b = J_GATES(jnp.asarray(x), jl["lru"])
    t_log_a, t_b = trglru._gates(torch.from_numpy(x), tl["lru"])
    assert t_log_a.dtype == t_b.dtype == torch.float32
    assert rel_err(j_log_a, t_log_a) < REL and rel_err(j_b, t_b) < REL


def test_rglru_step_continues_the_scan(rec_layer):
    jcfg, _, jl, tl = rec_layer
    rng = np.random.default_rng(21)
    x = rng.standard_normal((3, jcfg.lru_width)).astype(np.float32)
    h = rng.standard_normal((3, jcfg.lru_width)).astype(np.float32)
    jy, jh = J_STEP(jnp.asarray(x), jnp.asarray(h), jl["lru"])
    ty, th = trglru.rglru_step(torch.from_numpy(x), torch.from_numpy(h), tl["lru"])
    assert rel_err(jy, ty) < REL and rel_err(jh, th) < REL
    # one step from h equals the scan over one token started from h
    y1, h1 = trglru.rglru_scan(torch.from_numpy(x)[:, None], tl["lru"],
                               torch.from_numpy(h))
    assert rel_err(th.numpy(), h1) < REL and rel_err(ty.numpy(), y1[:, 0]) < REL


@pytest.mark.parametrize("s", [1, 3, 19], ids=lambda s: f"S={s}")
@pytest.mark.parametrize("use_kernel", [True, False], ids=["kernel", "plain"])
def test_recurrent_block_prefill_matches_reference(rec_layer, s, use_kernel):
    """Prompts shorter than the conv width (K = 4) left-pad the conv state.
    The port's prefill takes ``use_kernel`` (the reference's never does)."""
    jcfg, tcfg, jl, tl = rec_layer
    x = np.random.default_rng(30 + s).standard_normal((2, s, jcfg.d_model)).astype(np.float32)
    jout, jst = J_PREFILL(jnp.asarray(x), jl, jcfg, jnp.float32)
    tout, tst = trglru.recurrent_block_prefill(torch.from_numpy(x), tl, tcfg,
                                               torch.float32, use_kernel=use_kernel)
    assert rel_err(jout, tout) < REL
    assert tuple(tst["conv"].shape) == jst["conv"].shape == (2, jcfg.conv_width - 1,
                                                             jcfg.lru_width)
    assert tst["h"].dtype == torch.float32
    assert rel_err(jst["conv"], tst["conv"]) < REL and rel_err(jst["h"], tst["h"]) < REL
    jy = J_BLOCK(jnp.asarray(x), jl, jcfg, jnp.float32, use_kernel=use_kernel)
    assert rel_err(jy, trglru.recurrent_block(torch.from_numpy(x), tl, tcfg, torch.float32,
                                              use_kernel=use_kernel)) < REL


def test_recurrent_block_decode_matches_reference(rec_layer):
    jcfg, tcfg, jl, tl = rec_layer
    rng = np.random.default_rng(40)
    state = {"conv": rng.standard_normal((3, jcfg.conv_width - 1, jcfg.lru_width)).astype(np.float32),
             "h": rng.standard_normal((3, jcfg.lru_width)).astype(np.float32)}
    x = rng.standard_normal((3, jcfg.d_model)).astype(np.float32)
    jout, jst = J_DECODE(jnp.asarray(x), {k: jnp.asarray(v) for k, v in state.items()},
                         jl, jcfg, jnp.float32)
    tout, tst = trglru.recurrent_block_decode(
        torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in state.items()},
        tl, tcfg, torch.float32)
    assert rel_err(jout, tout) < REL
    assert rel_err(jst["conv"], tst["conv"]) < REL and rel_err(jst["h"], tst["h"]) < REL


def test_geglu_uses_the_tanh_gelu(rec_layer):
    """GeGLU's inner activation is ``gelu(approximate=True)`` on both sides.
    PyTorch's default erf gelu differs from it by up to ~5e-4 near |x| = 2,
    which the activation check below would catch (the two tanh forms agree
    to ~1e-7)."""
    jcfg, _, _, tl = rec_layer
    x = (3 * np.random.default_rng(50).standard_normal((2, 5, jcfg.d_model))).astype(np.float32)
    jl = {k: jnp.asarray(v.numpy()) for k, v in tl["mlp"].items()}
    want = jlayers.mlp(jnp.asarray(x), jl, "geglu", jnp.float32)
    assert rel_err(want, tlayers.mlp(torch.from_numpy(x), tl["mlp"], "geglu")) < REL
    grid = np.linspace(-4, 4, 801, dtype=np.float32)
    j_act = np.asarray(jax.nn.gelu(jnp.asarray(grid), approximate=True))
    assert np.abs(j_act - tlayers.gelu_tanh(torch.from_numpy(grid)).numpy()).max() < 1e-6
    assert np.abs(j_act - F.gelu(torch.from_numpy(grid)).numpy()).max() > 1e-4
