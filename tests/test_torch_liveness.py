"""The port's ``make_fx`` liveness profiler against ``repro.core.liveness``:
the reference's invariants restated on aten graphs, then the tiny qwen2 grad
step profiled by both packages.

The two profile different graphs of the same step (XLA primitives in one
scanned jaxpr, aten ops of an unrolled forward and backward in the other),
so only the retained bytes must agree to the byte; total bytes, the liveness
lower bound and the best-fit peak must fall inside the bands below."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.core import MemoryPlanner as JPlanner
from repro.core import profile_fn as jprofile_fn
from repro.models import Transformer as JTransformer
from repro_torch.core import MemoryPlanner, profile_fn
from repro_torch.models import RunOpts, Transformer
from repro_torch.runtime import train_lib
from torch_port_utils import small_cfgs

# port / reference, measured on the cases below (CHANGES.md, PR 20)
TOTAL_BAND = (1.0, 4.0)         # the port keeps transposes, copies and casts
PEAK_BAND = (0.6, 1.4)          # lower bound and best-fit peak


def test_linear_chain_profile():
    def f(x):
        a = x * 2.0        # alive until b
        b = a + 1.0        # alive until c
        c = b * b
        return c.sum()

    prof = profile_fn(f, torch.ones(128, 128))
    assert prof.n >= 3
    assert prof.meta["source"] == "fx" and prof.meta["n_eqns"] >= 4
    # every intermediate is 64KB; with perfect reuse peak stays near 2 bufs
    assert MemoryPlanner().plan(prof).peak <= 3 * 128 * 128 * 4
    rep = MemoryPlanner().plan_fn(f, torch.ones(128, 128))
    assert rep.plan.peak == MemoryPlanner().plan(prof).peak
    assert rep.baselines["pool_peak"] >= rep.plan.peak


def test_retained_excludes_inputs():
    def f(x, w):
        return (x @ w).sum()

    prof = profile_fn(f, torch.ones(64, 32), torch.ones(32, 16))
    assert prof.retained_bytes == (64 * 32 + 32 * 16) * 4
    for b in prof.blocks:
        assert b.size <= 64 * 16 * 4 + 512
    mm = [b for b in prof.blocks if b.tag == "aten.mm.default"]
    assert len(mm) == 1
    # the 2*M*N*K matmul count
    assert prof.meta["block_flops"][mm[0].bid] == 2 * 64 * 16 * 32


def test_fanout_extends_lifetime():
    def f(x):
        a = torch.tanh(x)              # used twice, far apart
        b = (x * 2).sum()
        c = (x * 3).sum()
        return (a * b).sum() + (a * c).sum()

    prof = profile_fn(f, torch.ones(64, 64))
    tanh_blocks = [b for b in prof.blocks if b.tag == "aten.tanh.default"]
    assert tanh_blocks
    other_max = max(b.lifetime for b in prof.blocks if b.tag != "aten.tanh.default")
    assert tanh_blocks[0].lifetime >= other_max - 2


def test_views_extend_the_block_they_alias():
    """A view makes no block; its uses keep its base alive."""
    def f(x):
        a = torch.tanh(x)
        v = a.t()                      # view of a
        b = torch.exp(x) * 2.0
        return (v * b).sum()

    prof = profile_fn(f, torch.ones(32, 32))
    assert not [b for b in prof.blocks if b.tag == "aten.t.default"]
    tanh = next(b for b in prof.blocks if b.tag == "aten.tanh.default")
    exp = next(b for b in prof.blocks if b.tag == "aten.exp.default")
    assert tanh.end > exp.start            # alive past exp, through the view


def test_grad_trace_has_larger_peak_than_fwd():
    def fwd(x, w):
        h = torch.tanh(x @ w)
        h = torch.tanh(h @ w)
        return (h * h).sum()

    def grad(x, w):
        return torch.autograd.grad(fwd(x, w), [w])

    x = torch.ones(256, 256)
    w = torch.ones(256, 256, requires_grad=True)
    fwd_prof = profile_fn(fwd, x, w)
    grad_prof = profile_fn(grad, x, w)
    assert grad_prof.liveness_lower_bound() >= fwd_prof.liveness_lower_bound()
    assert grad_prof.meta["op_edges"]


def test_fake_inputs_work_without_allocation():
    def f(x):
        return torch.tanh(x).sum()

    with FakeTensorMode():
        x = torch.empty(1 << 14, 1 << 12, dtype=torch.bfloat16)
    prof = profile_fn(f, x)
    assert prof.total_bytes >= (1 << 14) * (1 << 12) * 2


def test_view_only_graph_gives_an_empty_profile():
    def f(x):
        return x.reshape(64, 64).reshape(16, 256).squeeze()

    prof = profile_fn(f, torch.ones(4096))
    assert prof.n == 0                       # nothing left to pack
    assert prof.total_bytes == 0
    assert prof.retained_bytes == 4096 * 4   # input still accounted
    assert MemoryPlanner().plan(prof).peak == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qwen2_grad_step_profile_against_reference(dtype):
    """Both packages profile grad(loss) of the tiny qwen2 (2 layers, G=7)
    at batch 2 x 65 tokens on abstract inputs: params (f32 masters) and
    int32 tokens are the retained bytes in both, to the byte."""
    jcfg, tcfg = small_cfgs(dtype)
    jm = JTransformer(jcfg)
    tm = Transformer(tcfg, RunOpts(attention_impl="full", use_kernels=False),
                     device="cpu")
    jprof = jprofile_fn(jax.grad(lambda p, b: jm.loss_fn(p, b, remat=False)[0]),
                        jm.abstract(),
                        {"tokens": jax.ShapeDtypeStruct((2, 65), jnp.int32)})
    tprof = train_lib.profile_step(tm, {"tokens": ((2, 65), torch.int32)})
    assert tprof.retained_bytes == jprof.retained_bytes
    ratios = {
        "total": tprof.total_bytes / jprof.total_bytes,
        "lower_bound": tprof.liveness_lower_bound() / jprof.liveness_lower_bound(),
        "peak": MemoryPlanner().plan(tprof).peak / JPlanner().plan(jprof).peak,
    }
    assert TOTAL_BAND[0] <= ratios["total"] <= TOTAL_BAND[1], ratios
    for k in ("lower_bound", "peak"):
        assert PEAK_BAND[0] <= ratios[k] <= PEAK_BAND[1], ratios
    flops = tprof.meta["block_flops"]
    assert all(flops[b.bid] > 0 for b in tprof.blocks)
    assert np.isfinite(list(flops.values())).all()
