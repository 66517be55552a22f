"""MoE training against the reference: ``loss_fn``'s ``ce + 0.01 * aux``
with each layer's Switch aux term summed over the stack, its gradient
through the router, the top-k weights and the sort-based dispatch and
combine (with and without dropped assignments), AdamW steps through
``build_train_step``, remat under the three policies, the ``make_fx``
profile of the grad step against the reference's jaxpr profile, the closed
remat loop and the largest batch on that profile, and both CLIs, for
granite-moe-1b-a400m (E = 32, k = 8) and qwen3-moe-30b-a3b (E = 128, k = 8)
at the small layouts of ``torch_port_utils.MOE_SMALL``, f32 unless stated.

Tolerances: the loss, ``ce`` and ``aux`` within 1e-5 relative; the whole
gradient and the whole parameter vector after three AdamW steps within
1e-5 relative in L2 (observed ~6e-7: both packages sum in f32 in other
orders); remat against no remat 1e-6 of each leaf's largest gradient, as
in ``test_torch_remat.py``.  The profiles differ in their graphs (one
scanned jaxpr of XLA primitives against the aten ops of an unrolled
forward and backward), so only the retained bytes agree to the byte; the
other ratios lie in the bands below."""
import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_leaves

from repro.core import MemoryPlanner as JPlanner
from repro.core import profile_fn as jprofile_fn
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticPipeline as JPipeline
from repro.models import Transformer as JTransformer
from repro.optim import adamw as jadamw
from repro.runtime import train_lib as jtrain_lib
from repro_torch.core import MemoryPlanner
from repro_torch.core.events import align
from repro_torch.launch import train as train_cli
from repro_torch.models import RunOpts, Transformer, moe, params_from_jax
from repro_torch.optim import adamw
from repro_torch.remat import RematPolicy
from repro_torch.runtime import train_lib
from test_torch_train import ACFG, JACFG, LOSS_TOL, VEC_TOL, _port_leaves_of, _vec_rel
from torch_port_utils import MOE_SMALL, arch_params, small_cfgs

ARCHS = sorted(MOE_SMALL)
GRAD_TOL = 1e-6                 # remat changes the schedule, not the math
LOW_FACTOR = 0.5                # capacity factor at which >= 10% of assignments drop
# port / reference at batch 2 x 65 tokens, both archs, f32 and bf16 (measured:
# total 2.14-3.30, lower bound 0.54-0.73, best-fit peak 0.60-0.72).  The
# port's graph holds more blocks (casts, transposes, the combine's k - 1
# partial sums and its (T, k, d) gather, the backward's index_put) but frees
# each after its last use, where the reference's scan keeps each layer's
# residuals stacked for the backward.
TOTAL_BAND = (2.0, 3.6)
PEAK_BAND = (0.5, 0.8)
OPTS = RunOpts(attention_impl="full", use_kernels=False)


def _model(arch, dtype="float32", **over):
    jcfg, tcfg = (c.with_overrides(**over) for c in small_cfgs(dtype, arch))
    return jcfg, Transformer(tcfg, OPTS, device="cpu")


def _tokens(cfg, b: int = 4, s: int = 64, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s + 1)).astype(np.int32)


@pytest.fixture
def drops(monkeypatch):
    """Kept / all assignments over every ``moe_groups`` call the port makes."""
    seen = {"kept": 0, "all": 0}
    inner = moe.moe_groups

    def counting(*args, **kwargs):
        y, aux, disp = inner(*args, **kwargs)
        seen["kept"] += int(disp.keep.sum())
        seen["all"] += disp.keep.numel()
        return y, aux, disp
    monkeypatch.setattr(moe, "moe_groups", counting)
    return seen


@pytest.mark.parametrize("factor", [None, LOW_FACTOR])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_the_reference(arch, factor, drops):
    """``value_and_grad`` of the reference's ``loss_fn`` against the port's
    on the same weights and tokens: loss, ``ce``, ``aux`` and every leaf's
    gradient (router, experts, attention, norms, embedding).  At the low
    capacity factor at least 10% of the assignments drop: a dropped
    assignment must give its token and its weight no gradient, as the
    reference's ``keep`` mask does."""
    over = {} if factor is None else {"capacity_factor": factor}
    jcfg, tm = _model(arch, **over)
    jparams, np_tree = arch_params(arch, jcfg)
    tokens = _tokens(jcfg)
    jm = JTransformer(jcfg)
    (jloss, jaux), jgrads = jax.value_and_grad(
        lambda p, b: jm.loss_fn(p, b, remat=False), has_aux=True)(
            jparams, {"tokens": jnp.asarray(tokens)})
    params = params_from_jax(np_tree)
    leaves = [t.requires_grad_() for t in tree_leaves(params)]
    loss, aux = tm.loss_fn(params, {"tokens": torch.from_numpy(tokens)}, remat=False)
    grads = torch.autograd.grad(loss, leaves)
    assert set(aux) == set(jaux) == {"ce", "aux"}
    for got, want in ((loss, jloss), (aux["ce"], jaux["ce"]), (aux["aux"], jaux["aux"])):
        assert abs(float(got.detach()) - float(want)) <= LOSS_TOL * abs(float(want))
    assert float(aux["aux"].detach()) > 0
    assert _vec_rel(grads, _port_leaves_of(jgrads)) <= VEC_TOL
    share = 1 - drops["kept"] / drops["all"]
    assert drops["all"] == jcfg.n_layers * tokens[:, 1:].size * jcfg.top_k
    if factor is not None:
        assert share >= 0.10, share


@pytest.mark.parametrize("arch", ARCHS)
def test_adamw_steps_match_the_reference(arch):
    """Three steps of ``build_train_step`` from the same weights on the same
    pipeline batches: losses and the parameters after them."""
    jcfg, tm = _model(arch)
    jparams, np_tree = arch_params(arch, jcfg)
    jm = JTransformer(jcfg)
    pipe = JPipeline(JDataConfig(vocab_size=jcfg.vocab_size, seq_len=32,
                                 global_batch=4, seed=0))
    jstep, _ = jtrain_lib.build_train_step(
        jm, None, JACFG, jtrain_lib.TrainOpts(remat=False, donate=False))
    jstate = {"params": jparams, "opt": jadamw.init(jparams),
              "step": jnp.zeros((), jnp.int32)}
    params = params_from_jax(np_tree)
    state = {"params": params, "opt": adamw.init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    step, _ = train_lib.build_train_step(tm, None, ACFG, train_lib.TrainOpts(remat=False))
    for i in range(3):
        b = pipe.batch_at(i)
        jstate, jmet = jstep(jstate, {"tokens": jnp.asarray(b["tokens"])})
        state, m = step(state, {"tokens": torch.from_numpy(b["tokens"])})
        for k in ("loss", "ce", "aux"):
            assert abs(float(m[k]) - float(jmet[k])) <= LOSS_TOL * abs(float(jmet[k])), k
    assert _vec_rel(tree_leaves(state["params"]),
                    _port_leaves_of(jstate["params"])) <= VEC_TOL


# the dispatch's integer routing ops and the expert products recomputed
ROUTING = RematPolicy(mode="policy", recompute_prims=frozenset({
    "aten.topk.default", "aten.sort.stable", "aten.searchsorted.Tensor",
    "aten.gather.default", "aten.index.Tensor", "aten.bmm.default",
    "aten.scatter_add.default", "aten._softmax.default"}))


@pytest.fixture(scope="module")
def planned_loop():
    """The closed remat loop on granite-moe's grad step (2 layers, batch
    2 x 65 tokens) at the chip smoke's search bound (``max_evict=32``)."""
    _, model = _model("granite-moe-1b-a400m")
    bsds = {"tokens": ((2, 65), torch.int32)}
    policy, ev = train_lib.plan_remat_policy(model, bsds, target_ratio=0.5,
                                             max_rounds=2, max_evict=32)
    return model, bsds, policy, ev


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_variants_equal_no_remat(arch, request):
    """No remat, full remat, a policy that recomputes the router, the
    top-k and the dispatch's sort, searchsorted and gathers, and (granite)
    the searched policy: the same loss, aux and gradients.  A recomputed
    router picks the same experts (``topk``, the stable sort and
    ``searchsorted`` are deterministic)."""
    jcfg, model = _model(arch)
    _, np_tree = arch_params(arch, jcfg)
    params = params_from_jax(np_tree)
    leaves = [t.requires_grad_() for t in tree_leaves(params)]
    batch = {"tokens": torch.from_numpy(_tokens(jcfg, 2, 32, seed=3))}

    def run(remat):
        loss, m = model.loss_fn(params, batch, remat=remat)
        return loss.detach(), m["aux"].detach(), torch.autograd.grad(loss, leaves)

    policies = [RematPolicy.none(), True, ROUTING]
    if arch == "granite-moe-1b-a400m":
        policies.append(request.getfixturevalue("planned_loop")[2])
    base_loss, base_aux, base_grads = run(False)
    for remat in policies:
        loss, aux, grads = run(remat)
        assert abs(float(loss - base_loss)) <= GRAD_TOL * abs(float(base_loss))
        assert abs(float(aux - base_aux)) <= GRAD_TOL * abs(float(base_aux))
        for g, b in zip(grads, base_grads):
            assert float((g - b).abs().max()) <= GRAD_TOL * max(float(b.abs().max()), 1e-30)


def test_plan_remat_policy_loop_invariants(planned_loop):
    """The loop's invariants, as on the dense step (``test_torch_remat.py``).
    ``peak <= baseline_peak`` needs a search that evicts enough: the
    compiled selective checkpoint saves the output of every op it does not
    recompute, which no-remat autograd frees when no backward reads it, so
    a search cut much shorter (``max_evict=8``) ends above the baseline
    here and on the dense qwen2 step alike."""
    model, bsds, policy, ev = planned_loop
    assert policy.mode == "policy" and ev.meta["verified"]
    assert ev.meta["rounds"] <= 2
    # the verified peak is the re-traced plan's, never an estimate
    retraced = train_lib.profile_step(model, bsds, policy)
    assert ev.peak == MemoryPlanner().plan(retraced).peak == ev.plan.peak
    assert ev.peak <= ev.baseline_peak
    assert ev.profile.n == retraced.n
    if ev.reached_target:
        assert ev.peak <= ev.target_peak


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_grad_step_profile_against_reference(arch, dtype):
    """Both packages profile grad(loss) at batch 2 x 65 tokens on abstract
    inputs: the retained bytes (f32 masters and int32 tokens) agree to the
    byte, total bytes, lower bound and best-fit peak lie in their bands,
    the dispatch's ops each make blocks, the (E * C + 1, d) dispatch buffer
    is one block that the in-place ``index_put_`` writes without making
    another, and every block's recompute cost is finite and positive."""
    jcfg, tm = _model(arch, dtype)
    jm = JTransformer(jcfg)
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
    tags = {b.tag for b in tprof.blocks}
    assert tags >= {"aten.topk.default", "aten.sort.stable", "aten.searchsorted.Tensor",
                    "aten.gather.default", "aten.index.Tensor", "aten.bmm.default"}
    cap = moe.capacity(2 * 64, jcfg.top_k, jcfg.n_experts, jcfg.capacity_factor)
    itemsize = torch.finfo(tm.compute_dtype).bits // 8
    size = align((jcfg.n_experts * cap + 1) * jcfg.d_model * itemsize)
    bufs = [b for b in tprof.blocks if b.tag == "aten.new_zeros.default" and b.size == size]
    assert len(bufs) == jcfg.n_layers
    assert all(b.end - b.start > 2 for b in bufs)      # read by the expert products
    flops = tprof.meta["block_flops"]
    assert all(0 < flops[b.bid] < float("inf") for b in tprof.blocks)


def test_max_feasible_batch_planned_on_the_moe_profile():
    """The largest batch whose no-remat step fits a budget: its packed
    peak fits, the next batch's does not."""
    _, model = _model("granite-moe-1b-a400m")
    planner = MemoryPlanner()

    def prof(b):
        return train_lib.profile_step(model, {"tokens": ((b, 33), torch.int32)})

    def need(b):
        p = prof(b)
        return p.retained_bytes + planner.plan(p).peak
    budget = (need(2) + need(3)) // 2
    assert planner.max_feasible_batch_planned(prof, budget, hi=4) == 2


def _cli(*argv) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        train_cli.main(list(argv))
    return out.getvalue()


@pytest.mark.parametrize("remat", ["none", "full", "planned"])
def test_train_cli_trains_granite_moe_on_the_cpu(remat):
    """Each policy trains two steps; the planned one searches down to 0.9
    of the no-remat peak, which keeps its search short."""
    text = _cli("--arch", "granite-moe-1b-a400m", "--device", "cpu", "--preset", "tiny",
                "--steps", "2", "--log-every", "1", "--remat", remat,
                "--remat-target", "0.9")
    assert "arch=granite-moe-1b-a400m-tiny" in text and "done: 2 steps" in text
    assert ("remat plan: planned(recompute=" in text) == (remat == "planned")
    losses = [float(l.split("loss=")[1].split()[0]) for l in text.splitlines()
              if l.startswith("step ")]
    assert len(losses) == 2 and all(np.isfinite(losses))


def test_serve_cli_share_hbm_takes_an_moe_fine_tune():
    from repro_torch.launch import serve
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        serve.main(["--arch", "granite-moe-1b-a400m", "--device", "cpu",
                    "--share-hbm", "1", "--train-steps", "2", "--requests", "4"])
    out = out.getvalue()
    assert "[shared arena] budget=1.07GB" in out and "feasible=True" in out
    line = next(x for x in out.splitlines() if x.startswith("[colocated]"))
    assert int(line.split("train_steps=")[1].split()[0]) >= 1
    assert "completed 4/4 requests" in out


def test_moe_entry_points_need_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is valid here")
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _cli("--arch", "granite-moe-1b-a400m", "--steps", "1")
    with contextlib.redirect_stdout(io.StringIO()):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            serve.main(["--arch", "granite-moe-1b-a400m", "--share-hbm", "1"])
