"""repro_torch.remat against repro.remat: the cost model, the eviction stubs
and the eviction search on the same hand-built profiles with the same
constants (pure data, so exact), the policy compiled into selective
checkpoints (loss and gradients equal to the no-remat step, CPU f32, 1e-6),
the closed planning loop's invariants, and the host offload arena."""
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_leaves

from repro.core import MemoryPlanner as JPlanner
from repro.core import make_profile as jmake_profile
from repro.remat import CostModel as JCostModel
from repro.remat import block_cost as jblock_cost
from repro.remat import evict_block as jevict_block
from repro.remat import plan_evictions as jplan_evictions
from repro_torch.configs import get_config
from repro_torch.core import Block, MemoryPlanner, make_profile
from repro_torch.models import RunOpts, Transformer, params_from_jax
from repro_torch.remat import (CostModel, HostOffloadArena, RematPolicy,
                               block_cost, evict_block, measured_step_from_bench,
                               plan_evictions)
from repro_torch.remat.policy import _prim_of_tag
from repro_torch.remat.search import Eviction, EvictionPlan
from repro_torch.runtime import train_lib
from torch_port_utils import ref_params, small_cfgs

# the same constants for both packages: the reference's TPU peak and link
PEAK, LINK = 197e12, 50e9
GRAD_TOL = 1e-6                      # remat changes the schedule, not the math


def _skyline_spec():
    # one long-lived fat block under a churn of short ones, plus two
    # identical overlapping blocks the search must roll back
    spec = [(1 << 20, 0, 100)]
    spec += [(256 << 10, t, t + 4) for t in range(1, 93, 4)]
    spec += [(3 << 19, 20, 70), (3 << 19, 20, 70)]
    return spec


def _both_profiles(spec):
    jp, tp = jmake_profile(spec), make_profile(spec)
    flops = {b.bid: float((b.bid * 7919) % 1000) * 1e6 for b in tp.blocks}
    jp.meta["block_flops"] = dict(flops)
    tp.meta["block_flops"] = dict(flops)
    return jp, tp


def test_cost_model_prices_like_the_reference():
    jp, tp = _both_profiles(_skyline_spec())
    jc = JCostModel.from_profile(jp, peak_flops=PEAK, host_bw=LINK)
    tc = CostModel.from_profile(tp, peak_flops=PEAK, host_bw=LINK)
    assert {k: vars(v) for k, v in jc.costs.items()} == \
        {k: vars(v) for k, v in tc.costs.items()}
    assert [c.bid for c in jc.candidates()] == [c.bid for c in tc.candidates()]
    # tiny flops, big bytes -> recompute; huge flops, small bytes -> offload
    cheap = block_cost(Block(bid=1, size=1 << 20, start=0, end=10), flops=10.0)
    heavy = block_cost(Block(bid=2, size=4096, start=0, end=10), flops=1e15)
    assert cheap.mode == "recompute" and heavy.mode == "offload"
    assert heavy.cost_s == heavy.offload_s
    jb = jblock_cost(Block(bid=2, size=4096, start=0, end=10), 1e12,
                     peak_flops=PEAK, host_bw=LINK)
    tb = block_cost(Block(bid=2, size=4096, start=0, end=10), 1e12,
                    peak_flops=PEAK, host_bw=LINK)
    assert vars(jb) == vars(tb)


@pytest.mark.parametrize("steps", [1, 8])
def test_evict_block_stubs_equal_the_reference(steps):
    b = Block(bid=7, size=4096, start=0, end=20, tag="aten.mul.Tensor")
    got = evict_block(b, next_bid=99, steps=steps)
    want = jevict_block(b, next_bid=99, steps=steps)
    assert [vars(x) for x in got] == [vars(x) for x in want]
    assert got[0].bid == 7 and got[1].bid == 99
    assert got[0].lifetime == got[1].lifetime == 1
    assert evict_block(Block(bid=1, size=64, start=0, end=2), 99) == []


@pytest.mark.parametrize("price_mode", ["auto", "recompute"])
@pytest.mark.parametrize("target_ratio", [None, 0.9, 0.5])
def test_plan_evictions_picks_the_reference_bids(price_mode, target_ratio):
    jp, tp = _both_profiles(_skyline_spec())
    jev = jplan_evictions(jp, JCostModel.from_profile(jp, peak_flops=PEAK, host_bw=LINK),
                          target_ratio=target_ratio, price_mode=price_mode)
    tev = plan_evictions(tp, CostModel.from_profile(tp, peak_flops=PEAK, host_bw=LINK),
                         target_ratio=target_ratio, price_mode=price_mode)
    assert [(e.bid, e.mode, e.saved_area) for e in tev.evictions] == \
        [(e.bid, e.mode, e.saved_area) for e in jev.evictions]
    assert (tev.baseline_peak, tev.peak, tev.target_peak, tev.reached_target) == \
        (jev.baseline_peak, jev.peak, jev.target_peak, jev.reached_target)
    assert tev.plan.offsets == jev.plan.offsets
    assert tev.evictions                    # the fat block is bought back


def _profile_at_batch(mk, b):
    per = 8 << 20
    prof = mk([(b * per, 0, 100)] + [(per, t, t + 4) for t in range(1, 93, 4)])
    prof.retained_bytes = 32 << 20
    return prof


@pytest.mark.parametrize("remat", [None, True])
def test_max_feasible_batch_planned_equals_the_reference(remat):
    budget = 128 << 20
    want = JPlanner().max_feasible_batch_planned(
        lambda b: _profile_at_batch(jmake_profile, b), budget, hi=64, remat=remat)
    got = MemoryPlanner().max_feasible_batch_planned(
        lambda b: _profile_at_batch(make_profile, b), budget, hi=64, remat=remat)
    assert got == want > 0


@pytest.mark.parametrize("remat", [None, True])
@pytest.mark.parametrize("guess", [1, 9, 64])
def test_max_feasible_batch_planned_from_a_guess_equals_the_reference(remat, guess):
    """A guess changes where the search starts, not the batch it finds."""
    budget = 128 << 20
    want = JPlanner().max_feasible_batch_planned(
        lambda b: _profile_at_batch(jmake_profile, b), budget, hi=64, remat=remat)
    got = MemoryPlanner().max_feasible_batch_planned(
        lambda b: _profile_at_batch(make_profile, b), budget, hi=64, remat=remat,
        guess=guess)
    assert got == want > 0


def test_measured_step_reads_only_card_results():
    from pathlib import Path
    bench = Path(__file__).resolve().parents[1] / "BENCH_remat.json"
    assert measured_step_from_bench(str(bench)) is None     # TPU/CPU times
    card = {"device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3"},
            "configs": [{"arch": "qwen2-0.5b", "step_time_s": {"none": 0.25}}]}
    assert measured_step_from_bench(card, "qwen2-0.5b") == 0.25
    assert measured_step_from_bench(card, "other") is None


# ---------------------------------------------------------------------------
# policy
# ---------------------------------------------------------------------------


def test_policy_coerce_and_compile():
    assert RematPolicy.coerce(True).mode == "full"
    assert RematPolicy.coerce(False).mode == "none"
    assert RematPolicy.coerce(None).mode == "none"
    with pytest.raises(TypeError):
        RematPolicy.coerce(3.14)
    with pytest.raises(ValueError):
        RematPolicy(mode="sometimes")
    assert _prim_of_tag("aten.mm.default") == "aten.mm.default"
    for tag in ("aten.mm.default:rematerialize", "host:act0", "aten.nope.default",
                "aten.mm.nope", "mm", ""):
        assert _prim_of_tag(tag) is None
    evs = [Eviction(bid=1, mode="recompute", saved_area=1, cost_s=1e-9,
                    tag="aten.mm.default"),
           Eviction(bid=2, mode="offload", saved_area=1, cost_s=1e-9,
                    tag="aten.exp.default"),
           Eviction(bid=3, mode="recompute", saved_area=1, cost_s=1e-9,
                    tag="aten.mm.default:rematerialize")]
    pol = RematPolicy.from_eviction(EvictionPlan(
        evictions=evs, baseline_peak=2, peak=1, overhead_s=0, target_peak=None,
        plan=None, profile=None))
    assert pol.recompute_prims == frozenset({"aten.mm.default"})
    assert pol.offload_prims == frozenset({"aten.exp.default"})
    fn = pol.checkpoint_policy()
    from torch.utils.checkpoint import CheckpointPolicy as CP
    aten = torch.ops.aten
    assert fn(None, aten.mm.default) == CP.PREFER_RECOMPUTE
    assert fn(None, aten.exp.default) == CP.PREFER_RECOMPUTE   # offload folded in
    assert fn(None, aten.t.default) == CP.PREFER_RECOMPUTE     # a view
    assert fn(None, aten.add.Tensor) == CP.MUST_SAVE
    assert pol.restricted_to(["aten.exp.default"]).recompute_prims == frozenset()
    assert pol.restricted_to(["aten.add.Tensor"]).mode == "none"
    assert RematPolicy.none().checkpoint_policy() is None
    f = lambda x: x
    assert RematPolicy.none().wrap(f) is f
    assert "aten.mm.default" in pol.describe()


def _small_model():
    """The tiny qwen2 of the differential tests (2 layers, G=7, f32) on
    reference weights, and a numpy-seeded batch."""
    _, tcfg = small_cfgs()
    jcfg, _ = small_cfgs()
    _, np_tree = ref_params(jcfg)
    model = Transformer(tcfg, RunOpts(attention_impl="full", use_kernels=False),
                        device="cpu")
    tokens = np.random.default_rng(3).integers(0, tcfg.vocab_size, (2, 17))
    return model, params_from_jax(np_tree), {"tokens": torch.from_numpy(
        tokens.astype(np.int32))}


@pytest.mark.parametrize("loss_impl", ["full", "chunked"])
def test_remat_variants_equal_no_remat(loss_impl):
    model, params, batch = _small_model()
    model.opts = RunOpts(attention_impl="full", use_kernels=False,
                         loss_impl=loss_impl, loss_chunk=8)
    leaves = [t.requires_grad_() for t in tree_leaves(params)]

    def run(remat):
        loss, _ = model.loss_fn(params, batch, remat=remat)
        return loss.detach(), torch.autograd.grad(loss, leaves)

    base_loss, base_grads = run(False)
    planned = RematPolicy(mode="policy", recompute_prims=frozenset(
        {"aten.mm.default", "aten.mul.Tensor", "aten._softmax.default"}))
    for remat in (RematPolicy.none(), True, planned):
        loss, grads = run(remat)
        assert abs(float(loss - base_loss)) <= GRAD_TOL * abs(float(base_loss))
        for g, b in zip(grads, base_grads):
            assert float((g - b).abs().max()) <= GRAD_TOL * max(float(b.abs().max()), 1e-30)


def test_policy_recompute_shows_in_the_trace():
    """The traced step runs selective checkpoints as eager execution does:
    the recompute set's ops run again in the backward (more blocks of
    them), and full remat lowers the traced peak."""
    model, _, _ = _small_model()
    bsds = {"tokens": ((2, 65), torch.int32)}
    pol = RematPolicy(mode="policy", recompute_prims=frozenset({"aten.mm.default"}))
    none = train_lib.profile_step(model, bsds, False)
    planned = train_lib.profile_step(model, bsds, pol)
    full = train_lib.profile_step(model, bsds, True)

    def count(p, tag):
        return sum(b.tag == tag for b in p.blocks)
    assert count(planned, "aten.mm.default") > count(none, "aten.mm.default")
    mp = MemoryPlanner()
    assert mp.plan(full).peak < mp.plan(none).peak


@pytest.fixture(scope="module")
def planned_loop():
    cfg = get_config("qwen2-0.5b").smoke().with_overrides(name="qwen2-remat-test",
                                                          n_layers=4)
    model = Transformer(cfg, RunOpts(attention_impl="full", use_kernels=False),
                        device="cpu")
    bsds = {"tokens": ((2, 65), torch.int32)}
    policy, ev = train_lib.plan_remat_policy(model, bsds, target_ratio=0.5,
                                             max_rounds=2)
    return model, bsds, policy, ev


def test_plan_remat_policy_loop_invariants(planned_loop):
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


# ---------------------------------------------------------------------------
# host offload arena
# ---------------------------------------------------------------------------


def test_offload_roundtrip_and_instrumentation():
    arena = HostOffloadArena()
    x = torch.arange(1024, dtype=torch.float32).reshape(32, 32)
    nbytes = x.numel() * 4
    arena.stage_out("act0", x)
    x.zero_()                              # the staged copy is not a view
    assert len(arena) == 1
    assert arena.resident_bytes == nbytes
    with pytest.raises(KeyError):
        arena.stage_out("act0", x)
    back = arena.stage_in("act0")
    np.testing.assert_array_equal(back.numpy(), np.arange(1024, dtype=np.float32)
                                  .reshape(32, 32))
    assert back.device == x.device
    assert len(arena) == 0
    assert arena.bytes_out == arena.bytes_in == nbytes
    assert arena.estimated_transfer_s() > 0
    prof = arena.profile()
    assert prof.n == 1
    assert prof.blocks[0].tag == "host:act0"
    assert prof.blocks[0].size >= nbytes
