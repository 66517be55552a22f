"""repro_torch.core.unified against repro.core.unified: one HBM budget shared
by a serving tenant (the paged staircase of ``paged_request_blocks``) and a
training tenant (a step profile built in both packages with
``make_profile`` from numpy-seeded triples, or the reference's own traced
step carried over block by block).  The same ``SharedPlan`` (joint peak,
offsets, reserves, valley schedule, shrink rounds, feasibility) and the
same ``stats()`` and tracer instants, timing fields aside; the remat
search and ``plan_remat_policy`` planning against a tenant's share; the
shared engine against the reference's on a churned trace (caps, replans,
preemptions, page counts, tenant stats, token streams); and the CLIs'
``--share-hbm`` paths.  The plans are pure data, so every comparison is
exact; the engines run the converted weights in f32."""
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_leaves

from repro.configs import get_config as jget_config
from repro.core import MemoryPlanner as JPlanner
from repro.core import SharedArena as JSharedArena
from repro.core import make_profile as jmake_profile
from repro.core import profile_fn as jprofile_fn
from repro.core import unified as junified
from repro.core.events import Block as JBlock
from repro.models import Transformer as JTransformer
from repro.obs import Tracer as JTracer
from repro.obs import use_tracer as juse_tracer
from repro.remat import plan_evictions as jplan_evictions
from repro.runtime.serve_lib import Request as JRequest
from repro.serving import GenRequest as JGenRequest
from repro.serving import ServeEngine as JServeEngine
from repro.serving import pages as jpages
from repro_torch.configs import get_config
from repro_torch.core import (Block, MemoryPlanner, MemoryProfile, SharedArena,
                              SharedArenaError, best_fit, make_profile,
                              validate_plan)
from repro_torch.core import unified as tunified
from repro_torch.launch import serve as tserve
from repro_torch.models import RunOpts, Transformer
from repro_torch.obs import Tracer, use_tracer
from repro_torch.remat import plan_evictions
from repro_torch.runtime import train_lib
from repro_torch.runtime.serve_lib import Request as TRequest
from repro_torch.serving import GenRequest as TGenRequest
from repro_torch.serving import ServeEngine
from repro_torch.serving import pages as tpages
from torch_port_utils import models, prompt

ROOT = Path(__file__).resolve().parents[1]
TIMING = ("last_pack_s", "seconds")


def _train_spec(seed: int, n: int = 40, clock: int = 60, size: int = 4 << 20):
    """A training step's (size, start, end) triples drawn with numpy: a few
    long-lived activations under a churn of short ones."""
    rng = np.random.default_rng(seed)
    out = [(size, 0, clock)]
    for _ in range(n):
        s = int(rng.integers(0, clock - 2))
        out.append((int(rng.integers(1, 16)) * (size >> 4), s,
                    min(clock, s + int(rng.integers(2, 20)))))
    return out


def _train_both(seed: int, retained: int = 64 << 20, **kw):
    spec = _train_spec(seed, **kw)
    jp, tp = jmake_profile(spec), make_profile(spec)
    jp.retained_bytes = tp.retained_bytes = retained
    return jp, tp


def _requests(shapes):
    """shapes: (rid, prompt_len, gen_len, arrival) -> (reference, port)."""
    return ([JRequest(rid=r, prompt_len=p, gen_len=g, arrival=a) for r, p, g, a in shapes],
            [TRequest(rid=r, prompt_len=p, gen_len=g, arrival=a) for r, p, g, a in shapes])


def _serving_both(shapes, page_tokens: int = 8):
    jt, tt = _requests(shapes)
    return (jpages.paged_request_blocks(jt, jget_config("qwen2-0.5b"), page_tokens),
            tpages.paged_request_blocks(tt, get_config("qwen2-0.5b"), page_tokens))


def _blocks(p):
    return [(b.bid, b.size, b.start, b.end, b.tag) for b in p.blocks]


def _shared_plan(p):
    return (p.joint_peak, p.plan.offsets, p.plan.peak, p.standalone, p.reserves,
            p.retained_bytes, p.schedule, p.feasible, p.shrink_rounds, p.bid_map,
            _blocks(p.profile), p.profile.meta, p.summary())


def _stats(s):
    return {k: v for k, v in s.items() if k not in TIMING}


def _events(events):
    return [(e.name, e.cat, e.track, {k: v for k, v in e.args.items()
                                       if k not in TIMING}) for e in events]


def _both_arenas(budget, jserve, tserve_p, jtrain, ttrain, steps=1, **kw):
    ja, ta = JSharedArena(budget, **kw), SharedArena(budget, **kw)
    views = []
    for arena, s, t in ((ja, jserve, jtrain), (ta, tserve_p, ttrain)):
        if s is not None:
            views.append(arena.register_serving(s))
        if t is not None:
            views.append(arena.register_training(t, steps_per_round=steps))
    return ja, ta, views


MIDDLE = [(i + 1, 64, 8, 4) for i in range(4)]                       # idle at 0..3
STAGGER = [(i + 1, 24 + 13 * i, 6 + 3 * (i % 3), 2 * i) for i in range(6)]


# ---------------------------------------------------------------------------
# the joint plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shapes,steps", [(MIDDLE, 2), (STAGGER, 1), (STAGGER, 3)],
                         ids=["valley", "stagger-1", "stagger-3"])
@pytest.mark.parametrize("seed", range(2))
def test_shared_plan_matches_the_reference(shapes, steps, seed):
    js, ts = _serving_both(shapes)
    jt, tt = _train_both(seed)
    jtr, ttr = JTracer(), Tracer()
    with juse_tracer(jtr):
        ja, _, jviews = _both_arenas(1 << 32, js, None, jt, None, steps)
        jplan = ja.plan()
    with use_tracer(ttr):
        _, ta, tviews = _both_arenas(1 << 32, None, ts, None, tt, steps)
        tplan = ta.plan()
    assert _shared_plan(tplan) == _shared_plan(jplan)
    assert _stats(ta.stats()) == _stats(ja.stats())
    assert [(v.name, v.kind, v.reserve, v.budget, v.standalone_peak, v.stats())
            for v in tviews] == [(v.name, v.kind, v.reserve, v.budget,
                                  v.standalone_peak, v.stats()) for v in jviews]
    assert _events(ttr.events()) == _events(jtr.events())
    validate_plan(tplan.profile, tplan.plan)
    assert sum(tplan.reserves.values()) == tplan.joint_peak <= tplan.standalone_sum


def test_training_lands_in_the_valley_like_the_reference():
    js, ts = _serving_both(MIDDLE)
    jt, tt = _train_both(3)
    ja, ta, _ = _both_arenas(1 << 32, js, ts, jt, tt, steps=2)
    assert ta.plan().schedule == ja.plan().schedule == {"training": [0, 1]}
    assert ta.plan().joint_peak == max(ta.plan().standalone.values())


def test_boundary_replans_match_the_reference():
    """§4.3: a staged serving profile and a staged training profile, each
    applied at ``reset_round`` by an incremental re-pack (and a cold one
    with ``incremental=False``), in both packages alike."""
    js, ts = _serving_both(STAGGER)
    js2, ts2 = _serving_both([(r, p, g + 9, a) for r, p, g, a in STAGGER])
    jt, tt = _train_both(4)
    jt2, tt2 = _train_both(5)
    for incremental in (True, False):
        ja, ta, views = _both_arenas(1 << 32, js, ts, jt, tt, steps=2,
                                     incremental=incremental)
        js_v, jt_v, ts_v, tt_v = views
        for (sv, tv, arena), (sp, tp_) in (((js_v, jt_v, ja), (js2, jt2)),
                                           ((ts_v, tt_v, ta), (ts2, tt2))):
            arena.plan()
            assert not arena.reset_round()          # nothing staged
            sv.request_replan(sp, cause="decode-outrun")
            assert arena.reset_round()
            tv.request_replan(tp_)
            tv.request_replan()                     # a flag with no profile
            assert arena.reset_round()
        assert _shared_plan(ta.plan()) == _shared_plan(ja.plan())
        assert _stats(ta.stats()) == _stats(ja.stats())
        assert ta.n_reopt == 2 and ta.replan_causes == ja.replan_causes
        if incremental:
            assert ta.n_incr_packs >= 1


def test_reordered_and_envelope_unions_match_the_reference(monkeypatch):
    js, ts = _serving_both(STAGGER)
    jt, tt = _train_both(6)
    ja, ta, _ = _both_arenas(1 << 32, js, ts, jt, tt, steps=2, reorder="greedy")
    assert _shared_plan(ta.plan()) == _shared_plan(ja.plan())
    assert "reorder_improvement" in ta.plan().profile.meta
    # past MAX_JOINT_BLOCKS each training instance packs as one envelope
    monkeypatch.setattr(junified, "MAX_JOINT_BLOCKS", 50)
    monkeypatch.setattr(tunified, "MAX_JOINT_BLOCKS", 50)
    ja, ta, _ = _both_arenas(1 << 32, js, ts, jt, tt, steps=2)
    assert ta.plan().profile.meta["envelope"] is True
    assert _shared_plan(ta.plan()) == _shared_plan(ja.plan())


def test_errors_match_the_reference():
    for arena in (SharedArena(1 << 32), JSharedArena(1 << 32)):
        with pytest.raises(RuntimeError, match="no tenants"):
            arena.plan()
    arena = SharedArena(1 << 32)
    arena.register_serving(make_profile([(512, 0, 4)]))
    arena.register_training(make_profile([(512, 0, 4)]), steps_per_round=9)
    with pytest.raises(SharedArenaError, match="do not fit"):
        arena.plan()
    with pytest.raises(SharedArenaError, match="already registered"):
        arena.register_serving(make_profile([(512, 0, 4)]))
    with pytest.raises(ValueError, match="steps_per_round"):
        arena.register_training(make_profile([(1, 0, 1)]), steps_per_round=0,
                                name="t2")


# ---------------------------------------------------------------------------
# evict vs share: the shrink hook, the search under a view, plan_remat_policy
# ---------------------------------------------------------------------------


@pytest.fixture
def ref_pricing(monkeypatch):
    """The port's eviction search prices blocks with the H100's peak rate and
    host link, the reference's with the TPU's; the evict-vs-share tests
    price both with the reference's constants, so what they compare is the
    search and the arena, not two data sheets."""
    from repro.remat import cost_model as jcost
    from repro_torch.remat import search as tsearch
    from repro_torch.remat.cost_model import CostModel

    class RefPriced:
        @staticmethod
        def from_profile(profile, **kw):
            kw.setdefault("peak_flops", jcost.PEAK_FLOPS)
            kw.setdefault("host_bw", jcost.HOST_LINK_BW)
            return CostModel.from_profile(profile, **kw)

    monkeypatch.setattr(tsearch, "CostModel", RefPriced)


@pytest.fixture(scope="module")
def ref_train_profile():
    """The reference's traced grad step (its ``test_unified_arena`` fixture),
    and the same profile carried over to the port block by block."""
    cfg = jget_config("qwen2-0.5b").smoke()
    model = JTransformer(cfg)
    bsds = {"tokens": jax.ShapeDtypeStruct((2, 17), jnp.int32)}
    jp = jprofile_fn(jax.grad(lambda p, b: model.loss_fn(p, b, remat=False)[0]),
                     model.abstract(), bsds)
    tp = MemoryProfile(blocks=[Block(bid=b.bid, size=b.size, start=b.start,
                                     end=b.end, tag=b.tag) for b in jp.blocks],
                       retained_bytes=jp.retained_bytes, clock_end=jp.clock_end,
                       meta=dict(jp.meta))
    return jp, tp


def test_shrink_hook_resolves_evict_vs_share(ref_train_profile, ref_pricing):
    """The reference's ``test_shrink_hook_resolves_evict_vs_share`` on the
    same profiles: over budget, the arena asks the remat search to shrink
    the step.  That reference test fails today: its plan ends with
    ``feasible=False`` after one shrink round.  This test holds the port to
    the reference's result (the same ``SharedPlan``, shrink rounds and
    feasibility), not to that test's expectation."""
    jtrain, ttrain = ref_train_profile
    shapes = [(i + 1, 120, 2, 0) for i in range(4)]
    js, ts = _serving_both(shapes)
    budget = (ttrain.retained_bytes + best_fit(ts).peak
              + int(0.5 * best_fit(ttrain).peak))
    ja = JPlanner().plan_shared(hbm_budget=budget, serving_profile=js,
                                training_profile=jtrain, train_steps=1, shrink="remat")
    ta = MemoryPlanner().plan_shared(hbm_budget=budget, serving_profile=ts,
                                     training_profile=ttrain, train_steps=1,
                                     shrink="remat")
    assert _shared_plan(ta.plan()) == _shared_plan(ja.plan())
    assert _stats(ta.stats()) == _stats(ja.stats())
    assert ta.plan().shrink_rounds >= 1             # the eviction search engaged
    assert ta.plan().feasible == ja.plan().feasible


@pytest.mark.parametrize("seed", range(2))
def test_plan_shared_shrinks_like_the_reference(seed, ref_pricing):
    """A flat serving load with no valley and a budget half a training step
    short: the shrink hook (the eviction search) runs in both packages and
    lands on the same plan."""
    shapes = [(i + 1, 120, 2, 0) for i in range(4)]
    js, ts = _serving_both(shapes)
    jt, tt = _train_both(seed + 10, n=60, clock=80)
    budget = tt.retained_bytes + best_fit(ts).peak + int(0.6 * best_fit(tt).peak)
    for shrink in ("remat", None):
        ja = JPlanner().plan_shared(hbm_budget=budget, serving_profile=js,
                                    training_profile=jt, shrink=shrink, max_evict=16)
        ta = MemoryPlanner().plan_shared(hbm_budget=budget, serving_profile=ts,
                                         training_profile=tt, shrink=shrink,
                                         max_evict=16)
        assert _shared_plan(ta.plan()) == _shared_plan(ja.plan())
        assert _stats(ta.stats()) == _stats(ja.stats())
        assert (ta.plan().shrink_rounds > 0) == (shrink == "remat")


def test_eviction_search_under_a_view_matches_the_reference(ref_pricing):
    """``plan_evictions(view=)``: the tenant's budget is the target and the
    post-eviction profile is staged back to the arena (§4.3)."""
    js, ts = _serving_both([(i + 1, 120, 2, 0) for i in range(4)])
    jt, tt = _train_both(21, n=60, clock=80)
    budget = tt.retained_bytes + best_fit(ts).peak + int(0.6 * best_fit(tt).peak)
    out = []
    for arena_cls, search, s, t in ((JSharedArena, jplan_evictions, js, jt),
                                    (SharedArena, plan_evictions, ts, tt)):
        arena = arena_cls(budget)
        arena.register_serving(s)
        view = arena.register_training(t)
        target = view.budget
        ev = search(t, view=view, max_evict=16)
        assert ev.target_peak == target
        staged = arena._tenants["training"].staged
        assert arena.reset_round() == bool(ev.evictions)
        out.append(([vars(e) for e in ev.evictions], ev.peak, ev.plan.offsets,
                    ev.meta, _blocks(ev.profile),
                    None if staged is None else _blocks(staged),
                    _shared_plan(arena.plan()), arena.replan_causes))
    assert out[1] == out[0]
    assert out[1][0]                                # it had to evict


def test_plan_remat_policy_stages_its_plan_on_the_arena():
    """``plan_remat_policy(shared=)`` on the tiny step: the target is the
    training share of the split, and the verified post-remat profile is
    staged back and applied at once (the reference's test of the same
    name, on the port's own trace)."""
    cfg = get_config("qwen2-0.5b").smoke()
    model = Transformer(cfg, RunOpts(attention_impl="full", use_kernels=False),
                        device="cpu")
    bsds = {"tokens": ((2, 17), torch.int32)}
    tprof = train_lib.profile_step(model, bsds)
    sprof = tpages.paged_request_blocks(
        [TRequest(rid=i + 1, prompt_len=32, gen_len=24, arrival=2 * i) for i in range(6)],
        get_config("qwen2-0.5b"), 8)
    serve_peak, train_peak = best_fit(sprof).peak, best_fit(tprof).peak
    budget = tprof.retained_bytes + serve_peak + int(0.4 * train_peak)
    shared = SharedArena(budget)
    shared.register_serving(sprof)
    tv = shared.register_training(tprof, steps_per_round=1)
    target = tv.budget
    policy, ev = train_lib.plan_remat_policy(model, bsds, profile=tprof, shared=tv,
                                             max_evict=64)
    assert ev.target_peak == target == budget - tprof.retained_bytes - serve_peak
    assert ev.evictions and policy.enabled
    assert shared.n_reopt == 1                      # staged + rebalanced
    assert shared.replan_causes == {"boundary-rebalance": 1}
    assert shared._tenants["training"].profile is ev.profile
    plan = shared.plan()
    validate_plan(plan.profile, plan.plan)
    assert plan.standalone["training"] == MemoryPlanner().plan(ev.profile).peak


# ---------------------------------------------------------------------------
# the shared engine against the reference's
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pair():
    return models("float32")


def _churn(n=8):
    """Profiled at 4 generated tokens, live requests ask 10-16: the pool
    runs out, so requests are preempted and the pool is replanned."""
    return [(i + 1, 5 + (3 * i) % 12, 4, 10 + (i + 1) % 7, 2 * i) for i in range(n)]


def _engines(pair, shapes, budget_fn, steps=1, **kw):
    jm, jp, tm, tp = pair
    acct_j, acct_t = jget_config("qwen2-0.5b"), get_config("qwen2-0.5b")
    jt, tt = _requests([(r, n, g, a) for r, n, g, _, a in shapes])
    jl = [JGenRequest(rid=r, prompt=jnp.asarray(prompt(jm.cfg, r, n)), gen_len=gl,
                      arrival=a) for r, n, _, gl, a in shapes]
    tl = [TGenRequest(rid=r, prompt=torch.from_numpy(prompt(tm.cfg, r, n)),
                      gen_len=gl, arrival=a) for r, n, _, gl, a in shapes]
    jtrain, ttrain = _train_both(7)
    budget = budget_fn(acct_t, tt, ttrain)
    out = []
    for cls, arena_cls, m, p, acct, trace, train, live in (
            (JServeEngine, JSharedArena, jm, jp, acct_j, jt, jtrain, jl),
            (ServeEngine, SharedArena, tm, tp, acct_t, tt, ttrain, tl)):
        arena = arena_cls(budget)
        tv = arena.register_training(train, steps_per_round=steps)
        eng = cls(m, p, sample_trace=trace, page_tokens=8, accounting_cfg=acct,
                  shared=arena, **kw)
        cap0 = eng.sched.cap
        out.append((eng, cap0, eng.run(live), arena, tv))
    return out


SUMMARY = ("n_requests", "n_completed", "n_steps", "tokens", "tokens_discarded",
           "max_concurrent", "n_preemptions", "kv_n_reopt")
PAGE_STATS = ("page_tokens", "n_pages", "used_pages", "n_pool_resize", "n_reopt",
              "planned_peak", "max_peak", "overflow_peak", "replan_causes", "tenant")


def _same_engines(j, t):
    (jeng, jcap0, js, ja, jtv), (teng, tcap0, ts, ta, ttv) = j, t
    assert teng.completed == jeng.completed         # token-exact, every rid
    assert (tcap0, teng.sched.cap) == (jcap0, jeng.sched.cap)
    assert {k: ts[k] for k in SUMMARY} == {k: js[k] for k in SUMMARY}
    jkv, tkv = jeng.kv.stats(), teng.kv.stats()
    assert {k: tkv[k] for k in PAGE_STATS} == {k: jkv[k] for k in PAGE_STATS}
    assert _shared_plan(ta.plan()) == _shared_plan(ja.plan())
    assert _stats(ta.stats()) == _stats(ja.stats())
    assert ttv.stats() == jtv.stats()


def test_shared_engine_under_churn_matches_the_reference(pair):
    """Decode outruns the profile: preemptions and §4.3 pool replans, each
    pushed to the arena, which rebalances the split; the admission cap is
    re-derived from the serving share after each boundary."""
    j, t = _engines(pair, _churn(), lambda acct, trace, train: 1 << 32,
                    max_len=64, max_batch=4)
    _same_engines(j, t)
    teng, _, ts, ta, _ = t
    assert ts["n_completed"] == 8 and ts["n_preemptions"] > 0
    assert ts["kv_n_reopt"] >= 1 and ta.n_reopt >= 1
    assert teng.kv.tenant is not None
    assert teng.sched.cap == max(1, min(4, tpages.max_concurrency(
        get_config("qwen2-0.5b"), teng._sample_trace, teng.kv.page_tokens,
        teng.kv.tenant.budget, hi=4)))


def test_shared_split_caps_admission_like_the_reference(pair):
    """A flat serving load (no valley: the fine-tune step overlaps it) and a
    budget whose serving share is two concurrent requests' planned pool:
    the split bounds admission below max_batch in both packages alike."""
    def budget(acct, trace, train):
        two = tpages.concurrency_bytes(acct, trace, 8, batch=2)
        return train.retained_bytes + best_fit(train).peak + two
    shapes = [(i + 1, 8, 4, 4, 0) for i in range(6)]
    j, t = _engines(pair, shapes, budget, max_len=32, max_batch=6)
    _same_engines(j, t)
    teng, cap0, ts, _, _ = t
    assert cap0 < 6 and ts["max_concurrent"] <= teng.sched.cap
    assert ts["n_completed"] == 6


# ---------------------------------------------------------------------------
# the fine-tune tenant and the CLIs
# ---------------------------------------------------------------------------


def test_fine_tune_step_keeps_the_served_weights():
    """``make_train_step`` trains a private replica: the served weights stay
    bit-identical, the replica moves and its loss falls on its batch."""
    cfg = get_config("qwen2-0.5b").smoke()
    model = Transformer(cfg, RunOpts(attention_impl="kernel"), device="cpu")
    params = model.init_loaded(torch.Generator().manual_seed(0))
    before = [t.clone() for t in tree_leaves(params)]
    ft_model = tserve.finetune_model(model)
    assert ft_model.opts.attention_impl == "full" and not ft_model.opts.use_kernels
    with pytest.raises(ValueError, match="no backward"):
        model.loss_fn(params, {"tokens": torch.zeros((1, 9), dtype=torch.int32)})
    step = tserve.make_train_step(ft_model, params, seq=16, batch=2, lr=0.01)
    losses = [float(step()) for _ in range(4)]
    assert all(np.isfinite(losses)) and losses == sorted(losses, reverse=True)
    assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves(params)))
    assert tserve.finetune_shape("full") == tserve.FULL_FINETUNE_SEQ_BATCH
    # clipped: one step moves the replica by lr x max_grad_norm in L2
    clipped = tserve.make_train_step(ft_model, params, seq=16, batch=2, lr=0.5,
                                     max_grad_norm=1e-3)
    replica = tree_leaves(clipped.replica)
    start = [t.detach().clone() for t in replica]
    clipped()
    moved = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(a.detach() - b) for a, b in zip(replica, start)]))
    assert float(moved) == pytest.approx(0.5 * 1e-3, rel=1e-3)
    assert tserve.finetune_shape("tiny") == (32, 4)


def test_loaded_profile_is_of_the_replica_dtype():
    cfg = get_config("qwen2-0.5b").smoke().with_overrides(dtype="bfloat16")
    model = Transformer(cfg, RunOpts(attention_impl="full", use_kernels=False),
                        device="cpu")
    bsds = {"tokens": ((2, 17), torch.int32)}
    masters = train_lib.profile_step(model, bsds)
    loaded = train_lib.profile_step(model, bsds, loaded=True)
    weights = model.load(model.init(torch.Generator().manual_seed(0)))
    batch_bytes = 2 * 17 * 4
    assert loaded.retained_bytes == batch_bytes + sum(
        t.numel() * t.element_size() for t in tree_leaves(weights))
    assert masters.retained_bytes - loaded.retained_bytes == sum(
        t.numel() * 2 for t in tree_leaves(weights) if t.dtype == torch.bfloat16) > 0


@pytest.mark.parametrize("arch", ["mamba2-130m", "recurrentgemma-9b"])
def test_fine_tune_tenant_matches_the_reference_sgd_step(arch, monkeypatch):
    """The ``--share-hbm`` tenant of the recurrent patterns: the port's
    ``make_train_step`` against the reference's at smoke size on the same
    tokens (the reference's ``jax.random.randint`` draw is replaced by the
    batch the port's step draws from its seed), 3 SGD steps at lr 0.01:
    each loss and the final replica within 1e-5 relative.  wq and wk are redrawn at 1/sqrt(d_model)
    as in the pattern-training tests: under the reference's init the
    hybrid's one-head local attention is near one-hot, and f32 rounding of
    either package moves its SGD losses by ~1e-3 at the third step."""
    import inspect

    from repro.launch import serve as jserve_cli
    from repro_torch.models import params_from_jax
    from test_torch_pattern_train import _redraw_qk
    from torch_port_utils import ref_params
    jcfg, tcfg = jget_config(arch).smoke(), get_config(arch).smoke()
    _, np_tree = ref_params(jcfg)
    _redraw_qk(np_tree, jcfg.d_model)
    jparams = jax.tree.map(jnp.asarray, np_tree)
    seq, batch, lr = 16, 2, 0.01
    # the batch the port's step draws from its seed (0)
    tokens = torch.randint(0, tcfg.vocab_size, (batch, seq + 1), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(7)).numpy()
    with monkeypatch.context() as m:
        m.setattr(jax.random, "randint", lambda *a, **k: jnp.asarray(tokens))
        jstep = jserve_cli.make_train_step(JTransformer(jcfg), jparams, seq, batch, lr=lr)
    model = Transformer(tcfg, RunOpts(attention_impl="kernel"), device="cpu")
    tstep = tserve.make_train_step(tserve.finetune_model(model),
                                   model.load(params_from_jax(np_tree)), seq, batch, lr=lr)
    for _ in range(3):
        jl, tl = float(jstep()), float(tstep())
        assert np.isfinite(tl) and abs(tl - jl) <= 1e-5 * abs(jl)
    final = inspect.getclosurevars(jstep).nonlocals["state"]["p"]
    want = torch.cat([torch.as_tensor(np.asarray(t, np.float64)).flatten() for t in
                      tree_leaves(params_from_jax(jax.tree.map(np.asarray, final)))])
    got = torch.cat([t.detach().double().flatten() for t in tree_leaves(tstep.replica)])
    start = torch.cat([torch.as_tensor(np.asarray(t, np.float64)).flatten()
                       for t in tree_leaves(params_from_jax(np_tree))])
    assert float((got - want).norm() / want.norm()) <= 1e-5
    assert float((want - start).norm()) > 0


def _cli(module, *args):
    r = subprocess.run([sys.executable, "-m", module, *args], cwd=ROOT,
                       env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
                            "CUDA_VISIBLE_DEVICES": ""},
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout


def test_serve_cli_share_hbm_runs_fine_tune_steps():
    out = _cli("repro_torch.launch.serve", "--device", "cpu", "--share-hbm", "1",
               "--train-steps", "2", "--requests", "4", "--attn", "paged")
    assert "[shared arena] budget=1.07GB" in out
    line = next(x for x in out.splitlines() if x.startswith("[colocated]"))
    assert int(line.split("train_steps=")[1].split()[0]) >= 1
    assert "completed 4/4 requests" in out
    assert "feasible=True" in out


@pytest.mark.parametrize("arch", ["mamba2-130m", "recurrentgemma-9b"])
def test_serve_cli_share_hbm_runs_recurrent_fine_tune_steps(arch):
    out = _cli("repro_torch.launch.serve", "--arch", arch, "--device", "cpu",
               "--share-hbm", "1", "--train-steps", "2", "--requests", "4")
    assert "[shared arena] budget=1.07GB" in out and "feasible=True" in out
    line = next(x for x in out.splitlines() if x.startswith("[colocated]"))
    assert int(line.split("train_steps=")[1].split()[0]) >= 1
    loss = float(line.split(" loss=")[1].split()[0])
    assert np.isfinite(loss)
    assert "completed 4/4 requests" in out


def test_train_cli_share_hbm_plans_remat_against_the_split():
    out = _cli("repro_torch.launch.train", "--device", "cpu", "--preset", "tiny",
               "--share-hbm", "0.01", "--remat", "planned", "--steps", "2")
    assert "shared arena: budget=0.01GB" in out
    assert "shared arena after remat: reserves=" in out
    assert "done: 2 steps" in out


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: run on the card with "
                    "`python -m pytest -m cuda tests`")


@pytest.mark.cuda
def test_shared_engine_with_fine_tune_steps_on_the_card(card):
    """A small qwen2 on the card, paged decode and flash prefill, serving
    beside fine-tune steps in one arena: the steps fire, every request
    completes, and the token streams equal the same engine's run with no
    fine-tune steps."""
    from repro_torch.kernels import ops
    cfg = get_config("qwen2-0.5b").with_overrides(
        n_layers=2, d_model=128, n_heads=14, n_kv_heads=2, head_dim=64,
        d_ff=256, vocab_size=512, dtype="float32")
    model = Transformer(cfg, RunOpts(attention_impl="kernel"), device="cuda")
    params = model.init_loaded(torch.Generator(device="cuda").manual_seed(0))
    trace = [TRequest(rid=i + 1, prompt_len=8 + 3 * i, gen_len=6, arrival=2 * i)
             for i in range(6)]
    live = [TGenRequest(rid=r.rid, prompt=torch.from_numpy(prompt(cfg, r.rid, r.prompt_len)),
                        gen_len=r.gen_len, arrival=r.arrival) for r in trace]
    ft_model = tserve.finetune_model(model)
    tprof = train_lib.profile_step(ft_model, {"tokens": ((2, 33), torch.int32)},
                                   loaded=True)
    out = []
    for fine_tune in (True, False):
        arena = SharedArena(1 << 32)
        arena.register_training(tprof, steps_per_round=2)
        eng = ServeEngine(model, params, sample_trace=trace, max_len=64, max_batch=4,
                          page_tokens=8, attn_mode="paged", shared=arena)
        eng.warmup()
        ops.reset_launches()
        if fine_tune:
            step = tserve.make_train_step(ft_model, params, 32, 2)
            summary, colo = tserve.run_interleaved(eng, live, arena, step)
            assert colo["n_train_steps"] >= 1 and np.isfinite(colo["train_loss"])
        else:
            summary = eng.run(live)
        torch.cuda.synchronize()
        launches = {fn.__name__: fn.launches for fn in ops.WRAPPERS}
        assert summary["n_completed"] == len(live)
        assert launches["paged_attention"] == cfg.n_layers * eng.decode_steps
        out.append(eng.completed)
    assert out[0] == out[1]
