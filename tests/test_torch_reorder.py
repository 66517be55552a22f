"""repro_torch.core.reorder against repro.core.reorder: the same precedence
graph (ticks, edges, slack), the same reordered peak, plan offsets, op order
and stats (timing aside) on the same profiles, built in both packages with
``make_profile`` from numpy-seeded triples, with and without recorded
``op_edges``; the planner's reorder entry points, ``plan_pool(reorder=)``'s
advisory baselines, and the remat search's ``reorder=`` repacks.  Pure
data, so every comparison is exact."""
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import MemoryPlanner as JPlanner
from repro.core import PrecedenceGraph as JGraph
from repro.core import make_profile as jmake_profile
from repro.core import reorder_profile as jreorder_profile
from repro.core.events import Block as JBlock
from repro.core.events import MemoryProfile as JMemoryProfile
from repro.core.reorder import _list_schedule as jlist_schedule
from repro.core.reorder import apply_order as japply_order
from repro.remat import plan_evictions as jplan_evictions
from repro.runtime.serve_lib import Request as JRequest
from repro.serving import pages as jpages
from repro_torch.configs import get_config
from repro_torch.core import (MemoryPlanner, PrecedenceGraph, make_profile,
                              reorder_profile, validate_plan)
from repro_torch.core.reorder import _list_schedule, apply_order
from repro_torch.models import RunOpts, Transformer
from repro_torch.remat import plan_evictions
from repro_torch.runtime import train_lib
from repro_torch.runtime.serve_lib import Request as TRequest
from repro_torch.serving import pages as tpages


def _spec(seed: int, n: int = 24, horizon: int = 40):
    """(size, start, end) triples drawn with numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        s = int(rng.integers(0, horizon))
        out.append((int(rng.choice([256, 512, 1024, 4096, 8192])), s,
                    s + int(rng.integers(1, 12))))
    return out


def _edges(spec, seed: int, n: int = 12):
    """Forward (producer tick, consumer tick) pairs among the spec's ticks."""
    rng = np.random.default_rng(seed + 100)
    ticks = sorted({t for _, s, e in spec for t in (s, e - 1)})
    out = []
    for _ in range(n):
        i, j = sorted(rng.choice(len(ticks), 2, replace=False).tolist())
        out.append((ticks[i], ticks[j]))
    return out


def _both(spec, edges=None):
    jp, tp = jmake_profile(spec, alignment=1), make_profile(spec, alignment=1)
    if edges is not None:
        jp.meta["op_edges"] = list(edges)
        tp.meta["op_edges"] = list(edges)
    return jp, tp


def _graph(g):
    return (g.ticks, g.edges, g.start_op, g.end_op, g.preds, g.succs,
            g.levels(), g.slack())


def _result(r):
    stats = {k: v for k, v in r.stats.items() if k != "seconds"}
    blocks = [(b.bid, b.size, b.start, b.end) for b in r.profile.blocks]
    return (r.peak, r.identity_peak, r.order, r.plan.offsets, blocks, stats,
            r.profile.meta.get("reorder_ticks"), r.improved)


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("with_edges", [False, True])
def test_graph_matches_the_reference(seed, with_edges):
    spec = _spec(seed)
    jp, tp = _both(spec, _edges(spec, seed) if with_edges else None)
    jg, tg = JGraph.from_profile(jp), PrecedenceGraph.from_profile(tp)
    assert _graph(tg) == _graph(jg)
    assert tg.block_slack(tp) == jg.block_slack(jp)
    order = _list_schedule(tg, [b.size for b in tp.blocks][:tg.n_ops] +
                           [0] * max(0, tg.n_ops - tp.n), [0] * tg.n_ops)
    assert order == jlist_schedule(jg, [b.size for b in jp.blocks][:jg.n_ops] +
                                   [0] * max(0, jg.n_ops - jp.n), [0] * jg.n_ops)
    assert tg.check_order(order) and jg.check_order(order)
    a, b = apply_order(tp, tg, order), japply_order(jp, jg, order)
    assert [(x.bid, x.start, x.end) for x in a.blocks] == \
        [(x.bid, x.start, x.end) for x in b.blocks]
    assert a.meta["reorder_ticks"] == b.meta["reorder_ticks"]


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("mode", ["greedy", "ils"])
@pytest.mark.parametrize("with_edges", [False, True])
def test_reorder_matches_the_reference(seed, mode, with_edges):
    spec = _spec(seed + 20)
    jp, tp = _both(spec, _edges(spec, seed) if with_edges else None)
    jr = jreorder_profile(jp, mode=mode, rounds=6, seed=seed)
    tr = reorder_profile(tp, mode=mode, rounds=6, seed=seed)
    assert _result(tr) == _result(jr)
    validate_plan(tr.profile, tr.plan)
    assert tr.peak <= tr.identity_peak


def test_slide_instance_halves_like_the_reference():
    """The reference's slide instance: serialising the short blocks halves
    the peak, in both packages alike."""
    spec = []
    t = 0
    for _ in range(3):
        spec += [(1 << 10, t, t + 4), (1 << 10, t + 1, t + 2), (1 << 10, t + 2, t + 3)]
        t += 5
    jp, tp = _both(spec)
    jr, tr = jreorder_profile(jp, mode="greedy"), reorder_profile(tp, mode="greedy")
    assert _result(tr) == _result(jr)
    assert tr.peak == 1 << 10 and tr.identity_peak == 2 << 10


def test_backward_op_edges_raise_like_the_reference():
    spec = [(512, 0, 3), (512, 2, 6), (512, 5, 9)]
    jp, tp = _both(spec, [(5, 2)])
    with pytest.raises(ValueError, match="against the event clock") as te:
        PrecedenceGraph.from_profile(tp)
    with pytest.raises(ValueError, match="against the event clock") as je:
        JGraph.from_profile(jp)
    assert str(te.value) == str(je.value)
    with pytest.raises(ValueError, match="unknown reorder mode"):
        reorder_profile(make_profile(spec), mode="anneal")


@pytest.mark.parametrize("seed", range(3))
def test_planner_entry_points_match_the_reference(seed):
    spec = _spec(seed + 40)
    jp, tp = _both(spec, _edges(spec, seed))
    for mode in ("greedy", True):
        jr = JPlanner().plan_reordered(jp, mode=mode, rounds=4, seed=seed)
        tr = MemoryPlanner().plan_reordered(tp, mode=mode, rounds=4, seed=seed)
        assert _result(tr) == _result(jr)
        jplan, tplan = JPlanner().plan(jp, reorder=mode), MemoryPlanner().plan(tp, reorder=mode)
        assert (tplan.peak, tplan.offsets) == (jplan.peak, jplan.offsets)
    assert MemoryPlanner().plan(tp, reorder=None).offsets == JPlanner().plan(jp).offsets


@pytest.mark.parametrize("mode", ["greedy", True])
def test_plan_pool_reorder_baselines_match_the_reference(mode):
    cfg, jcfg = get_config("qwen2-0.5b"), jget_config("qwen2-0.5b")
    shapes = [(i + 1, 16 + 9 * i, 6 + (i % 3) * 4, i) for i in range(6)]
    jt = [JRequest(rid=r, prompt_len=p, gen_len=g, arrival=a) for r, p, g, a in shapes]
    tt = [TRequest(rid=r, prompt_len=p, gen_len=g, arrival=a) for r, p, g, a in shapes]
    jplan = jpages.plan_pool(jcfg, jt, 8, reorder=mode)
    tplan = tpages.plan_pool(cfg, tt, 8, reorder=mode)
    assert tplan.baselines == jplan.baselines
    assert "reordered_dsa_peak" in tplan.baselines
    # the pool is still sized by the identity-order plan
    assert (tplan.n_pages, tplan.planned_peak) == (jplan.n_pages, jplan.planned_peak)
    assert tplan.planned_peak == tpages.plan_pool(cfg, tt, 8).planned_peak
    kv = tpages.PagedKVCache(cfg, tt, page_tokens=8, reorder=mode)
    assert kv.plan.baselines == jpages.PagedKVCache(jcfg, jt, page_tokens=8,
                                                    reorder=mode).plan.baselines


@pytest.mark.parametrize("seed", range(3))
def test_eviction_search_with_reorder_matches_the_reference(seed):
    """``plan_evictions(reorder=)``: every trial repack keeps the cheaper of
    the identity and the reordered schedule; the same evictions, offsets and
    ``packed_profile`` in both packages."""
    spec = [(1 << 16, 0, 60)] + _spec(seed + 60, n=30, horizon=56)
    jp, tp = _both(spec)
    for reorder in ("greedy", True):
        je = jplan_evictions(jp, reorder=reorder, max_evict=6)
        te = plan_evictions(tp, reorder=reorder, max_evict=6)
        assert [vars(e) for e in te.evictions] == [vars(e) for e in je.evictions]
        assert (te.baseline_peak, te.peak, te.plan.offsets, te.meta) == \
            (je.baseline_peak, je.peak, je.plan.offsets, je.meta)
        assert (te.packed_profile is None) == (je.packed_profile is None)
        pp, jpp = te.plan_profile, je.plan_profile
        assert [(b.bid, b.size, b.start, b.end) for b in pp.blocks] == \
            [(b.bid, b.size, b.start, b.end) for b in jpp.blocks]
        validate_plan(te.plan_profile, te.plan)
        assert te.peak <= te.baseline_peak


def test_reorder_of_a_traced_step_matches_the_reference():
    """The port's ``make_fx`` profile writes ``op_edges``: the precedence
    graph keeps that dataflow, and the reference's reorder, run on the same
    profile carried over block by block, gives the same result."""
    cfg = get_config("qwen2-0.5b").smoke().with_overrides(n_layers=2)
    model = Transformer(cfg, RunOpts(attention_impl="full", use_kernels=False),
                        device="cpu")
    tp = train_lib.profile_step(model, {"tokens": ((2, 17), torch.int32)})
    assert tp.meta["op_edges"]
    jp = JMemoryProfile(blocks=[JBlock(bid=b.bid, size=b.size, start=b.start,
                                       end=b.end, tag=b.tag) for b in tp.blocks],
                        retained_bytes=tp.retained_bytes, clock_end=tp.clock_end,
                        meta={"op_edges": list(tp.meta["op_edges"])})
    tg, jg = PrecedenceGraph.from_profile(tp), JGraph.from_profile(jp)
    assert _graph(tg) == _graph(jg)
    assert len(tg.edges) > len({(tg.start_op[b.bid], tg.end_op[b.bid])
                                for b in tp.blocks if b.lifetime > 1})
    tr = reorder_profile(tp, mode="greedy")
    jr = jreorder_profile(jp, mode="greedy")
    assert _result(tr) == _result(jr)
    assert tr.peak <= tr.identity_peak
