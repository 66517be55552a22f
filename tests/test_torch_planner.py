"""Port planner and page-pool accounting vs the reference, checked exactly:
the framework-free copies must reproduce the reference's offsets, peaks,
pool sizes, page-size choices and pool statistics on seeded profiles and on
full-size qwen2-0.5b accounting."""
import dataclasses

import numpy as np
import pytest

import repro.configs as jconfigs
import repro.core as jcore
import repro.runtime.serve_lib as jserve
import repro.serving.pages as jpages
import repro_torch.configs as tconfigs
import repro_torch.core as tcore
import repro_torch.runtime.serve_lib as tserve
import repro_torch.serving.pages as tpages

TIMING = {"seconds", "last_replan_s", "reopt_seconds", "per_event_us",
          "pool_us_per_event"}


def _untimed(d: dict) -> dict:
    return {k: v for k, v in d.items() if k not in TIMING}


def _triples(seed: int, n: int):
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, 40, size=n)
    lens = rng.integers(1, 20, size=n)
    sizes = rng.integers(1, 5000, size=n)
    return [(int(s), int(a), int(a + l)) for s, a, l in zip(sizes, starts, lens)]


@pytest.mark.parametrize("seed,n", [(0, 12), (1, 60), (2, 200)])
def test_best_fit_and_refit_exact(seed, n):
    triples = _triples(seed, n)
    jp, tp = jcore.make_profile(triples), tcore.make_profile(triples)
    jplan, tplan = jcore.best_fit(jp), tcore.best_fit(tp)
    assert tplan.offsets == jplan.offsets and tplan.peak == jplan.peak
    assert _untimed(tplan.stats) == _untimed(jplan.stats)
    assert tp.liveness_lower_bound() == jp.liveness_lower_bound()
    # §4.3 warm-started replan after a few rectangles grow
    grown = [(s * 2 if i % 7 == 0 else s, a, e)
             for i, (s, a, e) in enumerate(triples)]
    jg, tg = jcore.make_profile(grown), tcore.make_profile(grown)
    jr, tr = jcore.refit(jg, jp, jplan), tcore.refit(tg, tp, tplan)
    assert tr.offsets == jr.offsets and tr.peak == jr.peak
    assert tr.stats["mode"] == jr.stats["mode"]


def test_arena_and_baselines_exact():
    triples = _triples(3, 80)
    jp, tp = jcore.make_profile(triples), tcore.make_profile(triples)
    ja, ta = jcore.ArenaAllocator(jp), tcore.ArenaAllocator(tp)
    for (s, _, _) in triples + triples[:5]:           # 5 novel blocks overflow
        assert ta.alloc(s) == ja.alloc(s)
    ja.reset_iteration(), ta.reset_iteration()
    assert _untimed(ta.stats()) == _untimed(ja.stats())
    jrep = jcore.MemoryPlanner().report(jp)
    trep = tcore.MemoryPlanner().report(tp)
    assert trep.plan.offsets == jrep.plan.offsets
    assert _untimed(trep.quality) == _untimed(jrep.quality)
    assert _untimed(trep.baselines) == _untimed(jrep.baselines)
    budget = lambda b: 1000 * b * b
    assert (tcore.MemoryPlanner().max_feasible_batch(budget, 10 ** 7)
            == jcore.MemoryPlanner().max_feasible_batch(budget, 10 ** 7))


def test_configs_are_copies():
    assert tconfigs.list_configs() == jconfigs.list_configs()
    for name in jconfigs.list_configs():
        assert (dataclasses.asdict(tconfigs.get_config(name))
                == dataclasses.asdict(jconfigs.get_config(name)))


def _trace(seed: int, n: int, lo: int, hi: int, gen: int):
    rng = np.random.default_rng(seed)
    t, out = 0, []
    for i in range(n):
        t += int(rng.integers(0, 4))
        out.append((i + 1, int(rng.integers(lo, hi)), gen + int(rng.integers(-3, 4)), t))
    return out


@pytest.mark.parametrize("arch,trace_args", [
    ("qwen2-0.5b", (0, 6, 100, 300, 32)),         # long prompts, bf16 pool
    ("qwen2-0.5b", (1, 30, 5, 40, 12)),
    ("mistral-nemo-12b", (2, 8, 64, 256, 48)),
])
def test_page_plan_and_arena_accounting_exact(arch, trace_args):
    """Full-size accounting: bytes per token, page-size choice, pool plan
    and slab baselines, and the slab-per-request ServingArena."""
    shapes = _trace(*trace_args)
    jtr = [jserve.Request(rid=r, prompt_len=p, gen_len=g, arrival=a) for r, p, g, a in shapes]
    ttr = [tserve.Request(rid=r, prompt_len=p, gen_len=g, arrival=a) for r, p, g, a in shapes]
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    assert tserve.cache_bytes_per_token(tcfg) == jserve.cache_bytes_per_token(jcfg)
    assert tserve.state_bytes(tcfg) == jserve.state_bytes(jcfg)
    jplan = jpages.choose_page_tokens(jcfg, jtr)
    tplan = tpages.choose_page_tokens(tcfg, ttr)
    for f in ("page_tokens", "page_bytes", "n_pages", "planned_peak"):
        assert getattr(tplan, f) == getattr(jplan, f), f
    assert tplan.baselines == jplan.baselines
    assert tplan.profile.blocks == [tcore.Block(**dataclasses.asdict(b))
                                    for b in jplan.profile.blocks]
    jp16, tp16 = jpages.plan_pool(jcfg, jtr, 16), tpages.plan_pool(tcfg, ttr, 16)
    assert (tp16.n_pages, tp16.planned_peak, tp16.baselines) == \
        (jp16.n_pages, jp16.planned_peak, jp16.baselines)
    assert (tpages.max_concurrency(tcfg, ttr, tplan.page_tokens, 2 * 10 ** 9, hi=64)
            == jpages.max_concurrency(jcfg, jtr, jplan.page_tokens, 2 * 10 ** 9, hi=64))
    assert (tserve.ServingArena(tcfg, ttr).compare_pool()
            == jserve.ServingArena(jcfg, jtr).compare_pool())


def test_paged_kv_cache_lifecycle_stats_exact():
    """Scripted admit/append/preempt/replan churn: every page id, exec table
    and (untimed) stat must match the reference step for step."""
    shapes = _trace(4, 10, 5, 30, 8)
    cfg_j = jconfigs.get_config("qwen2-0.5b")
    cfg_t = tconfigs.get_config("qwen2-0.5b")
    jkv = jpages.PagedKVCache(cfg_j, [jserve.Request(*s[:1], s[1], s[2], s[3]) for s in shapes], page_tokens=8)
    tkv = tpages.PagedKVCache(cfg_t, [tserve.Request(*s[:1], s[1], s[2], s[3]) for s in shapes], page_tokens=8)
    rng = np.random.default_rng(7)
    live = []
    for step, (rid, prompt, gen, _) in enumerate(shapes * 2):
        rid = rid + 100 * (step // len(shapes))
        for kv in (jkv, tkv):
            if kv.can_admit(prompt):
                kv.admit(rid, prompt)
        if rid in tkv.tables:
            live.append(rid)
        for r in list(live):
            for _ in range(int(rng.integers(1, 12))):
                outs = []
                for kv in (jkv, tkv):
                    try:
                        kv.append_token(r)
                        outs.append(True)
                    except (jpages.PagePoolExhausted, tpages.PagePoolExhausted):
                        kv.request_replan()
                        kv.release(r)
                        outs.append(False)
                assert outs[0] == outs[1]
                if not outs[0]:
                    live.remove(r)
                    break
            if r in live and rng.random() < 0.3:
                jkv.release(r), tkv.release(r)
                live.remove(r)
        assert tkv.tables == jkv.tables and tkv.exec_tables == jkv.exec_tables
        if step % 5 == 4:
            jkv.reset_epoch(), tkv.reset_epoch()
        assert _untimed(tkv.stats()) == _untimed(jkv.stats())
    assert tkv.stats()["n_reopt"] > 0
