"""repro_torch.core's exact solvers against repro.core's: the branch-and-bound
DSA (``solve_exact``, with its node limit hit and not hit), the LP export
(``to_lp``, ``to_lp_eviction``, ``num_variables``, ``eviction_candidates``),
the exact eviction optimum (``exact_eviction_peak``) and the scipy/HiGHS
MILPs (``solve_milp``, ``solve_joint``, ``solve_eviction_milp``), on the
same profiles built in both packages with ``make_profile`` from
numpy-seeded triples.  Everything but the MILPs is pure data, so exact.

The MILPs run with a 20 s time limit per solve on instances HiGHS closes to
optimality in well under a second: the status and the peak must agree, the
offsets must validate, and they must equal the reference's wherever the
reference gives the same offsets in two runs."""
import numpy as np
import pytest

from repro.core import MemoryPlanner as JPlanner
from repro.core import exact_eviction_peak as jexact_eviction_peak
from repro.core import make_profile as jmake_profile
from repro.core import solve_exact as jsolve_exact
from repro.core import to_lp as jto_lp
from repro.core import to_lp_eviction as jto_lp_eviction
from repro.core.mip import eviction_candidates as jeviction_candidates
from repro.core.mip import num_variables as jnum_variables
from repro_torch.core import (MemoryPlanner, SolverUnavailable, best_fit,
                              exact_eviction_peak, have_solver, make_profile,
                              solve_exact, to_lp, to_lp_eviction, validate_plan)
from repro_torch.core import solvers as tsolvers
from repro_torch.core.mip import eviction_candidates, num_variables

MILP_TIME_LIMIT_S = 20.0

needs_scipy = pytest.mark.skipif(not have_solver(),
                                 reason="scipy (the [solver] extra) is not installed")


POW2 = (256, 512, 1024, 2048, 4096)
# sizes that do not nest: best fit often misses the liveness bound on these,
# so the search has work to do
ODD = (300, 500, 700, 1100, 1300)
# ODD seeds (9 blocks over 12 ticks) where best fit misses the bound and the
# search closes the gap, in 46 to 4643 nodes
HARD_SEEDS = (12, 30, 53, 142, 177)
# ODD seeds (14 blocks over 6 ticks) where 40 nodes do not finish the search
CUT_SEEDS = (40, 47, 83, 123)


def _spec(seed: int, n: int = 8, horizon: int = 12, sizes=POW2):
    """(size, start, end) triples drawn with numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        s = int(rng.integers(0, horizon + 1))
        out.append((int(rng.choice(sizes)), s, s + int(rng.integers(1, 11))))
    return out


def _both(spec):
    return jmake_profile(spec, alignment=1), make_profile(spec, alignment=1)


def _plan(p, timing=("seconds",)):
    return (p.peak, p.offsets, p.solver, p.proven_optimal,
            {k: v for k, v in p.stats.items() if k not in timing})


def _fat_block_spec():
    # the reference's eviction instance: one fat long-lived block under a
    # churn of short ones, so evicting it lowers the exact peak
    return [(4096, 0, 12), (2048, 0, 3), (2048, 3, 6), (2048, 6, 9),
            (2048, 9, 12), (1024, 2, 10)]


# ---------------------------------------------------------------------------
# branch and bound
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", (0, *HARD_SEEDS))
def test_exact_matches_the_reference(seed):
    jp, tp = _both(_spec(seed, n=9, sizes=ODD))
    got, want = solve_exact(tp), jsolve_exact(jp)
    assert _plan(got) == _plan(want)
    validate_plan(tp, got)
    assert got.proven_optimal and got.peak <= best_fit(tp).peak
    if seed:
        assert got.peak < best_fit(tp).peak and got.stats["nodes"] > 0


@pytest.mark.parametrize("seed", CUT_SEEDS)
def test_exact_with_its_node_limit_hit_matches_the_reference(seed):
    jp, tp = _both(_spec(seed, n=14, horizon=6, sizes=ODD))
    got, want = solve_exact(tp, node_limit=40), jsolve_exact(jp, node_limit=40)
    assert _plan(got) == _plan(want)
    assert got.stats["nodes"] > 40 and not got.proven_optimal  # the limit cut it
    validate_plan(tp, got)


def test_exact_of_empty_and_zero_sized_profiles_matches_the_reference():
    for spec in ([], [(0, 0, 3), (128, 1, 2)]):
        jp, tp = _both(spec)
        assert _plan(solve_exact(tp)) == _plan(jsolve_exact(jp))


# ---------------------------------------------------------------------------
# LP export and the exact eviction optimum
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", (1, 2, *HARD_SEEDS[:2]))
def test_lp_text_matches_the_reference(seed):
    jp, tp = _both(_spec(seed, sizes=ODD))
    w = best_fit(tp).peak
    assert to_lp(tp, w) == jto_lp(jp, w)
    assert num_variables(tp) == jnum_variables(jp)
    for kw in ({}, {"max_evict": 1}, {"max_candidates": 3}):
        assert to_lp_eviction(tp, w, **kw) == jto_lp_eviction(jp, w, **kw)
    assert eviction_candidates(tp) == jeviction_candidates(jp)
    assert to_lp_eviction(tp, w, candidate_bids=[]) == \
        jto_lp_eviction(jp, w, candidate_bids=[])


def _eviction(r):
    return (r["peak"], r["evicted"], r["n_subsets"], r["proven_optimal"],
            r["candidates"], r["plan"].offsets,
            [(b.bid, b.size, b.start, b.end) for b in r["profile"].blocks])


@pytest.mark.parametrize("spec", [_fat_block_spec(), _spec(31, n=7), _spec(32, n=7)],
                         ids=["fat-block", "seed31", "seed32"])
def test_exact_eviction_peak_matches_the_reference(spec):
    jp, tp = _both(spec)
    got, want = exact_eviction_peak(tp, max_candidates=4), \
        jexact_eviction_peak(jp, max_candidates=4)
    assert _eviction(got) == _eviction(want)
    assert got["peak"] <= solve_exact(tp).peak
    capped = exact_eviction_peak(tp, max_candidates=4, max_evict=1)
    assert _eviction(capped) == _eviction(
        jexact_eviction_peak(jp, max_candidates=4, max_evict=1))


# ---------------------------------------------------------------------------
# scipy / HiGHS MILPs
# ---------------------------------------------------------------------------


def test_planner_solvers_match_the_reference_registry():
    from repro.core.planner import _SOLVERS as JSOLVERS
    from repro_torch.core.planner import _SOLVERS
    assert sorted(_SOLVERS) == sorted(JSOLVERS) == ["bestfit", "exact", "milp"]
    with pytest.raises(ValueError, match="unknown solver"):
        MemoryPlanner(solver="cplex")
    jp, tp = _both(_spec(3))
    assert _plan(MemoryPlanner(solver="exact").plan(tp)) == \
        _plan(JPlanner(solver="exact").plan(jp))
    assert issubclass(SolverUnavailable, RuntimeError)


def test_milp_without_scipy_raises_solver_unavailable(monkeypatch):
    monkeypatch.setattr(tsolvers, "_HAVE", False)
    assert not have_solver()
    with pytest.raises(SolverUnavailable, match="scipy"):
        MemoryPlanner(solver="milp")
    with pytest.raises(SolverUnavailable, match="scipy"):
        tsolvers.solve_milp(make_profile([(128, 0, 2)]))


def _milp_pair(fn_t, fn_j, tp, jp, **kw):
    """Port result, reference result, and whether the reference gave the
    same answer in a second run."""
    want = fn_j(jp, time_limit_s=MILP_TIME_LIMIT_S, **kw)
    again = fn_j(jp, time_limit_s=MILP_TIME_LIMIT_S, **kw)
    got = fn_t(tp, time_limit_s=MILP_TIME_LIMIT_S, **kw)
    return got, want, again


@needs_scipy
@pytest.mark.parametrize("seed", (0, 1, *HARD_SEEDS))
def test_milp_matches_the_reference(seed):
    from repro.core import solve_milp as jsolve_milp
    jp, tp = _both(_spec(seed, n=9, sizes=ODD))
    got, want, again = _milp_pair(tsolvers.solve_milp, jsolve_milp, tp, jp)
    assert want.proven_optimal                      # the instance closes
    assert (got.peak, got.proven_optimal, got.stats["status"]) == \
        (want.peak, want.proven_optimal, want.stats["status"])
    validate_plan(tp, got)
    if again.offsets == want.offsets:
        assert got.offsets == want.offsets
    assert got.peak == solve_exact(tp).peak         # both exact: one optimum
    plan = MemoryPlanner(solver="milp").plan(tp)
    assert (plan.solver, plan.peak) == ("milp", got.peak)


@needs_scipy
@pytest.mark.parametrize("seed", range(3))
def test_joint_milp_matches_the_reference(seed):
    from repro.core import solve_joint as jsolve_joint
    jp, tp = _both(_spec(seed + 10, n=5))
    got, want, again = _milp_pair(tsolvers.solve_joint, jsolve_joint, tp, jp)
    assert want.proven_optimal
    assert (got.peak, got.identity_peak, got.proven_optimal) == \
        (want.peak, want.identity_peak, want.proven_optimal)
    assert got.graph.check_order(got.order)
    validate_plan(got.profile, got.plan)
    if (again.order, again.plan.offsets) == (want.order, want.plan.offsets):
        assert (got.order, got.plan.offsets) == (want.order, want.plan.offsets)


@needs_scipy
@pytest.mark.parametrize("spec", [_fat_block_spec(), _spec(31, n=7)],
                         ids=["fat-block", "seed31"])
def test_eviction_milp_matches_the_reference(spec):
    from repro.core import solve_eviction_milp as jsolve_eviction_milp
    jp, tp = _both(spec)
    got, want, again = _milp_pair(tsolvers.solve_eviction_milp, jsolve_eviction_milp,
                                  tp, jp, max_candidates=4)
    assert want["proven_optimal"]
    assert (got["peak"], got["proven_optimal"]) == (want["peak"], want["proven_optimal"])
    assert got["peak"] == exact_eviction_peak(tp, max_candidates=4)["peak"]
    validate_plan(got["profile"], got["plan"])
    if (again["evicted"], again["plan"].offsets) == (want["evicted"], want["plan"].offsets):
        assert (got["evicted"], got["plan"].offsets) == \
            (want["evicted"], want["plan"].offsets)
