"""MIP formulation of DSA (paper §3.1, eqs. (1)-(6)) — CPLEX .lp export
(copy of ``repro.core.mip``).

We do not ship CPLEX; `to_lp()` emits the exact formulation in LP format so
the instance can be solved by any external MIP solver, and `objective_terms()`
exposes the model for the in-repo branch-and-bound (core/exact.py).

Eviction extension (the Fig. 4 analogue for remat): `to_lp_eviction()` adds a
binary e_i per evictable block — when set, block i's rectangle is replaced by
its production/re-materialization stubs (exactly the `remat.search.evict_block`
transform) — so an external solver proves the joint pack-AND-evict optimum.
`exact_eviction_peak()` is the in-repo ground truth: it enumerates eviction
subsets and solves each residual DSA exactly, lower-bounding the greedy
`remat.search.plan_evictions` selection on small instances.
"""
from __future__ import annotations

from itertools import combinations
from typing import Optional, Sequence

from .evict import MIN_EVICT_LIFETIME, evict_block, stub_size
from .events import MemoryProfile


def to_lp(profile: MemoryProfile, max_memory: int) -> str:
    """Emit eqs. (1)-(6) in CPLEX LP format.

    Variables: u (peak), x_i (offsets), z_ij (disjunction selectors).
    """
    bs = [b for b in profile.blocks if b.size > 0]
    E = []
    order = sorted(range(len(bs)), key=lambda i: bs[i].start)
    active: list[int] = []
    for i in order:
        active = [j for j in active if bs[j].end > bs[i].start]
        for j in active:
            a, b = min(i, j), max(i, j)
            E.append((a, b))
        active.append(i)
    E.sort()

    lines = ["\\ DSA MIP (Sekiyama et al. 2018, eqs. 1-6)", "Minimize", " obj: u",
             "Subject To"]
    # (2)  x_i + w_i <= u
    for i, b in enumerate(bs):
        lines.append(f" peak_{i}: x_{i} - u <= -{b.size}")
    # (3)  x_i + w_i <= x_j + z_ij * W
    # (4)  x_j + w_j <= x_i + (1 - z_ij) * W
    for (i, j) in E:
        wi, wj = bs[i].size, bs[j].size
        lines.append(f" no_ov_a_{i}_{j}: x_{i} - x_{j} - {max_memory} z_{i}_{j} <= -{wi}")
        lines.append(f" no_ov_b_{i}_{j}: x_{j} - x_{i} + {max_memory} z_{i}_{j} <= {max_memory - wj}")
    lines.append("Bounds")
    # (5)  0 <= u <= W ; (6) x_i >= 0
    lines.append(f" 0 <= u <= {max_memory}")
    for i, b in enumerate(bs):
        lines.append(f" 0 <= x_{i} <= {max_memory - b.size}")
    lines.append("Generals")
    lines.append(" u " + " ".join(f"x_{i}" for i in range(len(bs))))
    lines.append("Binaries")
    if E:
        lines.append(" " + " ".join(f"z_{i}_{j}" for (i, j) in E))
    lines.append("End")
    return "\n".join(lines) + "\n"


def num_variables(profile: MemoryProfile) -> dict:
    bs = [b for b in profile.blocks if b.size > 0]
    ne = len(profile.colliding_pairs())
    return {"x": len(bs), "z": ne, "u": 1, "total": len(bs) + ne + 1}


# ---------------------------------------------------------------------------
# eviction binaries (remat × DSA, exact)
# ---------------------------------------------------------------------------


def eviction_candidates(profile: MemoryProfile,
                        max_candidates: int = 8) -> list[int]:
    """Evictable bids, largest HBM area first — the same eligibility rule the
    greedy search uses (long enough to leave stub headroom)."""
    bs = [b for b in profile.blocks
          if b.size > 0 and b.lifetime >= MIN_EVICT_LIFETIME]
    bs.sort(key=lambda b: (-b.size * b.lifetime, b.bid))
    return [b.bid for b in bs[:max_candidates]]


def exact_eviction_peak(profile: MemoryProfile,
                        candidate_bids: Optional[Sequence[int]] = None, *,
                        max_evict: Optional[int] = None,
                        max_candidates: int = 8,
                        node_limit: int = 200_000,
                        time_limit_s: float = 20.0) -> dict:
    """Exact (small-instance) joint eviction + packing optimum.

    Enumerates every eviction subset of the candidates (up to ``max_evict``
    selections), applies the search's stub transform, and solves each
    residual DSA with the branch-and-bound solver.  The returned peak
    lower-bounds what the greedy `plan_evictions` can reach with the same
    candidate pool — the remat analogue of the paper's Fig. 4 exact-vs-
    heuristic comparison.
    """
    from .exact import solve_exact

    if candidate_bids is None:
        candidate_bids = eviction_candidates(profile, max_candidates)
    candidate_bids = list(candidate_bids)
    if max_evict is None:
        max_evict = len(candidate_bids)
    block_steps = profile.meta.get("block_steps", {})
    by_bid = {b.bid: b for b in profile.blocks}
    next_bid = max(by_bid, default=0) + 1

    best = None
    proven = True
    n_subsets = 0
    for k in range(0, min(max_evict, len(candidate_bids)) + 1):
        for subset in combinations(candidate_bids, k):
            n_subsets += 1
            blocks = dict(by_bid)
            nb = next_bid
            ok = True
            for bid in subset:
                steps = int(block_steps.get(bid, block_steps.get(str(bid), 1)))
                stubs = evict_block(blocks[bid], nb, steps)
                if not stubs:
                    ok = False
                    break
                del blocks[bid]
                for s in stubs:
                    blocks[s.bid] = s
                nb += 1
            if not ok:
                continue
            prof = MemoryProfile(blocks=list(blocks.values()),
                                 retained_bytes=profile.retained_bytes,
                                 clock_end=profile.clock_end,
                                 meta=profile.meta)
            plan = solve_exact(prof, node_limit=node_limit,
                               time_limit_s=time_limit_s)
            proven = proven and plan.proven_optimal
            if best is None or (plan.peak, len(subset)) < (best[0], len(best[1])):
                best = (plan.peak, subset, plan, prof)
    assert best is not None
    peak, subset, plan, prof = best
    return {"peak": peak, "evicted": tuple(subset), "plan": plan,
            "profile": prof, "n_subsets": n_subsets,
            "proven_optimal": proven, "candidates": tuple(candidate_bids)}


def to_lp_eviction(profile: MemoryProfile, max_memory: int,
                   candidate_bids: Optional[Sequence[int]] = None, *,
                   max_evict: Optional[int] = None,
                   max_candidates: int = 8) -> str:
    """Emit the DSA MIP extended with eviction binaries, in CPLEX LP format.

    Per candidate block i: binary ``e_i``; when set, i's full rectangle is
    replaced by a head stub at its offset ``x_i`` (production tick) and a
    tail stub at a fresh offset ``xt_i`` (re-materialization tick), both of
    the stub size.  Pairwise no-overlap disjunctions are gated by the
    presence of each rectangle (big-M on ``e``): eqs. (3)-(4) hold between
    every pair of co-live *present* rectangles.
    """
    if candidate_bids is None:
        candidate_bids = eviction_candidates(profile, max_candidates)
    cand = set(candidate_bids)
    block_steps = profile.meta.get("block_steps", {})
    bs = [b for b in profile.blocks if b.size > 0]
    index = {b.bid: i for i, b in enumerate(bs)}
    M = max_memory

    # rectangles: (name, offset_var, width, start, end, gate)
    # gate: None = always present, ("off", i) = present iff e_i = 0,
    # ("on", i) = present iff e_i = 1
    rects = []
    for b in bs:
        i = index[b.bid]
        if b.bid in cand:
            steps = int(block_steps.get(b.bid, block_steps.get(str(b.bid), 1)))
            w = stub_size(b, steps)
            rects.append((f"A_{i}", f"x_{i}", b.size, b.start, b.end, ("off", i)))
            rects.append((f"H_{i}", f"x_{i}", w, b.start, b.start + 1, ("on", i)))
            rects.append((f"T_{i}", f"xt_{i}", w, b.end - 1, b.end, ("on", i)))
        else:
            rects.append((f"A_{i}", f"x_{i}", b.size, b.start, b.end, None))

    lines = ["\\ DSA MIP with eviction binaries (remat x packing, exact)",
             "Minimize", " obj: u", "Subject To"]

    def gate_terms(gate):
        """LP terms adding M when the rectangle is absent: constraint is
        then vacuously satisfied."""
        if gate is None:
            return "", 0
        kind, i = gate
        # absent <=> e_i = 1 (for "off") or e_i = 0 (for "on")
        if kind == "off":
            return f" - {M} e_{i}", 0          # +M*e_i slack -> move to LHS
        return f" + {M} e_{i}", M              # +M*(1-e_i) slack

    # peak constraints: x + w <= u whenever the rectangle is present
    for name, xv, w, s, e, gate in rects:
        g, const = gate_terms(gate)
        lines.append(f" peak_{name}: {xv} - u{g} <= {const - w}")

    # pairwise no-overlap for co-live present rectangles
    z_vars: list[str] = []
    for a in range(len(rects)):
        for b2 in range(a + 1, len(rects)):
            n1, x1, w1, s1, e1, g1 = rects[a]
            n2, x2, w2, s2, e2, g2 = rects[b2]
            if x1 == x2:                     # same block (A_i vs its H_i)
                continue
            if not (s1 < e2 and s2 < e1):    # no lifetime overlap
                continue
            t1, c1 = gate_terms(g1)
            t2, c2 = gate_terms(g2)
            zv = f"z_{n1}_{n2}"
            z_vars.append(zv)
            lines.append(f" no_ov_a_{n1}_{n2}: {x1} - {x2} - {M} {zv}{t1}{t2}"
                         f" <= {c1 + c2 - w1}")
            lines.append(f" no_ov_b_{n1}_{n2}: {x2} - {x1} + {M} {zv}{t1}{t2}"
                         f" <= {M + c1 + c2 - w2}")

    if max_evict is not None and cand:
        terms = " + ".join(f"e_{index[bid]}" for bid in sorted(cand, key=index.get))
        lines.append(f" evict_budget: {terms} <= {max_evict}")

    lines.append("Bounds")
    lines.append(f" 0 <= u <= {max_memory}")
    for b in bs:
        i = index[b.bid]
        lines.append(f" 0 <= x_{i} <= {max_memory}")
        if b.bid in cand:
            lines.append(f" 0 <= xt_{i} <= {max_memory}")
    lines.append("Generals")
    gen = ["u"] + [f"x_{index[b.bid]}" for b in bs] + \
        [f"xt_{index[b.bid]}" for b in bs if b.bid in cand]
    lines.append(" " + " ".join(gen))
    lines.append("Binaries")
    bins = [f"e_{index[bid]}" for bid in sorted(cand, key=index.get)] + z_vars
    if bins:
        lines.append(" " + " ".join(bins))
    lines.append("End")
    return "\n".join(lines) + "\n"
