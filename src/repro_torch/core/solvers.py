"""External MILP solver backend for DSA (optional ``[solver]`` extra; copy
of ``repro.core.solvers``).

``core/mip.py`` *exports* the exact formulations (CPLEX LP text) for offline
solving; this module *solves* them in-process through
``scipy.optimize.milp`` (HiGHS), when scipy is installed via the ``[solver]``
extra.  Three models, all import-guarded so the core package keeps zero
dependencies beyond torch/numpy:

  * ``solve_milp``      — addresses only: the paper's eqs. (1)-(6), binaries
    per colliding pair.  Registered as ``MemoryPlanner(solver="milp")``.
  * ``solve_joint``     — joint lifetime+address (the OLLA model): integer op
    positions under recovered precedence plus a 4-way disjunction (before /
    after in time, below / above in address) per block pair.  Ground truth
    for what ``core.reorder`` approximates.
  * ``solve_eviction_milp`` — ``mip.to_lp_eviction`` solved in-process:
    eviction binaries gate full-rectangle vs head/tail-stub presence, giving
    the joint pack-AND-evict optimum the greedy search is measured against.

Offsets are recovered integrally: the MILP's binary decisions orient every
co-live pair (who sits below whom), and a longest-path pass over that DAG
left-justifies the offsets — so plans validate exactly even when the LP
relaxation leaves fractional ``x``.  ``exact.solve_exact`` remains the
dependency-free small-instance ground truth; the MILP path extends exactness
to mid-size instances (hundreds of pair binaries instead of an exponential
subset walk).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from itertools import combinations
from typing import Optional, Sequence

import time as _time

from .bestfit import best_fit
from .dsa import AllocationPlan, validate_plan
from .events import MemoryProfile
from .reorder import PrecedenceGraph, apply_order

try:                                    # the [solver] extra (scipy/HiGHS)
    from scipy.optimize import Bounds, LinearConstraint, milp  # type: ignore
    from scipy.sparse import csr_matrix  # type: ignore
    _HAVE = True
except Exception:                       # pragma: no cover - env without scipy
    _HAVE = False


class SolverUnavailable(RuntimeError):
    """Raised when a MILP entry point runs without the ``[solver]`` extra."""


def have_solver() -> bool:
    """True when scipy's HiGHS MILP backend is importable."""
    return _HAVE


def _require() -> None:
    if not _HAVE:
        raise SolverUnavailable(
            "scipy is not installed; install the [solver] extra "
            "(pip install -e '.[solver]') to use the MILP backend")


def _solve(c, rows, lbs, ubs, integrality, var_lo, var_hi, time_limit_s):
    """Thin wrapper over scipy.optimize.milp with sparse row constraints."""
    import numpy as np
    n = len(c)
    data, indices, indptr = [], [], [0]
    for row in rows:
        # HiGHS rejects duplicate column entries in a row ("Model error"):
        # coalesce coefficients per column and keep indices sorted.
        acc: dict[int, float] = {}
        for j, a in row:
            acc[j] = acc.get(j, 0.0) + a
        for j in sorted(acc):
            indices.append(j)
            data.append(acc[j])
        indptr.append(len(indices))
    A = csr_matrix((data, indices, indptr), shape=(len(rows), n))
    res = milp(
        c=np.asarray(c, dtype=float),
        constraints=LinearConstraint(A, np.asarray(lbs, dtype=float),
                                     np.asarray(ubs, dtype=float)),
        integrality=np.asarray(integrality),
        bounds=Bounds(np.asarray(var_lo, dtype=float),
                      np.asarray(var_hi, dtype=float)),
        options={"time_limit": float(time_limit_s)},
    )
    return res


def _offsets_longest_path(blocks, below_pairs):
    """Left-justified integral offsets from a pairwise below/above orientation.

    ``below_pairs``: (i, j) index pairs meaning block i sits entirely below
    block j (x_i + w_i <= x_j).  The orientation comes from a feasible MILP
    solution, so the implied digraph is acyclic (the fractional ``x`` is a
    potential); longest path left-justifies without losing feasibility.
    """
    n = len(blocks)
    adj = [[] for _ in range(n)]
    indeg = [0] * n
    for i, j in below_pairs:
        adj[i].append(j)
        indeg[j] += 1
    x = [0] * n
    queue = [i for i in range(n) if indeg[i] == 0]
    seen = 0
    while queue:
        i = queue.pop()
        seen += 1
        top = x[i] + blocks[i].size
        for j in adj[i]:
            if top > x[j]:
                x[j] = top
            indeg[j] -= 1
            if indeg[j] == 0:
                queue.append(j)
    if seen != n:
        raise ValueError("cyclic below/above orientation (infeasible MILP?)")
    return x


# ---------------------------------------------------------------------------
# model 1: addresses only (eqs. 1-6)
# ---------------------------------------------------------------------------


def solve_milp(profile: MemoryProfile, *, max_memory: Optional[int] = None,
               time_limit_s: float = 30.0) -> AllocationPlan:
    """Solve the paper's DSA MIP in-process; mid-size exact ground truth.

    Variables: u, x_i (continuous), one binary z per colliding pair.  The
    big-M is the best-fit peak (a valid upper bound on the optimum, so it
    tightens the relaxation for free).  Integral offsets are recovered by
    longest path over the z orientation.
    """
    _require()
    t_begin = _time.perf_counter()
    bs = [b for b in profile.blocks if b.size > 0]
    zero_offsets = {b.bid: 0 for b in profile.blocks if b.size == 0}
    incumbent = best_fit(profile)
    if not bs:
        return AllocationPlan(offsets=zero_offsets, peak=0, solver="milp",
                              proven_optimal=True)
    W = int(max_memory) if max_memory is not None else int(incumbent.peak)
    pairs = [(i, j) for i, j in
             MemoryProfile(blocks=bs).colliding_pairs()]

    # layout: [u, x_0..x_{n-1}, z_0..z_{m-1}]
    n = len(bs)
    m = len(pairs)
    nv = 1 + n + m
    c = [0.0] * nv
    c[0] = 1.0
    integrality = [0] * (1 + n) + [1] * m
    var_lo = [0.0] * nv
    var_hi = [float(W)] * (1 + n) + [1.0] * m
    for k, b in enumerate(bs):
        var_hi[1 + k] = float(W - b.size)

    rows, lbs, ubs = [], [], []
    NEG = float("-inf")
    # Valid cut: u >= liveness lower bound.  The big-M disjunctions have a
    # weak LP relaxation; this closes the root gap whenever the heuristic
    # incumbent already sits on the bound.
    lb = profile.liveness_lower_bound()
    rows.append([(0, 1.0)])
    lbs.append(float(lb))
    ubs.append(float("inf"))
    for k, b in enumerate(bs):           # (2) x_i + w_i - u <= 0
        rows.append([(1 + k, 1.0), (0, -1.0)])
        lbs.append(NEG)
        ubs.append(float(-b.size))
    for e, (i, j) in enumerate(pairs):
        wi, wj = bs[i].size, bs[j].size
        # (3) x_i + w_i <= x_j + W z   ->  x_i - x_j - W z <= -w_i
        rows.append([(1 + i, 1.0), (1 + j, -1.0), (1 + n + e, -float(W))])
        lbs.append(NEG)
        ubs.append(float(-wi))
        # (4) x_j + w_j <= x_i + W(1-z) -> x_j - x_i + W z <= W - w_j
        rows.append([(1 + j, 1.0), (1 + i, -1.0), (1 + n + e, float(W))])
        lbs.append(NEG)
        ubs.append(float(W - wj))

    res = _solve(c, rows, lbs, ubs, integrality, var_lo, var_hi, time_limit_s)
    if res.x is None:
        # infeasible-within-W or timed out with no incumbent: fall back
        plan = AllocationPlan(offsets=dict(incumbent.offsets),
                              peak=incumbent.peak, solver="milp",
                              proven_optimal=False,
                              stats={"status": int(res.status),
                                     "fallback": "bestfit"})
        return plan

    below = []
    for e, (i, j) in enumerate(pairs):
        if res.x[1 + n + e] < 0.5:
            below.append((i, j))
        else:
            below.append((j, i))
    xs = _offsets_longest_path(bs, below)
    offsets = {b.bid: xs[k] for k, b in enumerate(bs)}
    offsets.update(zero_offsets)
    peak = max(xs[k] + bs[k].size for k in range(n))
    plan = AllocationPlan(
        offsets=offsets, peak=peak, solver="milp",
        proven_optimal=(res.status == 0) or peak == lb,
        stats={"seconds": _time.perf_counter() - t_begin,
               "status": int(res.status), "objective": float(res.fun),
               "mip_gap": float(getattr(res, "mip_gap", 0.0) or 0.0),
               "n_pairs": m, "bestfit_peak": incumbent.peak},
    )
    validate_plan(profile, plan)
    return plan


# ---------------------------------------------------------------------------
# model 2: joint lifetime + address (the OLLA model)
# ---------------------------------------------------------------------------


@dataclass
class JointResult:
    """Optimal (schedule, placement) pair from the joint MILP."""

    profile: MemoryProfile              # reordered lifetimes
    plan: AllocationPlan                # placement for the reordered profile
    order: list[int]                    # op permutation (indices into graph)
    identity_peak: int                  # best-fit peak on the original order
    graph: PrecedenceGraph
    proven_optimal: bool = False
    stats: dict = field(default_factory=dict)

    @property
    def peak(self) -> int:
        return self.plan.peak


def solve_joint(profile: MemoryProfile, *, max_memory: Optional[int] = None,
                time_limit_s: float = 60.0) -> JointResult:
    """Jointly optimize op schedule (within precedence) and addresses.

    Integer position vars s_o per op with s_u + 1 <= s_v along every
    recovered precedence edge; per block pair, four binaries (i-before-j,
    j-before-i in time; i-below-j, j-below-i in address) of which at least
    one must hold.  Small instances only (4 binaries per pair) — this is the
    ground truth the greedy+ILS reorder pass is measured against.
    """
    _require()
    t_begin = _time.perf_counter()
    graph = PrecedenceGraph.from_profile(profile)
    incumbent = best_fit(profile)
    bs = [b for b in profile.blocks if b.size > 0]
    zero_offsets = {b.bid: 0 for b in profile.blocks if b.size == 0}
    n, n_ops = len(bs), graph.n_ops
    if not bs or n_ops <= 1:
        return JointResult(profile=profile, plan=incumbent,
                           order=list(range(n_ops)),
                           identity_peak=incumbent.peak, graph=graph,
                           proven_optimal=True)
    W = int(max_memory) if max_memory is not None else int(incumbent.peak)
    Mt = float(n_ops)

    # layout: [u, x_0.., s_0.., then per pair (a, b, l, r)]
    pairs = list(combinations(range(n), 2))
    off_x = 1
    off_s = 1 + n
    off_p = 1 + n + n_ops
    nv = off_p + 4 * len(pairs)
    c = [0.0] * nv
    c[0] = 1.0
    integrality = [0] * (1 + n) + [1] * (n_ops + 4 * len(pairs))
    var_lo = [0.0] * nv
    var_hi = ([float(W)] + [float(W - b.size) for b in bs]
              + [float(n_ops - 1)] * n_ops + [1.0] * (4 * len(pairs)))

    rows, lbs, ubs = [], [], []
    NEG = float("-inf")
    for k, b in enumerate(bs):           # peak
        rows.append([(off_x + k, 1.0), (0, -1.0)])
        lbs.append(NEG)
        ubs.append(float(-b.size))
    for u, v in graph.edges:             # precedence: s_u - s_v <= -1
        rows.append([(off_s + u, 1.0), (off_s + v, -1.0)])
        lbs.append(NEG)
        ubs.append(-1.0)
    for e, (i, j) in enumerate(pairs):
        bi, bj = bs[i], bs[j]
        ei, si = graph.end_op[bi.bid], graph.start_op[bi.bid]
        ej, sj = graph.end_op[bj.bid], graph.start_op[bj.bid]
        va, vb, vl, vr = (off_p + 4 * e + t for t in range(4))
        # a: i ends before j starts  (s_ei + 1 <= s_sj when a=1)
        rows.append([(off_s + ei, 1.0), (off_s + sj, -1.0), (va, Mt)])
        lbs.append(NEG)
        ubs.append(Mt - 1.0)
        # b: j ends before i starts
        rows.append([(off_s + ej, 1.0), (off_s + si, -1.0), (vb, Mt)])
        lbs.append(NEG)
        ubs.append(Mt - 1.0)
        # l: i below j in address
        rows.append([(off_x + i, 1.0), (off_x + j, -1.0), (vl, float(W))])
        lbs.append(NEG)
        ubs.append(float(W - bi.size))
        # r: j below i
        rows.append([(off_x + j, 1.0), (off_x + i, -1.0), (vr, float(W))])
        lbs.append(NEG)
        ubs.append(float(W - bj.size))
        # coverage: a + b + l + r >= 1
        rows.append([(va, 1.0), (vb, 1.0), (vl, 1.0), (vr, 1.0)])
        lbs.append(1.0)
        ubs.append(float("inf"))

    res = _solve(c, rows, lbs, ubs, integrality, var_lo, var_hi, time_limit_s)
    if res.x is None:
        return JointResult(profile=profile, plan=incumbent,
                           order=list(range(n_ops)),
                           identity_peak=incumbent.peak, graph=graph,
                           proven_optimal=False,
                           stats={"status": int(res.status),
                                  "fallback": "bestfit"})

    s_vals = [res.x[off_s + o] for o in range(n_ops)]
    order = sorted(range(n_ops), key=lambda o: (s_vals[o], o))
    assert graph.check_order(order), "MILP schedule violates precedence"
    new_prof = apply_order(profile, graph, order)

    # Orient co-live pairs of the *reordered* profile from the l/r binaries.
    by_bid = {b.bid: k for k, b in enumerate(bs)}
    new_by_bid = {b.bid: b for b in new_prof.blocks}
    below = []
    for e, (i, j) in enumerate(pairs):
        ni, nj = new_by_bid[bs[i].bid], new_by_bid[bs[j].bid]
        if not ni.overlaps(nj):
            continue
        vl, vr = off_p + 4 * e + 2, off_p + 4 * e + 3
        if res.x[vl] > 0.5:
            below.append((i, j))
        else:
            below.append((j, i))
    xs = _offsets_longest_path(bs, below)
    offsets = {b.bid: xs[by_bid[b.bid]] for b in bs}
    offsets.update(zero_offsets)
    peak = max(xs[k] + bs[k].size for k in range(n))
    plan = AllocationPlan(
        offsets=offsets, peak=peak, solver="milp-joint",
        proven_optimal=(res.status == 0),
        stats={"seconds": _time.perf_counter() - t_begin,
               "status": int(res.status), "objective": float(res.fun),
               "n_pairs": len(pairs), "n_ops": n_ops},
    )
    validate_plan(new_prof, plan)
    return JointResult(profile=new_prof, plan=plan, order=order,
                       identity_peak=incumbent.peak, graph=graph,
                       proven_optimal=(res.status == 0), stats=plan.stats)


# ---------------------------------------------------------------------------
# model 3: eviction binaries (mip.to_lp_eviction, solved in-process)
# ---------------------------------------------------------------------------


def solve_eviction_milp(profile: MemoryProfile,
                        candidate_bids: Optional[Sequence[int]] = None, *,
                        max_evict: Optional[int] = None,
                        max_candidates: int = 8,
                        max_memory: Optional[int] = None,
                        time_limit_s: float = 60.0) -> dict:
    """Joint pack-AND-evict optimum via MILP (mirrors ``mip.to_lp_eviction``).

    Decides *which* candidates to evict and the packed peak in one model,
    then re-solves the residual DSA for the chosen subset so the returned
    plan is integral and validated.  Mirrors ``mip.exact_eviction_peak``'s
    return shape; unlike the subset walk it scales past ~10 candidates.
    """
    _require()
    from .evict import evict_block, stub_size
    from .mip import eviction_candidates

    t_begin = _time.perf_counter()
    if candidate_bids is None:
        candidate_bids = eviction_candidates(profile, max_candidates)
    candidate_bids = list(candidate_bids)
    cand = set(candidate_bids)
    block_steps = profile.meta.get("block_steps", {})
    bs = [b for b in profile.blocks if b.size > 0]
    index = {b.bid: i for i, b in enumerate(bs)}
    incumbent = best_fit(profile)
    W = int(max_memory) if max_memory is not None else int(incumbent.peak)
    M = float(W)

    # rectangles: (offset_var_key, width, start, end, gate)
    #   gate None = always present; ("off", i) = present iff e_i = 0;
    #   ("on", i) = present iff e_i = 1.  offset_var_key: ("x", i) / ("xt", i)
    rects = []
    for b in bs:
        i = index[b.bid]
        if b.bid in cand:
            steps = int(block_steps.get(b.bid, block_steps.get(str(b.bid), 1)))
            w = stub_size(b, steps)
            rects.append((("x", i), b.size, b.start, b.end, ("off", i)))
            rects.append((("x", i), w, b.start, b.start + 1, ("on", i)))
            rects.append((("xt", i), w, b.end - 1, b.end, ("on", i)))
        else:
            rects.append((("x", i), b.size, b.start, b.end, None))

    # layout: [u, x_0.., xt_(cand).., e_(cand).., z_pairs..]
    n = len(bs)
    cand_idx = sorted(index[bid] for bid in cand)
    xt_pos = {i: k for k, i in enumerate(cand_idx)}
    off_x = 1
    off_xt = 1 + n
    off_e = off_xt + len(cand_idx)
    colive = []
    for a in range(len(rects)):
        for b2 in range(a + 1, len(rects)):
            k1, w1, s1, e1, g1 = rects[a]
            k2, w2, s2, e2, g2 = rects[b2]
            if k1 == k2:                 # A_i vs its own head stub H_i
                continue
            if s1 < e2 and s2 < e1:
                colive.append((a, b2))
    off_z = off_e + len(cand_idx)
    nv = off_z + len(colive)
    c = [0.0] * nv
    c[0] = 1.0
    integrality = [0] * off_e + [1] * (len(cand_idx) + len(colive))
    var_lo = [0.0] * nv
    var_hi = [float(W)] * off_e + [1.0] * (len(cand_idx) + len(colive))

    def var_of(key):
        kind, i = key
        return off_x + i if kind == "x" else off_xt + xt_pos[i]

    def gate_coeff(gate):
        """(var, coeff, const) adding M slack when the rectangle is absent."""
        if gate is None:
            return None
        kind, i = gate
        if kind == "off":                # absent <=> e_i = 1
            return (off_e + xt_pos[i], -M, 0.0)
        return (off_e + xt_pos[i], M, M)  # absent <=> e_i = 0

    rows, lbs, ubs = [], [], []
    NEG = float("-inf")
    for key, w, s, e, gate in rects:     # peak when present
        row = [(var_of(key), 1.0), (0, -1.0)]
        rhs = float(-w)
        g = gate_coeff(gate)
        if g is not None:
            row.append((g[0], g[1]))
            rhs += g[2]
        rows.append(row)
        lbs.append(NEG)
        ubs.append(rhs)
    for zk, (a, b2) in enumerate(colive):
        k1, w1, s1, e1, g1 = rects[a]
        k2, w2, s2, e2, g2 = rects[b2]
        extra = []
        rhs_extra = 0.0
        for g in (gate_coeff(g1), gate_coeff(g2)):
            if g is not None:
                extra.append((g[0], g[1]))
                rhs_extra += g[2]
        # rect1 below rect2 when z=0
        rows.append([(var_of(k1), 1.0), (var_of(k2), -1.0),
                     (off_z + zk, -M)] + extra)
        lbs.append(NEG)
        ubs.append(rhs_extra - w1)
        # rect2 below rect1 when z=1
        rows.append([(var_of(k2), 1.0), (var_of(k1), -1.0),
                     (off_z + zk, M)] + extra)
        lbs.append(NEG)
        ubs.append(M + rhs_extra - w2)
    if max_evict is not None and cand_idx:
        rows.append([(off_e + xt_pos[i], 1.0) for i in cand_idx])
        lbs.append(0.0)
        ubs.append(float(max_evict))

    res = _solve(c, rows, lbs, ubs, integrality, var_lo, var_hi, time_limit_s)
    if res.x is None:
        return {"peak": incumbent.peak, "evicted": (), "plan": incumbent,
                "profile": profile, "proven_optimal": False,
                "candidates": tuple(candidate_bids),
                "stats": {"status": int(res.status), "fallback": "bestfit"}}

    evicted = tuple(bs[i].bid for i in cand_idx
                    if res.x[off_e + xt_pos[i]] > 0.5)
    # Re-solve the residual DSA for the chosen subset -> integral plan.
    blocks = {b.bid: b for b in profile.blocks}
    nb = max(blocks, default=0) + 1
    for bid in evicted:
        steps = int(block_steps.get(bid, block_steps.get(str(bid), 1)))
        stubs = evict_block(blocks[bid], nb, steps)
        del blocks[bid]
        for s in stubs:
            blocks[s.bid] = s
        nb += 1
    prof = MemoryProfile(blocks=list(blocks.values()),
                         retained_bytes=profile.retained_bytes,
                         clock_end=profile.clock_end, meta=profile.meta)
    plan = solve_milp(prof, max_memory=W, time_limit_s=time_limit_s)
    return {"peak": plan.peak, "evicted": evicted, "plan": plan,
            "profile": prof, "proven_optimal":
                (res.status == 0) and plan.proven_optimal,
            "candidates": tuple(candidate_bids),
            "stats": {"seconds": _time.perf_counter() - t_begin,
                      "status": int(res.status),
                      "objective": float(res.fun),
                      "n_rects": len(rects), "n_pairs": len(colive)}}
