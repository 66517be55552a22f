"""The paper's experiment on its own nets (the port's counterpart of
``examples/profile_and_pack.py`` and of ``benchmarks/bench_memory.py``'s
paper rows): profile -> best-fit pack -> against the pool and naive
allocators -> the largest batch each fits -> train on the card -> export
the MIP.

CNNs (paper-alexnet, paper-resnet50, paper-inception-resnet):
  1. a ``make_fx`` profile of the SGD train step on fake tensors at
     ``--batch``, and of the inference forward at B=1;
  2. the Fig. 2 row of each: blocks, naive / pool / DSA peaks, the saving
     against the pool, retained bytes, DSA over the liveness lower bound;
  3. the largest batch naive, pool and DSA each fit in ``--hbm-gb``
     (retained + peak) over profiles scaled from two traced batches, the
     DSA boundary b checked against traces at b and b + 1;
  4. ``--steps`` SGD steps (``sgd_lr``: the reference's 0.01, 1e-6 for
     Inception-ResNet) from seeded inputs: step ms, and on
     the card ``max_memory_allocated`` / ``max_memory_reserved`` (the
     caching allocator, a real pool) beside retained + DSA and retained +
     pool;
  5. ``--lp PATH``: the MIP (eqs. 1-6) as LP text (``to_lp``).

seq2seq (paper-seq2seq): one train-step profile per ``--lengths`` bucket
(the reference's "profiles re-traced per length bucket"), then ``--steps``
SGD steps over a seeded order of those lengths, each length's profile
replayed through one ``ArenaAllocator(mode="signature")`` before its step:
the arena replans at a length it has not seen and stops replanning once
every length has been (paper §4.3); ``n_reopt`` and ``plans_cached`` per
step; then greedy inference of ``infer_len`` tokens at B=1, timed.

Runs on the card unless ``--device cpu``; raises without one otherwise.

  PYTHONPATH=src python -m repro_torch.launch.paper --arch paper-resnet50 \\
      --batch 32 --steps 3
  PYTHONPATH=src python -m repro_torch.launch.paper --arch paper-seq2seq \\
      --lengths 10,30,50 --batch 64 --steps 8
  PYTHONPATH=src python -m repro_torch.launch.paper --arch paper-alexnet \\
      --device cpu --preset tiny --lp /tmp/alexnet.lp
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import random
import statistics
import time
from typing import Callable

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._pytree import tree_leaves

from ..configs.paper_native import CNNS, SEQ2SEQ
from ..core import (ArenaAllocator, MemoryPlanner, MemoryProfile,
                    NaiveAllocator, PoolAllocator, align, profile_fn, replay, to_lp)
from ..core.events import DEFAULT_ALIGNMENT as ALIGN
from ..core.planner import HBM_BYTES
from ..models import cnn, seq2seq
from ..runtime.device import resolve_device

ARCHS = (*CNNS, SEQ2SEQ.name)
# --preset tiny: the CPU tests' sizes (two stages, the second widening inside
# a stage; an odd image; a short vocabulary)
TINY_CNN = dict(stages=((1, 8), (2, 16)), classes=10, img=17)
TINY_S2S = dict(vocab=64, d_model=16, layers=2, max_len=7, infer_len=5)
LR = 0.01                              # the reference's SGD rate
# Inception-ResNet's random-init logits (~900 at 64 and at 299 pixels) make
# its loss diverge to NaN within 3 steps at 0.01 and at 1e-4; it falls at 1e-6
ARCH_LR = {"paper-inception-resnet": 1e-6}


def sgd_lr(cfg) -> float:
    """The SGD rate a CNN trains at: ``ARCH_LR``'s, else the reference's."""
    return ARCH_LR.get(cfg.name, LR)


def config(arch: str, preset: str = "full"):
    """The registered ``CNNConfig`` / ``Seq2SeqConfig``, or its tiny cut."""
    if arch == SEQ2SEQ.name:
        return SEQ2SEQ if preset == "full" else dataclasses.replace(SEQ2SEQ, **TINY_S2S)
    cfg = CNNS[arch]
    if preset == "full":
        return cfg
    return dataclasses.replace(cfg, fc=32 if cfg.fc else 0, **TINY_CNN)


# -- profiles -------------------------------------------------------------------------
# Traced with alignment 1 (each block's exact bytes, affine in the batch for
# these nets) and memoized, since a run asks for one batch's several times;
# ``cnn_profile`` / ``s2s_profile`` round them up to the planners' alignment.
@functools.lru_cache(maxsize=16)
def _cnn_trace(cfg, batch: int, device, train: bool) -> MemoryProfile:
    mode = FakeTensorMode()
    with mode:
        params = cnn.init_cnn(cfg, torch.Generator(device=device))
        x = torch.empty((batch, 3, cfg.img, cfg.img), device=device)
        labels = torch.empty((batch,), dtype=torch.int32, device=device)
    if not train:
        return profile_fn(lambda p, a: cnn.cnn_forward(p, a, cfg), params, x, alignment=1)
    for p in params.values():
        p.requires_grad_()
    return profile_fn(cnn.train_step_fn(cfg, sgd_lr(cfg)), params, x, labels, alignment=1)


@functools.lru_cache(maxsize=16)
def _s2s_trace(cfg, batch: int, length: int, device, train: bool) -> MemoryProfile:
    mode = FakeTensorMode()
    with mode:
        params = seq2seq.init_seq2seq(cfg, torch.Generator(device=device))
        src = torch.empty((batch, length), dtype=torch.int32, device=device)
    if not train:
        return profile_fn(seq2seq.infer_fn(cfg), params, src, alignment=1)
    for p in tree_leaves(params):
        p.requires_grad_()
    return profile_fn(seq2seq.train_step_fn(cfg), params, src, src.clone(),
                      alignment=1)


def aligned(prof: MemoryProfile) -> MemoryProfile:
    """``prof`` with every block rounded up to ``DEFAULT_ALIGNMENT``."""
    return MemoryProfile(blocks=[dataclasses.replace(b, size=align(b.size, ALIGN))
                                 for b in prof.blocks],
                         retained_bytes=prof.retained_bytes, clock_end=prof.clock_end,
                         meta=prof.meta)


def cnn_profile(cfg, batch: int, device, train: bool = True) -> MemoryProfile:
    """``make_fx`` profile of the SGD train step (``train``) or of the
    inference forward at ``batch`` images, on fake tensors on ``device``:
    nothing is allocated.  Labels are int32, as the reference's."""
    return aligned(_cnn_trace(cfg, batch, torch.device(device), train))


def s2s_profile(cfg, batch: int, length: int, device, train: bool = True) -> MemoryProfile:
    """``make_fx`` profile of the seq2seq SGD train step over (batch,
    length) source and target ids, or (``train=False``) of greedy
    inference of ``cfg.infer_len`` tokens from a (batch, length) source."""
    return aligned(_s2s_trace(cfg, batch, length, torch.device(device), train))


def row(prof: MemoryProfile) -> dict:
    """The Fig. 2 row (``bench_memory._row``'s columns) of one profile."""
    rep = MemoryPlanner().report(prof)
    pool, dsa = rep.baselines["pool_peak"], rep.plan.peak
    return {"blocks": prof.n, "naive": rep.baselines["naive_peak"], "pool": pool,
            "dsa": dsa, "saving_vs_pool": 1.0 - dsa / pool if pool else 0.0,
            "retained": prof.retained_bytes, "gap_ratio": rep.quality["gap_ratio"]}


def format_row(r: dict) -> str:
    return (f"blocks={r['blocks']} naive={r['naive'] / 1e6:.1f}MB "
            f"pool={r['pool'] / 1e6:.1f}MB DSA={r['dsa'] / 1e6:.1f}MB "
            f"saving_vs_pool={100 * r['saving_vs_pool']:.2f}% "
            f"retained={r['retained'] / 1e6:.1f}MB gap_ratio={r['gap_ratio']:.3f}")


PEAKS: dict[str, Callable[[MemoryProfile], int]] = {
    "naive": lambda p: replay(p, NaiveAllocator())["peak"],
    "pool": lambda p: replay(p, PoolAllocator())["peak"],
    "dsa": lambda p: MemoryPlanner().plan(p).peak,
}


def scaled_profile(lo: MemoryProfile, b_lo: int, hi: MemoryProfile, b_hi: int,
                   b: int) -> MemoryProfile:
    """The profile at batch ``b`` from two traced at ``b_lo`` < ``b_hi``
    with alignment 1: these nets' graphs do not change with the batch and
    each buffer is batch-shaped or parameter-shaped, so every block keeps
    its lifetime and its exact size lies on the line through its two traced
    sizes; the result is rounded up to the alignment, as a trace at ``b``
    would be.  Raises ``ValueError`` if the two traces' blocks differ in
    anything but size."""
    if [(x.start, x.end, x.tag) for x in lo.blocks] != \
            [(y.start, y.end, y.tag) for y in hi.blocks]:
        raise ValueError("scaled_profile: the two traces' blocks differ")

    def at(s_lo, s_hi):
        return s_lo + -(-(s_hi - s_lo) * (b - b_lo) // (b_hi - b_lo))
    blocks = [dataclasses.replace(x, size=at(x.size, y.size))
              for x, y in zip(lo.blocks, hi.blocks)]
    return aligned(MemoryProfile(blocks=blocks,
                                 retained_bytes=at(lo.retained_bytes, hi.retained_bytes),
                                 clock_end=lo.clock_end, meta=lo.meta))


def max_batches(trace_at: Callable[[int], MemoryProfile], budget: int, b_lo: int) -> dict:
    """The largest batch each allocator (naive, pool, DSA) fits in
    ``budget`` bytes, retained bytes included, over profiles scaled from
    the traces (alignment 1) at ``b_lo`` and ``2 b_lo``
    (``scaled_profile``), by ``MemoryPlanner.max_feasible_batch`` from a
    guess on the line through those two batches' bytes.  The DSA boundary b
    is then traced at b and b + 1: each trace must equal its scaled profile
    block for block (so DSA's bytes there are the ones the search saw), or
    ``AssertionError``."""
    lo, hi = trace_at(b_lo), trace_at(2 * b_lo)
    scaled = functools.lru_cache(None)(
        lambda b: scaled_profile(lo, b_lo, hi, 2 * b_lo, b))
    planner, out = MemoryPlanner(), {}
    for name, peak in PEAKS.items():
        bytes_at = functools.lru_cache(None)(lambda b: scaled(b).retained_bytes
                                             + peak(scaled(b)))
        at_lo = bytes_at(b_lo)
        slope = max(1, (bytes_at(2 * b_lo) - at_lo) // b_lo)
        out[name] = planner.max_feasible_batch(
            bytes_at, budget, guess=b_lo + (budget - at_lo) // slope)
    for b in (out["dsa"], out["dsa"] + 1):
        if b < 1:
            continue
        traced, want = aligned(trace_at(b)), scaled(b)
        if (traced.blocks != want.blocks or traced.retained_bytes != want.retained_bytes):
            raise AssertionError(f"max_batches: the trace at B={b} differs from the "
                                 f"profile scaled from B={b_lo} and {2 * b_lo}")
    return out


# -- inputs ---------------------------------------------------------------------------
def cnn_batch(cfg, batch: int, seed: int, device):
    """Seeded images (N(0, 1), NCHW) and int32 labels, made on ``device``."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((batch, 3, cfg.img, cfg.img), generator=g, device=device)
    labels = torch.randint(0, cfg.classes, (batch,), generator=g, device=device,
                           dtype=torch.int32)
    return x, labels


def s2s_batch(cfg, batch: int, length: int, seed: int, device):
    """Seeded int32 source and target ids (batch, length) on ``device``."""
    g = torch.Generator(device=device).manual_seed(seed)
    return tuple(torch.randint(0, cfg.vocab, (batch, length), generator=g, device=device,
                               dtype=torch.int32) for _ in range(2))


def requiring_grad(params):
    """``params`` with every leaf set to require grad (SGD's inputs)."""
    for p in tree_leaves(params):
        p.requires_grad_()
    return params


# -- measured steps -------------------------------------------------------------------
def _synced_ms(device, fn):
    """(result, host ms) of ``fn()``, the device synchronised at both ends."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, 1e3 * (time.perf_counter() - t0)


def _peaks(device) -> dict:
    """Allocated and reserved peaks since the last reset, on the card."""
    if device.type != "cuda":
        return {}
    return {"allocated": torch.cuda.max_memory_allocated(device),
            "reserved": torch.cuda.max_memory_reserved(device)}


def _reset_peaks(device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def train_cnn(cfg, params: dict, batch: int, steps: int, seed: int, device) -> dict:
    """``steps`` SGD steps at ``sgd_lr(cfg)`` from ``params`` (leaves
    requiring grad) over seeded batches ``seed``, ``seed + 1``, ...: per
    step its loss, host ms and the card's allocated / reserved peaks (each
    batch made before the
    peaks are reset, so a peak holds one batch, the parameters and the
    step, as the profile's retained bytes and blocks do), then the first
    batch's loss under the trained parameters."""
    step = cnn.train_step_fn(cfg, sgd_lr(cfg))
    out = {"loss": [], "ms": [], "peaks": []}
    for i in range(steps):
        x, labels = cnn_batch(cfg, batch, seed + i, device)
        _reset_peaks(device)
        (loss, params), ms = _synced_ms(device, lambda: step(params, x, labels))
        out["loss"].append(float(loss))
        out["ms"].append(ms)
        out["peaks"].append(_peaks(device))
        del x, labels
    x, labels = cnn_batch(cfg, batch, seed, device)
    with torch.no_grad():
        out["first_batch_loss_after"] = float(cnn.cnn_loss(params, x, labels, cfg))
    out["params"] = params
    return out


def infer_cnn(cfg, params: dict, seed: int, device) -> dict:
    """One B=1 forward, timed, with its peaks (the caching allocator's
    unused segments released first, so its reserved peak is the forward's)."""
    x, _ = cnn_batch(cfg, 1, seed, device)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    _reset_peaks(device)
    with torch.no_grad():
        logits, ms = _synced_ms(device, lambda: cnn.cnn_forward(params, x, cfg))
    return {"ms": ms, "peaks": _peaks(device), "finite": bool(torch.isfinite(logits).all())}


def replay_arena(arena: ArenaAllocator, prof: MemoryProfile) -> None:
    """Drive ``prof``'s alloc/free stream through ``arena`` (allocations in
    block order, as a propagation requests them)."""
    events = sorted([(b.start, 0, b.bid, b.size) for b in prof.blocks]
                    + [(b.end, 1, b.bid, b.size) for b in prof.blocks])
    addr = {}
    for _, kind, bid, size in events:
        if kind == 0:
            addr[bid] = arena.alloc(size)
        else:
            arena.free(addr.pop(bid))


def length_order(lengths, steps: int, seed: int) -> list:
    """A seeded order of ``steps`` lengths: every length once, shuffled,
    then seeded draws."""
    rng = random.Random(seed)
    order = rng.sample(list(lengths), len(lengths))
    return (order + [rng.choice(lengths) for _ in range(steps - len(order))])[:steps]


# -- the two runs ---------------------------------------------------------------------
def run_cnn(cfg, *, batch: int, steps: int, device, seed: int = 0,
            budget: int = HBM_BYTES, lp: str = "", log=print) -> dict:
    """Steps 1-5 of the module docstring for one CNN; returns the rows, the largest batches, the steps and the inference
    run."""
    tag = f"[paper:{cfg.name.removeprefix('paper-')}]"
    t0 = time.perf_counter()
    train_row = row(cnn_profile(cfg, batch, device))
    infer_prof = cnn_profile(cfg, 1, device, train=False)
    infer_row = row(infer_prof)
    log(f"{tag} train B={batch} img={cfg.img}: {format_row(train_row)}")
    log(f"{tag} infer B=1: {format_row(infer_row)} "
        f"(profiles in {time.perf_counter() - t0:.1f}s)")
    t0 = time.perf_counter()
    fits = max_batches(lambda b: _cnn_trace(cfg, b, device, True), budget, batch)
    log(f"{tag} max batch in {budget / 1e9:.1f}GB: naive={fits['naive']} "
        f"pool={fits['pool']} DSA={fits['dsa']} (profiles scaled from B={batch} and "
        f"{2 * batch}, DSA's traced at {fits['dsa']} and {fits['dsa'] + 1}, "
        f"{time.perf_counter() - t0:.1f}s)")
    if lp:
        text = to_lp(cnn_profile(cfg, batch, device), max_memory=train_row["naive"])
        with open(lp, "w") as f:
            f.write(text)
        log(f"{tag} MIP (eqs. 1-6) written to {lp} "
            f"({text.count(chr(10))} lines)")
    # the steps own the only reference to each step's parameters
    trained = train_cnn(cfg, requiring_grad(cnn.init_cnn(
        cfg, torch.Generator(device=device).manual_seed(seed))), batch, steps, seed + 1,
        device)
    infer = infer_cnn(cfg, trained.pop("params"), seed + 1, device)
    plan = {"dsa": train_row["retained"] + train_row["dsa"],
            "pool": train_row["retained"] + train_row["pool"]}
    log(f"{tag} train B={batch} lr {sgd_lr(cfg):g}: losses "
        f"{[round(x, 5) for x in trained['loss']]} step-1 batch after "
        f"{trained['first_batch_loss_after']:.5f}; step_ms "
        f"{[round(x, 1) for x in trained['ms']]} median "
        f"{statistics.median(trained['ms']):.1f}; " + _vs_plan(trained["peaks"], plan))
    log(f"{tag} infer B=1: {infer['ms']:.2f}ms; " + _vs_plan(
        [infer["peaks"]], {"dsa": infer_row["retained"] + infer_row["dsa"],
                           "pool": infer_row["retained"] + infer_row["pool"]}))
    return {"train": train_row, "infer": infer_row, "max_batch": fits,
            "steps": trained, "inference": infer, "plan": plan}


def _vs_plan(peaks: list, plan: dict) -> str:
    """Measured peaks (max over ``peaks``) against retained + DSA and
    retained + pool."""
    text = (f"plan retained+DSA={plan['dsa'] / 1e9:.3f}GB "
            f"retained+pool={plan['pool'] / 1e9:.3f}GB")
    if not peaks or not peaks[0]:
        return text + " (measured peaks: card only)"
    alloc = max(p["allocated"] for p in peaks)
    resv = max(p["reserved"] for p in peaks)
    return (text + f" measured allocated={alloc / 1e9:.3f}GB "
            f"({alloc / plan['dsa']:.3f}x DSA) reserved={resv / 1e9:.3f}GB "
            f"({resv / plan['dsa']:.3f}x DSA, {resv / plan['pool']:.3f}x pool)")


def run_seq2seq(cfg, *, batch: int, lengths, steps: int, device, seed: int = 0,
                budget: int = HBM_BYTES, log=print) -> dict:
    """The seq2seq run of the module docstring; returns the per-length rows,
    the largest batches at the longest length, the per-step records and the
    inference run."""
    tag = "[paper:seq2seq]"
    rows, profs = {}, {}
    for length in lengths:
        t0 = time.perf_counter()
        profs[length] = s2s_profile(cfg, batch, length, device)
        t1 = time.perf_counter()
        rows[length] = row(profs[length])
        log(f"{tag} train B={batch} L={length}: {format_row(rows[length])} "
            f"(profile {t1 - t0:.1f}s, plan {time.perf_counter() - t1:.1f}s)")
    longest = max(lengths)
    infer_row = row(s2s_profile(cfg, 1, longest, device, train=False))
    log(f"{tag} infer B=1 L={longest} -> {cfg.infer_len} tokens: "
        f"{format_row(infer_row)}")
    t0 = time.perf_counter()
    fits = max_batches(lambda b: _s2s_trace(cfg, b, longest, device, True), budget, batch)
    log(f"{tag} max batch at L={longest} in {budget / 1e9:.1f}GB: "
        f"naive={fits['naive']} pool={fits['pool']} DSA={fits['dsa']} (profiles "
        f"scaled from B={batch} and {2 * batch}, DSA's traced at {fits['dsa']} and "
        f"{fits['dsa'] + 1}, {time.perf_counter() - t0:.1f}s)")

    order = length_order(lengths, steps, seed)
    arena = ArenaAllocator(profs[order[0]], mode="signature")
    step = seq2seq.train_step_fn(cfg)
    params = requiring_grad(seq2seq.init_seq2seq(
        cfg, torch.Generator(device=device).manual_seed(seed)))
    records = []
    for i, length in enumerate(order):
        t0 = time.perf_counter()
        arena.reset_iteration(hint=length)
        replay_arena(arena, profs[length])
        replay_s = time.perf_counter() - t0
        src, tgt = s2s_batch(cfg, batch, length, seed + 1 + i, device)
        _reset_peaks(device)
        (loss, params), ms = _synced_ms(device, lambda: step(params, src, tgt))
        s = arena.stats()
        rec = {"length": length, "loss": float(loss), "ms": ms, "peaks": _peaks(device),
               "plan_peak": s["peak"], "overflow_peak": s["overflow_peak"],
               "n_reopt": s["n_reopt"], "plans_cached": s["plans_cached"],
               "replay_s": replay_s}
        records.append(rec)
        plan = {"dsa": rows[length]["retained"] + rows[length]["dsa"],
                "pool": rows[length]["retained"] + rows[length]["pool"]}
        log(f"{tag} step {i + 1} L={length} loss={rec['loss']:.5f} "
            f"{ms:.1f}ms arena plan={s['peak'] / 1e6:.1f}MB "
            f"overflow={s['overflow_peak'] / 1e6:.1f}MB n_reopt={s['n_reopt']} "
            f"plans_cached={s['plans_cached']} (replay {replay_s:.2f}s); "
            + _vs_plan([rec["peaks"]], plan))
    src, _ = s2s_batch(cfg, 1, longest, seed, device)
    tokens, ms = _synced_ms(device, lambda: seq2seq.infer_fn(cfg)(params, src))
    log(f"{tag} infer B=1 L={longest}: {cfg.infer_len} greedy tokens "
        f"in {ms:.1f}ms")
    return {"rows": rows, "infer": infer_row, "max_batch": fits, "steps": records,
            "tokens": tokens, "infer_ms": ms, "params": params}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="paper-alexnet", choices=ARCHS)
    ap.add_argument("--preset", default="full", choices=["full", "tiny"],
                    help="the registered config, or the tests' tiny cut")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--lengths", default="10,30,50",
                    help="seq2seq: comma-separated length buckets")
    ap.add_argument("--hbm-gb", type=float, default=HBM_BYTES / 1e9,
                    help="budget of the max-batch search, GB (1e9 bytes)")
    ap.add_argument("--lp", default="", metavar="PATH", help="write the MIP as LP text")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; no silent fallback")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = config(args.arch, args.preset)
    budget = int(args.hbm_gb * 1e9)
    if args.arch == SEQ2SEQ.name:
        lengths = [int(x) for x in args.lengths.split(",")]
        return run_seq2seq(cfg, batch=args.batch, lengths=lengths, steps=args.steps,
                           device=device, seed=args.seed, budget=budget)
    return run_cnn(cfg, batch=args.batch, steps=args.steps, device=device,
                   seed=args.seed, budget=budget, lp=args.lp)


if __name__ == "__main__":
    main()
