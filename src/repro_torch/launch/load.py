"""Load cells: one seeded ``LoadSpec`` cell served through ``ServeEngine``
with the tracer on, folded into request spans, SLO attainment and the
plan-vs-actual drift report.

Two cells, the H100 counterparts of two of the reference's scenario cells
(``benchmarks/scenarios.py``), at the registered width and a realistic
prompt scale (lognormal prompts of median 256 up to 896 tokens, generations
of median 32 up to 96, ``gen_jitter`` 4):

  * ``qwen2-burst-tight`` — qwen2-0.5b, paged decode, flash prefill; 32
    requests landing in the first three steps, 40% ``interactive``
    (priority 1) and 60% ``batch``, under the ``priority`` policy: a batch
    of jobs arriving at once while interactive users keep sending;
  * ``mamba2-diurnal-tight`` — mamba2-130m, gather decode, the SSD kernel in
    every prefill; 32 requests under tidal (diurnal) arrivals, FCFS.

Both plan their pool from the trace with every generation length halved
(the reference's ``tight_budget``), so live traffic outgrows it: paged KV
pages run out mid-decode (preemption, §4.3 replans), and mamba2's O(1)
state pages can only run out at admission.  The engine's ``prefill_chunk``
stays at its default (512 prompt tokens a step); the reference's quick
cells use 16 for prompts of ~10 tokens.

  PYTHONPATH=src python -m repro_torch.launch.load --cell qwen2-burst-tight --preset full
  PYTHONPATH=src python -m repro_torch.launch.load --cell mamba2-diurnal-tight --preset tiny --device cpu

``--preset tiny`` keeps the registered vocabulary: ``LoadGen.gen_requests``
draws prompt tokens from the same stream as the generation jitter, so the
vocabulary size decides the live generation lengths.  Scheduling never
reads a token's value or a page's byte size, so a tiny model gives the
full-width cell's step clock (spans, percentiles, preemptions) exactly.

Wall-clock latencies come from the spans' ``ts`` and from the first-token
stamp of :class:`FirstTokenMetrics`: the ``prefill`` instant opens a
request's first ``decode`` phase *before* the prefill call, so TTFT in ms
ends at the stamp taken once the prefill's first token is on the host.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import torch

from ..configs import get_config
from ..models import RunOpts, Transformer
from ..obs import (ChromeTraceBuilder, DriftMonitor, SLOEngine, SLOSpec,
                   SpanTracker, StreamingHistogram, Tracer, get_tracer,
                   use_tracer)
from ..runtime.serve_lib import Request
from ..serving import LoadGen, LoadSpec, ServeEngine, ServeMetrics, TrafficClass
from .serve import reduced_config

# max_batch = n_requests, as in the reference's quick cells (8 and 8); its
# full burst-tight cell runs 20 requests at max_batch 8.  The planner's
# profile does not model the admission cap, so at ``--max-batch 8`` the
# 32-request burst runs 8 at a time inside a pool planned for 32 (halved)
# and never touches its edge: at tiny width 189 steps, no preemption, no
# replan, peak_ratio 1.0, against 111 steps, 2 preemptions and 1 replan at 32
MAX_BATCH, MAX_LEN, PAGE_TOKENS, GEN_JITTER = 32, 1024, 8, 4
TRACE_CAPACITY = 262_144            # the reference's scenario cells' tracer
CLASSES = (TrafficClass("interactive", priority=1, weight=0.4),
           TrafficClass("batch", priority=0, weight=0.6))
_LENGTHS = dict(n_requests=32, prompt_mean=256, prompt_sigma=0.6,
                prompt_max=896, gen_mean=32, gen_sigma=0.6, gen_max=96, seed=0)
# ``slo``: ceilings on the engine-step clock per traffic class, chosen from
# the cells' step clock (the same at tiny width on a CPU as at full width),
# where they meet 8/13 interactive, 7/19 batch and 15/32 mamba2 requests:
# neither all nor none
CELLS = {
    "qwen2-burst-tight": dict(
        arch="qwen2-0.5b", attn_mode="paged", policy="priority",
        opts=RunOpts(attention_impl="kernel"),
        spec=LoadSpec(arrival="burst", classes=CLASSES, **_LENGTHS),
        slo={"interactive": dict(ttft_steps=4, tpot_steps=1.0),
             "batch": dict(ttft_steps=12, e2e_steps=48)}),
    "mamba2-diurnal-tight": dict(
        arch="mamba2-130m", attn_mode="gather", policy="fcfs",
        opts=RunOpts(use_kernels=True),
        spec=LoadSpec(arrival="diurnal", mean_interarrival=1.5, **_LENGTHS),
        slo={"default": dict(ttft_steps=2, e2e_steps=40)}),
}


class FirstTokenMetrics(ServeMetrics):
    """``ServeMetrics`` that also stamps each request's first token on the
    active tracer's wall clock (``Tracer.now_us``).  The engine calls
    ``on_first_token`` after the prefill's argmax has reached the host."""

    def __init__(self):
        super().__init__()
        self.first_token_us: dict[int, float] = {}

    def on_first_token(self, rid: int, step: int) -> None:
        t = get_tracer()
        if t is not None and rid not in self.first_token_us:
            self.first_token_us[rid] = t.now_us()
        super().on_first_token(rid, step)


@dataclasses.dataclass
class CellRun:
    """One run of a cell.  The span, SLO, drift and first-token fields are
    filled only when the run was traced; ``trace`` only when exported."""

    summary: dict
    wall_s: float
    tracer: Optional[Tracer] = None
    tracker: Optional[SpanTracker] = None
    slo: Optional[dict] = None
    drift: Optional[dict] = None
    first_token_us: dict = dataclasses.field(default_factory=dict)
    trace: Optional[dict] = None


def cell_config(cell: str, preset: str):
    """The cell's model config: ``full`` is the registered one; ``tiny`` is
    ``launch.serve``'s tiny preset with the registered vocabulary."""
    arch = CELLS[cell]["arch"]
    if preset == "full":
        return get_config(arch)
    return reduced_config(arch, preset).with_overrides(
        vocab_size=get_config(arch).vocab_size)


def traffic(cell: str, vocab_size: int, n_requests: Optional[int] = None):
    """(LoadTrace, halved sample trace the pool is planned from, live
    requests with their numpy int32 prompts)."""
    spec = CELLS[cell]["spec"]
    if n_requests is not None:
        spec = dataclasses.replace(spec, n_requests=n_requests)
    lg = LoadGen(spec)
    lt = lg.trace()
    sample = [Request(rid=r.rid, prompt_len=r.prompt_len,
                      gen_len=max(2, r.gen_len // 2), arrival=r.arrival)
              for r in lt.requests]
    return lt, sample, lg.gen_requests(vocab_size, gen_jitter=GEN_JITTER, trace=lt)


def make_engine(model: Transformer, params, cell: str, sample, *,
                graphs: Optional[bool] = None,
                max_batch: int = MAX_BATCH) -> ServeEngine:
    c = CELLS[cell]
    return ServeEngine(model, params, sample_trace=sample, max_len=MAX_LEN,
                       max_batch=max_batch, page_tokens=PAGE_TOKENS,
                       policy=c["policy"], attn_mode=c["attn_mode"],
                       graphs=graphs, metrics=FirstTokenMetrics())


def drive(eng: ServeEngine, live, *, traced: bool = True):
    """Run ``live`` to completion; returns (summary, tracer or None)."""
    tracer = Tracer(capacity=TRACE_CAPACITY) if traced else None
    with use_tracer(tracer):
        summary = eng.run(live)
    return summary, tracer


def run_cell(eng: ServeEngine, cell: str, lt, live, *, traced: bool = True,
             trace_path: str = "") -> CellRun:
    """Drive ``live`` through a warmed ``make_engine`` engine; when traced,
    fold the events into spans, the cell's SLO report and the drift report,
    and write the Perfetto JSON to ``trace_path`` if one is given."""
    t0 = time.perf_counter()
    summary, tracer = drive(eng, live, traced=traced)
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    run = CellRun(summary=summary, wall_s=time.perf_counter() - t0)
    if tracer is None:
        return run
    run.tracer = tracer
    run.tracker = SpanTracker().feed(tracer.events())
    slo = SLOEngine([SLOSpec(name=n, **c) for n, c in CELLS[cell]["slo"].items()])
    slo.observe_spans(run.tracker.finished(), classes=lt.class_of)
    run.slo = slo.report(n_steps=eng.step_count, wall_s=run.wall_s)
    run.drift = drift_report(eng)
    run.first_token_us = dict(eng.metrics.first_token_us)
    if trace_path:
        run.trace = export(eng, tracer, run.tracker, trace_path)
    return run


def step_spans(tracker: SpanTracker) -> dict:
    """Each finished request's step-clock signature: its phases (kind, start
    and end step, replan cause) and token count — what must not depend on
    timing, CUDA graphs or the tracer."""
    return {s.rid: (tuple((p.kind, p.start_step, p.end_step, p.cause)
                          for p in s.phases), s.n_tokens)
            for s in tracker.finished()}


def drift_report(eng: ServeEngine) -> dict:
    """The pool plan against the logical arena's observed address peak."""
    drift = DriftMonitor(eng.kv.plan.profile)
    drift.observe_arena(eng.kv.arena)
    return drift.report()


def export(eng: ServeEngine, tracer: Tracer, tracker: SpanTracker,
           path: str) -> dict:
    """Runtime events, request span tracks and the ``kv-pool`` plan."""
    tb = ChromeTraceBuilder()
    tb.add_events(tracer.events())
    tb.add_events(tracker.to_events())
    tb.add_plan("kv-pool", eng.kv.plan.profile)
    return tb.write(path)


def ttft_ms(run: CellRun) -> str:
    """p50/p99 of a traced run's TTFT in ms: enqueue to the first token on
    the host."""
    return pcts((run.first_token_us[s.rid] - s.enqueue_ts) / 1e3
                for s in run.tracker.finished())


def pcts(values) -> str:
    """p50/p99 of ``values`` from the estimator of the SLO report's step
    percentiles."""
    h = StreamingHistogram(min_value=1e-3)
    for v in values:
        h.observe(v)
    return f"p50 {h.quantile(0.5):.4g} p99 {h.quantile(0.99):.4g}"


def report(run: CellRun, tag: str, suffix: str = "") -> None:
    """Print a traced run's latencies (steps, and ms with TTFT ending at the
    first token), SLO attainment and goodput per class, preemptions, stall
    steps by replan cause and the drift report."""
    spans = run.tracker.finished()
    first = {s.rid: run.first_token_us[s.rid] for s in spans}
    rep = run.slo

    def steps(metric):
        return f"p50 {rep[metric]['p50']:.4g} p99 {rep[metric]['p99']:.4g}"
    print(f"[load:{tag}] TTFT steps {steps('ttft_steps')}, ms "
          f"{ttft_ms(run)}; TPOT steps "
          f"{steps('tpot_steps')}, ms {pcts((s.finish_ts - first[s.rid]) / 1e3 / max(1, s.n_tokens - 1) for s in spans)}; "
          f"E2E steps {steps('e2e_steps')}, ms "
          f"{pcts((s.finish_ts - s.enqueue_ts) / 1e3 for s in spans)}{suffix}", flush=True)
    for name, row in rep["classes"].items():
        print(f"[load:{tag}] slo {name} {row['spec']}: attainment {row['n_met']}/"
              f"{row['n_requests']}, goodput {row['goodput_tokens']} of {row['tokens']} "
              f"tokens = {row['goodput_tokens'] / rep['n_steps']:.4f} tok/step, "
              f"{row['goodput_tokens'] / rep['wall_s']:.1f} tok/s{suffix}", flush=True)
    print(f"[load:{tag}] slo all: attainment {rep['attainment']:.4f}, goodput "
          f"{rep['goodput_tokens_per_step']:.4f} tok/step {rep['goodput_tokens_per_s']:.1f} "
          f"tok/s of {rep['tokens_per_step']:.4f} tok/step {rep['tokens_per_s']:.1f} tok/s"
          f"{suffix}", flush=True)
    s, d = run.summary, run.drift
    print(f"[load:{tag}] completed={s['n_completed']} preemptions={s['n_preemptions']} "
          f"reopts={s['kv_n_reopt']} max_concurrent={s['max_concurrent']}; conservation_violations={run.tracker.conservation_violations()}"
          f"; stalls by cause {run.tracker.attribution()}", flush=True)
    print(f"[load:{tag}] drift planned_peak={d['planned_peak']} observed_peak="
          f"{d['observed_peak']} peak_ratio={d['peak_ratio']:.4f} fragmentation="
          f"{d['fragmentation']:.4f} drift_ratio_mean={d['drift_ratio_mean']:.4f} "
          f"replans={d['replan_causes']}", flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", choices=sorted(CELLS), default="qwen2-burst-tight")
    ap.add_argument("--preset", choices=["tiny", "full"], default="full")
    ap.add_argument("--max-batch", type=int, default=MAX_BATCH,
                    help="the engine's admission cap (8 is the reference's "
                         "full burst-tight cell's)")
    ap.add_argument("--trace", default="", metavar="PATH",
                    help="write the run's Chrome-trace/Perfetto JSON")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain "
                         "PyTorch versions of the kernels)")
    args = ap.parse_args(argv)

    cfg = cell_config(args.cell, args.preset)
    model = Transformer(cfg, CELLS[args.cell]["opts"], device=args.device)
    params = model.init_loaded(torch.Generator(device=model.device).manual_seed(0))
    lt, sample, live = traffic(args.cell, cfg.vocab_size)
    eng = make_engine(model, params, args.cell, sample, max_batch=args.max_batch)
    eng.warmup()
    run = run_cell(eng, args.cell, lt, live, trace_path=args.trace)
    print(f"[load:{args.cell}] {cfg.name} on {model.device}: {len(live)} requests, "
          f"arrivals {[r.arrival for r in live]}, max_batch {args.max_batch}, "
          f"steps={eng.step_count}, pool "
          f"n_pages={eng.kv.stats()['n_pages']}, wall {run.wall_s:.3f}s, "
          f"prefill_compiles={eng.prefill_compiles} "
          f"prefill_graphs={eng.prefill.n_captures} prefill_ms="
          f"{1e3 * eng.prefill_time_s / max(1, eng.prefill_calls):.2f}")
    report(run, args.cell)
    if args.trace:
        print(f"[trace] {len(run.tracer.events())} events "
              f"(dropped {run.tracer.n_dropped}) -> {args.trace}")


if __name__ == "__main__":
    main()
