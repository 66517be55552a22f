"""Serving driver: the continuous-batching engine on the paged KV-cache
(port of ``repro.launch.serve``).

Runs a model through ``repro_torch.serving.ServeEngine`` over a synthetic
request trace — queue -> chunked prefill -> batched decode -> completion —
and reports throughput, page-pool telemetry, and the arena-vs-pool memory
comparison at full arch scale.  Prefill runs the flash-attention CUDA
kernel (attention layers), the SSD chunk-scan CUDA kernel (mamba2) and the
RG-LRU scan CUDA kernel (recurrentgemma's rec layers); ``--attn paged``
decodes through the paged-attention CUDA kernel and is for pure-attention
models only (not mamba2, recurrentgemma or the MoE decoders, which decode in
gather mode).  Weights are drawn and cast one leaf at a time
(``Transformer.init_loaded``), so recurrentgemma-9b's 9.6B parameters never
exist in f32 all at once.

  PYTHONPATH=src python -m repro_torch.launch.serve --preset full --attn paged
  PYTHONPATH=src python -m repro_torch.launch.serve --arch phi4-mini-3.8b --preset full --attn paged
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-130m --preset full
  PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-9b --preset full
  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-moe-1b-a400m --preset full
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-moe-30b-a3b --preset full

Decode runs through the bucketed ``DecodeRunner``, one CUDA graph per
bucket on the card; ``--no-runner`` decodes every slot each step through
the full-batch "slab" step (one graph per batch shape on the card).
Runs on the card; ``--device cpu`` runs the plain PyTorch versions instead,
eagerly.

``--share-hbm GB``: one budget, two workloads — a fine-tune step of the same
model (a dense or an MoE decoder; the MoE step's loss carries its aux term)
is registered as the training tenant of a ``SharedArena``, the page
pool becomes the serving tenant, and admission is gated against the serving
share of the jointly planned split.  The loop then executes the joint plan:
real fine-tune steps (SGD on a private replica of the weights, through the
plain attention path: no kernel has a backward) run at the valley phases
``SharedPlan.schedule`` picked, interleaved with engine steps in one
process, and both workloads' measured step times are reported.

  PYTHONPATH=src python -m repro_torch.launch.serve --preset full --attn paged --prompt-len 512 --gen-len 64 --max-len 2048 --requests 16 --share-hbm 6 --train-steps 2

``--trace PATH`` writes a Chrome-trace/Perfetto JSON of the run (runtime
events, one span track per request, the ``kv-pool`` plan's rectangles and,
with ``--share-hbm``, the ``joint`` plan's); ``--metrics`` prints the
engine's registry as Prometheus text; ``--slo-ttft/--slo-tpot/--slo-e2e``
(engine steps) print the ``[slo]`` attainment and goodput line.  Every run
prints the ``[drift]`` line: the pool's planned peak against the arena's
observed address peak, fragmentation and replans by cause.

  PYTHONPATH=src python -m repro_torch.launch.serve --preset full --attn paged --trace serve.json --metrics --slo-ttft 4 --slo-tpot 1.5
"""
from __future__ import annotations

import argparse
import random
import time

import torch
from torch.utils._pytree import tree_leaves, tree_map

from ..configs import get_config
from ..core import MemoryPlanner, SharedArena
from ..models import RunOpts, Transformer
from ..obs import (ChromeTraceBuilder, DriftMonitor, SLOEngine, SLOSpec,
                   SpanTracker, Tracer, use_tracer)
from ..runtime import train_lib
from ..runtime.serve_lib import ServingArena, synth_trace
from ..serving import GenRequest, ServeEngine
from . import train as train_launch

# --share-hbm at --preset full: the fine-tune tenant's (seq, batch).  The
# reference's full-size runs have no training shape; B=2, S=512 keeps the
# serving tenant from vanishing beside the training one.  Reduced presets
# take the training driver's (seq, batch).
FULL_FINETUNE_SEQ_BATCH = (512, 2)
# --share-hbm at --preset full: the fine-tune clips its global gradient norm
# to this.  The seeded random weights make an exploding stack at full width
# (qwen2-0.5b's first gradient has an L2 norm near 1.4e15 on the card), so
# unclipped SGD turns the replica to NaN within a few steps; reduced presets
# run unclipped SGD, as the reference does.
FULL_FINETUNE_MAX_GRAD_NORM = 1.0

# Copy of ``repro.launch.train.PRESETS``.
PRESETS = {
    "tiny": dict(d_model=64, vocab=512),
    "20m": dict(d_model=384, vocab=8192),
    "100m": dict(d_model=768, vocab=16384),
}


def reduced_config(arch: str, preset: str):
    """``repro.launch.train.reduced_config``'s model config; ``"full"`` is
    the registered config as is."""
    cfg = get_config(arch)
    if preset == "full":
        return cfg
    p = PRESETS[preset]
    n_pat = len(cfg.block_pattern) or 1
    layers = {"tiny": 2, "20m": 4, "100m": 8}[preset] * n_pat + \
        len(cfg.tail_pattern)
    heads = max(1, min(cfg.n_heads, p["d_model"] // 64))
    kv = max(1, min(cfg.n_kv_heads, heads))
    while heads % kv:
        kv -= 1
    return cfg.with_overrides(
        name=f"{arch}-{preset}", n_layers=layers, d_model=p["d_model"],
        n_heads=heads, n_kv_heads=kv, head_dim=64,
        d_ff=4 * p["d_model"] if not cfg.n_experts else p["d_model"] // 2,
        vocab_size=p["vocab"],
        n_experts=min(cfg.n_experts, 8) if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        lru_width=p["d_model"] if cfg.lru_width else 0,
        ssm_state=min(cfg.ssm_state, 64) if cfg.ssm_state else 0,
        encoder_layers=2 if cfg.encoder_layers else 0,
        encoder_seq=64 if cfg.encoder_seq else 0,
        local_window=min(cfg.local_window, 64) if cfg.local_window else 0,
        dtype="float32",
    )


def finetune_shape(preset: str) -> tuple[int, int]:
    """(seq, batch) of the ``--share-hbm`` fine-tune step at ``preset``."""
    if preset == "full":
        return FULL_FINETUNE_SEQ_BATCH
    p = train_launch.PRESETS[preset]
    return p["seq"], p["batch"]


def finetune_model(model: Transformer) -> Transformer:
    """The fine-tune tenant's model: the same config and device as the served
    ``model``, on the plain attention path (the kernels have no backward)."""
    return Transformer(model.cfg, RunOpts(attention_impl="full",
                                          use_kernels=False),
                       device=model.device)


def make_train_step(ft_model: Transformer, params, seq: int, batch: int,
                    lr: float = 1e-3, seed: int = 0,
                    max_grad_norm: float | None = None):
    """One real SGD fine-tune step on a private replica of ``params`` (the
    training tenant's executable; serving keeps decoding its own weights).
    The replica is a ``detach().clone()`` of the served (loaded) weights on
    their device, so it runs in their dtypes; ``ft_model`` is
    ``finetune_model``'s.  ``max_grad_norm`` scales the gradients down to
    that global L2 norm when they exceed it (None: plain SGD, the
    reference's step).  Returns ``step() -> loss`` (a 0-d tensor), with the
    replica as ``step.replica``."""
    gen = torch.Generator().manual_seed(seed + 7)
    tokens = torch.randint(0, ft_model.cfg.vocab_size, (batch, seq + 1),
                           dtype=torch.int32, generator=gen).to(ft_model.device)
    tbatch = {"tokens": tokens}
    replica = tree_map(lambda t: t.detach().clone(), params)
    leaves = tree_leaves(replica)
    for leaf in leaves:
        leaf.requires_grad_(True)

    def step():
        loss, _ = ft_model.loss_fn(replica, tbatch, remat=False)
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            scale = None
            if max_grad_norm is not None:
                norm = torch.linalg.vector_norm(torch.stack(
                    [torch.linalg.vector_norm(g.float()) for g in grads]))
                scale = (max_grad_norm / (norm + 1e-6)).clamp(max=1.0)
            for p, g in zip(leaves, grads):
                if scale is not None:
                    g = g * scale.to(g.dtype)
                p.sub_(g, alpha=lr)
        return loss.detach()

    step.replica = replica
    return step


def run_interleaved(eng, live, shared, train_step, max_steps: int = 100_000):
    """Execute the joint plan: engine steps with fine-tune steps fired at the
    valley phases the ``SharedArena`` scheduled, all in one process."""
    jp = shared.plan()
    window = max(1, jp.profile.meta.get("window_steps", 1))
    phases = set(jp.schedule.get("training", []))
    pending = sorted(live, key=lambda r: (r.arrival, r.rid))
    train_s, n_train, last_loss = 0.0, 0, None
    while pending or not eng.sched.idle:
        while pending and pending[0].arrival <= eng.step_count:
            eng.enqueue(pending.pop(0))
        eng.step()
        if phases and (eng.step_count - 1) % window in phases:
            t0 = time.perf_counter()
            last_loss = float(train_step())     # syncs: the step is timed whole
            train_s += time.perf_counter() - t0
            n_train += 1
        if eng.step_count >= max_steps:
            raise RuntimeError(f"engine did not drain in {max_steps} steps")
    return eng.metrics.summary(eng.kv.stats()), {
        "n_train_steps": n_train,
        "train_step_ms_mean": 1e3 * train_s / n_train if n_train else None,
        "train_loss": last_loss,
        "window_steps": window,
        "phases": sorted(phases),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--preset", default="tiny", choices=[*PRESETS, "full"],
                    help="reduced model size, or 'full' for the registered "
                         "config (full width and depth, its dtype)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--gen-len", type=int, default=12)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--page-tokens", type=int, default=None,
                    help="page size in tokens (default: profile-guided)")
    ap.add_argument("--policy", choices=["fcfs", "priority"], default="fcfs")
    ap.add_argument("--prefill-chunk", type=int, default=512)
    ap.add_argument("--share-hbm", type=float, default=0.0,
                    help="GiB (2**30 bytes) of one HBM budget shared with a "
                         "concurrent fine-tune tenant (0 = serving owns its "
                         "arena); the fine-tune takes the training driver's "
                         "(seq, batch) at a reduced preset and "
                         f"{FULL_FINETUNE_SEQ_BATCH} at --preset full, where "
                         "it also clips its global gradient norm to "
                         f"{FULL_FINETUNE_MAX_GRAD_NORM}")
    ap.add_argument("--train-steps", type=int, default=4,
                    help="--share-hbm: fine-tune steps per serving round")
    ap.add_argument("--runner", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="decode via the bucketed DecodeRunner (--no-runner: "
                         "the full-batch slab decode step)")
    ap.add_argument("--attn", choices=["gather", "paged"], default="gather",
                    help="decode KV layout: 'gather' copies each slot's "
                         "contiguous cache rows through the runner; 'paged' "
                         "runs the paged-attention kernel straight off the "
                         "page pool")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", default="", metavar="PATH",
                    help="write a Chrome-trace/Perfetto JSON of the run "
                         "(runtime events + per-request span tracks + "
                         "packed-plan rectangles)")
    ap.add_argument("--metrics", action="store_true",
                    help="print the metrics registry as Prometheus text")
    ap.add_argument("--slo-ttft", type=float, default=None, metavar="STEPS",
                    help="TTFT ceiling (engine steps); enables the SLO report")
    ap.add_argument("--slo-tpot", type=float, default=None, metavar="STEPS",
                    help="per-token decode-cadence ceiling (engine steps)")
    ap.add_argument("--slo-e2e", type=float, default=None, metavar="STEPS",
                    help="enqueue->finish ceiling (engine steps)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain "
                         "PyTorch versions of the kernels)")
    args = ap.parse_args(argv)

    cfg = reduced_config(args.arch, args.preset)
    model = Transformer(cfg, RunOpts(attention_impl="kernel"), device=args.device)
    gen = torch.Generator(device=model.device).manual_seed(args.seed)
    params = model.init_loaded(gen)

    # profile run: the sample trace the planner sizes the page pool from
    trace = synth_trace(args.requests, args.prompt_len, args.gen_len,
                        seed=args.seed, jitter=False)

    # full-size arch for the memory accounting; the chosen model executes
    full_cfg = get_config(args.arch)
    cmp = ServingArena(full_cfg, trace).compare_pool()
    print(f"[{args.arch} @ full size] slab baseline for {len(trace)} requests: "
          f"dsa={cmp['dsa_peak'] / 1e9:.2f}GB pool={cmp['pool_peak'] / 1e9:.2f}GB "
          f"naive={cmp['naive_peak'] / 1e9:.2f}GB "
          f"saving_vs_pool={100 * cmp['saving_vs_pool']:.1f}%")

    shared = ft_model = None
    if args.share_hbm > 0:
        # one budget, two workloads: register the fine-tune tenant first so
        # the engine's first joint plan sees both.  The profile is of the
        # step that runs: grad of the loss over the replica's dtypes.
        shared = SharedArena(int(args.share_hbm * 2 ** 30))
        planner = MemoryPlanner()
        seq, batch = finetune_shape(args.preset)
        ft_model = finetune_model(model)
        tprof = train_lib.profile_step(
            ft_model, {"tokens": ((batch, seq + 1), torch.int32)}, loaded=True)
        tview = shared.register_training(
            tprof, steps_per_round=args.train_steps,
            shrink=lambda target: planner.plan_with_remat(
                tprof, target_peak=target).profile)

    eng = ServeEngine(model, params, sample_trace=trace, max_len=args.max_len,
                      max_batch=args.max_batch, page_tokens=args.page_tokens,
                      policy=args.policy, prefill_chunk=args.prefill_chunk,
                      accounting_cfg=full_cfg, shared=shared,
                      use_runner=args.runner, attn_mode=args.attn)
    if args.runner:
        t0 = time.perf_counter()
        eng.warmup()
        print(f"[runner] buckets={list(eng.runner.buckets)} "
              f"graphs={eng.graphs} warmed {eng.runner.n_compiles} "
              f"compiles and prefill rungs {eng.prefill_rungs()} "
              f"({eng.prefill.n_captures} graphs) "
              f"in {time.perf_counter() - t0:.1f}s on {model.device}")
    kv = eng.kv.stats()
    print(f"[paged pool] page_tokens={kv['page_tokens']} "
          f"n_pages={kv['n_pages']} pool={kv['pool_bytes'] / 1e6:.2f}MB "
          f"(planned peak {kv['planned_peak'] / 1e6:.2f}MB)")
    if shared is not None:
        s = shared.stats()
        print(f"[shared arena] budget={s['hbm_budget'] / 1e9:.2f}GB "
              f"joint_peak={s['joint_peak'] / 1e6:.2f}MB "
              f"standalone_sum={s['standalone_sum'] / 1e6:.2f}MB "
              f"win={s['sharing_win'] / 1e6:.2f}MB "
              f"(joint/sum={s['joint_vs_sum']:.2f}) "
              f"train_steps@{s['schedule'].get('training', [])} "
              f"serving_cap={eng.sched.cap} "
              f"train_budget={tview.budget / 1e6:.2f}MB")

    # live traffic: same shapes with jitter, so some requests outgrow the
    # profile and exercise preemption + §4.3 replanning
    rng = random.Random(args.seed + 1)
    live = [GenRequest(rid=r.rid,
                       prompt=torch.randint(
                           0, cfg.vocab_size, (r.prompt_len,), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(r.rid)),
                       gen_len=max(2, r.gen_len + rng.randint(-2, 6)),
                       arrival=r.arrival)
            for r in trace]
    want_slo = any(v is not None
                   for v in (args.slo_ttft, args.slo_tpot, args.slo_e2e))
    tracer = Tracer() if (args.trace or want_slo) else None
    colocated = None
    with use_tracer(tracer):
        if shared is not None:
            # execute the joint plan: fine-tune steps at the valley phases
            train_step = make_train_step(
                ft_model, params, seq, batch, seed=args.seed,
                max_grad_norm=(FULL_FINETUNE_MAX_GRAD_NORM
                               if args.preset == "full" else None))
            summary, colocated = run_interleaved(eng, live, shared, train_step)
        else:
            summary = eng.run(live)
    tracker = None
    if tracer is not None:
        # fold the event stream into per-request spans (queue/prefill/
        # decode/preempted) — the trace export and SLO report read these
        tracker = SpanTracker().feed(tracer.events())
    if args.trace:
        tb = ChromeTraceBuilder()
        tb.add_events(tracer.events())
        tb.add_events(tracker.to_events())
        tb.add_plan("kv-pool", eng.kv.plan.profile)
        if shared is not None:
            jp = shared.plan()
            tb.add_plan("joint", jp.profile, plan=jp.plan)
        tb.write(args.trace)
        print(f"[trace] {len(tracer.events())} events "
              f"(dropped {tracer.n_dropped}), "
              f"{len(tracker.finished())} request spans -> {args.trace}")
    if want_slo:
        slo = SLOEngine(SLOSpec(ttft_steps=args.slo_ttft,
                                tpot_steps=args.slo_tpot,
                                e2e_steps=args.slo_e2e))
        slo.observe_spans(tracker.finished())
        rep = slo.report(n_steps=eng.step_count, wall_s=summary["wall_s"])
        att = rep["attainment"]
        print(f"[slo] attainment={'n/a' if att is None else f'{att:.3f}'} "
              f"({rep['n_met']}/{rep['n_requests']}) "
              f"goodput={rep['goodput_tokens_per_step']:.2f} tok/step "
              f"({rep['goodput_tokens_per_s']:.1f} tok/s) "
              f"ttft_p99={rep['ttft_steps']['p99']} "
              f"e2e_p99={rep['e2e_steps']['p99']}")
    # the observed peak is the logical arena's address peak; the physical
    # page pool is sized by max_batch x max_len, not by the plan
    drift = DriftMonitor(eng.kv.plan.profile)
    drift.observe_arena(eng.kv.arena)
    d = drift.report()
    print(f"[drift] planned={d['planned_peak'] / 1e6:.2f}MB "
          f"observed={d['observed_peak'] / 1e6:.2f}MB "
          f"peak_ratio={d['peak_ratio']:.2f} "
          f"frag={d['fragmentation']:.2f} "
          f"replans={d['n_replans']} causes={d['replan_causes']}")
    if args.metrics:
        print(eng.metrics.registry.to_prometheus_text(), end="")
    if eng.decode_steps:
        mode, compiles = (("runner", eng.runner.n_compiles) if args.runner
                          else ("slab", eng.decode_compiles))
        print(f"[decode:{mode}] steps={eng.decode_steps} "
              f"step_ms={1e3 * eng.decode_time_s / eng.decode_steps:.2f} "
              f"graphs={eng.graphs} compiles={compiles} "
              f"prefill_compiles={eng.prefill_compiles} "
              f"prefill_graphs={eng.prefill.n_captures} "
              f"prefill_ms={1e3 * eng.prefill_time_s / max(1, eng.prefill_calls):.2f}")
    if colocated is not None:
        tms = colocated["train_step_ms_mean"]
        print(f"[colocated] train_steps={colocated['n_train_steps']} "
              f"at phases {colocated['phases']} "
              f"(window={colocated['window_steps']}) "
              f"train_step_ms={'n/a' if tms is None else f'{tms:.1f}'} "
              f"loss={colocated['train_loss']}")
    ttft = summary["ttft_steps_mean"]
    print(f"completed {summary['n_completed']}/{summary['n_requests']} "
          f"requests, {summary['tokens']} tokens in {summary['wall_s']:.1f}s "
          f"({summary['tokens_per_s']:.1f} tok/s), "
          f"ttft_mean={'n/a' if ttft is None else f'{ttft:.1f}'} steps, "
          f"max_concurrent={summary['max_concurrent']}, "
          f"preemptions={summary['n_preemptions']}, "
          f"reopts={summary['kv_n_reopt']}")
    for rid in sorted(eng.completed)[:3]:
        print(f"  req {rid}: {eng.completed[rid][:8]}...")
    if shared is not None:
        jp = shared.plan()
        print(f"[shared arena] boundary_reopts={shared.n_reopt} "
              f"feasible={jp.feasible} "
              f"reserves={{'serving': {jp.reserves['serving'] / 1e6:.1f}MB, "
              f"'training': {jp.reserves['training'] / 1e6:.1f}MB}}")


if __name__ == "__main__":
    main()
