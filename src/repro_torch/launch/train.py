"""Training driver (port of ``repro.launch.train``).

Config registry, synthetic pipeline, AdamW, async checkpointing, fault
injection (--fail-at) with restart, straggler monitoring, and the paper's
memory planner: a ``make_fx`` profile of the step packed by best fit, and the
profile-guided remat policy.  Runs on the card unless ``--device cpu``.
``--trace PATH`` writes a Chrome-trace/Perfetto JSON of the planning phase:
the remat search's and the shared arena's events, the packed
``activations`` plan and, with ``--share-hbm``, the ``joint`` plan.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --preset tiny --steps 20
  PYTHONPATH=src python -m repro_torch.launch.train --preset 100m --steps 300 \\
      --ckpt-dir ckpt --fail-at 150 --resume
  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-moe-1b-a400m \\
      --preset 100m --steps 50 --remat planned
  PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-small \\
      --device cpu --preset tiny --steps 4   # also mamba2-130m, recurrentgemma-9b

Every registered decoder config trains; an encoder-decoder's batches carry
the pipeline's seeded frames (B, encoder_seq, d_model) beside the tokens.
Attention takes ``RunOpts(attention_impl="auto")``: full up to 8192 tokens,
the chunked scan past them.  The paper's own nets (``paper-cnn``,
``paper-rnn`` families) train through ``launch/paper.py``; this CLI
refuses them.
"""
from __future__ import annotations

import argparse
import tempfile
import time

import torch
from torch.utils._pytree import tree_leaves

from ..checkpoint import Checkpointer
from ..configs import get_config
from ..core import MemoryPlanner, SharedArena
from ..data import DataConfig, SyntheticPipeline
from ..models import RunOpts, Transformer
from ..obs import ChromeTraceBuilder, MetricsRegistry, Tracer
from ..obs import disable as trace_disable
from ..obs import enable as trace_enable
from ..optim.adamw import AdamWConfig
from ..runtime import train_lib
from ..runtime.fault import SimulatedFailure, StragglerMonitor, TrainController

PRESETS = {
    # name: (layer_scale, d_model, vocab, seq, batch)
    "tiny": dict(d_model=64, vocab=512, seq=32, batch=4),
    "20m": dict(d_model=384, vocab=8192, seq=64, batch=4),
    "100m": dict(d_model=768, vocab=16384, seq=128, batch=4),
}


def reduced_config(arch: str, preset: str):
    cfg = get_config(arch)
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
    ), p["seq"], p["batch"]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--preset", default="tiny", choices=sorted(PRESETS))
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="",
                    help="checkpoint directory (default: a temporary one, "
                         "removed at exit)")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--fail-at", type=int, default=-1,
                    help="inject a simulated host failure at this step")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="full",
                    choices=["none", "full", "planned"],
                    help="activation policy: keep all / recompute all / "
                         "profile-guided eviction selection (full by default: "
                         "on qwen2-0.5b B=8 S=512 planned is slower and larger "
                         "than full, PERF.md section 5)")
    ap.add_argument("--remat-target", type=float, default=0.5,
                    help="planned mode: target packed-peak ratio vs no-remat")
    ap.add_argument("--share-hbm", type=float, default=0.0,
                    help="GiB (2**30 bytes) of one HBM budget shared with a "
                         "concurrent serving tenant (0 = training owns its "
                         "arena); the remat target becomes the training "
                         "share of the jointly planned split")
    ap.add_argument("--share-requests", type=int, default=16,
                    help="--share-hbm: size of the serving peer's profiled "
                         "request trace")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--trace", default="", metavar="PATH",
                    help="write a Chrome-trace/Perfetto JSON of the planning "
                         "phase (remat search rounds, shared-arena events) "
                         "plus the packed activation plan")
    ap.add_argument("--metrics", action="store_true",
                    help="print planner metrics as Prometheus text")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; no silent fallback")
    args = ap.parse_args(argv)

    tracer = Tracer() if args.trace else None
    if tracer is not None:
        trace_enable(tracer)

    if get_config(args.arch).family.startswith("paper-"):   # paper-cnn, paper-rnn
        raise SystemExit(f"launch.train: {args.arch} is one of the paper's own nets; "
                         "train and profile it with python -m repro_torch.launch.paper")
    cfg, seq, batch = reduced_config(args.arch, args.preset)
    # "auto": full attention up to 8192 tokens, the chunked scan past them
    model = Transformer(cfg, RunOpts(attention_impl="auto", use_kernels=False),
                        device=args.device)
    acfg = AdamWConfig(lr=args.lr, warmup_steps=max(2, args.steps // 20),
                       total_steps=args.steps)

    # paper's planner: activation plan for this exact step, and the
    # profile-guided remat policy that replaces the boolean flag
    batch_sds = train_lib.batch_specs(cfg, batch, seq, torch.float32)  # the pipeline's frames
    enc = cfg.is_encoder_decoder
    prof = train_lib.profile_step(model, batch_sds, grad=False)
    rep = MemoryPlanner().report(prof)
    print(f"memory plan: peak={rep.plan.peak / 1e6:.1f}MB "
          f"pool={rep.baselines['pool_peak'] / 1e6:.1f}MB "
          f"saving={100 * rep.baselines['saving_vs_pool']:.1f}% "
          f"retained={prof.retained_bytes / 1e6:.1f}MB")

    tview = None
    if args.share_hbm > 0:
        # one budget, two workloads: a serving peer (paged staircases at
        # full arch scale) shares the HBM budget with this fine-tune
        from ..runtime.serve_lib import synth_trace
        from ..serving.pages import plan_pool
        pool_plan = plan_pool(get_config(args.arch),
                              synth_trace(args.share_requests, 64, 96,
                                          seed=args.seed, jitter=False),
                              page_tokens=32)
        shared = SharedArena(int(args.share_hbm * 2 ** 30))
        shared.register_serving(pool_plan.profile)
        tview = shared.register_training(prof, steps_per_round=1)
        s = shared.stats()
        print(f"shared arena: budget={s['hbm_budget'] / 1e9:.2f}GB "
              f"joint_peak={s['joint_peak'] / 1e6:.1f}MB "
              f"win={s['sharing_win'] / 1e6:.1f}MB "
              f"(joint/sum={s['joint_vs_sum']:.2f}) "
              f"train_budget={tview.budget / 1e6:.1f}MB")

    if args.remat == "planned":
        remat, ev = train_lib.plan_remat_policy(model, batch_sds,
                                                target_ratio=args.remat_target,
                                                shared=tview)
        s = ev.summary()
        print(f"remat plan: {remat.describe()} evicted={s['n_evicted']} "
              f"peak {s['baseline_peak'] / 1e6:.1f}->{s['peak'] / 1e6:.1f}MB "
              f"(-{100 * s['saving']:.1f}%) overhead={s['overhead_s'] * 1e3:.3f}ms")
        if tview is not None:
            print(f"shared arena after remat: reserves="
                  f"{ {k: round(v / 1e6, 1) for k, v in tview.shared.plan().reserves.items()} }MB "
                  f"feasible={tview.shared.plan().feasible}")
    else:
        remat = args.remat == "full"

    topts = train_lib.TrainOpts(microbatches=args.microbatches, remat=remat,
                                compress_grads=args.compress_grads)
    gen = torch.Generator(device=model.device).manual_seed(args.seed)
    state = train_lib.init_state(model, gen, acfg, topts)
    n_params = sum(x.numel() for x in tree_leaves(state["params"]))
    print(f"arch={cfg.name} params={n_params / 1e6:.1f}M seq={seq} "
          f"batch={batch} steps={args.steps} device={model.device}")

    step_fn, _ = train_lib.build_train_step(model, None, acfg, topts)
    pipe = SyntheticPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                        global_batch=batch, seed=args.seed,
                                        frames=cfg.encoder_seq if enc else 0,
                                        frame_dim=cfg.d_model if enc else 0))
    with tempfile.TemporaryDirectory(prefix="repro_torch_ckpt_") as tmp:
        ckpt = Checkpointer(args.ckpt_dir or tmp)
        ctl = TrainController(
            step_fn=step_fn, state=state, pipeline=pipe, ckpt=ckpt,
            ckpt_every=args.ckpt_every,
            to_device=lambda b: {k: torch.from_numpy(v).to(model.device)
                                 for k, v in b.items()})
        mon = StragglerMonitor(n_hosts=1)

        if args.resume:
            restored = ctl.resume()
            print(f"resumed from step {restored}")

        t_start = time.time()
        remaining = args.steps - ctl.step
        try:
            t0 = time.time()
            while ctl.step < args.steps:
                s0 = time.time()
                ctl.run(1, fail_at=args.fail_at if args.fail_at >= 0 else None)
                mon.record(0, time.time() - s0)
                if ctl.step % args.log_every == 0:
                    print(f"step {ctl.step:5d} loss={ctl.losses[-1]:.4f} "
                          f"({(time.time() - t0) / args.log_every:.2f}s/step)")
                    t0 = time.time()
        except SimulatedFailure as e:
            print(f"FAILURE: {e}; restarting from checkpoint...")
            restored = ctl.resume()
            print(f"restored step {restored}; replaying deterministically")
            while ctl.step < args.steps:
                ctl.run(1)
                if ctl.step % args.log_every == 0:
                    print(f"step {ctl.step:5d} loss={ctl.losses[-1]:.4f}")
        ctl.ckpt.save(ctl.step, ctl.state, blocking=True)
        dt = time.time() - t_start
        print(f"done: {remaining} steps in {dt:.1f}s "
              f"final_loss={ctl.losses[-1]:.4f} stragglers={mon.stragglers()}")

    if tracer is not None:
        trace_disable()
        tb = ChromeTraceBuilder()
        tb.add_events(tracer.events())
        tb.add_plan("activations", prof, plan=rep.plan)
        if tview is not None:
            jp = tview.shared.plan()
            tb.add_plan("joint", jp.profile, plan=jp.plan)
        tb.write(args.trace)
        print(f"[trace] {len(tracer.events())} events "
              f"(dropped {tracer.n_dropped}) -> {args.trace}")
    if args.metrics:
        reg = MetricsRegistry()
        reg.gauge("train_plan_peak_bytes",
                  "DSA-packed activation peak").set(rep.plan.peak)
        reg.gauge("train_pool_peak_bytes",
                  "pool-allocator baseline peak").set(rep.baselines["pool_peak"])
        reg.gauge("train_retained_bytes",
                  "params+batch held across the step").set(
                      prof.retained_bytes)
        reg.counter("train_steps_total", "steps run").set(args.steps)
        if args.remat == "planned":
            s = ev.summary()
            reg.gauge("train_remat_peak_bytes",
                      "packed peak after planned evictions").set(s["peak"])
            reg.counter("train_remat_evictions_total",
                        "blocks evicted by the search").set(s["n_evicted"])
        print(reg.to_prometheus_text(), end="")


if __name__ == "__main__":
    main()
