"""Serving driver: the continuous-batching engine on the paged KV-cache
(port of ``repro.launch.serve``).

Runs a model through ``repro_torch.serving.ServeEngine`` over a synthetic
request trace — queue -> chunked prefill -> batched decode -> completion —
and reports throughput, page-pool telemetry, and the arena-vs-pool memory
comparison at full arch scale.  Prefill runs the flash-attention CUDA
kernel (attention layers), the SSD chunk-scan CUDA kernel (mamba2) and the
RG-LRU scan CUDA kernel (recurrentgemma's rec layers); ``--attn paged``
decodes through the paged-attention CUDA kernel and is for pure-attention
models only.  Weights are drawn and cast one leaf at a time
(``Transformer.init_loaded``), so recurrentgemma-9b's 9.6B parameters never
exist in f32 all at once.

  PYTHONPATH=src python -m repro_torch.launch.serve --preset full --attn paged
  PYTHONPATH=src python -m repro_torch.launch.serve --arch phi4-mini-3.8b --preset full --attn paged
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-130m --preset full
  PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-9b --preset full

Decode runs through the bucketed ``DecodeRunner``, one CUDA graph per
bucket on the card; ``--no-runner`` decodes every slot each step through
the full-batch "slab" step (one graph per batch shape on the card).
Runs on the card; ``--device cpu`` runs the plain PyTorch versions instead,
eagerly.
``--share-hbm``, ``--trace`` and the ``--slo-*`` reports of the reference
driver are not ported yet.
"""
from __future__ import annotations

import argparse
import random
import time

import torch

from ..configs import get_config
from ..models import RunOpts, Transformer
from ..runtime.serve_lib import ServingArena, synth_trace
from ..serving import GenRequest, ServeEngine

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

    eng = ServeEngine(model, params, sample_trace=trace, max_len=args.max_len,
                      max_batch=args.max_batch, page_tokens=args.page_tokens,
                      policy=args.policy, prefill_chunk=args.prefill_chunk,
                      accounting_cfg=full_cfg, use_runner=args.runner,
                      attn_mode=args.attn)
    if args.runner:
        t0 = time.perf_counter()
        eng.warmup()
        print(f"[runner] buckets={list(eng.runner.buckets)} "
              f"graphs={eng.graphs} warmed {eng.runner.n_compiles} "
              f"compiles in {time.perf_counter() - t0:.1f}s on {model.device}")
    kv = eng.kv.stats()
    print(f"[paged pool] page_tokens={kv['page_tokens']} "
          f"n_pages={kv['n_pages']} pool={kv['pool_bytes'] / 1e6:.2f}MB "
          f"(planned peak {kv['planned_peak'] / 1e6:.2f}MB)")

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
    summary = eng.run(live)
    if eng.decode_steps:
        mode, compiles = (("runner", eng.runner.n_compiles) if args.runner
                          else ("slab", eng.decode_compiles))
        print(f"[decode:{mode}] steps={eng.decode_steps} "
              f"step_ms={1e3 * eng.decode_time_s / eng.decode_steps:.2f} "
              f"graphs={eng.graphs} compiles={compiles} "
              f"prefill_compiles={eng.prefill_compiles} "
              f"prefill_ms={1e3 * eng.prefill_time_s / max(1, eng.prefill_calls):.2f}")
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


if __name__ == "__main__":
    main()
