"""Where a serving decode step's time goes: ``torch.profiler`` over a steady
window of engine steps with every request already decoding.

  PYTHONPATH=src python -m repro_torch.launch.profile_serve --preset full

Prints the host time per step, the device time the profiler attributes to
kernels per step, their ratio (the device's busy share), and the kernels
with the most device time.  Runs on the card; ``--device cpu`` runs the
plain versions and shows host time only.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..models import RunOpts, Transformer
from ..runtime.serve_lib import Request
from ..serving import GenRequest, ServeEngine
from .serve import PRESETS, reduced_config


def _device_us(evt) -> float:
    return getattr(evt, "self_device_time_total",
                   getattr(evt, "self_cuda_time_total", 0.0))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--preset", default="full", choices=[*PRESETS, "full"])
    ap.add_argument("--batch", type=int, default=8,
                    help="requests decoding together (= max_batch)")
    ap.add_argument("--prompt-len", type=int, default=256)
    ap.add_argument("--max-len", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)

    cfg = reduced_config(args.arch, args.preset)
    model = Transformer(cfg, RunOpts(attention_impl="kernel"), device=args.device)
    params = model.load(model.init(
        torch.Generator(device=model.device).manual_seed(0)))
    gen_len = 3 * args.steps + 8
    # all requests arrive together, so the planned pool holds them at once
    trace = [Request(rid=i + 1, prompt_len=args.prompt_len, gen_len=gen_len,
                     arrival=0) for i in range(args.batch)]
    eng = ServeEngine(model, params, sample_trace=trace, max_len=args.max_len,
                      max_batch=args.batch, attn_mode="paged")
    eng.warmup()
    g = torch.Generator().manual_seed(1)
    for r in trace:
        eng.enqueue(GenRequest(rid=r.rid, prompt=torch.randint(
            0, cfg.vocab_size, (r.prompt_len,), generator=g,
            dtype=torch.int32), gen_len=gen_len))
    while len(eng.sched.running()) < args.batch:     # admit + prefill all
        if eng.step_count > args.batch + 4:
            raise RuntimeError("requests did not all reach decode")
        eng.step()
    for _ in range(2):
        eng.step()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if model.device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            eng.step()
        if model.device.type == "cuda":
            torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / args.steps
    # kernel records only: an op's own row repeats its kernels' time
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(_device_us(e) for e in kernels) / 1e3 / args.steps
    print(f"[profile] {cfg.name} batch={args.batch} prompt={args.prompt_len} "
          f"steps={args.steps} on {model.device}: host step_ms={wall_ms:.3f} "
          f"device_ms_per_step={dev_ms:.3f} busy_share={dev_ms / wall_ms:.3f}")
    for e in sorted(kernels, key=_device_us, reverse=True)[:10]:
        print(f"[profile]   {_device_us(e) / 1e3 / args.steps:8.4f} ms/step "
              f"x{e.count // args.steps:<4d} {e.key[:90]}")


if __name__ == "__main__":
    main()
