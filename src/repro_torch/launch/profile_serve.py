"""Where a serving decode step's time goes: ``torch.profiler`` over a steady
window of engine steps with every request already decoding.

  PYTHONPATH=src python -m repro_torch.launch.profile_serve --preset full
  PYTHONPATH=src python -m repro_torch.launch.profile_serve --arch phi4-mini-3.8b --preset full
  PYTHONPATH=src python -m repro_torch.launch.profile_serve --arch mamba2-130m
  PYTHONPATH=src python -m repro_torch.launch.profile_serve --arch recurrentgemma-9b
  PYTHONPATH=src python -m repro_torch.launch.profile_serve --arch qwen3-moe-30b-a3b
  PYTHONPATH=src python -m repro_torch.launch.profile_serve --arch whisper-small \
      --prompt-len 4 --max-len 448

Attention models decode off the paged pool (``attn_mode="paged"``); models
with recurrent state and the MoE decoders decode in gather mode, the only
mode they support.  The encoder-decoder, which no engine serves, goes
through ``runtime.serve_lib``'s steps instead: ``--steps`` prefills of
``--batch`` prompts over seeded frames, then ``--steps`` decode steps of
the slab step (on the card one CUDA graph each), each window profiled.

The engine is profiled as built: on the card its runner replays one CUDA
graph per bucket.  Prints the host time per step, the device time the
profiler attributes to kernels per step, their ratio (the device's busy
share), and the kernels with the most device time.  With graphs it then
runs a second, unprofiled window of as many steps and times each replay
with CUDA events: replay device ms per step against the host ms of the
same steps is a busy share that does not rest on the profiler seeing
kernels inside graphs.  For a pure-attention decoder it then times
``--steps`` prefills of one ``--prompt-len`` prompt, padded to its rung of
the ladder: the graphed prefill's replay device ms (CUDA events) against
its host ms (the engine's call through the first token's argmax on the
host), and the eager prefill's host ms.  Runs on the card; ``--device
cpu`` runs the plain versions eagerly and shows host time only.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..models import RunOpts, Transformer
from ..runtime import serve_lib
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
    params = model.init_loaded(torch.Generator(device=model.device).manual_seed(0))
    if cfg.is_encoder_decoder:
        _profile_encoder_decoder(model, params, args)
        return
    gen_len = 3 * args.steps + 8
    # all requests arrive together, so the planned pool holds them at once
    trace = [Request(rid=i + 1, prompt_len=args.prompt_len, gen_len=gen_len,
                     arrival=0) for i in range(args.batch)]
    eng = ServeEngine(model, params, sample_trace=trace, max_len=args.max_len,
                      max_batch=args.batch,
                      attn_mode="paged" if ServeEngine.pads_prefill(cfg) else "gather")
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
    wall_ms, dev_ms, kernels = _profiled(model, eng.step, args.steps)
    print(f"[profile] {cfg.name} batch={args.batch} prompt={args.prompt_len} "
          f"attn={eng.attn_mode} graphs={eng.graphs} steps={args.steps} on "
          f"{model.device}: host step_ms={wall_ms:.3f} "
          f"device_ms_per_step={dev_ms:.3f} busy_share={dev_ms / wall_ms:.3f}")
    _print_kernels(kernels, args.steps)
    if eng.graphs:
        eng.runner.replay_events = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.steps):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / args.steps
        ev = eng.runner.replay_events
        eng.runner.replay_events = None
        rep_ms = sum(a.elapsed_time(b) for a, b in ev) / args.steps
        print(f"[profile] unprofiled window, CUDA events around the {len(ev)} "
              f"graph replays: host step_ms={wall_ms:.3f} "
              f"replay_device_ms_per_step={rep_ms:.3f} "
              f"busy_share={rep_ms / wall_ms:.3f}")
    if eng.graphs and eng.prefill_rungs():
        _profile_prefill(eng, args.prompt_len, args.steps, g)


def _profiled(model, fn, n: int):
    """``fn()`` called ``n`` times under ``torch.profiler``: (host ms per
    call, the device ms per call that the profiler attributes to kernels,
    the kernel records)."""
    cuda = model.device.type == "cuda"
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        if cuda:
            torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / n
    # kernel records only: an op's own row repeats its kernels' time
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    return wall_ms, sum(_device_us(e) for e in kernels) / 1e3 / n, kernels


def _print_kernels(kernels, n: int, per: str = "step") -> None:
    for e in sorted(kernels, key=_device_us, reverse=True)[:10]:
        print(f"[profile]   {_device_us(e) / 1e3 / n:8.4f} ms/{per} "
              f"x{e.count // n:<4d} {e.key[:90]}")


def _profile_encoder_decoder(model, params, args) -> None:
    """The encoder-decoder through ``runtime.serve_lib``: prefills of
    ``args.batch`` seeded prompts over seeded frames, then decode steps of
    the slab step (both graphed on the card), each window profiled."""
    cfg, dev = model.cfg, model.device
    g = torch.Generator(device=dev).manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                                     generator=g, device=dev, dtype=torch.int32),
             "frames": torch.randn(args.batch, cfg.encoder_seq, cfg.d_model,
                                   generator=g, device=dev)}
    prefill = serve_lib.build_prefill_step(model, None, max_len=args.max_len)
    decode = serve_lib.build_decode_step(model, None)
    logits, cache = prefill(params, batch)
    wall_ms, dev_ms, kernels = _profiled(model, lambda: prefill(params, batch),
                                         args.steps)
    print(f"[profile] {cfg.name} prefill batch={args.batch} prompt={args.prompt_len} "
          f"frames={cfg.encoder_seq} x{args.steps} on {dev}: host ms={wall_ms:.3f} "
          f"device_ms={dev_ms:.3f} busy_share={dev_ms / wall_ms:.3f}")
    _print_kernels(kernels, args.steps, "prefill")
    tok = [logits.argmax(-1).int()]

    def step():
        out, _ = decode(params, cache, tok[0])
        tok[0] = out.argmax(-1).int()
    for _ in range(2):
        step()
    wall_ms, dev_ms, kernels = _profiled(model, step, args.steps)
    print(f"[profile] {cfg.name} decode batch={args.batch} graphs="
          f"{dev.type == 'cuda'} steps={args.steps} on {dev}: host step_ms="
          f"{wall_ms:.3f} device_ms_per_step={dev_ms:.3f} "
          f"busy_share={dev_ms / wall_ms:.3f}")
    _print_kernels(kernels, args.steps)


def _profile_prefill(eng: ServeEngine, prompt_len: int, n: int, g) -> None:
    """Graphed prefill of one padded prompt: replay device ms (CUDA events)
    and host ms per call, the eager prefill's host ms beside them."""
    batch = eng._prefill_batch(torch.randint(0, eng.model.cfg.vocab_size,
                                             (prompt_len,), generator=g,
                                             dtype=torch.int32))
    rung = int(batch["tokens"].shape[1])

    def host_ms(fn) -> float:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            int(fn()[0][0].argmax())        # the engine's first-token sync
        return 1e3 * (time.perf_counter() - t0) / n
    eager_ms = host_ms(lambda: eng.model.prefill(eng.params, batch))
    captures = eng.prefill.n_captures
    eng.prefill.replay_events = []
    graph_ms = host_ms(lambda: eng.prefill(eng.params, batch))
    ev = eng.prefill.replay_events[1:]      # the timed calls' replays
    eng.prefill.replay_events = None
    if eng.prefill.n_captures != captures:
        raise RuntimeError(f"rung {rung} was captured while it was timed")
    rep_ms = sum(a.elapsed_time(b) for a, b in ev) / len(ev)
    print(f"[profile] prefill prompt={prompt_len} rung={rung} x{len(ev)}: "
          f"graphed host ms={graph_ms:.3f} replay_device_ms={rep_ms:.3f} "
          f"busy_share={rep_ms / graph_ms:.3f}; eager host ms={eager_ms:.3f} "
          f"({eager_ms / graph_ms:.2f}x)")


if __name__ == "__main__":
    main()
