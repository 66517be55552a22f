#!/usr/bin/env python3
"""Chip smoke test for the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:
  1. require CUDA; print the card's name and power limit;
  2. build every CUDA kernel from ``src/repro_torch/kernels/csrc`` for sm_90a;
  3. hold each kernel against its plain PyTorch version on the card at the
     serving path's shapes (bf16 max-abs 2e-2, the reference's own
     tolerance; f32 1e-4, because the sum order differs), and time kernel,
     plain version, SDPA (a yardstick the port never calls) and the bound;
  4. serve full-width qwen2-0.5b (24 layers, bf16, seeded random weights)
     through the port's ``ServeEngine`` with paged decode and flash prefill,
     with every launch counter set to 0 just before and read just after, and
     check the slice against its plain path on a small f32 input;
  5. print the kernels JSON line, the card line, and the result line.

Imports nothing of JAX.  Stdout's last line is the result JSON.
"""
from __future__ import annotations

import itertools
import json
import math
import random
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TOL = {"bfloat16": 2e-2, "float32": 1e-4}
ARCH = "qwen2-0.5b"
MAX_BATCH, MAX_LEN, GEN_LEN, N_REQUESTS, SEED = 8, 1024, 32, 12, 0


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> tuple[float, float]:
    """(device ms, call ms) per call of ``fn``.

    Call ms: CUDA events around ``iters`` back-to-back calls — when a call's
    host work (Python, ctypes, allocation) outlasts its kernels, this is the
    host's pace, as the engine sees it.  Device ms: the same calls queued
    behind a GPU sleep long enough to cover their host work, so the kernels
    run back to back and the events time the device alone."""
    t0 = time.perf_counter()
    for _ in range(warmup):
        fn()
        torch.cuda.synchronize()
    host_s = (time.perf_counter() - t0) / warmup
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    call_ms = start.elapsed_time(end) / iters
    # hold the stream: ~2e9 cycles/s is at or above the H100's SM clock, so
    # the sleep lasts at least 1.5x the queued calls' host time
    torch.cuda._sleep(int(2e9 * (1.5 * iters * host_s + 2e-3)))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters, call_ms


def bound_ms(n_bytes: float, flops: float, dtype: str):
    """Least time on an H100 SXM: bytes over HBM bandwidth or operations
    over the dtype's peak rate, whichever is larger."""
    from repro_torch.core.planner import HBM_BW, PEAK_FLOPS_BF16, PEAK_FLOPS_F32
    peak = {"bfloat16": PEAK_FLOPS_BF16, "float32": PEAK_FLOPS_F32}[dtype]
    t_bytes = n_bytes / HBM_BW
    t_ops = flops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check(name, err, dtype):
    if not math.isfinite(err) or err > TOL[dtype]:
        raise AssertionError(f"{name}: max_abs_err {err:.3g} > {TOL[dtype]} ({dtype})")


def paged_cases(torch, ops, ref, pt: int):
    """Paged decode at the engine's pool geometry: fragmented non-monotonic
    page tables, partial last pages, zero-padded table tails; 24 layer pools
    cycled so every launch reads K/V from HBM, as decode does."""
    F = torch.nn.functional
    maxp = math.ceil(MAX_LEN / pt) + 1
    n_pages = MAX_BATCH * maxp
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    rng = random.Random(SEED + 1)
    out, worst = {}, {}
    for dtype_name, batches in (("bfloat16", (1, 3, 8)), ("float32", (8,))):
        dt = getattr(torch, dtype_name)
        layers = 24
        kp = torch.randn(layers, n_pages, pt, 2, 64, generator=g, device="cuda").to(dt)
        vp = torch.randn(layers, n_pages, pt, 2, 64, generator=g, device="cuda").to(dt)
        for b in batches:
            q = torch.randn(b, 2, 7, 64, generator=g, device="cuda").to(dt)
            pos = [rng.randint(100, 631) for _ in range(b)]
            perm = torch.randperm(n_pages, generator=g, device="cuda").int()
            tables = torch.zeros(b, maxp, dtype=torch.int32, device="cuda")
            for i, p in enumerate(pos):
                used = p // pt + 1
                tables[i, :used] = perm[i * maxp:i * maxp + used]
            positions = torch.tensor(pos, dtype=torch.int32, device="cuda")
            got = ops.paged_attention(q, kp[0], vp[0], tables, positions)
            want = ref.ref_paged_attention(q, kp[0], vp[0], tables, positions)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            check(f"paged B={b} {dtype_name}", err, dtype_name)
            worst[dtype_name] = max(worst.get(dtype_name, 0.0), err)
            calls = itertools.count()

            def cycled(fn):
                layer = next(calls) % layers
                return fn(q, kp[layer], vp[layer], tables, positions)
            k_ms, k_call = time_ms(torch, lambda: cycled(ops.paged_attention))
            p_ms, _ = time_ms(torch, lambda: cycled(ref.ref_paged_attention))
            # yardstick only: SDPA over an already gathered contiguous copy
            kc = kp[0][tables.long()].reshape(b, -1, 2, 64).transpose(1, 2)
            vc = vp[0][tables.long()].reshape(b, -1, 2, 64).transpose(1, 2)
            mask = (torch.arange(kc.shape[2], device="cuda")[None, :]
                    <= positions[:, None])[:, None, None, :]
            qs = q.reshape(b, 14, 1, 64)
            s_ms, _ = time_ms(torch, lambda: F.scaled_dot_product_attention(
                qs, kc, vc, attn_mask=mask, enable_gqa=True))
            tok = sum(p + 1 for p in pos)
            isz = q.element_size()
            n_bytes = (2 * q.numel() * isz + tok * 2 * 2 * 64 * isz
                       + 4 * sum(p // pt + 1 for p in pos) + 4 * b)
            bms, by = bound_ms(n_bytes, 4 * 64 * 14 * tok, dtype_name)
            out[(dtype_name, b)] = dict(err=err, ms=k_ms, plain_ms=p_ms,
                                        sdpa_ms=s_ms, bound_ms=bms, bound_by=by)
            print(f"[paged] B={b} {dtype_name} pt={pt} pos={pos} "
                  f"max_abs_err={err:.3g} kernel_ms={k_ms:.4f} "
                  f"wrapper_call_ms={k_call:.4f} "
                  f"plain_ms={p_ms:.4f} sdpa_gathered_ms={s_ms:.4f} "
                  f"bound_ms={bms:.5f} ({by})", flush=True)
    return out, worst


def flash_cases(torch, ops, ref):
    """Flash prefill at the padding ladder's shapes (B=1, H=14 over KV=2,
    D=64), plus one sliding-window and one q_offset case."""
    F = torch.nn.functional
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    cases = [("bfloat16", sq, 0, 0) for sq in (8, 37, 512, 1024)]
    cases += [("bfloat16", 512, 128, 0), ("bfloat16", 64, 0, 512),
              ("float32", 512, 0, 0)]
    out, worst = {}, {}
    for dtype_name, sq, window, q_off in cases:
        dt = getattr(torch, dtype_name)
        sk = sq + q_off
        q = torch.randn(1, sq, 2, 7, 64, generator=g, device="cuda").to(dt)
        k = torch.randn(1, sk, 2, 64, generator=g, device="cuda").to(dt)
        v = torch.randn(1, sk, 2, 64, generator=g, device="cuda").to(dt)
        kw = dict(causal=True, window=window, q_offset=q_off)
        qh, kh, vh = q.reshape(1, sq, 14, 64).transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        got = ops.flash_attention(q, k, v, **kw)
        want = ref.ref_attention_bhsd(qh, kh, vh, **kw).transpose(1, 2).reshape(got.shape)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        check(f"flash Sq={sq} window={window} q_offset={q_off} {dtype_name}", err, dtype_name)
        worst[dtype_name] = max(worst.get(dtype_name, 0.0), err)
        k_ms, k_call = time_ms(torch, lambda: ops.flash_attention(q, k, v, **kw))
        p_ms, _ = time_ms(torch, lambda: ref.ref_attention_bhsd(qh, kh, vh, **kw), iters=5)
        s_ms = None
        if window == 0 and q_off == 0:
            s_ms, _ = time_ms(torch, lambda: F.scaled_dot_product_attention(
                qh, kh, vh, is_causal=True, enable_gqa=True))
        qp = torch.arange(sq) + q_off
        kpos = torch.arange(sk)
        ok = kpos[None, :] <= qp[:, None]
        if window:
            ok &= kpos[None, :] > qp[:, None] - window
        pairs = int(ok.sum())
        isz = q.element_size()
        n_bytes = (2 * q.numel() + k.numel() + v.numel()) * isz
        bms, by = bound_ms(n_bytes, 4 * 64 * 14 * pairs, dtype_name)
        out[(dtype_name, sq, window, q_off)] = dict(
            err=err, ms=k_ms, plain_ms=p_ms, sdpa_ms=s_ms, bound_ms=bms, bound_by=by)
        print(f"[flash] Sq={sq} Sk={sk} window={window} q_offset={q_off} "
              f"{dtype_name} max_abs_err={err:.3g} kernel_ms={k_ms:.4f} "
              f"wrapper_call_ms={k_call:.4f} "
              f"plain_ms={p_ms:.4f} sdpa_ms="
              f"{'n/a' if s_ms is None else f'{s_ms:.4f}'} "
              f"bound_ms={bms:.5f} ({by})", flush=True)
    return out, worst


def serve_trace(cfg, torch, n: int, seed: int):
    """Staggered requests with prompts of 100-600 tokens and GEN_LEN
    generated tokens; prompts are seeded random token ids."""
    from repro_torch.runtime.serve_lib import Request
    from repro_torch.serving import GenRequest
    rng = random.Random(seed)
    g = torch.Generator().manual_seed(seed)
    trace, t = [], 0
    for i in range(n):
        t += rng.randint(0, 3)
        trace.append(Request(rid=i + 1, prompt_len=rng.randint(100, 600),
                             gen_len=GEN_LEN, arrival=t))
    live = [GenRequest(rid=r.rid, prompt=torch.randint(
                0, cfg.vocab_size, (r.prompt_len,), generator=g,
                dtype=torch.int32), gen_len=r.gen_len, arrival=r.arrival)
            for r in trace]
    return trace, live


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import build, ops, ref
    from repro_torch.models import RunOpts, Transformer
    from repro_torch.serving import ServeEngine
    from repro_torch.serving.pages import choose_page_tokens

    t_start = time.perf_counter()
    card = card_line()
    print(f"[card] {card} | torch {torch.__version__} cuda {torch.version.cuda} "
          f"| {torch.cuda.get_device_name(0)}", flush=True)

    # -- 2. build ---------------------------------------------------------------------
    secs = build.build_all()
    srcs = [str(s.relative_to(ROOT)) for s in build.sources()]
    print(f"[build] {len(srcs)} kernels {srcs} for sm_90a in {secs:.1f}s", flush=True)
    for name, log in build.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")

    # -- 3. kernels against their plain versions -------------------------------------
    cfg = get_config(ARCH)
    trace, live = serve_trace(cfg, torch, N_REQUESTS, SEED)
    pt = choose_page_tokens(cfg, trace).page_tokens
    paged, paged_worst = paged_cases(torch, ops, ref, pt)
    flash, flash_worst = flash_cases(torch, ops, ref)

    # -- 4. the main path: full-width qwen2-0.5b through the ServeEngine -------------
    model = Transformer(cfg, RunOpts(attention_impl="kernel"))
    params = model.load(model.init(torch.Generator(device="cuda").manual_seed(SEED)))
    eng = ServeEngine(model, params, sample_trace=trace, max_len=MAX_LEN,
                      max_batch=MAX_BATCH, attn_mode="paged")
    t0 = time.perf_counter()
    eng.warmup()
    print(f"[warmup] buckets={list(eng.runner.buckets)} in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    kv = eng.kv.stats()
    print(f"[paged pool] page_tokens={kv['page_tokens']} n_pages={kv['n_pages']} "
          f"pool={kv['pool_bytes'] / 1e6:.2f}MB (planned peak "
          f"{kv['planned_peak'] / 1e6:.2f}MB) exec_pool_pages={eng._pool_pages}")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    steps0, prefills0 = eng.decode_steps, eng.prefill_calls
    summary = eng.run(live)
    torch.cuda.synchronize()
    launches = {"paged_attention": ops.paged_attention.launches,
                "flash_attention": ops.flash_attention.launches}
    n_steps = eng.decode_steps - steps0
    n_prefills = eng.prefill_calls - prefills0
    if summary["n_completed"] != len(live):
        raise AssertionError(f"completed {summary['n_completed']}/{len(live)}")
    for r in live:
        toks = eng.completed[r.rid]
        if len(toks) != r.gen_len or not all(0 <= t < cfg.padded_vocab for t in toks):
            raise AssertionError(f"rid {r.rid}: bad output {toks}")
    if launches["paged_attention"] != cfg.n_layers * n_steps or n_steps == 0:
        raise AssertionError(f"paged launches {launches} vs {n_steps} decode steps")
    if launches["flash_attention"] != cfg.n_layers * n_prefills or n_prefills == 0:
        raise AssertionError(f"flash launches {launches} vs {n_prefills} prefills")
    step_ms = 1e3 * eng.decode_time_s / eng.decode_steps
    prefill_ms = 1e3 * eng.prefill_time_s / eng.prefill_calls
    print(f"[decode:runner] steps={n_steps} step_ms={step_ms:.2f} "
          f"prefills={n_prefills} prefill_ms={prefill_ms:.2f} "
          f"launches={launches} peak_mem={torch.cuda.max_memory_allocated() / 1e9:.2f}GB "
          f"| {card}")
    print(f"completed {summary['n_completed']}/{summary['n_requests']} requests, "
          f"{summary['tokens']} tokens in {summary['wall_s']:.1f}s "
          f"({summary['tokens_per_s']:.1f} tok/s), "
          f"max_concurrent={summary['max_concurrent']}, "
          f"preemptions={summary['n_preemptions']}, reopts={summary['kv_n_reopt']} "
          f"| {card}", flush=True)

    # small f32 input: paged decode + flash prefill against the plain path
    small = cfg.with_overrides(n_layers=2, dtype="float32")
    trace_s, live_s = serve_trace(small, torch, 4, SEED + 3)
    streams = {}
    for mode, impl in (("paged", "kernel"), ("gather", "full")):
        m = Transformer(small, RunOpts(attention_impl=impl))
        p = m.load(m.init(torch.Generator(device="cuda").manual_seed(SEED + 3)))
        e = ServeEngine(m, p, sample_trace=trace_s, max_len=MAX_LEN,
                        max_batch=4, attn_mode=mode)
        e.run(live_s)
        streams[mode] = e.completed
    same = sum(streams["paged"][r] == streams["gather"][r] for r in streams["gather"])
    print(f"[check] f32 2-layer full-width: paged+kernels vs gather+plain token "
          f"streams identical for {same}/{len(live_s)} requests")
    if same != len(live_s):
        raise AssertionError(f"token streams differ: {streams}")

    # -- 5. records ------------------------------------------------------------------------
    pk = paged[("bfloat16", MAX_BATCH)]
    fk = flash[("bfloat16", 512, 0, 0)]
    kernels = [
        {"name": "paged_attention_decode", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention.py:76",
         "launches": launches["paged_attention"],
         "max_abs_err": paged_worst["bfloat16"], "ms": pk["ms"],
         "plain_ms": pk["plain_ms"], "bound_ms": pk["bound_ms"],
         "bound_by": pk["bound_by"], "library_ms": None},
        {"name": "flash_attention_bhsd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:73",
         "launches": launches["flash_attention"],
         "max_abs_err": flash_worst["bfloat16"], "ms": fk["ms"],
         "plain_ms": fk["plain_ms"], "bound_ms": fk["bound_ms"],
         "bound_by": fk["bound_by"], "library_ms": fk["sdpa_ms"]},
    ]
    print(f"[done] {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
