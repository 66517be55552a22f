"""Time the CUDA kernels of two source trees in turns on one card.

    python -m repro_torch.launch.kernel_ab --base OTHER/src

``--base`` is the ``src`` directory of another checkout of this repository
(for instance a parent commit unpacked with ``git archive``).  Each tree
runs in a process of its own, in the order base, this, this, base, so that
drift of the card's clocks shows as a difference between the two runs of
one tree.  Every process builds its tree's kernels and times them at the
main paths' layouts, which every tree since the kernels' redesigns takes:
flash prefill at D=64 and 128 (B=1, 32 heads over 8, Sq=512) and at D=256
(16 heads over 1, Sq=2600, window 2048), paged decode at qwen2-0.5b's
layout (hd=64, 2 kv heads of 7) and at hd=128 (8 kv heads of 4), B=8,
16-token pages, eight layer pools cycled; the SSD scan at mamba2-130m's
(H=24, P=64, N=128, G=1), S=512; each in bf16 and f32.  Device ms per
call: CUDA events around 20 calls queued behind a GPU sleep.  Prints one
``[ab]`` line a case and run, then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import os
import random
import subprocess
import sys
from pathlib import Path

THIS_SRC = Path(__file__).resolve().parents[2]


def device_ms(torch, fn, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    call_ms = start.elapsed_time(end) / iters
    torch.cuda._sleep(int(2e9 * (1.5 * iters * call_ms / 1e3 + 2e-3)))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def time_tree(label: str) -> None:
    """Build and time the kernels of the tree ``repro_torch`` imports from."""
    import torch
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import ssd_scan as ssd
    build.build_all()
    g = torch.Generator(device="cuda").manual_seed(0)
    for dt in (torch.bfloat16, torch.float32):
        for h, kv, d, sq, window in ((32, 8, 64, 512, 0), (32, 8, 128, 512, 0),
                                     (16, 1, 256, 2600, 2048)):
            q = torch.randn(1, sq, kv, h // kv, d, generator=g, device="cuda").to(dt)
            k = torch.randn(1, sq, kv, d, generator=g, device="cuda").to(dt)
            v = torch.randn(1, sq, kv, d, generator=g, device="cuda").to(dt)
            ms = device_ms(torch, lambda: ops.flash_attention(q, k, v, window=window))
            print(f"[ab] {label} flash D={d} H={h} KV={kv} Sq={sq} {dt} ms={ms:.4f}",
                  flush=True)
        for kv, grp, hd in ((2, 7, 64), (8, 4, 128)):
            b, pt, maxp, layers = 8, 16, 65, 8
            n_pool = b * maxp
            kp = torch.randn(layers, n_pool, pt, kv, hd, generator=g, device="cuda").to(dt)
            vp = torch.randn(layers, n_pool, pt, kv, hd, generator=g, device="cuda").to(dt)
            q = torch.randn(b, kv, grp, hd, generator=g, device="cuda").to(dt)
            rng = random.Random(1)
            pos = [rng.randint(100, 631) for _ in range(b)]
            perm = torch.randperm(n_pool, generator=g, device="cuda").int()
            tables = torch.zeros(b, maxp, dtype=torch.int32, device="cuda")
            for i, p in enumerate(pos):
                tables[i, :p // pt + 1] = perm[i * maxp:i * maxp + p // pt + 1]
            positions = torch.tensor(pos, dtype=torch.int32, device="cuda")
            calls = iter(range(1 << 62))

            def paged():
                layer = next(calls) % layers
                return ops.paged_attention(q, kp[layer], vp[layer], tables, positions)
            print(f"[ab] {label} paged hd={hd} KV={kv} G={grp} B={b} {dt} "
                  f"ms={device_ms(torch, paged):.4f}", flush=True)
        x = torch.randn(1, 512, 24, 64, generator=g, device="cuda")
        dta = -torch.rand(1, 512, 24, generator=g, device="cuda")
        bm = torch.randn(1, 512, 1, 128, generator=g, device="cuda").to(dt)
        cm = torch.randn(1, 512, 1, 128, generator=g, device="cuda").to(dt)
        ms = device_ms(torch, lambda: ssd.ssd_scan_kernel(x, dta, bm, cm))
        print(f"[ab] {label} ssd P=64 N=128 G=1 H=24 S=512 B/C {dt} ms={ms:.4f}", flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--base", required=True, help="the other tree's src directory")
    ap.add_argument("--time", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.time is not None:
        time_tree(args.time)
        return
    base = Path(args.base).resolve()
    for label, src in (("base", base), ("this", THIS_SRC), ("this", THIS_SRC),
                       ("base", base)):
        # this file run by path, so that ``repro_torch`` is the one on PYTHONPATH
        # and no sibling module of this directory shadows a top-level one
        code = (f"import runpy, sys; sys.argv = ['kernel_ab', '--base', '', '--time', "
                f"{label!r}]; runpy.run_path({__file__!r}, run_name='__main__')")
        subprocess.run([sys.executable, "-c", code], check=True,
                       env=dict(os.environ, PYTHONPATH=str(src)))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())


if __name__ == "__main__":
    main()
