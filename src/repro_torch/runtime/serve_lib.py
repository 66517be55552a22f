"""Serving runtime: the DSA-planned KV arena and request traces.

This is where the paper's technique is a first-class serving feature: request
cache slabs are rectangles (size = cache bytes at final length, lifetime =
[admit, finish)), planned with the best-fit heuristic, with §4.3
reoptimization when a request outgrows its profiled length.  Port of
``repro.runtime.serve_lib``; the jitted step builders have no counterpart
here because PyTorch runs the model's prefill/decode calls eagerly.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..configs.base import ModelConfig
from ..core import ArenaAllocator, Block, MemoryProfile, PoolAllocator, align, best_fit

# Bytes per element of each config dtype (``jnp.dtype(cfg.dtype).itemsize``
# in the reference).
DTYPE_ITEMSIZE = {"float32": 4, "bfloat16": 2, "float16": 2}


def layer_kinds(cfg: ModelConfig) -> list[str]:
    """Per-layer kinds in execution order: the pattern repeated over its
    groups, then the tail."""
    return (list(cfg.block_pattern) * max(1, cfg.n_pattern_groups))[:max(
        0, cfg.n_layers - len(cfg.tail_pattern))] + list(cfg.tail_pattern)


def cache_bytes_per_token(cfg: ModelConfig) -> int:
    """Device bytes one token of context costs across all layers' caches."""
    hd, kv = cfg.resolved_head_dim, cfg.n_kv_heads
    itemsize = DTYPE_ITEMSIZE[cfg.dtype]
    total = 0
    for kind in layer_kinds(cfg):
        if kind in ("attn", "xattn"):
            total += 2 * kv * hd * itemsize
        # local/rec/mamba2 have O(1) state — no per-token cache cost
    return total


def state_bytes(cfg: ModelConfig) -> int:
    """O(1) per-request state bytes (recurrent h / ssm state / local window)."""
    itemsize = DTYPE_ITEMSIZE[cfg.dtype]
    total = 0
    for kind in layer_kinds(cfg):
        if kind == "local":
            total += 2 * cfg.n_kv_heads * cfg.resolved_head_dim * \
                cfg.local_window * itemsize
        elif kind == "rec":
            total += cfg.lru_width * (4 + (cfg.conv_width - 1) * itemsize)
        elif kind == "mamba2":
            total += cfg.ssm_heads * cfg.ssm_head_dim * cfg.ssm_state * 4
            total += (cfg.conv_width - 1) * (cfg.d_inner +
                                             2 * cfg.ssm_groups * cfg.ssm_state) * itemsize
    return total


@dataclass(frozen=True)
class Request:
    rid: int
    prompt_len: int
    gen_len: int            # tokens to generate
    arrival: int            # engine step index


def synth_trace(n: int, prompt_len: int, gen_len: int, seed: int = 0,
                jitter: bool = True) -> list[Request]:
    """Synthetic request trace with staggered arrivals (profile/bench/launch
    helper; jitter models live traffic outgrowing the profiled lengths)."""
    import random
    rng = random.Random(seed)
    trace, t = [], 0
    for i in range(n):
        t += rng.randint(0, 4)
        g = gen_len + (rng.randint(-gen_len // 3, gen_len // 3) if jitter else 0)
        trace.append(Request(rid=i + 1, prompt_len=prompt_len,
                             gen_len=max(2, g), arrival=t))
    return trace


def request_blocks(requests: list[Request], cfg: ModelConfig,
                   alignment: int = 4096) -> MemoryProfile:
    """Requests -> DSA blocks: size = cache bytes at final length, lifetime =
    [arrival, arrival + gen_len)."""
    bpt = cache_bytes_per_token(cfg)
    sbytes = state_bytes(cfg)
    blocks = []
    for r in requests:
        size = align(bpt * (r.prompt_len + r.gen_len) + sbytes, alignment)
        blocks.append(Block(bid=r.rid, size=size, start=r.arrival,
                            end=r.arrival + max(1, r.gen_len), tag=f"req{r.rid}"))
    clock_end = max(b.end for b in blocks) if blocks else 0
    return MemoryProfile(blocks=blocks, clock_end=clock_end,
                         meta={"kind": "serving", "arch": cfg.name})


class ServingArena:
    """Profile-guided KV-cache memory manager (paper §4 applied to serving).

    A sample trace of requests (the 'profile run') fixes the plan; subsequent
    traces reuse it, falling back to §4.3 reoptimization when request i runs
    longer than profiled.  ``compare_pool()`` replays the same trace through
    the Chainer-style pool — the Fig. 2 comparison for serving.
    """

    def __init__(self, cfg: ModelConfig, sample_trace: list[Request]):
        self.cfg = cfg
        self.profile = request_blocks(sample_trace, cfg)
        self.arena = ArenaAllocator(self.profile, solver=best_fit)
        self.bpt = cache_bytes_per_token(cfg)
        self.sbytes = state_bytes(cfg)

    @property
    def peak_bytes(self) -> int:
        return self.arena.peak

    def admit(self, r: Request) -> int:
        """Returns the slab offset for request r (reoptimizes if oversized)."""
        size = self.bpt * (r.prompt_len + r.gen_len) + self.sbytes
        return self.arena.alloc(size)

    def finish(self, offset: int) -> None:
        self.arena.free(offset)

    def reset_epoch(self) -> None:
        self.arena.reset_iteration()

    def stats(self) -> dict:
        return self.arena.stats()

    def compare_pool(self) -> dict:
        from ..core import replay
        pool = replay(self.profile, PoolAllocator())
        naive_total = self.profile.total_bytes
        return {
            "dsa_peak": self.arena.peak,
            "pool_peak": pool["peak"],
            "naive_peak": naive_total,
            "saving_vs_pool": 1 - self.arena.peak / pool["peak"] if pool["peak"] else 0,
            "lower_bound": self.profile.liveness_lower_bound(),
        }
