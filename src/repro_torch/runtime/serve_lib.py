"""Serving runtime: the prefill/decode step factories, the DSA-planned KV arena
and request traces.

This is where the paper's technique is a first-class serving feature: request
cache slabs are rectangles (size = cache bytes at final length, lifetime =
[admit, finish)), planned with the best-fit heuristic, with §4.3
reoptimization when a request outgrows its profiled length.  Port of
``repro.runtime.serve_lib``.  The reference jits both steps; here, on the
card, the decode step is captured into one CUDA graph per batch shape
(``runtime.graphs``), and so is the prefill of each padded prompt length
and of each encoder-decoder batch shape with its frames; on the CPU both
run eagerly, and so do unpadded prompts everywhere.

Given a ``DeviceMesh`` both steps run over DTensor parameters placed by
``sharding_rules.param_specs``, with the mesh and the model's
``RunOpts.mesh_rules()`` installed (``mesh_ctx.use_mesh``), as the
reference's jitted steps run under its in/out shardings: the batch is
placed by ``batch_specs``, the cache by ``cache_specs`` and the logits come
back whole.  On the card the same graphs are captured under the mesh:
DTensor's dispatch and the ``local_map`` regions run once, at capture, and
each replay runs the local kernels (on a mesh that splits a tensor, the
collectives too).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..configs.base import ModelConfig
from ..core import ArenaAllocator, Block, MemoryProfile, PoolAllocator, align, best_fit
from . import mesh_ctx, sharding_rules
from .graphs import StepGraph, pool_bytes, use_graphs

# Bytes per element of each config dtype (``jnp.dtype(cfg.dtype).itemsize``
# in the reference).
DTYPE_ITEMSIZE = {"float32": 4, "bfloat16": 2, "float16": 2}


# ---------------------------------------------------------------------------
# prefill and decode steps
# ---------------------------------------------------------------------------


def step_graphs(mesh, graphs: Optional[bool], device, what: str) -> bool:
    """``graphs`` resolved for a step on ``device`` (``use_graphs``: None
    means capture on a CUDA device, True elsewhere raises ``ValueError``);
    a ``mesh`` must be one ``mesh_ctx.check_mesh`` takes."""
    graphs = use_graphs(graphs, device)
    if mesh is not None:
        mesh_ctx.check_mesh(mesh, what)
    return graphs


def place_cache(cache: dict, mesh, rules: Optional[dict] = None) -> dict:
    """Each plain leaf of ``cache`` distributed by ``sharding_rules.
    cache_specs`` (``rules`` updating ``CACHE_RULES``), in the dict; a
    DTensor leaf keeps the placements it has (the engine's slots)."""
    specs = sharding_rules.cache_specs(cache, mesh, rules)
    for name, leaf in cache.items():
        if not mesh_ctx.is_dtensor(leaf):
            cache[name] = mesh_ctx.distribute(leaf, mesh, specs[name])
    return cache


class PrefillStep:
    """``prefill(params, batch)`` -> ``model.prefill(params, batch,
    max_len=max_len)``; built by ``build_prefill_step``.

    With graphs a padded prompt's prefill (a batch with ``true_len``) and
    an encoder-decoder's (a batch with ``frames``) replay one CUDA graph
    per signature: the tokens' shape, whether ``true_len`` is given, and
    the frames' shape and dtype.  A graph is bound to the ``params`` it was
    captured with; another ``params`` captures again.  The graphs share a
    graph memory pool of their own, apart from the decode graphs'.  Each
    signature has static input buffers, made once (the tokens, ``true_len``
    and the frames, as the batch has them); before the signature's first
    capture the step runs once eagerly on them, to pay first-call costs
    outside the capture.  Each call copies the batch into them, so any
    ``true_len`` of the length and any frames of the shape replay the same
    graph (the model reads both on the device).  The graph returns its
    static logits and cache (an encoder-decoder's cross ``xk``/``xv``
    too), which the next replay of that signature overwrites: a caller
    takes what it needs of them (copies them, or decodes on that cache in
    place) before it prefills that signature again.  A batch with neither
    (an unpadded prompt) runs eagerly.

    Under a mesh the step places the batch by ``batch_specs`` and returns
    the logits whole and the cache placed by ``cache_specs``; captured, the
    placement runs once, at capture, and the returned DTensors wrap the
    graph's static local tensors.

    ``trace_hook(batch)`` fires once per capture and, eagerly, once per new
    signature: the reference's jit traces once per such signature.  With
    ``replay_events`` set to a list, each replay appends a pair of CUDA
    events recorded around it (``launch.profile_serve`` times them)."""

    def __init__(self, model, max_len: Optional[int], trace_hook,
                 graphs: bool, mesh=None):
        self.model = model
        self.mesh = mesh
        self.max_len = max_len
        self.trace_hook = trace_hook
        self.graphs = graphs
        self.pool = torch.cuda.graph_pool_handle() if self.graphs else None
        self.n_captures = self.n_replays = 0
        self.replay_events: Optional[list] = None
        self._seen: set = set()
        self._captured: dict = {}      # signature -> StepGraph
        self._static: dict = {}        # signature -> its input buffers

    def _eager(self, params, batch):
        if self.mesh is None:
            return self.model.prefill(params, batch, max_len=self.max_len)
        mesh = self.mesh
        with mesh_ctx.use_mesh(mesh, rules=self.model.opts.mesh_rules()):
            arrays = {k: v for k, v in batch.items() if k != "true_len"}
            specs = sharding_rules.batch_specs(arrays, mesh)
            placed = {k: mesh_ctx.distribute(v, mesh, specs[k]) for k, v in arrays.items()}
            if "true_len" in batch:
                placed["true_len"] = batch["true_len"]
            logits, cache = self.model.prefill(params, placed, max_len=self.max_len)
            specs = sharding_rules.cache_specs(cache, mesh)
            return mesh_ctx.whole(logits), {k: mesh_ctx.distribute(v, mesh, specs[k])
                                    for k, v in cache.items()}

    def _hook(self, batch) -> None:
        if self.trace_hook is not None:
            self.trace_hook(batch)

    @staticmethod
    def signature(batch) -> tuple:
        """(tokens shape, whether ``true_len`` is given, frames shape and
        dtype or None): one graph each."""
        frames = batch.get("frames")
        return (tuple(batch["tokens"].shape), "true_len" in batch,
                None if frames is None else (tuple(frames.shape), frames.dtype))

    def __call__(self, params, batch):
        sig = self.signature(batch)
        if not (self.graphs and (sig[1] or sig[2] is not None)):
            if sig not in self._seen:
                self._seen.add(sig)
                self._hook(batch)
            return self._eager(params, batch)
        g = self._captured.get(sig)
        if g is None or not g.binds(params, []):
            g = self._capture(params, batch, sig)
        self._fill(self._static[sig], batch)
        self.n_replays += 1
        if self.replay_events is None:
            return g.replay()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = g.replay()
        end.record()
        self.replay_events.append((start, end))
        return out

    def _buffers(self, batch) -> dict:
        """The signature's static inputs, zeroed (``true_len`` the tokens'
        length)."""
        dev = self.model.device
        tokens = batch["tokens"]
        static = {"tokens": torch.zeros(tokens.shape, dtype=tokens.dtype, device=dev)}
        if "true_len" in batch:
            static["true_len"] = torch.full((tokens.shape[0],), tokens.shape[1],
                                            dtype=torch.int32, device=dev)
        if "frames" in batch:
            frames = batch["frames"]
            static["frames"] = torch.zeros(frames.shape, dtype=frames.dtype, device=dev)
        return static

    @staticmethod
    def _fill(static: dict, batch) -> None:
        """Copy ``batch`` into the static buffers (device to device; an int
        ``true_len`` is filled in)."""
        for name, buf in static.items():
            value = batch[name]
            if isinstance(value, torch.Tensor):
                buf.copy_(value)
            else:
                buf.fill_(int(value))

    def _capture(self, params, batch, sig):
        static = self._static.get(sig)
        if static is None:
            static = self._static[sig] = self._buffers(batch)
        if sig not in self._seen:
            self._seen.add(sig)
            self._eager(params, static)
        self._captured.pop(sig, None)       # its pool blocks go back first
        g = self._captured[sig] = StepGraph(lambda: self._eager(params, static),
                                            params=params, tensors=[], pool=self.pool)
        self.n_captures += 1
        self._hook(batch)
        return g

    def stats(self) -> dict:
        return {"graphs": self.graphs, "n_captures": self.n_captures,
                "n_replays": self.n_replays,
                "graph_pool_bytes": pool_bytes(self.pool) if self.graphs else 0}


def build_prefill_step(model, mesh, batch_sds: Optional[dict] = None,
                       max_len: Optional[int] = None, trace_hook=None,
                       graphs: Optional[bool] = None) -> PrefillStep:
    """The prefill step (``PrefillStep``).  ``graphs`` (default: on when the
    model lies on a CUDA device) captures padded prompts and batches with
    frames; True on another device raises ``ValueError``.  With a
    ``DeviceMesh`` it runs over DTensor parameters, the batch placed by
    ``batch_specs``, and returns the logits whole and the cache placed by
    ``cache_specs``; ``batch_sds`` (the reference's in-sharding shapes) is
    not needed: the batch's own shapes place it."""
    del batch_sds
    graphs = step_graphs(mesh, graphs, model.device, "build_prefill_step")
    return PrefillStep(model, max_len, trace_hook, graphs, mesh)


def build_decode_step(model, mesh, batch: Optional[int] = None,
                      max_len: Optional[int] = None, donate: bool = True,
                      shard_cache_len: bool = False, trace_hook=None,
                      graphs: Optional[bool] = None):
    """``decode(params, cache, tokens)`` -> ``(logits, cache)``: the "slab"
    step, every row of the batch cache advanced by one token, the cache
    (``pos`` included) updated in place and returned.

    ``graphs`` (default: on when the model lies on a CUDA device) captures
    the step into one CUDA graph per batch shape, bound to the ``params``
    and ``cache`` it was captured with; another cache captures again.
    Before a shape's first capture the step runs once eagerly on a zeroed
    copy of the cache, to pay first-call costs outside the capture.  The
    graph returns its static logits, overwritten by the next call.
    ``tokens`` are copied into the graph's own input buffer, so any (B,)
    tensor may be passed.  ``trace_hook(tokens)`` fires once per capture
    (the reference: once per trace); eagerly, once per batch shape.

    ``donate`` is implied (the cache is updated in place); ``batch`` and
    ``max_len`` only size the reference's in-shardings.

    With a ``DeviceMesh`` the step runs over DTensor parameters: the
    cache's plain leaves are placed in the dict by ``cache_specs`` on the
    first call, before any warm run or capture (with ``shard_cache_len``
    the cache length over the model axis: each rank holds a slice of every
    row and the decode attention's softmax and context sums meet across
    it), the tokens by ``batch_specs`` (a graph places its input buffer at
    capture), and the logits come back whole."""
    del batch, max_len, donate
    graphs = step_graphs(mesh, graphs, model.device, "build_decode_step")
    rules = {"cache": ("model",)} if shard_cache_len else None
    seen: set = set()
    captured: dict[int, StepGraph] = {}
    pool = torch.cuda.graph_pool_handle() if graphs else None

    @torch.no_grad()
    def step(params, cache, tokens):
        if mesh is not None:
            spec = sharding_rules.batch_specs({"tokens": tokens}, mesh)["tokens"]
            tokens = mesh_ctx.distribute(tokens, mesh, spec)
        logits, new = model.decode_step(params, cache, tokens)
        for name, leaf in new.items():
            if leaf is not cache[name]:
                cache[name].copy_(leaf)
        return mesh_ctx.whole(logits)

    def run(params, cache, tokens):
        b = int(tokens.shape[0])
        if mesh is not None:
            place_cache(cache, mesh, rules)
        if not graphs:
            if b not in seen:
                seen.add(b)
                if trace_hook is not None:
                    trace_hook(tokens)
            return step(params, cache, tokens)
        g = captured.get(b)
        if g is None or not g.binds(params, list(cache.values())):
            if b not in seen:
                seen.add(b)
                step(params, {k: torch.zeros_like(v) for k, v in cache.items()},
                     torch.zeros_like(tokens))
            captured.pop(b, None)
            static = torch.zeros_like(tokens)
            g = captured[b] = StepGraph(lambda: (step(params, cache, static), static),
                                        params=params, tensors=list(cache.values()),
                                        pool=pool)
            if trace_hook is not None:
                trace_hook(tokens)
        g.out[1].copy_(tokens)
        return g.replay()[0]

    def decode(params, cache, tokens):
        if mesh is None:
            return run(params, cache, tokens), cache
        with mesh_ctx.use_mesh(mesh, rules=model.opts.mesh_rules()):
            return run(params, cache, tokens), cache
    return decode


def abstract_sharded_prefill(model, mesh, mode, batch_sds: dict,
                             max_len: Optional[int] = None):
    """``build_prefill_step``'s step over ``mesh`` as a function of this
    rank's local shards, for a dry run's ``make_fx``: ``(fn, shards)``
    (``mesh_ctx.on_local_shards``), the served weights (``model.load`` of
    ``model.abstract``) under ``param_specs``, the batch (``{name: (shape,
    dtype)}``) under ``batch_specs``; fake tensors of ``mode``."""
    from .train_lib import _fake_batch
    step = build_prefill_step(model, mesh, max_len=max_len, graphs=False)
    params, batch = _abstract_served(model, mode), _fake_batch(mode, batch_sds, model.device)
    return mesh_ctx.on_local_shards(
        step, (params, batch), (sharding_rules.param_specs(model.schema(), mesh),
                                sharding_rules.batch_specs(batch, mesh)), mesh, mode)


def abstract_sharded_decode(model, mesh, mode, batch: int, max_len: int,
                            shard_cache_len: bool = False):
    """``build_decode_step``'s step over ``mesh`` as a function of this
    rank's local shards: ``(fn, shards)``, the served weights under
    ``param_specs``, the cache (``model.cache_spec``) under ``cache_specs``
    (its length over the model axis with ``shard_cache_len``) and the
    (batch,) tokens under ``batch_specs``; fake tensors of ``mode``."""
    from .train_lib import _fake_batch
    step = build_decode_step(model, mesh, shard_cache_len=shard_cache_len, graphs=False)
    params = _abstract_served(model, mode)
    cache = _fake_batch(mode, model.cache_spec(batch, max_len), model.device)
    tokens = _fake_batch(mode, {"tokens": ((batch,), torch.int32)}, model.device)["tokens"]
    rules = {"cache": ("model",)} if shard_cache_len else None
    return mesh_ctx.on_local_shards(
        step, (params, cache, tokens),
        (sharding_rules.param_specs(model.schema(), mesh),
         sharding_rules.cache_specs(cache, mesh, rules),
         sharding_rules.batch_specs({"tokens": tokens}, mesh)["tokens"]), mesh, mode)


def _abstract_served(model, mode):
    params = model.abstract(mode)
    with mode:
        return model.load(params)


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
