"""Serving runtime: the prefill/decode step factories, the DSA-planned KV arena
and request traces.

This is where the paper's technique is a first-class serving feature: request
cache slabs are rectangles (size = cache bytes at final length, lifetime =
[admit, finish)), planned with the best-fit heuristic, with §4.3
reoptimization when a request outgrows its profiled length.  Port of
``repro.runtime.serve_lib``.  The reference jits both steps; here the
decode step is captured into one CUDA graph per batch shape on the card
(``runtime.graphs``), and so is the prefill of each padded prompt length;
on the CPU both run eagerly, and so do unpadded prompts everywhere.

Given a ``DeviceMesh`` both steps run eagerly over DTensor parameters
placed by ``sharding_rules.param_specs``, with the mesh and the model's
``RunOpts.mesh_rules()`` installed (``mesh_ctx.use_mesh``), as the
reference's jitted steps run under its in/out shardings: the batch is
placed by ``batch_specs``, the cache by ``cache_specs`` and the logits come
back whole.  Capturing DTensor dispatch in CUDA graphs is not done yet
(ROADMAP queue 1: CUDA graphs under a mesh), so ``graphs=True`` with a mesh
raises.
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


MESH_GRAPHS = "ROADMAP queue 1: CUDA graphs under a mesh"


def mesh_graphs(mesh, graphs: Optional[bool], what: str) -> Optional[bool]:
    """``graphs`` for a step over ``mesh``: None without a mesh; under one
    the steps run eagerly (False), and ``graphs=True`` raises."""
    if mesh is None:
        return graphs
    if graphs:
        raise ValueError(f"{what}: graphs=True under a mesh: capturing DTensor "
                         f"dispatch in CUDA graphs is not done yet ({MESH_GRAPHS})")
    mesh_ctx.check_mesh(mesh, what)
    return False


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

    With graphs a padded prompt's prefill (a batch with ``true_len``)
    replays one CUDA graph per batch shape, bound to the ``params`` it was
    captured with; another ``params`` captures again.  The graphs share
    a graph memory pool of their own, apart from the decode graphs'.
    Before a signature's first capture the step runs once eagerly on the
    graph's own input buffers, to pay first-call costs outside the
    capture.  Each call copies the batch's tokens and ``true_len`` into
    those buffers, so any ``true_len`` of the length replays the same graph
    (the model reads it on the device); the graph returns its static logits
    and cache, which the next replay of that shape overwrites.  A batch
    without ``true_len`` (an unpadded prompt) runs eagerly, and so does one
    with ``frames`` (the encoder-decoder's: no graph holds a frames
    buffer).

    ``trace_hook(batch)`` fires once per capture and, eagerly, once per new
    signature: the reference's jit traces once per such signature.  With
    ``replay_events`` set to a list, each replay appends a pair of CUDA
    events recorded around it (``launch.profile_serve`` times them)."""

    def __init__(self, model, max_len: Optional[int], trace_hook,
                 graphs: Optional[bool], mesh=None):
        self.model = model
        self.mesh = mesh
        self.max_len = max_len
        self.trace_hook = trace_hook
        self.graphs = use_graphs(graphs, model.device)
        self.pool = torch.cuda.graph_pool_handle() if self.graphs else None
        self.n_captures = self.n_replays = 0
        self.replay_events: Optional[list] = None
        self._seen: set = set()
        self._captured: dict = {}      # signature -> (StepGraph, tokens, true_len)

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

    def __call__(self, params, batch):
        tokens = batch["tokens"]
        sig = (tuple(tokens.shape), "true_len" in batch)
        if not (self.graphs and sig[1]) or "frames" in batch:
            if sig not in self._seen:
                self._seen.add(sig)
                self._hook(batch)
            return self._eager(params, batch)
        entry = self._captured.get(sig)
        if entry is None or not entry[0].binds(params, []):
            entry = self._capture(params, batch, sig)
        g, tok_buf, len_buf = entry
        tok_buf.copy_(tokens)
        true_len = batch["true_len"]
        if isinstance(true_len, torch.Tensor):
            len_buf.copy_(true_len)
        else:
            len_buf.fill_(int(true_len))
        self.n_replays += 1
        if self.replay_events is None:
            return g.replay()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = g.replay()
        end.record()
        self.replay_events.append((start, end))
        return out

    def _capture(self, params, batch, sig):
        tokens = batch["tokens"]
        dev = self.model.device
        static = {"tokens": torch.zeros(tokens.shape, dtype=tokens.dtype, device=dev),
                  "true_len": torch.full((tokens.shape[0],), tokens.shape[1],
                                         dtype=torch.int32, device=dev)}
        if sig not in self._seen:
            self._seen.add(sig)
            self._eager(params, static)
        self._captured.pop(sig, None)       # its pool blocks go back first
        g = StepGraph(lambda: self._eager(params, static), params=params,
                      tensors=[], pool=self.pool)
        entry = self._captured[sig] = (g, static["tokens"], static["true_len"])
        self.n_captures += 1
        self._hook(batch)
        return entry

    def stats(self) -> dict:
        return {"graphs": self.graphs, "n_captures": self.n_captures,
                "n_replays": self.n_replays,
                "graph_pool_bytes": pool_bytes(self.pool) if self.graphs else 0}


def build_prefill_step(model, mesh, batch_sds: Optional[dict] = None,
                       max_len: Optional[int] = None, trace_hook=None,
                       graphs: Optional[bool] = None) -> PrefillStep:
    """The prefill step (``PrefillStep``).  ``graphs`` (default: on when the
    model lies on a CUDA device) captures padded prompts; True on another
    device raises ``ValueError``.  With a ``DeviceMesh`` it runs eagerly
    over DTensor parameters, the batch placed by ``batch_specs``, and
    returns the logits whole and the cache placed by ``cache_specs``;
    ``batch_sds`` (the reference's in-sharding shapes) is not needed: the
    batch's own shapes place it."""
    del batch_sds
    graphs = mesh_graphs(mesh, graphs, "build_prefill_step")
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

    With a ``DeviceMesh`` the step runs eagerly over DTensor parameters: the
    cache's plain leaves are placed in the dict by ``cache_specs`` (with
    ``shard_cache_len`` the cache length over the model axis: each rank
    holds a slice of every row and the decode attention's softmax and
    context sums meet across it), the tokens by ``batch_specs``, and the
    logits come back whole."""
    del batch, max_len, donate
    if mesh is not None:
        mesh_graphs(mesh, graphs, "build_decode_step")
        return _mesh_decode(model, mesh, shard_cache_len, trace_hook)
    graphs = use_graphs(graphs, model.device)
    seen: set = set()
    captured: dict[int, StepGraph] = {}
    pool = torch.cuda.graph_pool_handle() if graphs else None

    @torch.no_grad()
    def step(params, cache, tokens):
        logits, new = model.decode_step(params, cache, tokens)
        for name, leaf in new.items():
            if leaf is not cache[name]:
                cache[name].copy_(leaf)
        return logits

    def decode(params, cache, tokens):
        b = int(tokens.shape[0])
        if not graphs:
            if b not in seen:
                seen.add(b)
                if trace_hook is not None:
                    trace_hook(tokens)
            return step(params, cache, tokens), cache
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
        return g.replay()[0], cache
    return decode


def _mesh_decode(model, mesh, shard_cache_len: bool, trace_hook):
    rules = {"cache": ("model",)} if shard_cache_len else None
    seen: set = set()

    @torch.no_grad()
    def decode(params, cache, tokens):
        b = int(tokens.shape[0])
        if b not in seen:
            seen.add(b)
            if trace_hook is not None:
                trace_hook(tokens)
        with mesh_ctx.use_mesh(mesh, rules=model.opts.mesh_rules()):
            place_cache(cache, mesh, rules)
            spec = sharding_rules.batch_specs({"tokens": tokens}, mesh)["tokens"]
            logits, new = model.decode_step(params, cache,
                                            mesh_ctx.distribute(tokens, mesh, spec))
            for name, leaf in new.items():
                if leaf is not cache[name]:
                    cache[name].copy_(leaf)
            return mesh_ctx.whole(logits), cache
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
