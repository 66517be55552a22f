"""Continuous-batching decode engine on the profile-guided paged KV-cache
(port of ``repro.serving.engine``).

The engine owns a waiting queue and admits from it every step
(``GenRequest.arrival`` honored by ``run()``), runs chunked prefill, batched
greedy decode, preempts on page-pool exhaustion, and replans the pool at
epoch boundaries when observed generation lengths outgrow the profile (§4.3
under serving churn).

``cache["pos"]`` is a per-slot position vector, so every row attends and
writes at its own offset no matter when it was admitted.  Decode runs
through the bucketed ``DecodeRunner`` (one CUDA graph per bucket on the
card) or, with ``use_runner=False``, through the full-batch "slab" step of
``serve_lib.build_decode_step``; prompts of pure-attention models are
padded to a power-of-two ladder before prefill, and on the card each rung
replays one CUDA graph captured at ``warmup()`` (a recurrent state would
integrate the pad tokens and MoE capacity would count them, so mamba2,
recurrentgemma and MoE prompts go in unpadded and eagerly, one prefill
shape per prompt length).  ``attn_mode="paged"`` decodes straight off
per-layer page pools through the paged-attention CUDA kernel; prefill
runs the flash kernel when the model's ``RunOpts.attention_impl`` is
``"kernel"`` and the SSD and RG-LRU kernels when ``RunOpts.use_kernels``
is set.

Given a ``DeviceMesh`` the engine serves over DTensor parameters
(``sharding_rules.param_specs``) and a DTensor cache or pool
(``cache_specs`` with the batch axis whole: the host addresses slots, so
each rank holds every slot's rows of its kv heads).  The kernels run on
each rank's shards through ``local_map``.  On the card ``warmup()``
captures every runner bucket and every rung of the prompt ladder under
the mesh, as without one: DTensor's dispatch and the ``local_map`` regions
run at capture, and a replay runs their local kernels.  Prefill's writes
into the slots (``mesh_ctx.write_local``) stay eager, outside any graph.
"""
from __future__ import annotations

import contextlib
import math
import time
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..core.unified import SharedArena
from ..models.transformer import Transformer
from ..obs.metrics import get_registry
from ..obs.trace import get_tracer
from ..runtime import mesh_ctx, sharding_rules
from ..runtime.serve_lib import (Request, build_decode_step, build_prefill_step,
                                 place_cache, step_graphs)
from . import pages as pages_lib
from .metrics import ServeMetrics
from .pages import PagePoolExhausted, PagedKVCache
from .runner import DecodeRunner
from .scheduler import GenRequest, RequestState, ScheduledRequest, Scheduler

PREFILL_BUCKET_MIN = 8          # floor of the power-of-two prompt ladder


class ServeEngine:
    """Queue -> chunked prefill -> batched decode, memory-planned end to end."""

    def __init__(self, model: Transformer, params, *,
                 sample_trace: Sequence[Request], max_len: int,
                 max_batch: int = 8, page_tokens: Optional[int] = None,
                 policy: str = "fcfs", prefill_chunk: int = 512,
                 hbm_budget: Optional[int] = None, reserve_pages: int = 0,
                 accounting_cfg: Optional[ModelConfig] = None,
                 mesh=None, shared: Optional[SharedArena] = None,
                 metrics: Optional[ServeMetrics] = None,
                 use_runner: bool = True,
                 attn_mode: str = "gather",
                 replan_interval: Optional[int] = 64,
                 graphs: Optional[bool] = None):
        """``model`` fixes the device (the card unless it was built with
        ``device="cpu"``); ``params`` are ``model.load``-ed parameters.

        ``accounting_cfg`` lets the page pool account at full-size arch
        scale while a reduced model executes (the launch-driver pattern).
        ``hbm_budget`` caps admission at the largest concurrency whose
        planned pool fits it; ``reserve_pages`` pads the pool.

        ``shared`` (the ``--share-hbm`` path): the page pool becomes the
        serving tenant of a ``SharedArena`` — admission is gated against the
        tenant's share of the joint budget (register any training tenant on
        the arena *before* constructing the engine, so the first joint plan
        sees both workloads).

        ``use_runner=False`` decodes every slot each step through the
        full-batch "slab" step (the reference's baseline).

        ``attn_mode="paged"`` executes decode straight off per-layer page
        pools: the PagedKVCache's exec page tables address the pools inside
        the attention kernel, so no contiguous per-request KV copy ever
        materializes.  It needs the runner and a pure-attention model.

        ``replan_interval``: close a §4.3 epoch every this many steps even
        under sustained load (None: only when fully idle).

        ``graphs`` (the port's counterpart of the reference runner's
        ``donate`` and of its jitted prefill): decode, and prefill each
        rung of the prompt ladder, through CUDA graphs; None means on when
        the model lies on a CUDA device, False runs the same steps eagerly.

        ``mesh`` (a ``DeviceMesh``): serve sharded, with graphs as without
        one (the module's docstring); ``params`` may be plain (placed here)
        or DTensors.  An encoder-decoder ``model`` raises ``ValueError``:
        the engine, like the reference's, has no path for encoder frames."""
        if model.cfg.is_encoder_decoder:
            raise ValueError(
                f"ServeEngine: {model.cfg.name} is an encoder-decoder and the "
                "engine has no path for encoder frames (the reference's prefill "
                "batch holds tokens only); serve it through runtime.serve_lib's "
                "build_prefill_step and build_decode_step with a batch of "
                '{"tokens", "frames"}')
        self.mesh = mesh
        self.graphs = step_graphs(mesh, graphs, model.device, "ServeEngine")
        if mesh is not None:
            params = sharding_rules.distribute_tree(
                params, sharding_rules.param_specs(model.schema(), mesh), mesh)
        self.model = model
        self.params = params
        self.device = model.device
        self.max_len = max_len
        self.max_batch = max_batch
        acct = accounting_cfg or model.cfg
        self._acct = acct
        self._sample_trace = list(sample_trace)
        self.kv = PagedKVCache(acct, sample_trace, page_tokens=page_tokens,
                               reserve_pages=reserve_pages, shared=shared)
        if hbm_budget is None and self.kv.tenant is not None:
            # unified mode: the HBM gate is this tenant's share of the split
            hbm_budget = self.kv.tenant.budget
        cap = None
        if hbm_budget is not None:
            cap = pages_lib.max_concurrency(acct, sample_trace,
                                            self.kv.page_tokens, hbm_budget,
                                            hi=max_batch)
        self.sched = Scheduler(self.kv, max_batch=max_batch, policy=policy,
                               max_concurrency=cap, prefill_chunk=prefill_chunk)
        self.metrics = metrics if metrics is not None else ServeMetrics()
        cfg = model.cfg
        self._pad_prefill = self.pads_prefill(cfg)
        self.prefill = build_prefill_step(model, mesh,
                                          trace_hook=self._on_prefill_trace,
                                          graphs=self.graphs)
        self.runner = self.decode = None
        if use_runner:
            self.runner = DecodeRunner(model, max_batch=max_batch,
                                       graphs=self.graphs)
        else:
            self.decode = build_decode_step(model, mesh, donate=False,
                                            trace_hook=self._on_decode_trace,
                                            graphs=self.graphs)
        self.replan_interval = replan_interval
        self.prefill_compiles = 0
        self.prefill_calls = 0
        self.prefill_time_s = 0.0
        self.decode_compiles = 0
        self.decode_steps = 0
        self.decode_time_s = 0.0
        if attn_mode not in ("gather", "paged"):
            raise ValueError(f"unknown attn_mode {attn_mode!r}")
        self.attn_mode = attn_mode
        if attn_mode == "paged":
            if not use_runner:
                raise ValueError(
                    "attn_mode='paged' requires use_runner=True: the "
                    "full-batch decode advances every slot, so stale rows "
                    "would scatter their KV into page 0")
            if not self._pad_prefill:
                raise ValueError(
                    "attn_mode='paged' needs a pure-attention decoder "
                    f"(pattern {cfg.block_pattern}, tail {cfg.tail_pattern})")
            ept = self.kv.page_tokens
            # +1 page: the exec grant runs one token ahead of accounting
            # (decode writes position T before append_token commits T+1)
            self._pages_per_req = math.ceil(max_len / ept) + 1
            self._pool_pages = max_batch * self._pages_per_req
            self.cache = model.init_paged_cache(
                max_batch, n_pages=self._pool_pages, page_tokens=ept,
                pages_per_req=self._pages_per_req)
            self._slot_pages = [0] * max_batch  # synced table-row lengths
        else:
            self.cache = model.init_cache(max_batch, max_len)
        if mesh is not None:
            place_cache(self.cache, mesh, rules={"batch": ()})
        self.tokens = torch.zeros((max_batch,), dtype=torch.int32,
                                  device=self.device)
        self.step_count = 0
        self.completed: dict[int, list[int]] = {}

    # -- compile accounting (the reference's trace-time hooks) --------------------
    def _on_prefill_trace(self, batch) -> None:
        self.prefill_compiles += 1
        reg = get_registry()
        if reg is not None:
            reg.counter("prefill_compile_total",
                        "prefill shapes first seen").inc()
        t = get_tracer()
        if t is not None:
            t.instant("compile", "serving", track="prefill",
                      seq=int(batch["tokens"].shape[1]),
                      total=self.prefill_compiles)

    def _on_decode_trace(self, tokens) -> None:
        self.decode_compiles += 1
        t = get_tracer()
        if t is not None:
            t.instant("compile", "serving", track="decode",
                      batch=int(tokens.shape[0]), total=self.decode_compiles)

    def _sync_device(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @staticmethod
    def pads_prefill(cfg: ModelConfig) -> bool:
        """Prompt padding is exact only when every cache is positional
        attention (recurrent state integrates pad tokens; MoE capacity
        counts them into expert load).  The same pure-attention decoder is
        what ``attn_mode="paged"`` needs: its pools store K/V only."""
        return (set(cfg.block_pattern) | set(cfg.tail_pattern) <= {"attn"}
                and not cfg.is_encoder_decoder and not cfg.n_experts)

    def prefill_rungs(self) -> list[int]:
        """The padded prompt lengths, ascending: powers of two from
        PREFILL_BUCKET_MIN, capped at ``max_len``; none when prompts go in
        unpadded."""
        rungs, padded = [], PREFILL_BUCKET_MIN
        while self._pad_prefill:
            rungs.append(min(padded, self.max_len))
            if padded >= self.max_len:
                break
            padded *= 2
        return rungs

    def warmup(self) -> None:
        """Warm (and on the card capture) every runner bucket and every rung
        of the prompt ladder, largest first (on the card the smaller rungs'
        graphs reuse the prefill pool's memory), so the serving loop sees no
        first-call cost and captures nothing: the compile counters stay
        flat from step 0.  Unpadded (recurrent or MoE) prompts have no
        ladder to warm."""
        if self.runner is not None:
            with self._in_mesh():
                self.runner.warmup(self.params, self.cache, self.tokens)
        for p in reversed(self.prefill_rungs()):
            self.prefill(self.params,
                         {"tokens": torch.zeros((1, p), dtype=torch.int32,
                                                device=self.device),
                          "true_len": self._true_len(p)})
        self._sync_device()

    def _true_len(self, n: int) -> torch.Tensor:
        """A prompt's true length as a 0-d device tensor (the reference's
        traced scalar), filled on the device: no host copy."""
        return torch.full((), n, dtype=torch.int32, device=self.device)

    # -- queue --------------------------------------------------------------------
    def enqueue(self, req: GenRequest) -> None:
        self.sched.enqueue(req)
        self.metrics.on_enqueue(req.rid, int(req.prompt.shape[0]),
                                self.step_count)
        t = get_tracer()
        if t is not None:
            t.set_step(self.step_count)
            t.instant("enqueue", "serving", track="queue", rid=req.rid,
                      prompt_len=int(req.prompt.shape[0]),
                      queue_depth=self.sched.queue_depth)

    @property
    def n_active(self) -> int:
        return self.sched.n_active

    # -- one engine step ------------------------------------------------------------
    def _in_mesh(self):
        """The engine's mesh installed (``mesh_ctx.use_mesh``), or nothing."""
        if self.mesh is None:
            return contextlib.nullcontext()
        return mesh_ctx.use_mesh(self.mesh, rules=self.model.opts.mesh_rules())

    def step(self) -> None:
        with self._in_mesh():
            self._step()

    def _step(self) -> None:
        t = get_tracer()
        if t is not None:
            t.set_step(self.step_count)
        for sr in self.sched.admit(self.step_count):
            self.metrics.on_admit(sr.rid, self.step_count)
        for sr in self.sched.prefill_batch():
            if sr.state is RequestState.RUNNING:    # not preempted by an
                self._model_prefill(sr)             # earlier grow this step
        self._decode_running()
        self.metrics.on_step(concurrent=self.sched.n_active,
                             occupancy=self.kv.occupancy(),
                             queue_depth=self.sched.queue_depth)
        self.step_count += 1
        if self.sched.idle:
            self.kv.reset_epoch()       # epoch boundary: §4.3 replan if dirty
            self._refresh_cap()
        elif (self.replan_interval
              and self.step_count % self.replan_interval == 0):
            self.kv.reset_epoch()       # sustained load: close on a clock
            self._refresh_cap()

    def _refresh_cap(self) -> None:
        """Unified mode: a boundary replan may have rebalanced the split, so
        re-gate admission against the serving tenant's current share."""
        if self.kv.tenant is None:
            return
        cap = pages_lib.max_concurrency(self._acct, self._sample_trace,
                                        self.kv.page_tokens,
                                        self.kv.tenant.budget,
                                        hi=self.max_batch)
        self.sched.cap = max(1, min(self.max_batch, cap))

    def _prefill_batch(self, prompt) -> dict:
        """Pad the prompt to the smallest rung of the ladder that holds it
        (``prefill_rungs``) so prefill sees O(log max_len) shapes, each a
        CUDA graph on the card.  The padded tail is exact: logits are read
        at ``true_len - 1`` and decode masks cache positions >=
        ``true_len`` until they are overwritten.  Without ``_pad_prefill``,
        or past ``max_len`` (no rung holds it), the prompt goes in as it is,
        without ``true_len``, and prefills eagerly."""
        prompt = torch.as_tensor(prompt, dtype=torch.int32).to(self.device)
        s = int(prompt.shape[0])
        if not self._pad_prefill or s > self.max_len:
            return {"tokens": prompt[None, :]}
        padded = next(r for r in self.prefill_rungs() if r >= s)
        return {"tokens": F.pad(prompt, (0, padded - s))[None, :],
                "true_len": self._true_len(s)}

    def _model_prefill(self, sr: ScheduledRequest) -> None:
        self.metrics.n_prefill_tokens += sr.prompt_len
        t = get_tracer()
        if t is not None:
            t.instant("prefill", "serving", track="engine", rid=sr.rid,
                      prompt_len=sr.prompt_len, slot=sr.slot)
        t0 = time.perf_counter()
        # a padded prompt's logits and cache1 may be a prefill graph's static
        # outputs: the merge copies them and the argmax reads them, in stream
        # order before the next replay overwrites them; nothing keeps them
        # (a preempted request prefills again)
        logits, cache1 = self.prefill(self.params,
                                      self._prefill_batch(sr.req.prompt))
        if self.attn_mode == "paged":
            self._merge_paged(cache1, sr)
        else:
            _merge_slot(self.cache, cache1, sr.slot)
        tok = int(logits[0].argmax())     # syncs: the merge is attributed here
        self.prefill_time_s += time.perf_counter() - t0
        self.prefill_calls += 1
        self.tokens[sr.slot] = tok
        if not self._grow(sr):          # prefill already yields one token
            return
        sr.out.append(tok)
        self.metrics.on_first_token(sr.rid, self.step_count)
        self.metrics.on_token(sr.rid)
        if sr.remaining <= 0:
            self._finish(sr)

    def _decode_running(self) -> None:
        running = sorted(self.sched.running(), key=lambda s: s.slot)
        if not running:
            return
        t = get_tracer()
        if t is not None:
            t.instant("decode", "serving", track="engine",
                      n_running=len(running))
        t0 = time.perf_counter()
        slots = [sr.slot for sr in running]
        if self.runner is not None:
            # nxt arrives as host ints (step_greedy blocks on the transfer)
            nxt, self.tokens, self.cache = self.runner.step_greedy(
                self.params, self.cache, self.tokens, slots)
            by_slot = {slot: i for i, slot in enumerate(slots)}
        else:
            # the slab step advances every slot; read the running ones
            logits, self.cache = self.decode(self.params, self.cache,
                                             self.tokens)
            self.tokens.copy_(logits.argmax(dim=-1))
            nxt = self.tokens.cpu().numpy()     # one blocking transfer
            by_slot = {slot: slot for slot in slots}
        self.decode_time_s += time.perf_counter() - t0
        self.decode_steps += 1
        for sr in running:
            if sr.state is not RequestState.RUNNING:
                continue                # preempted by an earlier grow this step
            if not self._grow(sr):
                continue                # sr itself was the preemption victim
            sr.out.append(int(nxt[by_slot[sr.slot]]))
            self.metrics.on_token(sr.rid)
            if sr.remaining <= 0:
                self._finish(sr)

    def _table_row(self, row: list[int]) -> torch.Tensor:
        arr = torch.zeros((self._pages_per_req,), dtype=torch.int32)
        arr[:len(row)] = torch.tensor(row, dtype=torch.int32)
        return arr.to(self.device)

    def _merge_paged(self, cache1, sr: ScheduledRequest) -> None:
        """Install one request into the paged cache: position clock, exec
        page-table row, and the prefill KV cut into page_tokens chunks and
        written to the granted pool pages in place.  The padded prompt tail
        (ladder padding past ``true_len``) lands in granted pages where the
        per-row position mask hides it until decode overwrites it."""
        ept = self.kv.page_tokens
        row = self.kv.exec_table(sr.rid)
        n_rowp = len(row)
        ids = torch.tensor(row, dtype=torch.long, device=self.device)
        _put_row(self.cache["pos"], sr.slot, cache1["pos"][0])
        _put_row(self.cache["block_tables"], sr.slot, self._table_row(row))
        want = n_rowp * ept

        def put(pages, x, offsets):     # x (L,1,S,kv,hd) -> (L,n_rowp,ept,kv,hd)
            del offsets
            x = x[:, 0]
            s = x.shape[1]
            if s < want:
                x = F.pad(x, (0, 0, 0, 0, 0, want - s))
            elif s > want:          # ladder padding past the granted pages
                x = x[:, :want]
            pages[:, ids] = x.reshape(x.shape[0], n_rowp, ept, *x.shape[2:])

        for name in ("k", "v"):
            mesh_ctx.write_local(self.cache[f"{name}_pages"],
                                 [(cache1[name], {3: 3, 4: 4})], put)
        self._slot_pages[sr.slot] = n_rowp

    def _sync_table_row(self, sr: ScheduledRequest) -> None:
        """Mirror an exec-table growth into the device block-table row (a
        no-op in steady state: rows only change when a page is granted)."""
        row = self.kv.exec_table(sr.rid)
        if len(row) == self._slot_pages[sr.slot]:
            return
        if len(row) > self._pages_per_req or max(row) >= self._pool_pages:
            raise RuntimeError(f"exec table {row} outgrew the pool of "
                               f"{self._pool_pages} pages")
        _put_row(self.cache["block_tables"], sr.slot, self._table_row(row))
        self._slot_pages[sr.slot] = len(row)

    def _grow(self, sr: ScheduledRequest) -> bool:
        """Account one generated token; preempt the youngest request until the
        growth page fits.  Returns False if ``sr`` itself was evicted."""
        while True:
            try:
                self.kv.append_token(sr.rid)
                if self.attn_mode == "paged":
                    self._sync_table_row(sr)
                return True
            except PagePoolExhausted:
                self.kv.request_replan()    # observed lengths outgrew the plan
                if self.sched.n_active <= 1:
                    # no other victim: grow the pool rather than thrash
                    self.kv.ensure_free(1)
                    continue
                victim = self.sched.preempt_victim()
                self.metrics.on_preempt(victim.rid,
                                        discarded_tokens=len(victim.out))
                t = get_tracer()
                if t is not None:
                    t.instant("preempt", "serving", track="scheduler",
                              rid=victim.rid, grower=sr.rid,
                              discarded=len(victim.out))
                if victim.rid == sr.rid:
                    return False

    def _finish(self, sr: ScheduledRequest) -> None:
        self.completed[sr.rid] = sr.out
        self.sched.finish(sr)
        self.metrics.on_finish(sr.rid, self.step_count)
        t = get_tracer()
        if t is not None:
            t.instant("finish", "serving", track="engine", rid=sr.rid,
                      n_tokens=len(sr.out), n_preempt=sr.n_preempt)

    # -- drive a whole trace ----------------------------------------------------------
    def run(self, requests: Sequence[GenRequest],
            max_steps: int = 100_000) -> dict:
        """Feed requests by ``arrival`` step and run until everything drains."""
        pending = sorted(requests, key=lambda r: (r.arrival, r.rid))
        while pending or not self.sched.idle:
            while pending and pending[0].arrival <= self.step_count:
                self.enqueue(pending.pop(0))
            self.step()
            if self.step_count >= max_steps:
                raise RuntimeError(f"engine did not drain in {max_steps} steps")
        return self.metrics.summary(self.kv.stats())


def _merge_slot(batched_cache: dict, single_cache: dict, slot: int) -> None:
    """Copy one request's prefill cache into slot ``slot`` of the batch cache
    in place: its position clock, and every per-layer leaf's row (batch axis
    1).  K/V rows are zero past the prompt; the state rows (mamba2
    ``conv``/``ssm``, RG-LRU ``conv``/``h``) have the same shape on both
    sides and are copied whole.  A local layer's rolling K/V window arrives
    with length min(prompt, window): a prompt shorter than the window fills
    indices [0, S) and the rest is zeroed; a longer one fills the whole
    window in rolling order (position t at t % window)."""
    _put_row(batched_cache["pos"], slot, single_cache["pos"][0])

    def put(leaf, src, offsets):
        del offsets
        row = leaf[:, slot]                         # (L, ...) view
        src = src[:, 0]
        if src.shape != row.shape:                  # K/V: prompt vs max_len
            n = min(src.shape[1], row.shape[1])
            row[:, n:] = 0
            src = src[:, :n]
        row[:, :src.shape[1]] = src
    for name, leaf in batched_cache.items():
        if name != "pos":                           # every dim but the batch's
            mesh_ctx.write_local(leaf, [(single_cache[name], {
                d: d for d in range(leaf.ndim) if d != 1})], put)


def _put_row(leaf, slot: int, row) -> None:
    """``leaf[slot] = row`` in place (a slot's position or page-table row);
    under a mesh on the local tensor of a leaf whose slots no rank splits."""
    def put(dst, src, offsets):
        del offsets
        dst[slot] = src
    mesh_ctx.write_local(leaf, [(row, {d + 1: d for d in range(leaf.ndim - 1)})], put)
