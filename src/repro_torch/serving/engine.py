"""Continuous-batching decode engine on the profile-guided paged KV-cache
(port of ``repro.serving.engine``).

The engine owns a waiting queue and admits from it every step
(``GenRequest.arrival`` honored by ``run()``), runs chunked prefill, batched
greedy decode, preempts on page-pool exhaustion, and replans the pool at
epoch boundaries when observed generation lengths outgrow the profile (§4.3
under serving churn).

``cache["pos"]`` is a per-slot position vector, so every row attends and
writes at its own offset no matter when it was admitted.  Decode runs
through the bucketed ``DecodeRunner``; prompts are padded to a power-of-two
ladder before prefill.  ``attn_mode="paged"`` decodes straight off per-layer
page pools through the paged-attention CUDA kernel; prefill runs the flash
kernel when the model's ``RunOpts.attention_impl`` is ``"kernel"``.
"""
from __future__ import annotations

import math
import time
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..models.transformer import Transformer
from ..obs.metrics import get_registry
from ..obs.trace import get_tracer
from ..runtime.serve_lib import Request
from .metrics import ServeMetrics
from .pages import PagePoolExhausted, PagedKVCache
from .runner import DecodeRunner
from .scheduler import GenRequest, RequestState, ScheduledRequest, Scheduler

PREFILL_BUCKET_MIN = 8          # floor of the power-of-two prompt ladder
# close a §4.3 epoch every this many steps even under sustained load (an
# engine that never goes idle would otherwise starve decode-outrun replans)
REPLAN_INTERVAL = 64


class ServeEngine:
    """Queue -> chunked prefill -> batched decode, memory-planned end to end."""

    def __init__(self, model: Transformer, params, *,
                 sample_trace: Sequence[Request], max_len: int,
                 max_batch: int = 8, page_tokens: Optional[int] = None,
                 policy: str = "fcfs", prefill_chunk: int = 512,
                 accounting_cfg: Optional[ModelConfig] = None,
                 attn_mode: str = "gather"):
        """``model`` fixes the device (the card unless it was built with
        ``device="cpu"``); ``params`` are ``model.load``-ed parameters.

        ``accounting_cfg`` lets the page pool account at full-size arch
        scale while a reduced model executes (the launch-driver pattern).

        ``attn_mode="paged"`` executes decode straight off per-layer page
        pools: the PagedKVCache's exec page tables address the pools inside
        the attention kernel, so no contiguous per-request KV copy ever
        materializes."""
        self.model = model
        self.params = params
        self.device = model.device
        self.max_len = max_len
        self.max_batch = max_batch
        acct = accounting_cfg or model.cfg
        self.kv = PagedKVCache(acct, sample_trace, page_tokens=page_tokens)
        self.sched = Scheduler(self.kv, max_batch=max_batch, policy=policy,
                               prefill_chunk=prefill_chunk)
        self.metrics = ServeMetrics()
        self.runner = DecodeRunner(model, max_batch=max_batch)
        self._prefill_shapes: set = set()
        self.prefill_compiles = 0
        self.prefill_calls = 0
        self.prefill_time_s = 0.0
        self.decode_steps = 0
        self.decode_time_s = 0.0
        if attn_mode not in ("gather", "paged"):
            raise ValueError(f"unknown attn_mode {attn_mode!r}")
        self.attn_mode = attn_mode
        if attn_mode == "paged":
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
        self.tokens = torch.zeros((max_batch,), dtype=torch.int32,
                                  device=self.device)
        self.step_count = 0
        self.completed: dict[int, list[int]] = {}

    # -- prefill shape accounting (the reference's trace-time hook) ---------------
    def _prefill(self, batch) -> tuple:
        """Run the model's prefill; count each new padded prompt shape once
        (the reference counts jit retraces, one per shape signature)."""
        sig = (int(batch["tokens"].shape[1]), "true_len" in batch)
        if sig not in self._prefill_shapes:
            self._prefill_shapes.add(sig)
            self.prefill_compiles += 1
            reg = get_registry()
            if reg is not None:
                reg.counter("prefill_compile_total",
                            "prefill shapes first seen").inc()
            t = get_tracer()
            if t is not None:
                t.instant("compile", "serving", track="prefill", seq=sig[0],
                          total=self.prefill_compiles)
        return self.model.prefill(self.params, batch)

    def _sync_device(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warmup(self) -> None:
        """Warm every runner bucket and every prefill ladder shape, so the
        serving loop sees no first-call cost and the compile counters stay
        flat from step 0."""
        self.runner.warmup(self.params, self.cache, self.tokens)
        padded = PREFILL_BUCKET_MIN
        while True:
            p = min(padded, self.max_len)
            self._prefill({"tokens": torch.zeros((1, p), dtype=torch.int32,
                                                 device=self.device),
                           "true_len": p})
            if p >= self.max_len:
                break
            padded *= 2
        self._sync_device()

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
    def step(self) -> None:
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
        elif self.step_count % REPLAN_INTERVAL == 0:
            self.kv.reset_epoch()       # sustained load: close on a clock

    def _prefill_batch(self, prompt) -> dict:
        """Pad the prompt to a power-of-two ladder so prefill sees
        O(log max_len) shapes.  The padded tail is exact: logits are read at
        ``true_len - 1`` and decode masks cache positions >= ``true_len``
        until they are overwritten."""
        prompt = torch.as_tensor(prompt, dtype=torch.int32).to(self.device)
        s = int(prompt.shape[0])
        padded = PREFILL_BUCKET_MIN
        while padded < s:
            padded *= 2
        padded = min(padded, self.max_len) if self.max_len >= s else s
        return {"tokens": F.pad(prompt, (0, padded - s))[None, :],
                "true_len": s}

    def _model_prefill(self, sr: ScheduledRequest) -> None:
        self.metrics.n_prefill_tokens += sr.prompt_len
        t = get_tracer()
        if t is not None:
            t.instant("prefill", "serving", track="engine", rid=sr.rid,
                      prompt_len=sr.prompt_len, slot=sr.slot)
        t0 = time.perf_counter()
        logits, cache1 = self._prefill(self._prefill_batch(sr.req.prompt))
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
        # nxt arrives as host ints (step_greedy blocks on the transfer)
        nxt, self.tokens, self.cache = self.runner.step_greedy(
            self.params, self.cache, self.tokens, slots)
        by_slot = {slot: i for i, slot in enumerate(slots)}
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
        self.cache["pos"][sr.slot] = cache1["pos"][0]
        self.cache["block_tables"][sr.slot] = self._table_row(row)
        want = n_rowp * ept

        def cut(x):                 # (L,1,S,kv,hd) -> (L,n_rowp,ept,kv,hd)
            x = x[:, 0]
            s = x.shape[1]
            if s < want:
                x = F.pad(x, (0, 0, 0, 0, 0, want - s))
            elif s > want:          # ladder padding past the granted pages
                x = x[:, :want]
            return x.reshape(x.shape[0], n_rowp, ept, *x.shape[2:])

        self.cache["k_pages"][:, ids] = cut(cache1["k"])
        self.cache["v_pages"][:, ids] = cut(cache1["v"])
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
        self.cache["block_tables"][sr.slot] = self._table_row(row)
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
    in place: its position clock and its K/V rows, zero past the prompt."""
    batched_cache["pos"][slot] = single_cache["pos"][0]
    for name in ("k", "v"):
        row = batched_cache[name][:, slot]          # (L, C, kv, hd) view
        src = single_cache[name][:, 0]
        n = min(src.shape[1], row.shape[1])
        row[:, :n] = src[:, :n]
        row[:, n:] = 0
