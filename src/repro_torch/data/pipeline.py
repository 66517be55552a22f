"""Deterministic synthetic data pipeline with per-host sharding + prefetch
(copy of ``repro.data.pipeline``: numpy only, so its batches are
byte-identical to the reference's for the same seed and step).

Determinism contract: the batch for (step, host) is a pure function of
(seed, step, host) — a restarted or replaced host regenerates exactly the
data it would have seen, which is what makes checkpoint-restart and elastic
re-sharding bit-exact (runtime/fault.py tests this).

Tokens are Zipf-distributed so CE losses move like real text rather than
uniform noise.  Staging buffers come from a DSA-planned host arena — the
paper's allocator applied to the input path.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

from ..core import ArenaAllocator, MemoryRecorder


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0
    zipf_a: float = 1.2
    frames: int = 0            # >0: also emit (B, frames, frame_dim) features
    frame_dim: int = 0
    prefetch: int = 2


class SyntheticPipeline:
    def __init__(self, cfg: DataConfig):
        assert cfg.global_batch % cfg.n_hosts == 0, "batch must split over hosts"
        self.cfg = cfg
        self.local_batch = cfg.global_batch // cfg.n_hosts
        # Zipf-ish rank distribution over the vocab (stable across processes).
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        p = 1.0 / np.power(ranks, cfg.zipf_a)
        self._cdf = np.cumsum(p / p.sum())
        self._staging = self._plan_staging()

    # -- the paper's allocator on the host staging path ------------------------
    def _plan_staging(self) -> ArenaAllocator:
        cfg = self.cfg
        rec = MemoryRecorder()
        tok_bytes = self.local_batch * (cfg.seq_len + 1) * 4
        ids = [rec.on_alloc(tok_bytes, tag="tokens")]
        if cfg.frames:
            ids.append(rec.on_alloc(
                self.local_batch * cfg.frames * cfg.frame_dim * 4, tag="frames"))
        for i in ids:
            rec.on_free(i)
        return ArenaAllocator(rec.finish())

    def batch_at(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, cfg.host_id]))
        u = rng.random((self.local_batch, cfg.seq_len + 1))
        tokens = np.searchsorted(self._cdf, u).astype(np.int32)
        np.clip(tokens, 0, cfg.vocab_size - 1, out=tokens)
        batch = {"tokens": tokens}
        if cfg.frames:
            batch["frames"] = rng.standard_normal(
                (self.local_batch, cfg.frames, cfg.frame_dim)).astype(np.float32)
        return batch

    # -- prefetching iterator ----------------------------------------------------
    def __iter__(self) -> Iterator[dict]:
        return self.iterate(0)

    def iterate(self, start_step: int, stop_step: Optional[int] = None):
        q: queue.Queue = queue.Queue(maxsize=self.cfg.prefetch)
        stop = threading.Event()

        def producer():
            step = start_step
            while not stop.is_set() and (stop_step is None or step < stop_step):
                q.put((step, self.batch_at(step)))
                step += 1
            q.put(None)

        th = threading.Thread(target=producer, daemon=True)
        th.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                yield item
        finally:
            stop.set()
