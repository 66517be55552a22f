"""Serving telemetry: per-request latency + engine/pool counters.

Step-indexed (deterministic, test-friendly) and wall-clock (throughput)
views of the same run.  ``summary()`` is the machine-readable record the
benchmarks dump into ``BENCH_serving.json``.

Scalar counters live in a ``repro_torch.obs.metrics.MetricsRegistry`` (pass one in
to aggregate several engines into a single scrape; by default each
ServeMetrics owns a private registry exposed as ``.registry``), so a run can
be exported as Prometheus text without touching ``summary()``.  Wall time
comes from an injectable ``clock`` callable — inject a
``repro_torch.obs.metrics.ManualClock`` to make throughput numbers reproducible.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional

from ..obs.metrics import MetricsRegistry, get_registry

TTFT_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512)
QUEUE_BUCKETS = (0, 1, 2, 4, 8, 16, 32, 64, 128)


@dataclass
class RequestMetrics:
    rid: int
    prompt_len: int
    enqueue_step: int
    admit_step: Optional[int] = None
    first_token_step: Optional[int] = None
    finish_step: Optional[int] = None
    n_preempt: int = 0
    n_generated: int = 0

    @property
    def ttft_steps(self) -> Optional[int]:
        if self.first_token_step is None:
            return None
        return self.first_token_step - self.enqueue_step

    @property
    def queue_steps(self) -> Optional[int]:
        if self.admit_step is None:
            return None
        return self.admit_step - self.enqueue_step


class ServeMetrics:
    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 clock: Optional[Callable[[], float]] = None):
        if registry is None:
            # aggregate into the driver-installed registry when one is
            # active (benchmarks/run.py --metrics); else stay private
            registry = get_registry()
        self.registry = registry if registry is not None else MetricsRegistry()
        self._clock = clock if clock is not None else time.perf_counter
        self.requests: dict[int, RequestMetrics] = {}
        self.occupancy_samples: list[float] = []
        self.queue_depth_samples: list[int] = []
        self._t0 = self._clock()
        self._wall = 0.0
        r = self.registry
        self._c_steps = r.counter(
            "serve_steps_total", "engine steps run")
        self._c_decode = r.counter(
            "serve_decode_tokens_total", "tokens produced by batched decode")
        self._c_prefill = r.counter(
            "serve_prefill_tokens_total", "prompt tokens processed (chunked)")
        self._c_preempt = r.counter(
            "serve_preemptions_total", "preemptions on page-pool exhaustion")
        self._c_discard = r.counter(
            "serve_discarded_tokens_total",
            "generated tokens discarded by preemption (recompute-on-resume)")
        self._c_enqueued = r.counter(
            "serve_requests_total", "requests enqueued")
        self._c_completed = r.counter(
            "serve_requests_completed_total", "requests finished")
        self._g_concurrent = r.gauge(
            "serve_concurrent", "active requests at the last step")
        self._g_concurrent_max = r.gauge(
            "serve_concurrent_max", "high-water mark of active requests")
        self._g_occupancy = r.gauge(
            "serve_page_occupancy", "page-pool occupancy at the last step")
        self._h_ttft = r.histogram(
            "serve_ttft_steps", "steps from enqueue to first token",
            buckets=TTFT_BUCKETS)
        self._h_queue = r.histogram(
            "serve_queue_depth", "waiting-queue depth sampled per step",
            buckets=QUEUE_BUCKETS)
        # a shared registry aggregates counters across engines (that is the
        # point of the scrape); this instance's own view must stay
        # per-engine even when several engines write the same registry, so
        # the summary fields are plain local tallies and the registry
        # counters are incremented alongside for export only
        self._n_steps = 0
        self._n_decode = 0
        self._n_prefill = 0
        self._n_preempt = 0
        self._n_discard = 0
        self._max_concurrent = 0

    # per-engine views of the old dataclass fields (engine mutates
    # ``n_prefill_tokens`` in place, hence the setter)
    @property
    def n_steps(self) -> int:
        return self._n_steps

    @property
    def n_decode_tokens(self) -> int:
        return self._n_decode

    @property
    def n_prefill_tokens(self) -> int:
        return self._n_prefill

    @n_prefill_tokens.setter
    def n_prefill_tokens(self, value: int) -> None:
        self._c_prefill.inc(value - self._n_prefill)
        self._n_prefill = value

    @property
    def n_preemptions(self) -> int:
        return self._n_preempt

    @property
    def n_discarded_tokens(self) -> int:
        return self._n_discard

    @property
    def max_concurrent(self) -> int:
        return self._max_concurrent

    # -- recording ---------------------------------------------------------------
    def on_enqueue(self, rid: int, prompt_len: int, step: int) -> None:
        self.requests[rid] = RequestMetrics(rid=rid, prompt_len=prompt_len,
                                            enqueue_step=step)
        self._c_enqueued.inc()

    def on_admit(self, rid: int, step: int) -> None:
        r = self.requests[rid]
        if r.admit_step is None:
            r.admit_step = step

    def on_first_token(self, rid: int, step: int) -> None:
        r = self.requests[rid]
        if r.first_token_step is None:
            r.first_token_step = step
            self._h_ttft.observe(r.ttft_steps)

    def on_token(self, rid: int) -> None:
        self.requests[rid].n_generated += 1
        self._n_decode += 1
        self._c_decode.inc()

    def on_preempt(self, rid: int, discarded_tokens: int = 0) -> None:
        """``discarded_tokens``: generated output thrown away by the eviction
        (recompute-on-resume), so throughput can separate work from goodput."""
        self.requests[rid].n_preempt += 1
        self._n_preempt += 1
        self._n_discard += discarded_tokens
        self._c_preempt.inc()
        self._c_discard.inc(discarded_tokens)

    def on_finish(self, rid: int, step: int) -> None:
        self.requests[rid].finish_step = step
        self._c_completed.inc()

    def on_step(self, concurrent: int, occupancy: float,
                queue_depth: int) -> None:
        self._n_steps += 1
        self._c_steps.inc()
        self._max_concurrent = max(self._max_concurrent, concurrent)
        self._g_concurrent.set(concurrent)
        self._g_concurrent_max.set_max(concurrent)
        self._g_occupancy.set(occupancy)
        self._h_queue.observe(queue_depth)
        self.occupancy_samples.append(occupancy)
        self.queue_depth_samples.append(queue_depth)
        self._wall = self._clock() - self._t0

    # -- reporting ---------------------------------------------------------------
    def summary(self, kv_stats: Optional[dict] = None) -> dict:
        done = [r for r in self.requests.values() if r.finish_step is not None]
        ttfts = [r.ttft_steps for r in done if r.ttft_steps is not None]
        wall = max(self._wall, 1e-9)
        out = {
            "n_requests": len(self.requests),
            "n_completed": len(done),
            "n_steps": self.n_steps,
            "wall_s": self._wall,
            "tokens": self.n_decode_tokens,
            "tokens_per_s": self.n_decode_tokens / wall,
            "tokens_discarded": self.n_discarded_tokens,
            "goodput_tokens_per_s":
                (self.n_decode_tokens - self.n_discarded_tokens) / wall,
            "prefill_tokens": self.n_prefill_tokens,
            "ttft_steps_mean": sum(ttfts) / len(ttfts) if ttfts else None,
            "ttft_steps_max": max(ttfts) if ttfts else None,
            "max_concurrent": self.max_concurrent,
            "n_preemptions": self.n_preemptions,
            "occupancy_peak": max(self.occupancy_samples, default=0.0),
            "occupancy_mean": (sum(self.occupancy_samples)
                               / len(self.occupancy_samples)
                               if self.occupancy_samples else 0.0),
        }
        if kv_stats:
            out.update({f"kv_{k}": v for k, v in kv_stats.items()})
        return out
