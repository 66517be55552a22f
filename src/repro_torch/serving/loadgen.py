"""Seeded trace-replay load generator for the serving stack (a copy of
``repro.serving.loadgen``).

Production traffic is not the paced, equal-length synthetic traces the
planner profiles from — it is bursty (Poisson), tidal (diurnal), and
long-tailed (lognormal prompt/output lengths), with a mix of latency
classes.  This module generates such traffic *deterministically*: the same
``LoadSpec`` always yields the byte-identical trace (``LoadTrace.to_bytes()`` is
the equality witness the tests pin), so a scenario cell is replayable and
its numbers are stable across machines.

Two products per spec:

  * ``trace()``        — planner-facing ``runtime.serve_lib.Request`` list
    (what the page pool / SharedArena is sized from);
  * ``gen_requests()`` — engine-facing ``GenRequest`` list with real token
    arrays and optional generation-length jitter, so live traffic can
    outgrow the profile and exercise preemption + §4.3 replanning.

Arrival processes:

  * ``poisson`` — exponential inter-arrivals at ``1/mean_interarrival``
    requests per engine step;
  * ``diurnal`` — inhomogeneous Poisson via Lewis–Shedler thinning, rate
    modulated ``(1 + depth·sin(2πt/period))`` — rush hours and valleys;
  * ``burst``   — all requests in the first few steps (the worst case the
    tight-budget scenario cell uses).
"""
from __future__ import annotations

import math
import random
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

from ..runtime.serve_lib import Request
from .scheduler import GenRequest

ARRIVALS = ("poisson", "diurnal", "burst")


@dataclass(frozen=True)
class TrafficClass:
    """One latency class: requests are tagged with it (and its priority
    feeds the scheduler's "priority" policy; SLO specs key on ``name``)."""

    name: str
    priority: int = 0
    weight: float = 1.0


@dataclass(frozen=True)
class LoadSpec:
    """Declarative description of one traffic pattern (fully seeded)."""

    n_requests: int = 32
    arrival: str = "poisson"
    mean_interarrival: float = 2.0      # engine steps between arrivals
    diurnal_period: float = 64.0        # steps per day-cycle
    diurnal_depth: float = 0.8          # rate swing: (1 ± depth) · base
    prompt_mean: int = 32               # lognormal median prompt length
    prompt_sigma: float = 0.6           # log-space spread (the long tail)
    prompt_max: int = 512
    gen_mean: int = 12                  # lognormal median generation length
    gen_sigma: float = 0.7
    gen_max: int = 256
    classes: tuple = ()                 # TrafficClass mix (empty = untagged)
    seed: int = 0

    def __post_init__(self):
        if self.arrival not in ARRIVALS:
            raise ValueError(f"unknown arrival {self.arrival!r}; "
                             f"have {ARRIVALS}")
        if self.n_requests < 1:
            raise ValueError("n_requests must be >= 1")


@dataclass
class LoadTrace:
    """One realized trace: requests plus their class tags."""

    spec: LoadSpec
    requests: list = field(default_factory=list)     # list[Request]
    class_of: dict = field(default_factory=dict)     # rid -> class name

    def to_bytes(self) -> bytes:
        """Canonical serialization — the determinism witness (same spec =>
        byte-identical)."""
        rows = ["rid,prompt_len,gen_len,arrival,class"]
        for r in self.requests:
            rows.append(f"{r.rid},{r.prompt_len},{r.gen_len},{r.arrival},"
                        f"{self.class_of.get(r.rid, '')}")
        return "\n".join(rows).encode()

    @property
    def span_steps(self) -> int:
        return max((r.arrival + r.gen_len for r in self.requests), default=0)


class LoadGen:
    """Realizes a ``LoadSpec`` into planner traces and engine requests."""

    def __init__(self, spec: LoadSpec):
        self.spec = spec

    # -- arrival processes --------------------------------------------------------
    def _arrivals(self, rng: random.Random) -> list[int]:
        s = self.spec
        base_rate = 1.0 / max(1e-9, s.mean_interarrival)
        out: list[int] = []
        t = 0.0
        if s.arrival == "burst":
            return [i % 3 for i in range(s.n_requests)]
        if s.arrival == "poisson":
            for _ in range(s.n_requests):
                t += rng.expovariate(base_rate)
                out.append(int(t))
            return out
        # diurnal: Lewis–Shedler thinning at rate_max, accept by rate(t)
        rate_max = base_rate * (1.0 + s.diurnal_depth)
        while len(out) < s.n_requests:
            t += rng.expovariate(rate_max)
            rate_t = base_rate * (1.0 + s.diurnal_depth
                                  * math.sin(2 * math.pi * t / s.diurnal_period))
            if rng.random() * rate_max <= max(rate_t, 0.0):
                out.append(int(t))
        return out

    def _lognormal(self, rng: random.Random, median: int, sigma: float,
                   hi: int) -> int:
        v = rng.lognormvariate(math.log(max(1, median)), sigma)
        return max(1, min(hi, int(round(v))))

    def _pick_class(self, rng: random.Random) -> Optional[TrafficClass]:
        classes = self.spec.classes
        if not classes:
            return None
        total = sum(c.weight for c in classes)
        x = rng.random() * total
        acc = 0.0
        for c in classes:
            acc += c.weight
            if x <= acc:
                return c
        return classes[-1]

    # -- products -----------------------------------------------------------------
    def trace(self) -> LoadTrace:
        """The deterministic realized trace (planner-facing requests)."""
        s = self.spec
        rng = random.Random(s.seed)
        arrivals = self._arrivals(rng)
        lt = LoadTrace(spec=s)
        for i, arr in enumerate(arrivals):
            rid = i + 1
            cls = self._pick_class(rng)
            lt.requests.append(Request(
                rid=rid,
                prompt_len=self._lognormal(rng, s.prompt_mean, s.prompt_sigma,
                                           s.prompt_max),
                gen_len=max(2, self._lognormal(rng, s.gen_mean, s.gen_sigma,
                                               s.gen_max)),
                arrival=arr))
            if cls is not None:
                lt.class_of[rid] = cls.name
        return lt

    def gen_requests(self, vocab_size: int, *, gen_jitter: int = 0,
                     trace: Optional[LoadTrace] = None) -> list[GenRequest]:
        """Engine-facing requests with real token arrays.

        ``gen_jitter`` perturbs each generation length by up to ±jitter
        tokens (seeded separately, so the planner trace stays identical) —
        the live-traffic-outgrows-the-profile regime that §4.3 replanning
        and preemption exist for.
        """
        lt = trace if trace is not None else self.trace()
        s = self.spec
        rng = random.Random(s.seed + 0x9E3779B9)   # independent jitter stream
        prio = {c.name: c.priority for c in s.classes}
        out = []
        for r in lt.requests:
            gen = r.gen_len
            if gen_jitter:
                gen = max(2, gen + rng.randint(-gen_jitter, gen_jitter))
            tokens = np.array([rng.randrange(vocab_size)
                               for _ in range(r.prompt_len)], dtype=np.int32)
            out.append(GenRequest(
                rid=r.rid, prompt=tokens, gen_len=gen,
                priority=prio.get(lt.class_of.get(r.rid, ""), 0),
                arrival=r.arrival))
        return out


def make_loadgen(arrival: str, n_requests: int, *, seed: int = 0,
                 mean_interarrival: float = 2.0,
                 classes: Sequence[TrafficClass] = (),
                 **overrides) -> LoadGen:
    """Convenience constructor the scenario matrix uses."""
    return LoadGen(LoadSpec(n_requests=n_requests, arrival=arrival,
                            mean_interarrival=mean_interarrival,
                            classes=tuple(classes), seed=seed, **overrides))
