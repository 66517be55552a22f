"""Fault tolerance: checkpoint-restart controller + straggler detection
(port of ``repro.runtime.fault``).

Single-process simulation of the multi-host failure model: the controller
drives the train loop, checkpoints every N steps, and can inject a failure at
a chosen step; ``resume()`` restores the latest checkpoint and replays —
because the data pipeline is a pure function of (seed, step, host), the
restarted run repeats the same batches.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from ..checkpoint import Checkpointer
from ..data import SyntheticPipeline


class SimulatedFailure(RuntimeError):
    pass


def host_batch(batch: dict) -> dict:
    """numpy batch -> CPU tensors (the default ``to_device``)."""
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@dataclass
class TrainController:
    step_fn: Callable          # (state, batch) -> (state, metrics)
    state: dict
    pipeline: SyntheticPipeline
    ckpt: Checkpointer
    ckpt_every: int = 10
    to_device: Callable = host_batch
    losses: list = field(default_factory=list)
    step: int = 0

    def run(self, n_steps: int, fail_at: Optional[int] = None) -> list:
        """Run ``n_steps`` from the current step; optionally inject a failure."""
        end = self.step + n_steps
        while self.step < end:
            if fail_at is not None and self.step == fail_at:
                raise SimulatedFailure(f"injected host failure at step {self.step}")
            batch = self.to_device(self.pipeline.batch_at(self.step))
            self.state, metrics = self.step_fn(self.state, batch)
            self.losses.append(float(metrics["loss"]))
            self.step += 1
            if self.step % self.ckpt_every == 0:
                self.ckpt.save(self.step, self.state, meta={"step": self.step})
        self.ckpt.wait()
        return self.losses

    def resume(self) -> int:
        """Restore the latest checkpoint; returns the restored step."""
        self.ckpt.wait()
        latest = self.ckpt.latest_step()
        if latest is None:
            self.step = 0
            return 0
        self.state = self.ckpt.restore(latest, like=self.state)
        self.step = latest
        self.losses = self.losses[:latest]
        return latest


class StragglerMonitor:
    """Flags hosts whose recent step times exceed ``factor`` x fleet median.

    At production scale the mitigation is scheduler-level (drain + replace the
    host, restart from checkpoint); here we detect and report, and the
    controller's checkpoint/restart path is the recovery mechanism.
    """

    def __init__(self, n_hosts: int, window: int = 8, factor: float = 2.0):
        self.n_hosts = n_hosts
        self.window = window
        self.factor = factor
        self._times: list[list[float]] = [[] for _ in range(n_hosts)]

    def record(self, host: int, seconds: float) -> None:
        t = self._times[host]
        t.append(seconds)
        if len(t) > self.window:
            t.pop(0)

    def stragglers(self) -> list[int]:
        means = [float(np.mean(t)) if t else 0.0 for t in self._times]
        ready = [m for m in means if m > 0]
        if len(ready) < 2:
            return []
        med = float(np.median(ready))
        return [h for h, m in enumerate(means)
                if m > self.factor * med and m > 0]

    def report(self) -> dict:
        means = [float(np.mean(t)) if t else 0.0 for t in self._times]
        return {"per_host_mean_s": means, "stragglers": self.stragglers()}
