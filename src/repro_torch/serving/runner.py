"""Bucketed decode steps over the planner-addressed cache (port of
``repro.serving.runner``).

The reference AOT-compiles one decode step per batch-size bucket B in
{1, 2, 4, ..., max_batch}.  PyTorch runs the step eagerly, so here a bucket
is "compiled" when it is first warmed: ``n_compiles`` (and the
``runner_compile_total`` counter) count buckets warmed and stay flat after
``warmup()``.  Capturing one CUDA graph per bucket is a later change.

Each step gathers the running slots' rows of the small per-slot leaves
(positions, page-table rows, and the contiguous K/V or recurrent state rows
in gather mode),
runs the model's decode step, and scatters the updated rows back.  Paged
pool leaves (``*_pages``) carry no batch axis: they are never gathered, and
the step updates them in place.  A partial batch is padded to its bucket by
repeating the last running slot: duplicated rows compute identical updates
from identical inputs, so the duplicate writes are value-identical.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..models.transformer import Transformer
from ..obs.metrics import get_registry
from ..obs.trace import get_tracer


def bucket_ladder(max_batch: int) -> tuple[int, ...]:
    """Powers of two up to ``max_batch``, plus ``max_batch`` itself."""
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    out = []
    b = 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return tuple(out)


def _batch_axis(name: str):
    """Positions and page-table rows are (B, ...); pools (``*_pages``) have
    no batch axis; every per-layer leaf (K/V, ``conv``/``ssm``/``h``) is
    (L, B, ...)."""
    if name.endswith("_pages"):
        return None
    return 0 if name in ("pos", "block_tables") else 1


def _gather_rows(cache: dict, slots: torch.Tensor) -> dict:
    """Sub-cache of the rows named by ``slots`` (bucket-sized batch)."""
    out = {}
    for name, leaf in cache.items():
        axis = _batch_axis(name)
        out[name] = leaf if axis is None else leaf.index_select(axis, slots)
    return out


def _scatter_rows(cache: dict, sub: dict, slots: torch.Tensor) -> None:
    """Write the updated sub-cache rows back into the full batch cache."""
    for name, leaf in cache.items():
        axis = _batch_axis(name)
        if axis == 1:
            leaf[:, slots] = sub[name]
        elif axis == 0:
            leaf[slots] = sub[name]
        # pools were updated in place by the step itself


class DecodeRunner:
    """Ladder of decode steps over batch-size buckets.

    ``step(params, cache, tokens, slots)`` selects the smallest bucket that
    fits ``len(slots)``, pads by repeating the last slot, and runs the step
    against the full cache.  With ``warmup()`` called once, ``n_compiles``
    (and the ``runner_compile_total`` registry counter) stay flat no matter
    how admissions, finishes and preemptions churn the batch.
    """

    def __init__(self, model: Transformer, *, max_batch: int):
        self.model = model
        self.max_batch = max_batch
        self.buckets = bucket_ladder(max_batch)
        self.n_compiles = 0
        self._warm: set[int] = set()

    # -- the step ------------------------------------------------------------------
    def _step_fn(self, params, cache, tokens, slots: torch.Tensor):
        sub = _gather_rows(cache, slots)
        logits, new_sub = self.model.decode_step(params, sub, tokens[slots])
        # greedy selection and the token-buffer update stay on the device;
        # only the (bucket,) next tokens travel to the host
        nxt = logits.argmax(dim=-1).to(torch.int32)
        tokens[slots] = nxt
        _scatter_rows(cache, new_sub, slots)
        return logits, nxt

    def _note_compile(self, bucket: int) -> None:
        """First use of a bucket: count it (never again for that bucket)."""
        self.n_compiles += 1
        reg = get_registry()
        if reg is not None:
            reg.counter("runner_compile_total",
                        "decode-runner bucket (re)compilations").inc()
        t = get_tracer()
        if t is not None:
            t.instant("compile", "serving", track="runner", bucket=bucket,
                      total=self.n_compiles)

    # -- bucket management --------------------------------------------------------
    def bucket_for(self, n: int) -> int:
        """Smallest bucket that fits ``n`` running requests."""
        for b in self.buckets:
            if b >= n:
                return b
        raise ValueError(f"{n} running requests exceed every bucket "
                         f"{self.buckets}")

    def warmup(self, params, cache, tokens) -> int:
        """Run every bucket once end to end through the hot path against a
        throwaway zeroed cache, so first-call costs (allocator growth, kernel
        library load) are paid before serving.  Returns the compile count."""
        for b in self.buckets:
            dummy = {k: torch.zeros_like(v) for k, v in cache.items()}
            self.step_greedy(params, dummy, torch.zeros_like(tokens), [0] * b)
        return self.n_compiles

    # -- the hot path -------------------------------------------------------------
    def step(self, params, cache, tokens, slots: Sequence[int]):
        """One decode step for the rows in ``slots`` (any count <= max_batch).

        Returns ``(logits, cache)`` with ``logits[i]`` the next-token logits
        for ``slots[i]``; rows outside ``slots`` are untouched.  ``tokens``
        (the (max_batch,) token buffer) gets the greedy picks in place.
        """
        n = len(slots)
        if n == 0:
            return torch.zeros((0, self.model.cfg.padded_vocab)), cache
        logits, _ = self._replay(params, cache, tokens, slots)
        return logits[:n], cache

    def step_greedy(self, params, cache, tokens, slots: Sequence[int]):
        """Engine hot path: one decode step plus greedy pick.

        Returns ``(next_tokens, tokens, cache)`` where ``next_tokens[i]`` is
        the argmax token for ``slots[i]`` (a host numpy array — one blocking
        (bucket,)-int transfer) and ``tokens`` is the (max_batch,) token
        buffer, updated in place."""
        n = len(slots)
        if n == 0:
            return np.zeros(0, np.int32), tokens, cache
        _, nxt = self._replay(params, cache, tokens, slots)
        return nxt.cpu().numpy()[:n], tokens, cache

    def _replay(self, params, cache, tokens, slots):
        bucket = self.bucket_for(len(slots))
        if bucket not in self._warm:
            self._warm.add(bucket)
            self._note_compile(bucket)
        padded = list(slots) + [slots[-1]] * (bucket - len(slots))
        idx = torch.tensor(padded, dtype=torch.long, device=tokens.device)
        return self._step_fn(params, cache, tokens, idx)

    def stats(self) -> dict:
        return {"buckets": list(self.buckets),
                "n_compiled": len(self._warm),
                "n_compiles": self.n_compiles}
