"""Host staging for offload-mode evictions, instrumented with MemoryRecorder
(port of ``repro.remat.offload``).

Offload-selected activations are staged to host RAM between their production
and their backward-pass use.  The staging arena records every stage-out as an
alloc and every stage-in as a free on a ``MemoryRecorder``, so staged buffers
show up as first-class blocks (tag ``host:<tag>``) in a ``MemoryProfile`` —
the host side of the ledger the planner otherwise only sees as missing HBM
area.  Transfer time is charged against the host-link bandwidth.

Host copies of CUDA tensors are pinned, so the copies back can be
asynchronous.  The training path does not stage through this arena: a
``RematPolicy`` folds its offload selections into the recompute set (see
``policy.py``), as the reference's checkpoint policy does.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch

from ..core.events import MemoryProfile
from ..core.profiler import MemoryRecorder
from .cost_model import HOST_LINK_BW


@dataclass
class _Staged:
    bid: int            # recorder block id
    value: torch.Tensor  # host copy
    device: torch.device
    nbytes: int


class HostOffloadArena:
    """Stage activations out to host and back, with profile instrumentation."""

    def __init__(self, recorder: Optional[MemoryRecorder] = None,
                 bandwidth: float = HOST_LINK_BW):
        self.recorder = recorder or MemoryRecorder()
        self.bandwidth = bandwidth
        self._staged: dict[Any, _Staged] = {}
        self.bytes_out = 0
        self.bytes_in = 0

    def __len__(self) -> int:
        return len(self._staged)

    @property
    def resident_bytes(self) -> int:
        return sum(s.nbytes for s in self._staged.values())

    def stage_out(self, key, tensor: torch.Tensor) -> int:
        """Copy ``tensor`` to host; returns the recorder block id."""
        if key in self._staged:
            raise KeyError(f"{key!r} already staged")
        host = torch.empty(tensor.shape, dtype=tensor.dtype,
                           pin_memory=tensor.device.type == "cuda")
        host.copy_(tensor.detach())
        nbytes = host.numel() * host.element_size()
        bid = self.recorder.on_alloc(nbytes, tag=f"host:{key}")
        self._staged[key] = _Staged(bid=bid, value=host, device=tensor.device,
                                    nbytes=nbytes)
        self.bytes_out += nbytes
        return bid

    def stage_in(self, key) -> torch.Tensor:
        """Bring a staged activation back to its device; frees the host copy."""
        s = self._staged.pop(key)
        self.recorder.on_free(s.bid)
        self.bytes_in += s.nbytes
        return s.value.to(s.device, non_blocking=True)

    def peek(self, key) -> torch.Tensor:
        return self._staged[key].value

    def estimated_transfer_s(self) -> float:
        return (self.bytes_out + self.bytes_in) / self.bandwidth

    def profile(self, meta: Optional[dict] = None) -> MemoryProfile:
        """Emit the host-side profile (staged-buffer blocks) recorded so far."""
        return self.recorder.finish(dict(meta or {}, source="host_offload",
                                         bytes_out=self.bytes_out,
                                         bytes_in=self.bytes_in))

    def stats(self) -> dict:
        return {
            "staged": len(self._staged),
            "resident_bytes": self.resident_bytes,
            "bytes_out": self.bytes_out,
            "bytes_in": self.bytes_in,
            "est_transfer_s": self.estimated_transfer_s(),
        }
