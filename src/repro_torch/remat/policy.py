"""RematPolicy — the profile-guided replacement for the boolean remat flag
(port of ``repro.remat.policy``).

A ``RematPolicy`` carries the *selection* the eviction search made and
compiles it into a ``torch.utils.checkpoint`` policy: outputs of the selected
aten ops are recomputed in the backward pass, every other op's output is
saved (selective activation checkpointing).

The mapping uses the liveness profiler's tags: a block is tagged with the
aten overload that produced it (``aten.mm.default``), which is the ``op`` the
selective-checkpoint callback receives.  Offload-mode evictions are folded
into the recompute set, as the reference folds them into its in-jit policy;
the host-staging mechanism itself lives in ``offload.py``.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Iterable, Optional

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

if TYPE_CHECKING:                     # pragma: no cover - typing only
    from .search import EvictionPlan


def _prim_of_tag(tag: str) -> Optional[str]:
    """Profiler tag -> the aten op (``aten.<op>.<overload>``) the checkpoint
    policy can match on; None for stubs (``...:rematerialize``) and for tags
    that name no aten op."""
    parts = tag.split(".")
    if ":" in tag or len(parts) != 3 or parts[0] != "aten":
        return None
    packet = getattr(torch.ops.aten, parts[1], None)
    if packet is None or parts[2] not in packet.overloads():
        return None
    return tag


def _aliases(op) -> bool:
    """Does ``op`` return a view of, or write into, one of its inputs?"""
    return any(r.alias_info is not None for r in op._schema.returns)


# Ops that make a buffer from nothing but a shape and a value.  Remaking one
# costs a fill, and the buffer may be written in place afterwards (the MoE
# dispatch's ``index_put_`` into ``new_zeros``, its expert counts'
# ``scatter_add_`` into ``zeros_like``): a selective checkpoint refuses to
# hand back a saved output that was mutated since, so fills are never saved.
_FILLS = frozenset({"zeros", "zeros_like", "new_zeros", "ones", "ones_like",
                    "new_ones", "full", "full_like", "new_full", "empty",
                    "empty_like", "new_empty", "arange", "scalar_tensor"})


def _fills(op) -> bool:
    return op._schema.name.split("::")[-1] in _FILLS


def pattern_group(tag: str) -> str:
    """Pattern group of a profiled block — the unit policies can be scoped to.

    The reference groups grad-of-scan residuals by their ``scan:<prim>`` tag
    and everything else by its producing primitive.  The port traces no
    scan, so every block groups by its producing aten op.  Untagged blocks
    (synthetic / recorded traces carry no provenance) share one group."""
    return tag or "<untagged>"


@dataclass(frozen=True)
class RematPolicy:
    """What to do with activations in the loss path.

    mode:
      * "none"   — save everything (the old ``remat=False``)
      * "full"   — recompute everything (the old ``remat=True``)
      * "policy" — recompute only outputs of ``recompute_prims``
    """

    mode: str = "none"
    recompute_prims: frozenset = field(default_factory=frozenset)
    offload_prims: frozenset = field(default_factory=frozenset)
    #: Pattern groups (see :func:`pattern_group`) this policy is scoped to.
    #: Empty = applies everywhere.
    scope: frozenset = field(default_factory=frozenset)

    def __post_init__(self):
        if self.mode not in ("none", "full", "policy"):
            raise ValueError(f"unknown remat mode {self.mode!r}")

    # ---- constructors -------------------------------------------------------
    @classmethod
    def none(cls) -> "RematPolicy":
        return cls(mode="none")

    @classmethod
    def full(cls) -> "RematPolicy":
        return cls(mode="full")

    @classmethod
    def coerce(cls, value) -> "RematPolicy":
        """Accept the legacy bool (and None) alongside real policies."""
        if isinstance(value, cls):
            return value
        if value is None or value is False:
            return cls.none()
        if value is True:
            return cls.full()
        raise TypeError(f"cannot interpret {value!r} as a RematPolicy")

    @classmethod
    def from_eviction(cls, ev: "EvictionPlan",
                      scope: Optional[Iterable[str]] = None) -> "RematPolicy":
        """Compile the search's selection into an op-level policy.

        ``scope`` restricts compilation to evictions whose
        :func:`pattern_group` is in the given set and stamps the policy with
        that scope.
        """
        scope_set = frozenset(scope) if scope is not None else frozenset()
        recompute, offload = set(), set()
        for e in ev.evictions:
            if scope_set and pattern_group(e.tag) not in scope_set:
                continue
            prim = _prim_of_tag(e.tag)
            if prim is None:
                continue
            (offload if e.mode == "offload" else recompute).add(prim)
        if not (recompute or offload):
            return cls.none()
        return cls(mode="policy", recompute_prims=frozenset(recompute),
                   offload_prims=frozenset(offload), scope=scope_set)

    def restricted_to(self, groups: Iterable[str]) -> "RematPolicy":
        """Narrow a policy to the given pattern groups.

        Keeps only recompute/offload ops reachable from ``groups`` (via the
        tag -> op mapping) and records the scope.  ``none``/``full`` modes
        only gain the scope stamp.
        """
        scope_set = frozenset(groups)
        if self.mode != "policy":
            return RematPolicy(mode=self.mode,
                               recompute_prims=self.recompute_prims,
                               offload_prims=self.offload_prims,
                               scope=scope_set)
        allowed = {p for p in (_prim_of_tag(g) for g in scope_set)
                   if p is not None}
        recompute = self.recompute_prims & allowed
        offload = self.offload_prims & allowed
        if not (recompute or offload):
            return RematPolicy(mode="none", scope=scope_set)
        return RematPolicy(mode="policy", recompute_prims=frozenset(recompute),
                           offload_prims=frozenset(offload), scope=scope_set)

    # ---- application --------------------------------------------------------
    @property
    def enabled(self) -> bool:
        return self.mode != "none"

    def checkpoint_policy(self):
        """None = checkpoint's own full remat; else a selective-checkpoint
        callback: outputs of the evicted ops are recomputed, every other
        op's output is saved.  Views and in-place ops are always replayed:
        they make no buffer of their own (the profile gives them no block),
        and a saved view would hold its base alive.  Fills (``_FILLS``) are
        always remade too."""
        if self.mode != "policy":
            return None
        evict = self.recompute_prims | self.offload_prims

        def policy_fn(ctx, op, *args, **kwargs):
            if str(op) in evict or _aliases(op) or _fills(op):
                return CheckpointPolicy.PREFER_RECOMPUTE
            return CheckpointPolicy.MUST_SAVE

        return policy_fn

    def wrap(self, fn):
        """``fn`` under ``torch.utils.checkpoint`` per this policy (``fn``
        itself if none)."""
        if not self.enabled:
            return fn
        kw = {}
        policy_fn = self.checkpoint_policy()
        if policy_fn is not None:
            kw["context_fn"] = functools.partial(
                create_selective_checkpoint_contexts, policy_fn)

        @functools.wraps(fn)
        def wrapped(*args):
            return checkpoint(fn, *args, use_reentrant=False, **kw)

        return wrapped

    def describe(self) -> str:
        suffix = f" @ {sorted(self.scope)}" if self.scope else ""
        if self.mode == "policy":
            return (f"planned(recompute={sorted(self.recompute_prims)}, "
                    f"offload={sorted(self.offload_prims)}){suffix}")
        return self.mode + suffix
