"""Async, atomic checkpointing of the port's nested-dict state (port of
``repro.checkpoint.checkpointer``).

Layout: <dir>/step_<N>/  one .npy file per leaf + manifest.json (step, flat
key paths, meta).  Keys are the leaf's path through the
dicts and lists (``params/layers/0/attn/wq``).  Writes go to a tmp dir that
is atomically renamed, so a crash mid-save never corrupts the latest
checkpoint; ``latest_step`` scans completed manifests only.  Saving runs on a
background thread with a ``wait()`` barrier; the host snapshot is taken on
the caller's thread, since the optimizer updates the state in place right
after.  Restore places each leaf on the device and dtype of the matching
leaf of ``like``, and a DTensor leaf of ``like`` on its mesh and
placements: checkpoints hold full tensors, so a state saved on one mesh
restores onto another (the reference's N -> M restore).  Under a mesh
every rank calls ``save``: each leaf is gathered whole on every rank, one
at a time, and only the mesh's first rank keeps a host copy and writes.
``blocking=True`` then ends on every rank of the mesh once the write is
done, and raises on every rank if it failed.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch
from torch.utils._pytree import tree_flatten_with_path, tree_unflatten

from ..runtime.mesh_ctx import is_dtensor, whole


def _flatten(tree):
    leaves, spec = tree_flatten_with_path(tree)
    out = {}
    for kp, leaf in leaves:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp)
        out[key] = leaf
    return out, spec


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` (a plain tensor), never a view of it; numpy has
    no bf16, so bf16 leaves are stored as f32 (``restore`` casts back to
    ``like``'s dtype)."""
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.to("cpu", copy=True).numpy()


def _mesh_of(flat: dict):
    """The mesh of the first DTensor leaf, or None."""
    return next((v.device_mesh for v in flat.values() if is_dtensor(v)), None)


def _any_failed(mesh, failed: bool) -> bool:
    """Whether ``failed`` holds on any rank of ``mesh``: a max over each of
    its dims in turn, which no rank leaves before every rank has come."""
    import torch.distributed as dist
    flag = torch.tensor([float(failed)], device=mesh.device_type)
    for j in range(mesh.ndim):
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=mesh.get_group(j))
    return bool(flag.item())


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- save --------------------------------------------------------------------
    def save(self, step: int, tree: Any, meta: Optional[dict] = None,
             blocking: bool = False) -> None:
        self.wait()
        flat, _ = _flatten(tree)
        mesh = _mesh_of(flat)
        # under a mesh every rank takes part in each leaf's gather (a DTensor
        # is written whole, so a checkpoint does not depend on the mesh it
        # was saved from) and the mesh's first rank keeps and writes it
        writes = mesh is None or not any(mesh.get_coordinate())
        host = {}
        for k, v in flat.items():
            t = whole(v.detach())
            if writes:
                host[k] = _to_host(t)
            del t
        if not writes:
            if blocking and _any_failed(mesh, False):
                raise RuntimeError(f"checkpoint step {step}: the mesh's first rank "
                                   "failed to write it")
            return

        def work():
            try:
                tmp = os.path.join(self.dir, f".tmp_step_{step}_{os.getpid()}")
                final = os.path.join(self.dir, f"step_{step:08d}")
                os.makedirs(tmp, exist_ok=True)
                for k, v in host.items():
                    np.save(os.path.join(tmp, k.replace("/", "__") + ".npy"), v)
                manifest = {
                    "step": step,
                    "keys": sorted(host.keys()),
                    "time": time.time(),
                    "meta": meta or {},
                }
                with open(os.path.join(tmp, "manifest.json"), "w") as f:
                    json.dump(manifest, f)
                if os.path.exists(final):
                    shutil.rmtree(final)
                os.rename(tmp, final)
                self._gc()
            except BaseException as e:   # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
        if not blocking:
            return
        if mesh is None:
            self.wait()
            return
        try:
            self.wait()
        except BaseException:
            _any_failed(mesh, True)
            raise
        _any_failed(mesh, False)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"), ignore_errors=True)

    # -- restore -------------------------------------------------------------------
    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_"):
                manifest = os.path.join(self.dir, name, "manifest.json")
                if os.path.exists(manifest):
                    out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like: Any) -> Any:
        """Restore into the structure of ``like``: each leaf on the device
        and dtype of ``like``'s leaf at the same path."""
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        flat_like, spec = _flatten(like)
        if sorted(flat_like.keys()) != manifest["keys"]:
            raise ValueError("checkpoint/state structure mismatch")
        leaves = []
        for key, ref in flat_like.items():
            arr = np.load(os.path.join(path, key.replace("/", "__") + ".npy"))
            leaf = torch.from_numpy(arr).to(device=ref.device, dtype=ref.dtype)
            if is_dtensor(ref):                 # N -> M: onto like's mesh
                from torch.distributed.tensor import distribute_tensor
                leaf = distribute_tensor(leaf, ref.device_mesh, ref.placements)
            leaves.append(leaf)
        return tree_unflatten(leaves, spec)

    def meta(self, step: int) -> dict:
        path = os.path.join(self.dir, f"step_{step:08d}", "manifest.json")
        with open(path) as f:
            return json.load(f)["meta"]


def config_hash(obj: Any) -> str:
    return hashlib.sha256(repr(obj).encode()).hexdigest()[:16]
