"""The production meshes of the port (counterpart of ``repro.launch.mesh``).

The reference's single-pod mesh is 256 TPU chips, (data=16, model=16), and
its multi-pod mesh 512, (pod=2, data=16, model=16).  Three kinds here:

  * ``CardMesh``, axis names and sizes only: the ``single`` dry run's mesh,
    one H100 (data=1, model=1), whose per-device numbers are the whole
    step's on one card;
  * ``make_production_mesh(multi_pod=True)``, the reference's multi-pod
    mesh entry for entry: a ``DeviceMesh`` of shape (2, 16, 16) over torch's
    ``"fake"`` process group of world size 512, as its rank 0.  A fake
    group moves no data: its collectives return tensors of the right shape,
    so a step traced over it on fake tensors records every collective
    DTensor issues, with its group, and rank 0's local shards (the dry run
    over a mesh, ``launch.dryrun --mesh multi``); ``fake_mesh`` builds any
    other shape the same way;
  * ``one_card_mesh()``, a ``DeviceMesh`` of shape (1, 1) over a
    world-size-1 process group (NCCL on the card) that meets through a
    local ``HashStore``: no TCP rendezvous, no network.  The sharded steps
    (``runtime.train_lib``, ``runtime.serve_lib``, ``serving.engine``) run
    over it with DTensor state; every placement is local.

A process holds one default process group at a time, so the fake group and
``one_card_mesh``'s never coexist: each raises if another group is up.  The
fake group is made once per process and reused for every mesh of its world
size; ``end_process_group`` ends whichever is up.  Functions, not module
constants, as in the reference: importing this module touches no device and
no process group.
"""
from __future__ import annotations

import contextlib
import functools
import math
from dataclasses import dataclass
from unittest import mock

MULTI_POD = {"shape": (2, 16, 16), "axes": ("pod", "data", "model")}

_FAKE: dict = {"world": None, "meshes": {}}


@dataclass(frozen=True)
class CardMesh:
    """Axis names and sizes of a device mesh, in the reference's order."""
    axis_names: tuple = ("data", "model")
    shape: tuple = (1, 1)

    @property
    def size(self) -> int:
        return math.prod(self.shape)


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    """``single``: one H100 (``CardMesh``); ``multi_pod``: the reference's
    (pod 2, data 16, model 16) mesh over a 512-rank fake process group
    (``fake_mesh``) on ``device``."""
    if multi_pod:
        return fake_mesh(MULTI_POD["shape"], MULTI_POD["axes"], device)
    return CardMesh()


def fake_mesh(shape: tuple, axes: tuple = MULTI_POD["axes"], device: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` on ``device`` (the card
    unless the caller names the CPU), over torch's ``"fake"`` process group
    of world size ``prod(shape)``, this process its rank 0.  The group is
    started by the first call and reused by later calls of the same world
    size; raises if another process group is up.  On a CUDA device the mesh
    sets the current device from the rank: ``cuda:0``."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    world = math.prod(shape)
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("fake_mesh: no card is visible; pass device='cpu' to "
                           "trace over the mesh on the CPU")
    key = (tuple(shape), tuple(axes), dev.type)
    if _FAKE["world"] is not None and dist.is_initialized():
        if _FAKE["world"] != world:
            raise RuntimeError(f"fake_mesh: a fake group of world size {_FAKE['world']} "
                               f"is up; end it first (end_process_group)")
        if key in _FAKE["meshes"]:
            return _FAKE["meshes"][key]
    else:
        if dist.is_initialized():
            raise RuntimeError("fake_mesh: a process group is already initialized")
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
        _FAKE.update(world=world, meshes={})
    mesh = DeviceMesh(dev.type, torch.arange(world).reshape(shape), mesh_dim_names=tuple(axes))
    _FAKE["meshes"][key] = mesh
    return mesh


def end_process_group() -> None:
    """End the process group that is up (the fake one or
    ``one_card_mesh``'s), if any."""
    import torch.distributed as dist
    _FAKE.update(world=None, meshes={})
    if dist.is_initialized():
        dist.destroy_process_group()


def one_card_mesh(device: str = "cuda"):
    """A (data=1, model=1) ``DeviceMesh`` on ``device`` (the card unless the
    caller names the CPU), over a world-size-1 process group that this call
    starts: NCCL on the card, gloo on the CPU, meeting through a
    ``HashStore``.  Raises if a process group is already up; end it with
    ``end_process_group()``."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("one_card_mesh: no card is visible; pass device='cpu' "
                               "to build the mesh on the CPU")
        torch.cuda.set_device(dev.index or 0)
    if dist.is_initialized():
        raise RuntimeError("one_card_mesh: a process group is already initialized")
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1)
    return DeviceMesh(dev.type, torch.zeros((1, 1), dtype=torch.int64),
                      mesh_dim_names=("data", "model"))


@contextlib.contextmanager
def dtensor_tracing():
    """Around ``make_fx`` of a step over DTensors of concrete shapes:

      * DTensor keeps its sharding propagation and its redistribution plans
        out of its caches while it is traced (a traced shape may be
        symbolic).  The dry run's shapes are concrete, so here both are
        memoized, as they are when DTensor runs eagerly: a 24-layer step
        asks the same questions once a layer;
      * ``_StridedShard``'s shard arithmetic builds an index tensor and
        reads it back, which fake tensors cannot do; it runs on real
        tensors, outside the trace (its inputs are ints).

    Each patch is applied only where this torch has what it patches."""
    import torch.distributed.tensor._redistribute as redistribute
    import torch.distributed.tensor._sharding_prop as sharding_prop
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import _disable_current_modes
    with contextlib.ExitStack() as stack:
        if hasattr(sharding_prop, "_are_we_tracing"):
            stack.enter_context(mock.patch.object(sharding_prop, "_are_we_tracing",
                                                  lambda: False))
        prop = DTensor._op_dispatcher.sharding_propagator
        if hasattr(prop, "propagate_op_sharding_non_cached"):
            stack.enter_context(mock.patch.object(
                prop, "propagate_op_sharding_non_cached", prop.propagate_op_sharding))
        plan = getattr(redistribute, "_gen_transform_infos_non_cached", None)
        if plan is not None:
            stack.enter_context(mock.patch.object(
                redistribute, "_gen_transform_infos_non_cached", functools.cache(plan)))
        try:
            from torch.distributed.tensor.placement_types import _StridedShard
        except ImportError:
            _StridedShard = None
        arith = getattr(_StridedShard, "local_shard_size_and_offset", None)
        if arith is not None:
            def untraced(*args, **kwargs):
                with _disable_current_modes():
                    return arith(*args, **kwargs)
            stack.enter_context(mock.patch.object(
                _StridedShard, "local_shard_size_and_offset", untraced))
        yield


def describe(mesh) -> dict:
    """Axis sizes and device count of a ``CardMesh`` or a ``DeviceMesh``."""
    names = getattr(mesh, "mesh_dim_names", None) or mesh.axis_names
    shape = tuple(mesh.shape)
    return {"axes": dict(zip(names, shape)), "n_devices": int(math.prod(shape))}
