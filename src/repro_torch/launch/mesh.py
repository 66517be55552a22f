"""The production mesh of the port (counterpart of ``repro.launch.mesh``).

The reference's single-pod mesh is 256 TPU chips, (data=16, model=16); the
port runs on one card, so its mesh is (data=1, model=1).  Two kinds:

  * ``CardMesh``, axis names and sizes only: what the dry run reads, whose
    per-device numbers are the whole step's on one card;
  * ``one_card_mesh()``, a ``DeviceMesh`` of shape (1, 1) over a
    world-size-1 process group (NCCL on the card) that meets through a
    local ``HashStore``: no TCP rendezvous, no network.  The sharded steps
    (``runtime.train_lib``, ``runtime.serve_lib``, ``serving.engine``) run
    over it with DTensor state; every placement is local.

A dry run over a mesh of several devices waits for ROADMAP queue 1: the
dry run over a mesh.  Functions, not module constants, as in the
reference: importing this module touches no device.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

MESH_DRYRUN = "ROADMAP queue 1: the dry run over a mesh"


@dataclass(frozen=True)
class CardMesh:
    """Axis names and sizes of a device mesh, in the reference's order."""
    axis_names: tuple = ("data", "model")
    shape: tuple = (1, 1)

    @property
    def size(self) -> int:
        return math.prod(self.shape)


def make_production_mesh(*, multi_pod: bool = False) -> CardMesh:
    if multi_pod:
        raise NotImplementedError(
            f"make_production_mesh(multi_pod=True): a dry run over a mesh of "
            f"several cards is not ported yet ({MESH_DRYRUN})")
    return CardMesh()


def one_card_mesh(device: str = "cuda"):
    """A (data=1, model=1) ``DeviceMesh`` on ``device`` (the card unless the
    caller names the CPU), over a world-size-1 process group that this call
    starts: NCCL on the card, gloo on the CPU, meeting through a
    ``HashStore``.  Raises if a process group is already up; end it with
    ``torch.distributed.destroy_process_group()``."""
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


def describe(mesh) -> dict:
    """Axis sizes and device count of a ``CardMesh`` or a ``DeviceMesh``."""
    names = getattr(mesh, "mesh_dim_names", None) or mesh.axis_names
    shape = tuple(mesh.shape)
    return {"axes": dict(zip(names, shape)), "n_devices": int(math.prod(shape))}
