"""The production "mesh" of the port: one H100 (counterpart of
``repro.launch.mesh``).

The reference's single-pod mesh is 256 TPU chips, (data=16, model=16); the
port runs on one card, so its mesh is (data=1, model=1) and a dry run's
per-device numbers are the whole step's.  A mesh over several cards waits
for the port of the reference's sharding (ROADMAP queue 1: sharding).
A function, not a module constant, as in the reference: importing this
module touches no device.
"""
from __future__ import annotations

import math
from dataclasses import dataclass


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
            "make_production_mesh(multi_pod=True): a mesh over several cards is "
            "not ported yet (ROADMAP queue 1: sharding)")
    return CardMesh()


def describe(mesh: CardMesh) -> dict:
    return {"axes": dict(zip(mesh.axis_names, mesh.shape)),
            "n_devices": int(mesh.size)}
