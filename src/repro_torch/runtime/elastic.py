"""Elastic scaling: re-mesh and re-shard when the device count changes (port
of ``repro.runtime.elastic``).

Checkpoints are mesh-independent (full tensors), so an N -> M restore
distributes each leaf onto the new mesh (``Checkpointer.restore``).  For
in-flight elasticity, ``remesh_state`` moves live DTensor state onto a mesh
built over the surviving ranks, from the full tensors, as the reference's
``device_put`` does; the deterministic pipeline then replays from the
current step.
"""
from __future__ import annotations

from typing import Any, Sequence

import torch
from torch.utils._pytree import tree_map

from . import mesh_ctx, sharding_rules


def factor_mesh(n_devices: int, max_model: int = 16) -> tuple:
    """Pick (data, model) for n devices: the largest power-of-2 model dim <= max."""
    model = 1
    while model * 2 <= max_model and n_devices % (model * 2) == 0:
        model *= 2
    return (n_devices // model, model)


def make_mesh_over(ranks: Sequence[int], multi_pod: bool = False,
                   device_type: str = "cuda"):
    """A ``DeviceMesh`` over ``ranks`` of the default process group:
    ("pod", "data", "model") with two pods when ``multi_pod`` and the count
    is even, else ("data", "model"), factored by ``factor_mesh``.  Every
    rank of the group calls it, as with any ``DeviceMesh``."""
    from torch.distributed.device_mesh import DeviceMesh
    n = len(ranks)
    ids = torch.as_tensor(list(ranks), dtype=torch.int64)
    if multi_pod and n % 2 == 0:
        data, model = factor_mesh(n // 2)
        return DeviceMesh(device_type, ids.reshape(2, data, model),
                          mesh_dim_names=("pod", "data", "model"))
    data, model = factor_mesh(n)
    return DeviceMesh(device_type, ids.reshape(data, model),
                      mesh_dim_names=("data", "model"))


def remesh_state(state: Any, schema: dict, new_mesh, opts=None) -> Any:
    """The train state on ``new_mesh``: every leaf's full tensor (a DTensor
    is gathered first) distributed by ``train_lib.state_shardings``."""
    from .train_lib import TrainOpts, state_shardings

    class _M:   # state_shardings only reads .schema()
        def __init__(self, s):
            self._s = s

        def schema(self):
            return self._s

    specs = state_shardings(_M(schema), new_mesh, opts or TrainOpts())
    return sharding_rules.distribute_tree(tree_map(mesh_ctx.whole, state), specs,
                                          new_mesh)


def shrink_plan(old_n: int, new_n: int) -> dict:
    """Describe the re-shard implied by losing devices (for logs)."""
    od, om = factor_mesh(old_n)
    nd, nm = factor_mesh(new_n)
    return {
        "old_mesh": {"data": od, "model": om},
        "new_mesh": {"data": nd, "model": nm},
        "per_device_param_growth": (od * om) / (nd * nm),
        "global_batch_note": "keep global batch; per-device batch grows by "
                             f"{od / max(1, nd):.2f}x (data axis {od}->{nd})",
    }
