"""What a CUDA graph capture refuses, recorded while a step runs eagerly:
shared by the graph tests and the ranks of ``torch_sharded_worker.py``
(imports no JAX).

A capture refuses reading a device value on the host (``.item()``,
``int(t)``, ``bool(t)``: ``aten._local_scalar_dense``) and a copy of host
data onto the device (``torch.tensor(..., device=cuda)``).  On ``meta``
tensors every legitimate input is a meta tensor, so an op that takes a CPU
tensor is host traffic too; on CPU tensors (a model on the CPU, the device
being the host) every tensor built from host data inside the step is.
"""
import contextlib

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


class HostTraffic(TorchDispatchMode):
    """Records every op that reads a device value on the host and, with
    ``cpu_is_host`` (the model on ``meta``), every op that takes a CPU
    tensor.  Under a mesh it sees DTensor-level ops and the local ops of
    ``local_map`` regions."""

    def __init__(self, cpu_is_host: bool = True):
        super().__init__()
        self.cpu_is_host = cpu_is_host
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        tensors = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        if (func is torch.ops.aten._local_scalar_dense.default
                or (self.cpu_is_host and any(t.device.type == "cpu" for t in tensors))):
            self.seen.append(str(func))
        return func(*args, **kwargs)


@contextlib.contextmanager
def host_built(every: bool = False):
    """Yields a list of the tensors built from host data inside:
    ``torch.tensor(data, device=...)`` off the CPU and, with ``every`` (a
    model on the CPU), every ``torch.tensor``, ``torch.as_tensor`` and
    ``torch.from_numpy`` call."""
    built = []
    real = {name: getattr(torch, name) for name in ("tensor", "as_tensor", "from_numpy")}

    def tensor(data, *a, device=None, **kw):
        if every or (device is not None and torch.device(device).type != "cpu"):
            built.append(("tensor", str(device)))
        return real["tensor"](data, *a, device=device, **kw)

    def as_tensor(data, *a, **kw):
        built.append(("as_tensor", str(kw.get("device"))))
        return real["as_tensor"](data, *a, **kw)

    def from_numpy(arr):
        built.append(("from_numpy", "cpu"))
        return real["from_numpy"](arr)
    torch.tensor = tensor
    if every:
        torch.as_tensor, torch.from_numpy = as_tensor, from_numpy
    try:
        yield built
    finally:
        for name, fn in real.items():
            setattr(torch, name, fn)


@contextlib.contextmanager
def capture_check(cpu_is_host: bool):
    """``(host, built, comm)`` recorded inside: ``HostTraffic``,
    ``host_built(every=not cpu_is_host)`` and DTensor's ``CommDebugMode``
    (the collectives a capture would hold)."""
    from torch.distributed.tensor.debug import CommDebugMode
    with host_built(every=not cpu_is_host) as built, CommDebugMode() as comm, \
            HostTraffic(cpu_is_host) as host:
        yield host, built, comm


def collectives(comm) -> dict:
    """``{op name: count}`` of a ``CommDebugMode``."""
    return {str(op): n for op, n in comm.get_comm_counts().items()}


def mesh_steps_report(model, params, mesh, batch: int = 4, max_len: int = 32,
                      prompt: int = 16) -> dict:
    """The serving steps a graph captures under ``mesh``, each run once
    eagerly (its warm run, which places what it places) and then once
    under ``capture_check``: the runner's static-buffer step over a paged
    pool (``model`` built with ``attention_impl="kernel"``: the plain
    versions on the CPU) and over a contiguous cache, the slab decode step
    and the padded prefill's static-buffer body.  ``params`` are plain
    loaded parameters, placed here.  Returns ``{step: {"host": [...],
    "built": [...], "comm": {...}}}``."""
    from repro_torch.runtime import mesh_ctx, serve_lib, sharding_rules
    from repro_torch.serving import DecodeRunner
    cpu_is_host = model.device.type != "cpu"
    dev = model.device
    p = sharding_rules.distribute_tree(
        params, sharding_rules.param_specs(model.schema(), mesh), mesh)
    tokens = torch.zeros(batch, dtype=torch.int32, device=dev)
    slots = torch.arange(batch, device=dev).flip(0)
    out = {}

    def record(name, fn):
        fn()
        with capture_check(cpu_is_host) as (host, built, comm):
            fn()
        out[name] = {"host": list(host.seen), "built": list(built),
                     "comm": collectives(comm)}

    runner = DecodeRunner(model, max_batch=batch)
    pages = model.init_paged_cache(batch, n_pages=batch * 3, page_tokens=8,
                                   pages_per_req=3)
    contiguous = model.init_cache(batch, max_len)
    for name, cache in (("runner:paged", pages), ("runner:gather", contiguous)):
        serve_lib.place_cache(cache, mesh, rules={"batch": ()})

        def run(cache=cache):
            with mesh_ctx.use_mesh(mesh, rules=model.opts.mesh_rules()):
                runner._step_fn(p, cache, tokens, slots)
        record(name, run)
    slab = serve_lib.build_decode_step(model, mesh, graphs=False)
    slab_cache = model.init_cache(batch, max_len)
    record("slab", lambda: slab(p, slab_cache, tokens))
    prefill = serve_lib.build_prefill_step(model, mesh, max_len=max_len, graphs=False)
    batch_in = {"tokens": torch.zeros((1, prompt), dtype=torch.int32, device=dev),
                "true_len": torch.full((), prompt // 2 + 1, dtype=torch.int32, device=dev)}
    static = prefill._buffers(batch_in)
    prefill._fill(static, batch_in)
    record("prefill", lambda: prefill._eager(p, static))
    return out
