"""Ranks of ``test_torch_sharded_steps.py``: the port's sharded steps on a
(data 2, model 2) mesh of 4 gloo ranks on the CPU, each held against the
same step unsharded.

Run as ``python tests/torch_sharded_worker.py <dir> [case,...]``, where
``<dir>`` holds ``inputs.pt`` (the seeded parameters, batches and inputs
the test wrote); with a list of case names only those run, and ``capture``
(the serving steps' capture safety) runs only when named.
It spawns the ranks with ``torch.multiprocessing``; they meet through a
``FileStore`` in ``<dir>`` (no TCP port, so parallel test workers cannot
collide), run one thread each and import no JAX.  Rank 0 writes every
number to ``<dir>/results.json``.
"""
from __future__ import annotations

import json
import os
import sys
import time
import traceback

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

WORLD = 4
ACFG = dict(lr=1e-3, warmup_steps=2, total_steps=10)


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.detach().clone()


def _full(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _rel(got, want) -> float:
    g = torch.cat([_full(t).detach().double().flatten() for t in got])
    w = torch.cat([t.detach().double().flatten() for t in want])
    return float((g - w).norm() / w.norm().clamp(min=1e-30))


def _model(arch, **opts):
    from repro_torch.configs import get_config
    from repro_torch.models import RunOpts, Transformer
    return Transformer(get_config(arch).smoke(), RunOpts(**opts), device="cpu")


def _train_model(arch, **knobs):
    return _model(arch, attention_impl="full", use_kernels=False, **knobs)


def _grads(model, params, batch, mesh):
    """The loss and every leaf's gradient (full tensors) of ``loss_fn``."""
    from torch.utils._pytree import tree_leaves
    from repro_torch.runtime import mesh_ctx, sharding_rules
    from repro_torch.runtime.train_lib import leaf_grads
    from torch.utils._pytree import tree_flatten, tree_unflatten
    if mesh is not None:
        params = sharding_rules.distribute_tree(
            params, sharding_rules.param_specs(model.schema(), mesh), mesh)
    leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
    _, spec = tree_flatten(params)
    p = tree_unflatten(leaves, spec)
    if mesh is None:
        loss, _ = model.loss_fn(p, batch, remat=False)
        return float(loss), [g.detach() for g in leaf_grads(loss, leaves)]
    with mesh_ctx.use_mesh(mesh, rules=model.opts.mesh_rules()):
        specs = sharding_rules.batch_specs(batch, mesh)
        placed = {k: mesh_ctx.distribute(v, mesh, specs[k]) for k, v in batch.items()}
        loss, _ = model.loss_fn(p, placed, remat=False)
        grads = [g.redistribute(t.device_mesh, t.placements)
                 for g, t in zip(leaf_grads(loss, leaves), leaves)]
        return float(_full(loss)), [_full(g).detach() for g in grads]


def _state(model, params, topts):
    from repro_torch.optim import adamw, grad_compress
    params = _clone(params)
    st = {"params": params, "opt": adamw.init(params),
          "step": torch.zeros((), dtype=torch.int32)}
    if topts.compress_grads:
        st["err"] = grad_compress.init_error(params)
    return st


def train_case(mesh, inp, arch, knobs=None, remat=False, steps=3, **topts_kw):
    """Losses, first-step gradients and parameters after ``steps`` AdamW
    steps, sharded against unsharded."""
    from torch.utils._pytree import tree_leaves
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime import sharding_rules, train_lib
    model = _train_model(arch, **(knobs or {}))
    acfg = AdamWConfig(**ACFG)
    topts = train_lib.TrainOpts(remat=remat, **topts_kw)
    params = inp[arch]["params"]
    batches = inp[arch]["batches"][:steps]
    l1, g1 = _grads(model, params, batches[0], None)
    lm, gm = _grads(model, params, batches[0], mesh)
    if topts.microbatches > 1:      # microbatches of the other cases' shape
        batches = [{k: torch.cat([a[k]] * topts.microbatches) for k in a} for a in batches]
    step1, _ = train_lib.build_train_step(model, None, acfg, topts)
    stepm, (shs, batch_fn) = train_lib.build_train_step(model, mesh, acfg, topts)
    st1 = _state(model, params, topts)
    stm = sharding_rules.distribute_tree(_state(model, params, topts), shs, mesh)
    placed = all(hasattr(t, "device_mesh") for t in tree_leaves(stm))
    loss1, lossm = [], []
    for b in batches:
        st1, m1 = step1(st1, b)
        stm, mm = stepm(stm, b)
        loss1.append(float(m1["loss"]))
        lossm.append(float(mm["loss"]))
    return {"loss_unsharded": loss1, "loss_sharded": lossm,
            "loss0_grad_fn": [l1, lm],
            "grad_rel": _rel(gm, g1),
            "param_rel": _rel(tree_leaves(stm["params"]), tree_leaves(st1["params"])),
            "dtensor_state": placed,
            "batch_spec": list(map(str, batch_fn({"tokens": (4, 17)})["tokens"]))}


def moe_grouped_case(mesh, inp):
    """The MoE FFN with ``grouped=True`` on the mesh (2 data groups)."""
    from repro_torch.models import moe as moe_lib
    from repro_torch.runtime import mesh_ctx, sharding_rules
    model = _train_model("granite-moe-1b-a400m", moe_grouped=True)
    p = inp["moe"]["layer"]
    x = inp["moe"]["x"]
    with mesh_ctx.use_mesh(mesh):
        specs = sharding_rules.param_specs(model.schema()["layers"][0]["mlp"], mesh)
        dp = sharding_rules.distribute_tree(p, specs, mesh)
        groups = moe_lib._n_data_groups()
        y, aux = moe_lib.moe_mlp(x, dp, model.cfg, torch.float32, grouped=True)
        return {"n_groups": groups, "y": _full(y).tolist(), "aux": float(_full(aux))}


def serving_case(mesh, inp):
    """Prefill, then decode with shard_cache_len, and prefill under
    cp_attention, sharded against unsharded: logits' largest difference
    over their largest magnitude."""
    from repro_torch.runtime import serve_lib, sharding_rules
    out = {}
    tok = inp["qwen2-0.5b"]["prompt"]
    for tag, knobs, decode in [("plain", {}, True), ("cp", {"cp_attention": True}, False)]:
        model = _model("qwen2-0.5b", **knobs)
        p = model.load(_clone(inp["qwen2-0.5b"]["params"]))
        dp = sharding_rules.distribute_tree(p, sharding_rules.param_specs(model.schema(), mesh),
                                            mesh)
        l1, c1 = serve_lib.build_prefill_step(model, None, max_len=24)(p, {"tokens": tok})
        lm, cm = serve_lib.build_prefill_step(model, mesh, max_len=24)(dp, {"tokens": tok})
        errs = [float((l1 - lm).abs().max() / l1.abs().max())]
        placed = all(hasattr(v, "device_mesh") for v in cm.values())
        k_cache = cm["k"]
        cm = {k: v.full_tensor() for k, v in cm.items()}
        dec1 = serve_lib.build_decode_step(model, None, graphs=False)
        decm = serve_lib.build_decode_step(model, mesh, shard_cache_len=True)
        t = l1.argmax(-1).to(torch.int32)
        for _ in range(4 if decode else 0):
            a, c1 = dec1(p, c1, t)
            b, cm = decm(dp, cm, t)
            errs.append(float((a - b).abs().max() / a.abs().max()))
            t = a.argmax(-1).to(torch.int32)
            k_cache = cm["k"]
        out[tag] = {"rel": errs, "cache_dtensor": placed, "decode_steps": len(errs) - 1,
                    "k_placements": [f"{type(x).__name__}({getattr(x, 'dim', '')})"
                                     for x in k_cache.placements]}
    return out


def engine_case(mesh, inp):
    """Greedy streams of the engine on the mesh and off it."""
    import numpy as np
    from repro_torch.runtime.serve_lib import Request
    from repro_torch.serving import GenRequest, ServeEngine
    out = {}
    # two prompt lengths: DTensor plans each new shape's redistributions
    # afresh, the bulk of an eager step's host time on 4 CPU ranks
    trace = [Request(rid=i + 1, prompt_len=(6, 9)[i % 2], gen_len=5, arrival=i)
             for i in range(4)]
    for arch, mode in [("qwen2-0.5b", "paged"), ("qwen2-0.5b", "gather")]:
        model = _model(arch)
        p = model.load(_clone(inp[arch]["params"]))
        streams = []
        for m in (None, mesh):
            eng = ServeEngine(model, p, sample_trace=trace, max_len=48, max_batch=2,
                              page_tokens=8, attn_mode=mode, mesh=m, graphs=False)
            rng = np.random.default_rng(7)
            eng.run([GenRequest(rid=r.rid, prompt=rng.integers(
                0, model.cfg.vocab_size, r.prompt_len).astype(np.int32),
                gen_len=r.gen_len, arrival=r.arrival) for r in trace])
            streams.append({str(k): v for k, v in sorted(eng.completed.items())})
        out[f"{arch}:{mode}"] = {"equal": streams[0] == streams[1], "streams": streams[1]}
    return out


def elastic_and_checkpoint_case(mesh, inp, tmp, rank):
    """remesh (2, 2) -> (1, 2) over ranks 0-1, one step against the
    unsharded step; a checkpoint saved on (2, 2) restored onto (1, 2)."""
    from torch.utils._pytree import tree_leaves
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime import elastic, sharding_rules, train_lib
    model = _train_model("qwen2-0.5b")
    acfg = AdamWConfig(**ACFG)
    topts = train_lib.TrainOpts(remat=False)
    params = inp["qwen2-0.5b"]["params"]
    batch = inp["qwen2-0.5b"]["batches"][0]
    shs = train_lib.state_shardings(model, mesh, topts)
    stm = sharding_rules.distribute_tree(_state(model, params, topts), shs, mesh)
    whole = [_full(t) for t in tree_leaves(stm)]      # every rank takes part
    ck = Checkpointer(os.path.join(tmp, "ckpt"))
    ck.save(1, stm, blocking=True)
    small = elastic.make_mesh_over([0, 1], device_type="cpu")
    moved = elastic.remesh_state(stm, model.schema(), small, topts)
    if rank >= 2:           # outside the new mesh: nothing more to hold
        return None
    restored = ck.restore(1, moved)
    ck_err = max(float((_full(a) - b).abs().max())
                 for a, b in zip(tree_leaves(restored), whole))
    on_small = all(getattr(t, "device_mesh", None) is small for t in tree_leaves(restored))
    step1, _ = train_lib.build_train_step(model, None, acfg, topts)
    steps, _ = train_lib.build_train_step(model, small, acfg, topts)
    st1, m1 = step1(_state(model, params, topts), batch)
    sts, ms = steps(moved, batch)
    return {"mesh": list(small.shape), "loss": [float(m1["loss"]), float(ms["loss"])],
            "param_rel": _rel(tree_leaves(sts["params"]), tree_leaves(st1["params"])),
            "ckpt_max_abs": ck_err, "restored_on_new_mesh": on_small}


def comm_case(mesh, inp):
    """Collectives around the local_map'd attention calls, q/k/v made as the
    model shards them, and the wrappers' refusal of a DTensor."""
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch.kernels import ops as kops
    from repro_torch.models import attention as attn
    from repro_torch.runtime import mesh_ctx
    g = torch.Generator().manual_seed(3)
    out = {}
    with mesh_ctx.use_mesh(mesh):
        q = attn._shard_q(torch.randn(4, 16, 2, 7, 16, generator=g))
        k = attn._shard_kv(torch.randn(4, 16, 2, 16, generator=g))
        v = attn._shard_kv(torch.randn(4, 16, 2, 16, generator=g))
        with CommDebugMode() as comm:
            ctx = attn.attend(q, k, v)
        out["flash"] = {str(op): n for op, n in comm.get_comm_counts().items()}
        out["flash_err"] = float((ctx.full_tensor() - kops.flash_attention_plain(
            q.full_tensor(), k.full_tensor(), v.full_tensor())).abs().max())
        pool = mesh_ctx.distribute(torch.randn(6, 8, 2, 16, generator=g), mesh,
                                   (None, None, "model", None))
        tables = torch.tensor([[0, 1], [2, 3], [4, 5], [1, 0]], dtype=torch.int32)
        pos = torch.tensor([3, 9, 15, 0], dtype=torch.int32)
        qd = attn._shard_q(torch.randn(4, 1, 2, 7, 16, generator=g))
        with CommDebugMode() as comm:
            ctx = attn.attend_paged_decode(qd, pool, pool, tables, pos)
        out["paged"] = {str(op): n for op, n in comm.get_comm_counts().items()}
        paged = (ctx.full_tensor(), qd.full_tensor(), pool.full_tensor())
        refused = []
        for call in (lambda: kops.flash_attention(q, k, v),
                     lambda: kops.paged_attention(qd[:, 0], pool, pool, tables, pos),
                     lambda: kops.rglru_scan(k, k),
                     lambda: kops.ssd_scan(q, k, k, k, k, k)):
            try:
                call()
                refused.append(False)
            except TypeError as e:
                refused.append("DTensor" in str(e))
        out["wrappers_refuse_dtensor"] = refused
    ctx, qf, full = paged
    out["paged_err"] = float((ctx - attn.attend_paged_decode(qf, full, full, tables, pos))
                             .abs().max())
    return out


def capture_case(mesh, inp):
    """Capture safety of the serving steps a graph captures under the mesh
    (``torch_capture_check.mesh_steps_report``): host reads, tensors built
    from host data and the collectives each step issues."""
    from torch_capture_check import mesh_steps_report
    model = _model("qwen2-0.5b", attention_impl="kernel")
    return mesh_steps_report(model, model.load(_clone(inp["qwen2-0.5b"]["params"])), mesh)


def _rank(rank: int, tmp: str, only=None) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(tmp, "store"), WORLD),
                            rank=rank, world_size=WORLD)
    try:
        mesh = DeviceMesh("cpu", torch.arange(WORLD).reshape(2, 2),
                          mesh_dim_names=("data", "model"))
        inp = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
        res, seconds = {}, {}
        cases = [
            ("qwen2:none", lambda: train_case(mesh, inp, "qwen2-0.5b")),
            ("qwen2:full", lambda: train_case(mesh, inp, "qwen2-0.5b", remat=True)),
            ("qwen2:microbatches", lambda: train_case(mesh, inp, "qwen2-0.5b", microbatches=2)),
            ("qwen2:compress_grads", lambda: train_case(mesh, inp, "qwen2-0.5b",
                                                        compress_grads=True)),
            ("qwen2:sp_residual", lambda: train_case(mesh, inp, "qwen2-0.5b",
                                                     {"sp_residual": True})),
            ("qwen2:cp_attention", lambda: train_case(mesh, inp, "qwen2-0.5b",
                                                      {"cp_attention": True})),
            ("mamba2:ssd_shard_p", lambda: train_case(mesh, inp, "mamba2-130m",
                                                      {"ssd_shard_p": True})),
            ("granite-moe", lambda: train_case(mesh, inp, "granite-moe-1b-a400m")),
            ("recurrentgemma", lambda: train_case(mesh, inp, "recurrentgemma-9b")),
            ("mamba2", lambda: train_case(mesh, inp, "mamba2-130m")),
            ("moe_grouped", lambda: moe_grouped_case(mesh, inp)),
            ("serving", lambda: serving_case(mesh, inp)),
            ("engine", lambda: engine_case(mesh, inp)),
            ("comm", lambda: comm_case(mesh, inp)),
            ("elastic", lambda: elastic_and_checkpoint_case(mesh, inp, tmp, rank)),
        ]
        if only is not None:
            extra = [("capture", lambda: capture_case(mesh, inp))]
            cases = [(n, fn) for n, fn in cases + extra if n in only]
        for name, fn in cases:
            t0 = time.perf_counter()
            res[name] = fn()
            seconds[name] = time.perf_counter() - t0
        if rank == 0:
            res["seconds"] = seconds
            with open(os.path.join(tmp, "results.json"), "w") as f:
                json.dump(res, f)
    except BaseException:
        with open(os.path.join(tmp, f"error_rank{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def main(tmp: str, only=None) -> None:
    import torch.multiprocessing as mp
    mp.start_processes(_rank, args=(tmp, only), nprocs=WORLD, start_method="spawn")


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2].split(",") if len(sys.argv) > 2 else None)
