"""Dry run: trace every (arch x shape) cell's step on fake tensors and record
its roofline quantities and its memory (port of ``repro.launch.dryrun``).

For each supported cell this traces the right step (train / prefill /
decode) with ``core.liveness.trace`` (``make_fx`` under a
``FakeTensorMode``: nothing is allocated, and fake CUDA tensors need no
card) and records:

  * ``aten``: ``launch.aten_analysis``'s summary of the graph (dot FLOPs,
    HBM bytes, collective wire bytes by kind; none on one card), where the
    reference records ``hlo``;
  * ``memory_analysis``: ``argument_bytes`` (the inputs: state and batch,
    or weights, batch and cache), ``output_bytes`` (the new buffers the
    step returns), ``temp_bytes`` — the best-fit (DSA) peak of the step's
    liveness profile, the paper's account of a step's memory, where XLA has
    its buffer assignment — ``alias_bytes`` (the input buffers the step
    returns, updated in place) and ``constant_bytes`` (small tensors the
    trace lifted into the graph, as whisper's sinusoid frequencies);
  * ``fits``: whether retained (inputs and constants) + DSA fits the
    card's memory.

Every number is per device: over a mesh, rank 0's.

The steps are the port's own: ``runtime.train_lib.build_train_step``'s
whole update (gradient and AdamW over ``train_lib.abstract_state``, full
remat unless ``--no-remat``), ``runtime.serve_lib``'s prefill and decode
steps (eager, ``graphs=False``) over the served weights (``model.load``,
the compute dtype; the reference lowers over f32 masters cast at each use).
As the reference's default (``--attn-impl auto``, ``use_kernels=False``),
the plain paths are traced: the CUDA kernels do not run on fake tensors.

The reference's ``single`` mesh is 256 TPU chips; the port's is one H100
(``launch.mesh``), so per-device numbers differ from the reference's by
design.  ``multi`` is the reference's multi-pod mesh, (pod 2, data 16,
model 16): the step is built over it as the sharded steps run
(``build_train_step(model, mesh)``, ``build_prefill_step`` and
``build_decode_step(model, mesh, shard_cache_len=...)``, eager) and traced
as rank 0 of a 512-rank fake process group (``launch.mesh.fake_mesh``),
taking rank 0's local shards of every state, weight, cache and batch
leaf (``train_lib.abstract_sharded_step``, ``serve_lib.
abstract_sharded_prefill`` / ``abstract_sharded_decode``), so its numbers
are one device's: the collectives DTensor issues (where GSPMD would choose
its own), ``argument_bytes`` of the local shards, and ``fits`` against one
H100.  The mesh-only knobs (``--cp-attention``, ``--moe-grouped``,
``--sp-residual``, ``--ssd-shard-p``, ``--shard-cache-len``) reach the
traced step under ``multi``; on ``single`` there is no mesh to shard over
and they raise ``ValueError``.  The process holds one fake group for all
its ``multi`` cells and ends it at the end of the run.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all \\
      --mesh single --device cpu --out results/dryrun_torch
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b \\
      --shape train_4k,decode_32k --mesh multi --device cpu --out results/dryrun_torch
  PYTHONPATH=src python -m repro_torch.launch.dryrun --report md \\
      --mesh multi --out results/dryrun_torch    # the roofline table of those records
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from ..configs import ARCHS, SHAPES, get_config
from ..configs.base import ModelConfig, ShapeConfig
from ..core import MemoryPlanner
from ..core.liveness import profile_graph, trace
from ..models import RunOpts, Transformer
from ..models.transformer import DTYPES
from ..optim.adamw import AdamWConfig
from ..runtime import serve_lib, train_lib
from . import aten_analysis
from .mesh import CardMesh, describe, dtensor_tracing, end_process_group, make_production_mesh
from . import roofline

MESH_ONLY = ("cp_attention", "moe_grouped", "sp_residual", "ssd_shard_p",
             "shard_cache_len")


def input_specs(cfg: ModelConfig, shape: ShapeConfig, kind: str) -> dict:
    """``{name: (shape, dtype)}`` of every model input (no allocation).  An
    encoder-decoder's frames are in the compute dtype, as the reference's
    (the training CLI's pipeline gives f32)."""
    b, s = shape.global_batch, shape.seq_len
    if kind == "train":
        return train_lib.batch_specs(cfg, b, s, DTYPES[cfg.dtype])
    if kind == "decode":  # just the new tokens; cache specs come from the model
        return {"tokens": ((b,), torch.int32)}
    specs = {"tokens": ((b, s), torch.int32)}
    if cfg.is_encoder_decoder:
        specs["frames"] = ((b, cfg.encoder_seq, cfg.d_model), DTYPES[cfg.dtype])
    return specs


def run_opts_for(shape: ShapeConfig, args, multi_pod: bool = False) -> RunOpts:
    """The reference's ``run_opts_for``.  A mesh-only knob without a mesh
    (``multi_pod=False``: one card) raises, and so does a kernel path,
    which fake tensors cannot run."""
    del shape
    on = [k for k in MESH_ONLY if getattr(args, k)]
    if on and not multi_pod:
        raise ValueError(f"--{on[0].replace('_', '-')} shards over a mesh: the one "
                         "card of --mesh single has none; pass --mesh multi")
    if args.attn_impl in ("kernel", "pallas"):
        raise ValueError(f"--attn-impl {args.attn_impl}: the dry run traces the plain "
                         "paths (auto, full or chunked); the CUDA kernels do not "
                         "run on fake tensors")
    return RunOpts(attention_impl=args.attn_impl, attn_chunk=args.attn_chunk,
                   loss_impl=args.loss_impl, loss_chunk=args.loss_chunk,
                   softmax_dtype=args.softmax_dtype, use_kernels=False,
                   cp_attention=args.cp_attention, moe_grouped=args.moe_grouped,
                   sp_residual=args.sp_residual, ssd_shard_p=args.ssd_shard_p)


def _mode() -> FakeTensorMode:
    # the model's own small device tensors (whisper's cross-attention
    # position) enter the graph as constants
    return FakeTensorMode(allow_non_fake_inputs=True)


def trace_train(model: Transformer, batch_sds: dict, remat=True,
                microbatches: int = 1) -> torch.fx.GraphModule:
    """``build_train_step``'s whole update (gradient and AdamW) of ``model``
    over its fake train state and a fake batch (``{name: (shape, dtype)}``),
    under ``remat`` (``TrainOpts.remat``)."""
    mode = _mode()
    acfg = AdamWConfig()
    topts = train_lib.TrainOpts(microbatches=microbatches, remat=remat)
    step, _ = train_lib.build_train_step(model, None, acfg, topts)
    state = train_lib.abstract_state(model, mode, acfg, topts)
    return trace(step, state, train_lib._fake_batch(mode, batch_sds, model.device))


def trace_step(cfg: ModelConfig, shape: ShapeConfig, args, mesh=None):
    """The step of ``shape.kind`` for ``cfg``, traced on fake tensors ->
    ``(GraphModule, meta)``; over ``mesh`` (a ``DeviceMesh``) rank 0's
    step on its local shards (``trace_sharded``)."""
    model = Transformer(cfg, run_opts_for(shape, args, mesh is not None), device=args.device)
    kind = shape.kind
    specs = input_specs(cfg, shape, kind)
    meta = {"kind": kind, "dtype": cfg.dtype, "device": str(model.device)}
    if kind == "train":
        meta["remat"] = "none" if args.no_remat else "full"
    if mesh is not None:
        meta["mesh_knobs"] = [k for k in MESH_ONLY if getattr(args, k)]
        return trace_sharded(model, shape, specs, mesh, args), meta
    if kind == "train":
        return trace_train(model, specs, not args.no_remat, args.microbatches), meta
    mode = _mode()
    params = model.abstract(mode)
    with mode:
        params = model.load(params)
    batch = train_lib._fake_batch(mode, specs, model.device)
    if kind == "prefill":
        step = serve_lib.build_prefill_step(model, None, max_len=shape.seq_len,
                                            graphs=False)
        return trace(lambda p, b: step(p, b), params, batch), meta
    b, s = shape.global_batch, shape.seq_len
    step = serve_lib.build_decode_step(model, None, batch=b, max_len=s, graphs=False)
    cache = train_lib._fake_batch(mode, model.cache_spec(b, s), model.device)
    return trace(step, params, cache, batch["tokens"]), meta


def trace_sharded(model: Transformer, shape: ShapeConfig, specs: dict, mesh, args):
    """The sharded step of ``shape.kind`` over ``mesh``, traced as its rank
    0 on fake local shards: the graph's placeholders are that rank's
    shards of the state (or weights and cache) and batch."""
    mode = _mode()
    kind, b, s = shape.kind, shape.global_batch, shape.seq_len
    if kind == "train":
        topts = train_lib.TrainOpts(microbatches=args.microbatches, remat=not args.no_remat)
        fn, shards = train_lib.abstract_sharded_step(model, mesh, mode, AdamWConfig(),
                                                     topts, specs)
    elif kind == "prefill":
        fn, shards = serve_lib.abstract_sharded_prefill(model, mesh, mode, specs, max_len=s)
    else:
        fn, shards = serve_lib.abstract_sharded_decode(
            model, mesh, mode, b, s, shard_cache_len=args.shard_cache_len)
    with dtensor_tracing():
        gm = trace(fn, *shards)
    # make_fx records products that nothing reads: torch 2.11's DTensor
    # leaves some over the global shapes (a (256 * 4096, 152064) lm head
    # beside the local one), and autograd some of its own; drop them
    gm.graph.eliminate_dead_code()
    gm.recompile()
    return gm


def lower_cell(arch: str, shape_name: str, mesh, args):
    """Returns ``(GraphModule, meta)`` for one registered cell over ``mesh``
    (``make_production_mesh``'s: one card, or the multi-pod ``DeviceMesh``)."""
    sharded = mesh if not isinstance(mesh, CardMesh) else None
    gm, meta = trace_step(get_config(arch), SHAPES[shape_name], args, sharded)
    meta.update(arch=arch, shape=shape_name, mesh=describe(mesh)["axes"])
    return gm, meta


def analyze_cell(gm, meta: dict, args=None) -> dict:
    """Fills ``meta`` with the graph's summary, its memory and whether it
    fits the card; with ``args.save_graph`` writes the graph's code."""
    t0 = time.time()
    prof = profile_graph(gm)
    dsa = MemoryPlanner().plan(prof).peak
    meta["plan_s"] = round(time.time() - t0, 2)
    returned = prof.meta["returned"]
    meta["memory_analysis"] = {
        "argument_bytes": prof.meta["input_bytes"]["placeholder"],
        "output_bytes": sum(size for kind, size in returned if kind == "block"),
        "temp_bytes": dsa,
        "alias_bytes": sum(size for kind, size in returned if kind != "block"),
        "constant_bytes": prof.meta["input_bytes"]["get_attr"],
    }
    meta["fits"] = {"retained_plus_dsa": prof.retained_bytes + dsa,
                    "hbm_bytes": roofline.HBM_BYTES,
                    "fits": prof.retained_bytes + dsa <= roofline.HBM_BYTES}
    meta["graph_nodes"] = prof.meta["n_eqns"]
    s = aten_analysis.analyze(gm)
    meta["aten"] = {
        "dot_flops": s.dot_flops,
        "hbm_bytes": s.hbm_bytes,
        "coll_bytes": s.coll_bytes,
        "coll_bytes_by_kind": s.coll_bytes_by_kind,
        "coll_counts": s.coll_counts,
        "n_while": s.n_while,
        "trips": s.trips,
    }
    if args is not None and args.save_graph:
        path = os.path.join(args.out, "graph",
                            f"{meta['arch']}__{meta['shape']}__{meta['mesh_tag']}.py")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(gm.code)
    return meta


def report(dirpath: str, fmt: str = "md", mesh: str | None = "single") -> str:
    """``roofline.table`` of the records of mesh tag ``mesh`` (None: all)
    in ``dirpath`` with each cell's retained + DSA bytes (GB, per device)
    and whether they fit one card."""
    return roofline.table(roofline.load_cells(dirpath, mesh), fmt, extra=(
        ("retained+dsa_GB", lambda c: f"{c.raw['fits']['retained_plus_dsa'] / 1e9:.4g}"),
        ("fits", lambda c: str(c.raw["fits"]["fits"]))))


def supported(arch: str, shape_name: str) -> bool:
    return get_config(arch).supports_shape(SHAPES[shape_name])


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--arch", default="all")
    p.add_argument("--shape", default="all")
    p.add_argument("--mesh", default="single", choices=["single", "multi", "both"],
                   help="single: one H100; multi: the reference's (pod 2, data 16, "
                        "model 16) mesh, traced as rank 0 of a 512-rank fake "
                        "process group; both: each")
    p.add_argument("--out", default="results/dryrun_torch")
    p.add_argument("--device", default="cuda",
                   help="device of the fake tensors (cuda needs a visible card, "
                        "as every entry point of the port; the counts do not "
                        "depend on it)")
    p.add_argument("--attn-impl", default="auto")
    p.add_argument("--attn-chunk", type=int, default=1024)
    p.add_argument("--loss-impl", default="full")
    p.add_argument("--loss-chunk", type=int, default=512)
    p.add_argument("--microbatches", type=int, default=1)
    p.add_argument("--no-remat", action="store_true")
    p.add_argument("--softmax-dtype", default="float32")
    p.add_argument("--cp-attention", action="store_true")
    p.add_argument("--moe-grouped", action="store_true")
    p.add_argument("--shard-cache-len", action="store_true")
    p.add_argument("--sp-residual", action="store_true")
    p.add_argument("--ssd-shard-p", action="store_true")
    p.add_argument("--save-graph", action="store_true",
                   help="write each cell's traced graph code under OUT/graph")
    p.add_argument("--tag", default="")
    p.add_argument("--list", action="store_true")
    p.add_argument("--report", choices=["md", "csv"],
                   help="print the roofline table of the records in OUT (no tracing)")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    archs = ARCHS if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    cells = [(a, s, mp) for a in archs for s in shapes for mp in meshes]
    if args.report:
        print(report(args.out, args.report, {"single": "single", "multi": "multi",
                                             "both": None}[args.mesh]))
        return
    if args.list:
        for a, s, mp in cells:
            ok = supported(a, s)
            print(f"{a:24s} {s:12s} {'multi' if mp else 'single':6s} "
                  f"{'RUN' if ok else 'SKIP (DESIGN.md §4)'}")
        return
    run_opts_for(None, args, multi_pod=False not in meshes)   # knobs without a mesh raise

    os.makedirs(args.out, exist_ok=True)
    try:
        n_ok, n_skip, n_fail = _run_cells(cells, args)
    finally:
        if True in meshes:
            end_process_group()
    print(f"done: ok={n_ok} skip={n_skip} fail={n_fail}")
    if n_fail:
        raise SystemExit(1)


def _run_cells(cells: list, args) -> tuple:
    n_ok = n_skip = n_fail = 0
    for arch, shape_name, multi_pod in cells:
        mesh_tag = "multi" if multi_pod else "single"
        tag = f"{arch}__{shape_name}__{mesh_tag}"
        out_path = os.path.join(args.out, tag + (args.tag and f"__{args.tag}") + ".json")
        if not supported(arch, shape_name):
            n_skip += 1
            print(f"[skip] {tag} (full attention at 500k — DESIGN.md §4)")
            continue
        try:
            t0 = time.time()
            mesh = make_production_mesh(multi_pod=multi_pod, device=args.device)
            gm, meta = lower_cell(arch, shape_name, mesh, args)
            meta["mesh_tag"] = mesh_tag
            meta["trace_s"] = round(time.time() - t0, 2)
            meta = analyze_cell(gm, meta, args)
            meta["status"] = "ok"
            with open(out_path, "w") as f:
                json.dump(meta, f, indent=1)
            h, m = meta["aten"], meta["memory_analysis"]
            kinds = " ".join(f"{k}={v:.3g}" for k, v in h["coll_bytes_by_kind"].items())
            print(f"[ok]   {tag} trace={meta['trace_s']}s plan={meta['plan_s']}s "
                  f"flops={h['dot_flops']:.3g} hbm={h['hbm_bytes']:.3g} "
                  f"coll={h['coll_bytes']:.3g}{' (' + kinds + ')' if kinds else ''} "
                  f"retained={m['argument_bytes']:.3g} "
                  f"dsa={m['temp_bytes']:.3g} fits={meta['fits']['fits']}", flush=True)
            n_ok += 1
        except Exception as e:
            n_fail += 1
            err = {"status": "fail", "arch": arch, "shape": shape_name,
                   "mesh_tag": mesh_tag, "error": str(e)[:2000],
                   "traceback": traceback.format_exc()[-4000:]}
            with open(out_path, "w") as f:
                json.dump(err, f, indent=1)
            print(f"[FAIL] {tag}: {str(e)[:300]}", flush=True)
    return n_ok, n_skip, n_fail


if __name__ == "__main__":
    main()
