"""The reference's dry run over a (pod, data, model) mesh of XLA host
devices, for ``test_torch_dryrun_mesh.py`` and a full-size check by hand.

Run as a script, in a process of its own: it sets ``XLA_FLAGS`` to the
mesh's device count before JAX starts, so it never imports
``repro.launch.dryrun`` (which sets 512 at import).  It builds a
``jax.sharding.Mesh`` with the axes of the reference's multi-pod mesh
(``jax.make_mesh`` would make them Explicit, which the reference's
``with_sharding_constraint`` calls refuse), lowers the reference's train
(full remat unless ``--no-remat``), prefill and decode steps over it as
``repro.launch.dryrun.lower_cell`` does, compiles them and prints one line
``RESULT {json}``: per kind the per-device ``hlo_analysis`` summary (dot
FLOPs, HBM bytes, collective wire bytes by kind and counts),
``memory_analysis`` and the compile seconds.

    python tests/torch_dryrun_mesh_reference.py --arch qwen2-0.5b --mesh 2,2,2 \\
        --smoke --batch 4 --seq 64 --kinds train,prefill,decode
    python tests/torch_dryrun_mesh_reference.py --arch qwen2-0.5b --mesh 2,16,16 \\
        --kinds train          # the registered config at train_4k's shape
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="qwen2-0.5b")
    p.add_argument("--mesh", default="2,2,2")
    p.add_argument("--smoke", action="store_true", help="the config's smoke() size")
    p.add_argument("--batch", type=int, help="default: the registered shape's")
    p.add_argument("--seq", type=int, help="default: the registered shape's")
    p.add_argument("--kinds", default="train,prefill,decode")
    p.add_argument("--no-remat", action="store_true")
    args = p.parse_args()
    shape = tuple(int(x) for x in args.mesh.split(","))
    os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={math.prod(shape)}"
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh

    from repro.configs import SHAPES, get_config
    from repro.launch import hlo_analysis
    from repro.models import RunOpts, Transformer
    from repro.optim.adamw import AdamWConfig
    from repro.runtime import serve_lib, train_lib

    mesh = Mesh(np.array(jax.devices()).reshape(shape), ("pod", "data", "model"))
    cfg = get_config(args.arch)
    cfg = cfg.smoke() if args.smoke else cfg
    model = Transformer(cfg, RunOpts())
    registered = {"train": "train_4k", "prefill": "prefill_32k", "decode": "decode_32k"}
    out = {}
    for kind in args.kinds.split(","):
        reg = SHAPES[registered[kind]]
        b, s = args.batch or reg.global_batch, args.seq or reg.seq_len
        specs = {"tokens": jax.ShapeDtypeStruct((b, s + 1 if kind == "train" else s),
                                                jnp.int32)}
        if cfg.is_encoder_decoder:
            specs["frames"] = jax.ShapeDtypeStruct((b, cfg.encoder_seq, cfg.d_model),
                                                   jnp.dtype(cfg.dtype))
        t0 = time.time()
        if kind == "train":
            acfg, topts = AdamWConfig(), train_lib.TrainOpts(remat=not args.no_remat)
            step, _ = train_lib.build_train_step(model, mesh, acfg, topts, batch_sds=specs)
            lowered = step.lower(train_lib.abstract_state(model, acfg, topts), specs)
        elif kind == "prefill":
            step = serve_lib.build_prefill_step(model, mesh, batch_sds=specs, max_len=s)
            lowered = step.lower(model.abstract(), specs)
        else:
            step = serve_lib.build_decode_step(model, mesh, batch=b, max_len=s)
            lowered = step.lower(model.abstract(), model.cache_spec(b, s),
                                 jax.ShapeDtypeStruct((b,), jnp.int32))
        compiled = lowered.compile()
        summary = hlo_analysis.analyze(compiled.as_text())
        ma = compiled.memory_analysis()
        out[kind] = {
            "batch": b, "seq": s, "compile_s": round(time.time() - t0, 2),
            "dot_flops": summary.dot_flops, "hbm_bytes": summary.hbm_bytes,
            "coll_bytes": summary.coll_bytes,
            "coll_bytes_by_kind": summary.coll_bytes_by_kind,
            "coll_counts": summary.coll_counts,
            "argument_bytes": int(ma.argument_size_in_bytes),
            "temp_bytes": int(ma.temp_size_in_bytes),
        }
    print("RESULT " + json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
