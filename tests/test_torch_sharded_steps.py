"""The port's sharded steps on a (data 2, model 2) mesh of 4 gloo ranks on
the CPU, each held against the same step unsharded (and, where the
reference has the number, against the reference).

One module-scoped fixture makes the seeded inputs here (the reference's
parameters at ``smoke()`` size in f32, through ``params_from_jax``, with
every ``wq``/``wk`` redrawn at 1/sqrt(d_model), as ``test_torch_pattern_
train.py`` does: the reference's init makes the hybrid's gradient move
~1.5e-4 under f32 rounding alone), computes the reference's numbers in this
process and writes the inputs to ``tmp_path``; then one ``subprocess.run``
of ``tests/torch_sharded_worker.py`` spawns the ranks, as
``tests/test_sharding_small_mesh.py`` does, so no pytest worker starts a
process group itself.  The ranks meet through a ``FileStore`` there.

Tolerances (f32): each step's loss within 1e-5 relative; the first step's
gradient within 1e-5 relative in L2; the parameters after three AdamW
steps within 1e-4 relative in L2 (AdamW divides by sqrt(v): a near-zero
gradient's rounding in the all-reduce moves its update by a whole step);
logits within 1e-5 relative to their largest magnitude; token streams and
checkpoints exactly.
"""
import json
import os
import subprocess
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import RunOpts as JRunOpts
from repro.models import Transformer as JTransformer
from repro.models import moe as jmoe
from repro.optim import adamw as jadamw
from repro.runtime import train_lib as jtrain_lib
from repro_torch.models import params_from_jax
from torch_port_utils import ref_params

LOSS_TOL = GRAD_TOL = LOGIT_TOL = 1e-5
PARAM_TOL = 1e-4
ARCHS = ("qwen2-0.5b", "granite-moe-1b-a400m", "recurrentgemma-9b", "mamba2-130m")
WORKER = os.path.join(os.path.dirname(__file__), "torch_sharded_worker.py")


def _redraw_qk(np_tree, d_model: int) -> None:
    rng = np.random.default_rng(d_model)
    for block in [*np_tree["pattern"].values(), *np_tree.get("tail", {}).values()]:
        for w in ("wq", "wk") if "attn" in block else ():
            leaf = block["attn"][w]
            block["attn"][w] = (rng.standard_normal(leaf.shape)
                                / np.sqrt(d_model)).astype(np.float32)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded")
    rng = np.random.default_rng(0)
    inputs, ref = {}, {}
    for arch in ARCHS:
        jcfg = jget_config(arch).smoke()
        _, np_tree = ref_params(jcfg)
        _redraw_qk(np_tree, jcfg.d_model)
        batches = [{"tokens": rng.integers(0, jcfg.vocab_size, (4, 17)).astype(np.int32)}
                   for _ in range(3)]
        inputs[arch] = {"params": params_from_jax(np_tree),
                        "batches": [{k: torch.from_numpy(v) for k, v in b.items()}
                                    for b in batches],
                        "prompt": torch.from_numpy(
                            rng.integers(0, jcfg.vocab_size, (4, 16)).astype(np.int32))}
        if arch == "qwen2-0.5b":
            jparams = jax.tree.map(jnp.asarray, np_tree)
            jm = JTransformer(jcfg, JRunOpts(attention_impl="full"))
            acfg = jadamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
            step, _ = jtrain_lib.build_train_step(
                jm, None, acfg, jtrain_lib.TrainOpts(remat=False, donate=False))
            state = {"params": jparams, "opt": jadamw.init(jparams),
                     "step": jnp.zeros((), jnp.int32)}
            ref["qwen2_losses"] = []
            for b in batches:
                state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
                ref["qwen2_losses"].append(float(m["loss"]))
        if arch == "granite-moe-1b-a400m":
            layer = {k: np.array(v[0]) for k, v in np_tree["pattern"]["0"]["mlp"].items()}
            x = rng.standard_normal((4, 8, jcfg.d_model)).astype(np.float32)
            with mock.patch.object(jmoe.mesh_ctx, "shard", lambda a, *axes: a):
                jy, jaux = jmoe._moe_mlp_grouped(
                    jnp.asarray(x), {k: jnp.asarray(v) for k, v in layer.items()},
                    jcfg, jnp.float32, 2)
            ref["moe_y"], ref["moe_aux"] = np.asarray(jy), float(jaux)
            inputs["moe"] = {"x": torch.from_numpy(x),
                             "layer": {k: torch.from_numpy(v) for k, v in layer.items()}}
    torch.save(inputs, tmp / "inputs.pt")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, WORKER, str(tmp)], env=env, timeout=300,
                          capture_output=True, text=True)
    errors = "".join((tmp / f).read_text() for f in sorted(os.listdir(tmp))
                     if f.startswith("error_rank"))
    assert proc.returncode == 0, (errors or proc.stderr)[-6000:]
    with open(tmp / "results.json") as f:
        out = json.load(f)
    return out, ref


def _rel(a, b) -> float:
    return abs(a - b) / abs(b)


def _assert_train(r):
    assert r["dtensor_state"], "the mesh's state is not DTensors"
    for got, want in zip(r["loss_sharded"], r["loss_unsharded"]):
        assert _rel(got, want) <= LOSS_TOL, (r["loss_sharded"], r["loss_unsharded"])
    assert _rel(*r["loss0_grad_fn"][::-1]) <= LOSS_TOL
    assert r["grad_rel"] <= GRAD_TOL
    assert r["param_rel"] <= PARAM_TOL


@pytest.mark.parametrize("remat", ["none", "full"])
def test_qwen2_adamw_steps_match_unsharded_and_the_reference(run, remat):
    out, ref = run
    r = out[f"qwen2:{remat}"]
    _assert_train(r)
    assert r["batch_spec"] == ["data", "None"]
    for got, want in zip(r["loss_unsharded"], ref["qwen2_losses"]):
        assert _rel(got, want) <= LOSS_TOL


@pytest.mark.parametrize("case", ["microbatches", "compress_grads"])
def test_qwen2_train_options_on_the_mesh(run, case):
    _assert_train(run[0][f"qwen2:{case}"])


@pytest.mark.parametrize("case", ["qwen2:sp_residual", "qwen2:cp_attention",
                                  "mamba2:ssd_shard_p"])
def test_mesh_knobs_one_at_a_time(run, case):
    _assert_train(run[0][case])


@pytest.mark.parametrize("arch", ["granite-moe", "recurrentgemma", "mamba2"])
def test_other_families_train_sharded(run, arch):
    _assert_train(run[0][arch])


def test_moe_grouped_dispatch_matches_the_reference_at_two_groups(run):
    out, ref = run
    r = out["moe_grouped"]
    assert r["n_groups"] == 2
    y = np.asarray(r["y"], np.float32)
    assert np.abs(y - ref["moe_y"]).max() <= LOGIT_TOL * np.abs(ref["moe_y"]).max()
    assert _rel(r["aux"], ref["moe_aux"]) <= LOSS_TOL


@pytest.mark.parametrize("case", ["plain", "cp"])
def test_prefill_and_decode_steps_match_unsharded(run, case):
    """plain: prefill, then 4 decode steps with shard_cache_len; cp: the
    prefill under cp_attention."""
    r = run[0]["serving"][case]
    assert r["cache_dtensor"]
    assert max(r["rel"]) <= LOGIT_TOL, r["rel"]
    assert r["decode_steps"] == (4 if case == "plain" else 0)
    # the cache (L, B, C, kv, hd): batch over data; the prefill's kv heads
    # over model, the shard_cache_len decode's cache length
    want = "Shard(2)" if case == "plain" else "Shard(3)"
    assert r["k_placements"] == ["Shard(1)", want]


@pytest.mark.parametrize("case", ["qwen2-0.5b:paged", "qwen2-0.5b:gather"])
def test_engine_streams_on_the_mesh_equal_unsharded(run, case):
    r = run[0]["engine"][case]
    assert r["equal"] and len(r["streams"]) == 4


def test_remesh_then_step_and_checkpoint_restore(run):
    r = run[0]["elastic"]
    assert r["mesh"] == [1, 2]
    assert _rel(r["loss"][1], r["loss"][0]) <= LOSS_TOL
    assert r["param_rel"] <= GRAD_TOL
    assert r["ckpt_max_abs"] == 0.0 and r["restored_on_new_mesh"]


def test_no_gather_of_qkv_around_the_kernels(run):
    r = run[0]["comm"]
    for call in ("flash", "paged"):
        assert not any("all_gather" in op for op in r[call]), r[call]
    assert r["flash_err"] <= 1e-6 and r["paged_err"] <= 1e-6
    assert r["wrappers_refuse_dtensor"] == [True] * 4


def test_every_case_ran_on_the_four_ranks(run):
    """Rank 0 timed each case (its seconds are in ``results.json``; ~55 s
    in all on an idle 8-core CPU, the subprocess's limit 300 s)."""
    assert set(run[0]["seconds"]) == {
        "qwen2:none", "qwen2:full", "qwen2:microbatches", "qwen2:compress_grads",
        "qwen2:sp_residual", "qwen2:cp_attention", "mamba2:ssd_shard_p", "granite-moe",
        "recurrentgemma", "mamba2", "moe_grouped", "serving", "engine", "comm", "elastic"}
