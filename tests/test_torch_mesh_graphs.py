"""CUDA graphs wherever the reference compiles a serving step: under a
``DeviceMesh`` (the runner's buckets, the slab decode step, the padded
prefill) and for the encoder-decoder's prefill with frames.

On the CPU: a graph binds a DTensor leaf by its local tensor
(``runtime.graphs._signature``); the steps a graph captures under a mesh
read no device value on the host, build no tensor from host data and, on
the one-card mesh, issue no collective (``torch_capture_check``), on the
one-card gloo mesh in this process and on the (data 2, model 2) gloo mesh
of ``torch_sharded_worker.py``'s 4 ranks; the frames prefill's signature,
its static-buffer body against ``Transformer.prefill`` and the reference's
jitted prefill at whisper's ``smoke()`` size in f32 (max-abs 1e-5, as in
``test_torch_whisper.py``, whose weights these are), and that body on
``meta`` tensors.

The same on the card, with real graphs: ``test_torch_mesh_graphs_card.py``
(no JAX import).
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import RunOpts as JRunOpts
from repro.models import Transformer as JTransformer
from repro.runtime import serve_lib as jserve_lib
from repro_torch.configs import get_config
from repro_torch.launch.mesh import end_process_group, one_card_mesh
from repro_torch.models import RunOpts, Transformer, params_from_jax
from repro_torch.runtime import graphs as graphs_lib
from repro_torch.runtime import mesh_ctx, serve_lib
from repro_torch.runtime.serve_lib import PrefillStep
from torch_capture_check import capture_check, mesh_steps_report
from torch_port_utils import max_err, ref_params

TOL = 1e-5
WORKER = os.path.join(os.path.dirname(__file__), "torch_sharded_worker.py")
STEPS = ("runner:paged", "runner:gather", "slab", "prefill")
WHISPER = "whisper-small"


@pytest.fixture(scope="module")
def cpu_mesh():
    """The one-card mesh on the CPU: a world-size-1 gloo group, ended with
    the module."""
    mesh = one_card_mesh("cpu")
    try:
        yield mesh
    finally:
        end_process_group()


# --------------------------------------------------------------------------
# (a) a graph binds a DTensor leaf by its local tensor
# --------------------------------------------------------------------------


def test_signature_of_a_dtensor_leaf_is_its_local_tensors(cpu_mesh):
    """A placed leaf signs as its local tensor (here the plain leaf's own
    storage); a leaf placed anew holds another local tensor and no longer
    binds; a leaf already placed keeps its DTensor."""
    leaf = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 3, 8, 2, 16)).astype(np.float32))      # (L, B, C, kv, hd)
    cache = serve_lib.place_cache({"k": leaf}, cpu_mesh)
    dt = cache["k"]
    assert mesh_ctx.is_dtensor(dt)
    sig = graphs_lib._signature([dt])
    assert sig == graphs_lib._signature([dt.to_local()]) == [(leaf.data_ptr(), leaf.shape)]
    g = graphs_lib.StepGraph.__new__(graphs_lib.StepGraph)   # binds() without a card
    params = object()
    g.params, g._sig = params, sig
    assert g.binds(params, [dt]) and not g.binds(object(), [dt])
    assert serve_lib.place_cache(cache, cpu_mesh)["k"] is dt
    again = serve_lib.place_cache({"k": leaf.clone()}, cpu_mesh)["k"]
    assert torch.equal(again.to_local(), dt.to_local())
    assert not g.binds(params, [again])


# --------------------------------------------------------------------------
# (b) capture safety of the mesh steps: one card here, four gloo ranks
# --------------------------------------------------------------------------


def _qwen2_smoke():
    """qwen2-0.5b at ``smoke()`` size in f32 on the CPU with the kernels'
    plain versions, and the reference's seeded parameters for it."""
    jcfg = jget_config("qwen2-0.5b").smoke()
    model = Transformer(get_config("qwen2-0.5b").smoke().with_overrides(dtype="float32"),
                        RunOpts(attention_impl="kernel"), device="cpu")
    return model, params_from_jax(ref_params(jcfg, 3)[1])


@pytest.fixture(scope="module")
def one_card_report(cpu_mesh):
    model, params = _qwen2_smoke()
    return mesh_steps_report(model, model.load(params), cpu_mesh)


@pytest.fixture(scope="module")
def four_rank_report(tmp_path_factory):
    """The worker's ``capture`` case on 4 gloo ranks (a subprocess, as
    ``test_torch_sharded_steps.py`` runs it); rank 0's report."""
    tmp = tmp_path_factory.mktemp("mesh_graphs")
    _, params = _qwen2_smoke()
    torch.save({"qwen2-0.5b": {"params": params}}, tmp / "inputs.pt")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, WORKER, str(tmp), "capture"], env=env,
                          timeout=240, capture_output=True, text=True)
    errors = "".join((tmp / f).read_text() for f in sorted(os.listdir(tmp))
                     if f.startswith("error_rank"))
    assert proc.returncode == 0, (errors or proc.stderr)[-6000:]
    with open(tmp / "results.json") as f:
        out = json.load(f)
    assert set(out["seconds"]) == {"capture"}
    return out["capture"]


@pytest.mark.parametrize("step", STEPS)
def test_mesh_steps_are_capture_safe_on_the_one_card_mesh(one_card_report, step):
    """No host read, no tensor built from host data, no collective."""
    assert set(one_card_report) == set(STEPS)
    assert one_card_report[step] == {"host": [], "built": [], "comm": {}}


@pytest.mark.parametrize("step", STEPS)
def test_mesh_steps_are_capture_safe_on_four_ranks(four_rank_report, step):
    """No host read and no tensor built from host data on a (data 2, model
    2) mesh, where the steps' collectives (the row-parallel partial sums,
    the logits made whole over a vocabulary split over ``model``) are part
    of what a capture holds."""
    r = four_rank_report[step]
    assert r["host"] == [] and r["built"] == []
    assert sum(r["comm"].values()) > 0, r["comm"]


# --------------------------------------------------------------------------
# (c) the encoder-decoder's frames prefill
# --------------------------------------------------------------------------


def _redraw_qk(np_tree, d_model: int) -> None:
    """wq/wk of every attention at std 1/sqrt(d_model), as
    ``test_torch_whisper.py`` draws them (its docstring says why)."""
    rng = np.random.default_rng(d_model)
    for block in (np_tree["pattern"]["0"], np_tree["encoder"]["blocks"]):
        for name in ("attn", "xattn"):
            for w in ("wq", "wk") if name in block else ():
                leaf = block[name][w]
                block[name][w] = (rng.standard_normal(leaf.shape)
                                  / np.sqrt(d_model)).astype(np.float32)


@pytest.fixture(scope="module")
def whisper():
    """(reference model, its params, port model, loaded params) at
    ``smoke()`` size in f32."""
    jcfg = jget_config(WHISPER).smoke()
    _, np_tree = ref_params(jcfg, 0)
    _redraw_qk(np_tree, jcfg.d_model)
    jm = JTransformer(jcfg, JRunOpts(attention_impl="pallas"))
    tm = Transformer(get_config(WHISPER).smoke(), RunOpts(attention_impl="kernel"),
                     device="cpu")
    return jm, jax.tree.map(jnp.asarray, np_tree), tm, tm.load(params_from_jax(np_tree))


def _whisper_batch(cfg, b: int, s: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
            "frames": rng.standard_normal((b, cfg.encoder_seq, cfg.d_model)).astype(
                np.float32)}


def test_frames_prefill_signature_keys_the_frames_shape_and_dtype(whisper):
    """One signature per (tokens shape, ``true_len`` given, frames shape and
    dtype); other frames of the shape share it.  On the CPU the step runs
    eagerly and its hook fires once per signature."""
    *_, tm, tp = whisper
    cfg = tm.cfg
    a = {k: torch.from_numpy(v) for k, v in _whisper_batch(cfg, 2, 4, 1).items()}
    b = {k: torch.from_numpy(v) for k, v in _whisper_batch(cfg, 2, 4, 2).items()}
    sig = PrefillStep.signature(a)
    assert sig == PrefillStep.signature(b)
    assert sig == ((2, 4), False, ((2, cfg.encoder_seq, cfg.d_model), torch.float32))
    others = [{**a, "frames": a["frames"].double()},
              {"tokens": a["tokens"][:1], "frames": a["frames"][:1]},
              {**a, "true_len": torch.tensor(3)}, {"tokens": a["tokens"]}]
    assert len({sig, *map(PrefillStep.signature, others)}) == 5
    hooks = []
    step = serve_lib.build_prefill_step(tm, None, max_len=8, trace_hook=hooks.append)
    for batch in (a, b, others[1]):
        step(tp, batch)
    assert len(hooks) == 2 and step.stats()["n_captures"] == 0 and not step.graphs


def test_frames_prefill_static_body_matches_prefill_and_reference(whisper):
    """The graph's body, ``_eager`` over the static buffers filled from a
    batch, gives ``Transformer.prefill``'s logits and cache (``xk``/``xv``
    included) and the reference's jitted prefill's; refilled with other
    frames of the shape, the other batch's."""
    jm, jp, tm, tp = whisper
    cfg = tm.cfg
    step = serve_lib.build_prefill_step(tm, None, max_len=16, graphs=False)
    jstep = jserve_lib.build_prefill_step(jm, None, max_len=16)
    first = {k: torch.from_numpy(v) for k, v in _whisper_batch(cfg, 3, 4, 5).items()}
    static = step._buffers(first)
    assert set(static) == {"tokens", "frames"}
    for seed in (5, 6):
        np_batch = _whisper_batch(cfg, 3, 4, seed)
        batch = {k: torch.from_numpy(v) for k, v in np_batch.items()}
        step._fill(static, batch)
        assert static["frames"] is not batch["frames"]
        logits, cache = step._eager(tp, static)
        want_l, want_c = tm.prefill(tp, batch, max_len=16)
        jl, jc = jstep(jp, {k: jnp.asarray(v) for k, v in np_batch.items()})
        assert max_err(want_l, logits) < TOL and max_err(jl, logits) < TOL
        assert set(cache) == {"pos", "k", "v", "xk", "xv"}
        for name, leaf in cache.items():
            assert max_err(want_c[name], leaf) < TOL, name
            if name != "pos":
                assert max_err(jc["pattern"]["0"][name], leaf) < TOL, name
        assert cache["pos"].tolist() == np.asarray(jc["pos"]).tolist() == [4] * 3


def test_frames_prefill_body_is_capture_safe(whisper):
    """The same body on ``meta`` tensors (the plain attention: no kernel
    takes meta): no op reads a value on the host or takes a host tensor,
    and nothing is built on the host for the device (the encoder's
    sinusoid frequencies were put on the device at init)."""
    tm = whisper[2]
    model = Transformer(tm.cfg, RunOpts(attention_impl="full"), device="meta")
    params = model.load(Transformer(tm.cfg, device="cpu").init(
        torch.Generator().manual_seed(0)))
    step = serve_lib.build_prefill_step(model, None, max_len=16, graphs=False)
    batch = {"tokens": torch.zeros((2, 4), dtype=torch.int32, device="meta"),
             "frames": torch.zeros((2, tm.cfg.encoder_seq, tm.cfg.d_model),
                                   device="meta")}
    static = step._buffers(batch)
    with capture_check(cpu_is_host=True) as (host, built, comm):
        logits, cache = step._eager(params, static)
    assert host.seen == [] and built == []
    assert logits.shape == (2, tm.cfg.padded_vocab) and cache["xk"].device.type == "meta"
