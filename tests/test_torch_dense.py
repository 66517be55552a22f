"""The untied dense decoders against the reference: mistral-nemo-12b (G = 4,
attention width 64 against d_model 96), starcoder2-15b (G = 12, LayerNorm,
the ungated tanh-gelu MLP with ``b_up``/``b_down``, q/k/v biases) and
chameleon-34b (G = 8), each at the small layout of
``torch_port_utils.DENSE_SMALL`` with the reference's weights converted by
``params_from_jax`` (every zero leaf randomised, so each bias carries
weight).  The reference runs its Pallas kernels in interpret mode
(tests/conftest.py), the port its wrappers' plain versions.

Tolerances: f32 logits max-abs 1e-5 (|logits| ~1; observed ~1e-6) with
equal argmaxes, caches 1e-5 of their largest magnitude; token streams,
scheduler and page-pool decisions exact; the training loss within 1e-5 relative and the whole gradient within 1e-5
relative in L2 (``test_torch_train``'s limits).
"""
import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticPipeline as JPipeline
from repro.models import Transformer as JTransformer
from repro_torch.configs import get_config
from repro_torch.models import RunOpts, Transformer, params_from_jax
from repro_torch.models.transformer import _unsupported
from test_torch_model import _staggered, _to_pages
from test_torch_serving import _assert_same, _run_both
from test_torch_train import _check_loss_and_gradients
from torch_port_utils import (DENSE_SMALL, arch_params, max_err, models, prompt, ref_params,
                              small_cfgs)

TOL = 1e-5
ARCHS = sorted(DENSE_SMALL)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return models("float32", arch=request.param)


def test_layouts_keep_what_sets_each_config_apart(pair):
    _, _, tm, tp = pair
    cfg = tm.cfg
    group = cfg.n_heads // cfg.n_kv_heads
    assert "lm_head" in tp and not cfg.tie_embeddings
    if cfg.name == "mistral-nemo-12b":
        assert group == 4 and cfg.n_heads * cfg.resolved_head_dim != cfg.d_model
        assert cfg.rope_theta == 1e6
    elif cfg.name == "starcoder2-15b":
        assert group == 12 and cfg.norm == "layernorm" and cfg.act == "gelu"
        layer = tp["layers"][0]
        assert {"b_up", "b_down"} <= set(layer["mlp"]) and "w_gate" not in layer["mlp"]
        assert {"bq", "bk", "bv"} <= set(layer["attn"])
        assert set(tp["final_norm"]) == {"scale", "bias"}
    else:
        assert group == 8


def test_prefill_and_forward_match_reference(pair):
    """Prefill with ``true_len`` (reference: Pallas flash in interpret mode;
    port: the flash wrapper's plain version) and the full forward."""
    jm, jp, tm, tp = pair
    toks = np.stack([prompt(jm.cfg, 41, 16), prompt(jm.cfg, 42, 16)])
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks),
                             "true_len": jnp.asarray(11, jnp.int32)}, max_len=24)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks), "true_len": 11},
                        max_len=24)
    assert max_err(jl, tl) < TOL
    assert tc["pos"].tolist() == np.asarray(jc["pos"]).tolist() == [11, 11]
    for name in ("k", "v"):          # K/V of ~20 deep in the stack: 1e-5 of the scale
        want = jc["pattern"]["0"][name]
        assert tuple(tc[name].shape) == want.shape
        assert max_err(want, tc[name]) < TOL * max(1.0, float(jnp.abs(want).max()))
    jf = jm.forward(jp, jnp.asarray(toks))
    tf = tm.forward(tp, torch.from_numpy(toks))
    assert max_err(jf, tf) < TOL
    assert np.asarray(jnp.argmax(jf, -1)).tolist() == tf.argmax(-1).tolist()


def test_gather_decode_steps_match_reference(pair):
    """Five decode steps over the contiguous cache, each row on its own clock."""
    jm, jp, tm, tp = pair
    jc, tc = _staggered(jm, jp, tm, tp)
    tok = np.array([5, 7, 9], np.int32)
    for _ in range(5):
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(tok))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(tok))
        assert max_err(jl, tl) < TOL
        assert tc["pos"].tolist() == np.asarray(jc["pos"]).tolist()
        tok = np.array(jnp.argmax(jl, -1), np.int32)
        assert tok.tolist() == tl.argmax(-1).tolist()


def test_paged_decode_steps_match_reference(pair):
    """Five paged decode steps (reference: the Pallas paged kernel in
    interpret mode; port: the paged wrapper's plain version) on permuted
    page tables, the rows' clocks crossing page boundaries."""
    jm, jp, tm, tp = pair
    jc, tc = _staggered(jm, jp, tm, tp)
    pt, maxp = 4, 5
    tables = np.random.default_rng(11).permutation(3 * maxp).astype(np.int32).reshape(3, maxp)
    kp = _to_pages(jc["pattern"]["0"]["k"], 16, pt, tables)
    vp = _to_pages(jc["pattern"]["0"]["v"], 16, pt, tables)
    jcache = {"pos": jc["pos"], "block_tables": jnp.asarray(tables),
              "pattern": {"0": {"k_pages": jnp.asarray(kp), "v_pages": jnp.asarray(vp)}}}
    tcache = {"pos": tc["pos"].clone(), "block_tables": torch.from_numpy(tables),
              "k_pages": torch.from_numpy(kp.copy()), "v_pages": torch.from_numpy(vp.copy())}
    tok = np.array([3, 1, 4], np.int32)
    for _ in range(5):
        jl, jcache = jm.decode_step(jp, jcache, jnp.asarray(tok))
        tl, tcache = tm.decode_step(tp, tcache, torch.from_numpy(tok))
        assert max_err(jl, tl) < TOL
        tok = np.array(jnp.argmax(jl, -1), np.int32)
        assert tok.tolist() == tl.argmax(-1).tolist()
    want = jcache["pattern"]["0"]["v_pages"]
    assert max_err(want, tcache["v_pages"]) < TOL * max(1.0, float(jnp.abs(want).max()))


def test_engine_matches_reference_under_preemption(pair):
    """The engines on a trace the profile undersizes (profiled at 4
    generated tokens, live 10-16), so decode-outrun preemptions and §4.3
    replans churn the batch: token streams, summary and page stats equal."""
    shapes = [(i + 1, 5 + (3 * i) % 12, 4, 10 + (i + 1) % 7, 2 * i) for i in range(5)]
    jeng, js, teng, ts = _run_both(pair, shapes, max_len=64, max_batch=4, page_tokens=8)
    assert ts["n_preemptions"] > 0 and ts["n_completed"] == len(shapes)
    _assert_same(jeng, js, teng, ts)


def test_starcoder2_loss_and_gradients_match_reference():
    """The training loss and every leaf's gradient (LayerNorm scale and bias,
    the MLP's biases, the q/k/v biases, the untied head) against the
    reference's, on f32 master parameters."""
    jcfg, tcfg = small_cfgs(arch="starcoder2-15b")
    jparams, np_tree = arch_params("starcoder2-15b", jcfg, seed=5)
    tm = Transformer(tcfg, RunOpts(attention_impl="full", use_kernels=False), device="cpu")
    pipe = JPipeline(JDataConfig(vocab_size=jcfg.vocab_size, seq_len=16,
                                 global_batch=4, seed=2))
    _check_loss_and_gradients(JTransformer(jcfg), jparams, np_tree, tm, pipe.batch_at(0))


def test_load_keeps_layernorm_bias_f32_and_casts_the_other_biases():
    jcfg, tcfg = small_cfgs("bfloat16", "starcoder2-15b")
    _, np_tree = ref_params(jcfg)
    p = Transformer(tcfg, RunOpts(), device="cpu").load(params_from_jax(np_tree))
    layer = p["layers"][0]
    for norm in (layer["attn"]["norm"], layer["mlp_norm"], p["final_norm"]):
        assert norm["scale"].dtype == norm["bias"].dtype == torch.float32
    for leaf in (layer["mlp"]["b_up"], layer["mlp"]["b_down"], layer["attn"]["bq"],
                 layer["attn"]["bk"], layer["attn"]["bv"], p["lm_head"]):
        assert leaf.dtype == torch.bfloat16


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _paths(v, prefix + (i,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_carries_every_leaf(arch):
    """Every leaf of the reference's tree reaches the port, value for value,
    and the port's tree has the leaves and shapes of its own schema."""
    jcfg, tcfg = small_cfgs(arch=arch)
    _, np_tree = ref_params(jcfg, seed=3)
    p = params_from_jax(np_tree)
    schema = dict(_paths(Transformer(tcfg, device="cpu").schema()))
    got = dict(_paths(p))
    assert set(got) == set(schema)
    assert all(tuple(got[k].shape) == schema[k].shape for k in got)
    n_ref = 0
    for path, leaf in _paths(np_tree):
        if path[0] == "pattern":            # stacked (L, ...) under pattern["0"]
            for i in range(leaf.shape[0]):
                assert np.array_equal(got[("layers", i) + path[2:]].numpy(), leaf[i])
                n_ref += 1
        else:
            assert np.array_equal(got[path].numpy(), leaf)
            n_ref += 1
    assert n_ref == len(got)
    if arch == "starcoder2-15b":
        assert ("final_norm", "bias") in got and ("layers", 1, "mlp", "b_down") in got


@pytest.mark.parametrize("arch", ARCHS)
def test_full_configs_are_admitted_with_the_reference_schema(arch):
    """The registered configs build, and their parameter shapes are the
    reference's, layer by layer (``jax.eval_shape``: nothing allocated)."""
    cfg = get_config(arch)
    assert not _unsupported(cfg)
    tm = Transformer(cfg, device="cpu")
    shapes = jax.eval_shape(JTransformer(jget_config(arch)).init, jax.random.PRNGKey(0))
    want = {}
    for path, leaf in _paths(jax.tree.map(lambda s: s.shape, shapes,
                                          is_leaf=lambda s: hasattr(s, "shape"))):
        if path[0] == "pattern":
            for i in range(cfg.n_layers):
                want[("layers", i) + path[2:]] = tuple(leaf[1:])
        else:
            want[path] = tuple(leaf)
    got = {k: tuple(v.shape) for k, v in _paths(tm.schema())}
    assert got == want


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_runs_each_config_on_the_cpu(arch, capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", arch, "--device", "cpu", "--attn", "paged", "--requests", "4",
                "--max-batch", "2", "--max-len", "32"])
    out = capsys.readouterr().out
    assert f"[{arch} @ full size]" in out and "completed 4/4 requests" in out


@pytest.mark.parametrize("remat", ["none", "full", "planned"])
def test_train_cli_runs_starcoder2(remat):
    """The make_fx profile and the remat search take LayerNorm and gelu
    (``aten.native_layer_norm``, ``aten.gelu``); every policy trains."""
    from repro_torch.launch import train
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        train.main(["--arch", "starcoder2-15b", "--device", "cpu", "--preset", "tiny",
                    "--steps", "2", "--remat", remat, "--log-every", "1"])
    text = out.getvalue()
    assert "done: 2 steps" in text and "memory plan: peak=" in text
    losses = [float(l.split("loss=")[1].split()[0]) for l in text.splitlines()
              if l.startswith("step ")]
    assert len(losses) == 2 and all(np.isfinite(losses))
    if remat == "planned":
        line = next(l for l in text.splitlines() if l.startswith("remat plan:"))
        assert "aten.native_layer_norm.default" in line and "aten.gelu.default" in line
