"""The MoE decoders against the reference: ``models/moe.py`` (capacity, the
f32 router and top-k, the stable sort-based dispatch with its drops, the
batched SwiGLU experts, the combine, the Switch aux term, the grouped
dispatch) and granite-moe-1b-a400m (E = 32, k = 8, tied, G = 2) and
qwen3-moe-30b-a3b (E = 128, k = 8, untied, G = 8, attention width 128
against d_model 64) at the small layouts of ``torch_port_utils.MOE_SMALL``:
prefill, forward, gather decode, the engine with the bucketed runner and
with the slab step, the bridge, load dtypes, the full configs' schema and
both CLIs (training is in ``test_torch_moe_train.py``).  The reference
runs its Pallas flash kernel in interpret mode (tests/conftest.py), the
port its wrappers' plain versions.

Tolerances: f32 MoE outputs and logits max-abs 1e-5 (|y| ~1, |logits| ~1;
observed ~1e-7 to 2e-6 and ~1e-6: the router's and the experts' products
sum in other orders), the aux term 1e-6 of max(1, |aux|) (aux is ~1 for a
spread router and up to E/k, ~11 observed, for a skewed one, where 1e-6 is
one f32 ulp; observed ~1e-7 relative); ``keep``, ``dest``, the dispatch
buffer, token streams and the engine's decisions exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import Transformer as JTransformer
from repro.models import moe as jmoe
from repro.serving import ServeEngine as JServeEngine
from repro.serving.runner import DecodeRunner as JDecodeRunner
from repro_torch.configs import get_config
from repro_torch.models import RunOpts, Transformer, moe, params_from_jax
from repro_torch.models.transformer import _unsupported
from repro_torch.serving import DecodeRunner, ServeEngine, bucket_ladder
from test_torch_dense import _paths
from test_torch_model import _staggered
from test_torch_serving import _assert_same, _workload
from torch_port_utils import MOE_SMALL, max_err, models, prompt, ref_params, small_cfgs

TOL = 1e-5
AUX_TOL = 1e-6
ARCHS = sorted(MOE_SMALL)


def _aux_close(jaux, taux) -> bool:
    return abs(float(jaux) - float(taux)) < AUX_TOL * max(1.0, abs(float(jaux)))


# --------------------------------------------------------------------------
# models/moe.py
# --------------------------------------------------------------------------


def test_capacity_matches_reference():
    for t in (1, 7, 8, 16, 37, 600, 4800):
        for k, e in ((8, 32), (8, 128), (2, 8), (1, 4)):
            for factor in (1.0, 1.25, 2.0):
                assert moe.capacity(t, k, e, factor) == jmoe.capacity(t, k, e, factor)


def _expert_weights(cfg, seed: int, skew: bool):
    """One layer's MoE leaves as numpy f32.  ``skew`` adds to the router a
    direction that the inputs of ``_inputs(skew=True)`` share, so experts
    0..k-1 win for every token and overflow their capacity."""
    rng = np.random.default_rng(seed)
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    p = {"w_router": rng.standard_normal((d, e)) / np.sqrt(d),
         "w_gate": rng.standard_normal((e, d, f)) / np.sqrt(d),
         "w_up": rng.standard_normal((e, d, f)) / np.sqrt(d),
         "w_down": rng.standard_normal((e, f, d)) / np.sqrt(f)}
    if skew:
        p["w_router"][:, :cfg.top_k] += 8.0 / d
    return {k: v.astype(np.float32) for k, v in p.items()}


def _inputs(cfg, t: int, seed: int, skew: bool, batch: int = 1):
    x = np.random.default_rng(seed + 1).standard_normal((batch, t, cfg.d_model))
    return (x + (0.5 if skew else 0.0)).astype(np.float32)


def _reference_dispatch(x, p, cfg):
    """The reference's routing lines (``repro.models.moe.moe_mlp``: the f32
    router, ``lax.top_k``, the stable argsort, ``searchsorted``) in JAX on
    the CPU -> (keep, dest, token_of) as numpy."""
    e, k = cfg.n_experts, cfg.top_k
    xf = jnp.asarray(x.reshape(-1, cfg.d_model))
    t = xf.shape[0]
    c = jmoe.capacity(t, k, e, cfg.capacity_factor)
    probs = jax.nn.softmax(xf @ jnp.asarray(p["w_router"]), axis=-1)
    _, top_i = jax.lax.top_k(probs, k)
    eids = top_i.reshape(-1)
    order = jnp.argsort(eids, stable=True)
    sorted_eids = eids[order]
    seg_start = jnp.searchsorted(sorted_eids, jnp.arange(e))
    pos_in_e = jnp.arange(t * k) - seg_start[sorted_eids]
    dest = sorted_eids * c + jnp.minimum(pos_in_e, c - 1)
    return (np.asarray(pos_in_e < c), np.asarray(dest), np.asarray(order // k))


@pytest.mark.parametrize("skew", [False, True], ids=["spread", "skewed"])
@pytest.mark.parametrize("t", [1, 8, 37, 96])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_mlp_matches_reference(arch, t, skew, monkeypatch):
    """y, aux, ``keep``/``dest``/``token_of`` and the reference's own
    (E, C, d) dispatch buffer and expert outputs (caught where it shards
    them), below capacity, at it and past it; the skewed router makes
    experts overflow, and the drops are the reference's."""
    jcfg, tcfg = small_cfgs(arch=arch)
    p = _expert_weights(tcfg, seed=t, skew=skew)
    x = _inputs(tcfg, t, seed=t, skew=skew)
    caught = []
    monkeypatch.setattr(jmoe.mesh_ctx, "shard",
                        lambda a, *axes: caught.append(np.asarray(a)) or a)
    jy, jaux = jmoe.moe_mlp(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()},
                            jcfg, jnp.float32)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    ty, taux = moe.moe_mlp(torch.from_numpy(x), tp, tcfg, torch.float32)
    assert max_err(jy, ty) < TOL and _aux_close(jaux, taux)
    assert moe.moe_mlp(torch.from_numpy(x), tp, tcfg, torch.float32,
                       need_aux=False)[1] is None

    _, _, disp = moe.moe_groups(torch.from_numpy(x), tp, tcfg, torch.float32)
    keep, dest, token_of = (a[0].numpy() for a in (disp.keep, disp.dest, disp.token_of))
    want = _reference_dispatch(x, p, tcfg)
    for got, ref in zip((keep, dest, token_of), want):
        assert np.array_equal(got, ref)
    e, cap = tcfg.n_experts, moe.capacity(t, tcfg.top_k, tcfg.n_experts,
                                          tcfg.capacity_factor)
    buf = np.zeros((e * cap, tcfg.d_model), np.float32)
    buf[dest[keep]] = x[0][token_of[keep]]
    ref_buf, ref_y = caught
    assert np.array_equal(buf.reshape(e, cap, -1), ref_buf)
    assert ref_y.shape == (e, cap, tcfg.d_model)
    dropped = int((~keep).sum())
    if t <= cap:                       # one token meets an expert at most once
        assert dropped == 0
    if skew and t >= 37:
        assert dropped > 0


@pytest.mark.parametrize("n_groups", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_grouped_dispatch_matches_reference(arch, n_groups):
    """``_moe_mlp_grouped`` against the reference's, called directly: each
    batch-major group with its own capacity, aux the mean of the groups'."""
    jcfg, tcfg = small_cfgs(arch=arch)
    p = _expert_weights(tcfg, seed=n_groups, skew=True)
    x = _inputs(tcfg, 24, seed=n_groups, skew=True, batch=4)
    jy, jaux = jmoe._moe_mlp_grouped(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()},
                                     jcfg, jnp.float32, n_groups)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    ty, taux = moe._moe_mlp_grouped(torch.from_numpy(x), tp, tcfg, torch.float32, n_groups)
    assert max_err(jy, ty) < TOL and _aux_close(jaux, taux)
    # without a mesh, grouped=True runs ungrouped in both packages
    jy1, _ = jmoe.moe_mlp(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()},
                          jcfg, jnp.float32, grouped=True)
    ty1, _ = moe.moe_mlp(torch.from_numpy(x), tp, tcfg, torch.float32, grouped=True)
    assert moe._n_data_groups() == 1 and max_err(jy1, ty1) < TOL
    assert not torch.equal(ty1, ty)


# --------------------------------------------------------------------------
# the models
# --------------------------------------------------------------------------


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return models("float32", arch=request.param)


def test_layouts_keep_what_sets_each_config_apart(pair):
    _, _, tm, tp = pair
    cfg = tm.cfg
    assert cfg.top_k == 8 and cfg.capacity_factor == get_config(cfg.name).capacity_factor
    assert set(tp["layers"][0]["mlp"]) == {"w_router", "w_gate", "w_up", "w_down"}
    if cfg.name == "granite-moe-1b-a400m":
        assert cfg.n_experts == 32 and cfg.n_heads // cfg.n_kv_heads == 2
        assert cfg.tie_embeddings and "lm_head" not in tp
    else:
        assert cfg.n_experts == 128 and cfg.n_heads // cfg.n_kv_heads == 8
        assert "lm_head" in tp and cfg.n_heads * cfg.resolved_head_dim != cfg.d_model


def test_prefill_and_forward_match_reference(pair):
    """Unpadded prefill (the engine pads no MoE prompt) and the forward,
    37 tokens a row: experts overflow their capacity of 8 or 16."""
    jm, jp, tm, tp = pair
    toks = np.stack([prompt(jm.cfg, 41, 37), prompt(jm.cfg, 42, 37)])
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, max_len=48)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, max_len=48)
    assert max_err(jl, tl) < TOL
    assert tc["pos"].tolist() == np.asarray(jc["pos"]).tolist() == [37, 37]
    for name in ("k", "v"):
        want = jc["pattern"]["0"][name]
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


def test_runner_keeps_the_references_row_where_pad_rows_overflow(pair):
    """Nine running slots in bucket 16: seven pad rows repeat slot 8, route
    to its experts and, sorting after it, are dropped first where an expert
    overflows (capacity 8), so they compute other values than slot 8 does.
    The reference keeps the last duplicate's row; so must the runner, in the
    cache and in the token buffer."""
    jm, jp, tm, tp = pair
    n, bucket = 9, 16
    rows = np.stack([prompt(jm.cfg, r, 6) for r in range(bucket)])
    _, jc = jm.prefill(jp, {"tokens": jnp.asarray(rows)}, max_len=16)
    _, tc = tm.prefill(tp, {"tokens": torch.from_numpy(rows)}, max_len=16)
    pos = np.array([3 + i % 4 for i in range(bucket)], np.int32)
    jc = dict(jc, pos=jnp.asarray(pos))
    tc["pos"] = torch.from_numpy(pos.copy())
    toks = np.array([prompt(jm.cfg, 7, bucket)], np.int32)[0]
    slots = list(range(n))
    padded = slots + [slots[-1]] * (bucket - n)
    sub = {k: (v.index_select(0 if k == "pos" else 1, torch.tensor(padded)))
           for k, v in tc.items()}
    logits, _ = tm.decode_step(tp, sub, torch.from_numpy(toks[padded]))
    assert float((logits[n - 1] - logits[-1]).abs().max()) > 1e-3   # the pads differ

    jr, tr = JDecodeRunner(jm, max_batch=bucket), DecodeRunner(tm, max_batch=bucket,
                                                                graphs=False)
    jn, jtok, jc = jr.step_greedy(jp, jc, jnp.asarray(toks), slots)
    tn, ttok, tc = tr.step_greedy(tp, tc, torch.from_numpy(toks.copy()), slots)
    assert tn.tolist() == np.asarray(jn).tolist()
    assert ttok.tolist() == np.asarray(jtok).tolist()
    for name in ("k", "v"):
        want = jc["pattern"]["0"][name]
        assert max_err(want, tc[name]) < TOL * max(1.0, float(jnp.abs(want).max()))
    assert tc["pos"].tolist() == np.asarray(jc["pos"]).tolist()


def _engines(pair, shapes, **kw):
    jm, jp, tm, tp = pair
    jt, tt, jl, tl = _workload(jm.cfg, shapes)
    jeng = JServeEngine(jm, jp, sample_trace=jt, attn_mode="gather", **kw)
    teng = ServeEngine(tm, tp, sample_trace=tt, attn_mode="gather", **kw)
    return jeng, jeng.run(jl), teng, teng.run(tl)


# twelve requests at three prompt lengths (each a prefill shape of its own),
# profiled at 4 generated tokens and asking 10-16: the pool runs out
CHURN = [(i + 1, (7, 12, 5)[i % 3], 4, 10 + (i + 1) % 7, i // 4) for i in range(12)]


def test_engine_matches_reference_under_preemption(pair):
    """The engines in gather mode at max_batch 16 with up to 12 requests
    running (bucket 16, pad rows overflowing experts), on a trace whose
    live generations outrun the profile: preemptions and §4.3 replans churn
    the batch.  Token streams, summary and page stats equal; prompts go in
    unpadded, one prefill shape per prompt length."""
    jeng, js, teng, ts = _engines(pair, CHURN, max_len=40, max_batch=16, page_tokens=8)
    assert ts["n_preemptions"] > 0 and ts["max_concurrent"] >= 9
    assert ts["n_completed"] == len(CHURN)
    _assert_same(jeng, js, teng, ts)
    assert teng.prefill_compiles == jeng.prefill_compiles == 3
    assert teng.runner.n_compiles == len(bucket_ladder(16))


def test_slab_decode_matches_reference(pair):
    """``use_runner=False``: every slot decodes each step, idle ones too,
    and all of them are tokens to the router, as in the reference."""
    shapes = [(i + 1, (7, 12, 5)[i % 3], 4, 6 + (3 * i) % 7, i) for i in range(8)]
    jeng, js, teng, ts = _engines(pair, shapes, max_len=40, max_batch=4,
                                  page_tokens=None, use_runner=False)
    assert ts["n_completed"] == len(shapes) and ts["max_concurrent"] >= 3
    _assert_same(jeng, js, teng, ts)
    assert teng.decode_compiles == jeng.decode_compiles == 1


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_mode_is_refused(arch):
    _, tcfg = small_cfgs(arch=arch)
    tm = Transformer(tcfg, device="cpu")
    tt = _workload(tcfg, [(1, 4, 4, 4, 0)])[1]
    assert not ServeEngine.pads_prefill(tcfg)
    with pytest.raises(ValueError, match="pure-attention"):
        ServeEngine(tm, {}, sample_trace=tt, max_len=16, max_batch=2, attn_mode="paged")


@pytest.mark.parametrize("arch", ARCHS)
def test_load_keeps_the_router_f32(arch):
    jcfg, tcfg = small_cfgs("bfloat16", arch)
    _, np_tree = ref_params(jcfg)
    p = Transformer(tcfg, RunOpts(), device="cpu").load(params_from_jax(np_tree))
    mlp = p["layers"][1]["mlp"]
    assert mlp["w_router"].dtype == torch.float32
    assert all(mlp[k].dtype == torch.bfloat16 for k in ("w_gate", "w_up", "w_down"))
    e, d, f = tcfg.n_experts, tcfg.d_model, tcfg.d_ff
    assert [tuple(mlp[k].shape) for k in ("w_router", "w_gate", "w_up", "w_down")] == [
        (d, e), (e, d, f), (e, d, f), (e, f, d)]


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_carries_the_expert_leaves(arch):
    jcfg, tcfg = small_cfgs(arch=arch)
    _, np_tree = ref_params(jcfg, seed=3)
    got = dict(_paths(params_from_jax(np_tree)))
    assert set(got) == set(dict(_paths(Transformer(tcfg, device="cpu").schema())))
    for name in ("w_router", "w_gate", "w_up", "w_down"):
        leaf = np_tree["pattern"]["0"]["mlp"][name]
        for i in range(tcfg.n_layers):
            assert np.array_equal(got[("layers", i, "mlp", name)].numpy(), leaf[i])


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
    n = sum(int(np.prod(s)) for s in got.values())
    assert n == {"granite-moe-1b-a400m": 1_334_887_424,
                 "qwen3-moe-30b-a3b": 30_532_634_624}[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_runs_each_config_on_the_cpu(arch, capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", arch, "--device", "cpu", "--requests", "4",
                "--max-batch", "2", "--max-len", "32"])
    out = capsys.readouterr().out
    assert f"[{arch} @ full size]" in out and "completed 4/4 requests" in out
    assert "prefill_compiles=1" in out          # four prompts of one length, unpadded
    with pytest.raises(ValueError, match="pure-attention"):
        serve.main(["--arch", arch, "--device", "cpu", "--attn", "paged"])


def test_profile_cli_runs_a_moe_decode_step(capsys):
    from repro_torch.launch import profile_serve
    profile_serve.main(["--arch", "granite-moe-1b-a400m", "--preset", "tiny",
                        "--device", "cpu", "--batch", "2", "--prompt-len", "8",
                        "--max-len", "32", "--steps", "2"])
    assert ("[profile] granite-moe-1b-a400m-tiny batch=2 prompt=8 attn=gather"
            in capsys.readouterr().out)
