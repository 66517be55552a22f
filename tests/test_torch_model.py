"""Port model vs the reference on the same (converted) weights: prefill with
``true_len``, decode over the contiguous cache and over the paged pool, and
the full forward.

f32 tolerance is max-abs 1e-4 on logits of magnitude ~1: both sides compute
in f32, but XLA and PyTorch order the matmul and softmax sums differently,
so the last bits differ (observed errors are ~1e-6).  bf16 is checked
loosely (max-abs 0.25): the two frameworks round intermediate bf16 values at
different places, and a random-weight model's logits amplify that.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.models import RunOpts as TRunOpts
from repro_torch.models import Transformer as TTransformer
from repro_torch.models import params_from_jax
from torch_port_utils import max_err, models, prompt, ref_params, small_cfgs

TOL = {"float32": 1e-4, "bfloat16": 0.25}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_true_len_matches_reference(dtype):
    jm, jp, tm, tp = models(dtype)
    toks = np.stack([prompt(jm.cfg, 1, 16)])
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks),
                             "true_len": jnp.asarray(11, jnp.int32)}, max_len=24)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks), "true_len": 11},
                        max_len=24)
    assert tl.shape == (1, jm.cfg.padded_vocab) and tl.dtype == tm.compute_dtype
    assert max_err(jl, tl) < TOL[dtype]
    assert tc["pos"].tolist() == np.asarray(jc["pos"]).tolist() == [11]
    for name in ("k", "v"):
        assert tuple(tc[name].shape) == jc["pattern"]["0"][name].shape
        assert max_err(jc["pattern"]["0"][name], tc[name]) < 10 * TOL[dtype]


def _staggered(jm, jp, tm, tp, n_rows=3, s=12, max_len=32):
    """Prefill ``n_rows`` prompts, then give each row its own clock."""
    toks = np.stack([prompt(jm.cfg, r, s) for r in range(n_rows)])
    _, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, max_len=max_len)
    _, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, max_len=max_len)
    pos = np.array([s - 3, s, s - 1][:n_rows], np.int32)
    jc = dict(jc, pos=jnp.asarray(pos))
    tc["pos"] = torch.from_numpy(pos.copy())
    return jc, tc


def test_forward_and_gather_decode_steps_match_reference():
    jm, jp, tm, tp = models("float32", jax_impl="full", port_impl="full")
    toks = np.stack([prompt(jm.cfg, 9, 10), prompt(jm.cfg, 10, 10)])
    assert max_err(jm.forward(jp, jnp.asarray(toks)),
                   tm.forward(tp, torch.from_numpy(toks))) < TOL["float32"]
    jc, tc = _staggered(jm, jp, tm, tp)
    tok = np.array([5, 7, 9], np.int32)
    for _ in range(3):
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(tok))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(tok))
        assert max_err(jl, tl) < TOL["float32"]
        assert tc["pos"].tolist() == np.asarray(jc["pos"]).tolist()
        tok = np.array(jnp.argmax(jl, -1), np.int32)
        assert tok.tolist() == tl.argmax(-1).tolist()


def _to_pages(k, pos_max, pt, tables):
    """(L,B,C,kv,hd) contiguous cache -> (L,P,pt,kv,hd) pool laid out by
    ``tables`` (fragmented page ids; row tails zero)."""
    k = np.asarray(k)
    n_pool = tables.max() + 2
    pool = np.zeros((k.shape[0], n_pool, pt) + k.shape[3:], np.float32)
    for b in range(k.shape[1]):
        for j in range(math.ceil((pos_max + 1) / pt)):
            pool[:, tables[b, j]] = k[:, b, j * pt:(j + 1) * pt]
    return pool


def test_paged_decode_steps_match_reference():
    """Paged decode (reference: Pallas paged kernel in interpret mode; port:
    the kernel wrapper's plain version) on fragmented page tables, with
    per-row clocks crossing page boundaries."""
    jm, jp, tm, tp = models("float32")
    jc, tc = _staggered(jm, jp, tm, tp)
    pt, maxp = 4, 5
    rng = np.random.default_rng(3)
    ids = rng.permutation(3 * maxp).astype(np.int32)
    tables = ids.reshape(3, maxp)
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
        assert max_err(jl, tl) < TOL["float32"]
        tok = np.array(jnp.argmax(jl, -1), np.int32)
    assert max_err(jcache["pattern"]["0"]["k_pages"], tcache["k_pages"]) < TOL["float32"]


def test_bf16_decode_is_close():
    jm, jp, tm, tp = models("bfloat16", jax_impl="full", port_impl="full")
    jc, tc = _staggered(jm, jp, tm, tp)
    tok = np.array([2, 4, 6], np.int32)
    jl, _ = jm.decode_step(jp, jc, jnp.asarray(tok))
    tl, _ = tm.decode_step(tp, tc, torch.from_numpy(tok))
    assert tl.dtype == torch.bfloat16
    assert max_err(jl, tl) < TOL["bfloat16"]


def test_bridge_splits_layers_and_keeps_layouts():
    jcfg, tcfg = small_cfgs()
    _, np_tree = ref_params(jcfg, seed=4)
    p = params_from_jax(np_tree)
    stacked = np_tree["pattern"]["0"]
    assert len(p["layers"]) == jcfg.n_layers
    for i, layer in enumerate(p["layers"]):
        assert np.array_equal(layer["attn"]["wq"].numpy(), stacked["attn"]["wq"][i])
        assert np.array_equal(layer["mlp"]["w_down"].numpy(), stacked["mlp"]["w_down"][i])
    assert tuple(p["layers"][0]["attn"]["wq"].shape) == (64, 14, 16)
    assert tuple(p["layers"][0]["attn"]["wo"].shape) == (14, 16, 64)
    assert tuple(p["embed"].shape) == (jcfg.padded_vocab, 64)


def test_init_follows_reference_scale_rules():
    """Port init (torch.Generator) has the reference's shapes and per-leaf
    scales: the two frameworks draw different numbers, so compare stds."""
    jcfg, tcfg = small_cfgs()
    _, np_tree = ref_params(jcfg.with_overrides(d_ff=256), seed=0)
    tm = TTransformer(tcfg.with_overrides(d_ff=256), TRunOpts(), device="cpu")
    p = tm.init(torch.Generator().manual_seed(0))
    ref = params_from_jax(np_tree)
    for name in ("wq", "wk", "wo"):
        a, b = p["layers"][0]["attn"][name], ref["layers"][0]["attn"][name]
        assert a.shape == b.shape
        assert abs(a.std().item() / b.std().item() - 1) < 0.1, name
    for name in ("w_up", "w_down", "w_gate"):
        a, b = p["layers"][1]["mlp"][name], ref["layers"][1]["mlp"][name]
        assert a.shape == b.shape
        assert abs(a.std().item() / b.std().item() - 1) < 0.1, name
    assert abs(p["embed"].std().item() / ref["embed"].std().item() - 1) < 0.05
    assert not p["layers"][0]["attn"]["bq"].any()       # zeros, as reference


def test_load_casts_weights_once_and_keeps_norms_f32():
    jcfg, tcfg = small_cfgs("bfloat16")
    _, np_tree = ref_params(jcfg)
    tm = TTransformer(tcfg, TRunOpts(), device="cpu")
    p = tm.load(params_from_jax(np_tree))
    assert p["embed"].dtype == torch.bfloat16
    assert p["layers"][0]["attn"]["bq"].dtype == torch.bfloat16
    assert p["layers"][0]["attn"]["norm"]["scale"].dtype == torch.float32
    assert p["final_norm"]["scale"].dtype == torch.float32


# --------------------------------------------------------------------------
# mamba2 (attention-free SSD stack); helpers in test_torch_ssm
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mamba2_pair():
    from test_torch_ssm import mamba2_models
    return mamba2_models("float32")


def test_mamba2_prefill_and_decode_match_reference(mamba2_pair):
    """Prefill (port: SSD wrapper, plain version for CPU tensors; reference:
    chunked scan) builds the same conv/SSD state, and greedy decode steps
    from it give the same logits and states."""
    jm, jp, tm, tp = mamba2_pair
    toks = np.stack([prompt(jm.cfg, 21, 13), prompt(jm.cfg, 22, 13)])
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)})
    assert max_err(jl, tl) < TOL["float32"]
    assert tc["pos"].tolist() == np.asarray(jc["pos"]).tolist() == [13, 13]
    for name in ("conv", "ssm"):
        assert tuple(tc[name].shape) == jc["pattern"]["0"][name].shape
        assert max_err(jc["pattern"]["0"][name], tc[name]) < TOL["float32"]
    assert tc["ssm"].dtype == torch.float32
    tok = np.array(jnp.argmax(jl, -1), np.int32)
    for _ in range(3):
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(tok))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(tok))
        assert max_err(jl, tl) < TOL["float32"]
        tok = np.array(jnp.argmax(jl, -1), np.int32)
        assert tok.tolist() == tl.argmax(-1).tolist()
    assert tc["pos"].tolist() == [16, 16]
    assert max_err(jc["pattern"]["0"]["ssm"], tc["ssm"]) < TOL["float32"]


def test_mamba2_forward_kernel_route_matches_reference(mamba2_pair):
    """``forward`` with ``use_kernels=True``: the reference runs its Pallas
    SSD kernel (interpret mode), the port its wrapper; ragged length 21 over
    chunks of 8."""
    jm, jp, tm, tp = mamba2_pair
    toks = np.stack([prompt(jm.cfg, 23, 21)])
    assert max_err(jm.forward(jp, jnp.asarray(toks)),
                   tm.forward(tp, torch.from_numpy(toks))) < TOL["float32"]


def test_mamba2_bf16_forward_is_close():
    from test_torch_ssm import mamba2_models
    jm, jp, tm, tp = mamba2_models("bfloat16")
    toks = np.stack([prompt(jm.cfg, 24, 12)])
    tl = tm.forward(tp, torch.from_numpy(toks))
    assert tl.dtype == torch.bfloat16
    assert max_err(jm.forward(jp, jnp.asarray(toks)), tl) < TOL["bfloat16"]


def test_mamba2_cache_load_and_bridge():
    from test_torch_ssm import mamba2_cfgs
    jcfg, tcfg = mamba2_cfgs("bfloat16")
    _, np_tree = ref_params(jcfg, seed=5)
    p = params_from_jax(np_tree)
    assert len(p["layers"]) == jcfg.n_layers
    for i, layer in enumerate(p["layers"]):
        for name in ("w_in", "w_conv", "a_log", "norm_scale", "w_out"):
            assert np.array_equal(layer[name].numpy(), np_tree["pattern"]["0"][name][i])
    tm = TTransformer(tcfg, TRunOpts(), device="cpu")
    lp = tm.load(p)
    assert lp["layers"][0]["w_in"].dtype == torch.bfloat16
    for name in ("w_conv", "b_conv", "dt_bias", "a_log", "d_skip", "norm_scale"):
        assert lp["layers"][0][name].dtype == torch.float32, name
    spec = tm.cache_spec(3, 99)
    conv_dim = tcfg.d_inner + 2 * tcfg.ssm_groups * tcfg.ssm_state
    assert spec == {"pos": ((3,), torch.int32),
                    "conv": ((2, 3, tcfg.conv_width - 1, conv_dim), torch.bfloat16),
                    "ssm": ((2, 3, tcfg.ssm_heads, tcfg.ssm_head_dim, tcfg.ssm_state),
                            torch.float32)}
    init = tm.init(torch.Generator().manual_seed(0))
    assert init["layers"][0]["a_log"].eq(1).all() and init["layers"][0]["d_skip"].eq(1).all()


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "granite-moe-1b-a400m",
                                  "qwen3-moe-30b-a3b", "whisper-small"])
def test_unported_patterns_are_refused(arch):
    from repro_torch.configs import get_config
    cfg = get_config(arch).smoke()
    if arch == "recurrentgemma-9b":     # ported; any other hybrid pattern is not
        cfg = cfg.with_overrides(block_pattern=("rec", "local", "rec"))
    elif arch == "granite-moe-1b-a400m":    # ported; experts on mamba2 are not
        cfg = get_config("mamba2-130m").smoke().with_overrides(
            n_experts=cfg.n_experts, top_k=cfg.top_k)
    elif arch == "qwen3-moe-30b-a3b":       # ported; experts with an encoder are not
        cfg = cfg.with_overrides(encoder_layers=2, encoder_seq=16)
    elif arch == "whisper-small":           # ported; experts on its xattn blocks are not
        cfg = cfg.with_overrides(n_experts=4, top_k=2)
    with pytest.raises(ValueError, match="the port runs") as err:
        TTransformer(cfg, device="cpu")
    if arch == "granite-moe-1b-a400m":
        assert "experts on pattern ('mamba2',)" in str(err.value)
    elif arch == "qwen3-moe-30b-a3b":
        assert "encoder-decoder" in str(err.value)
    elif arch == "whisper-small":
        assert "experts on pattern ('xattn',)" in str(err.value)


# --------------------------------------------------------------------------
# phi4-mini-3.8b's attention shape: head_dim 128, G = 3
# --------------------------------------------------------------------------

# f32 logits at max-abs 1e-5 (|logits| ~1-2; observed ~1e-6), on weights
# whose attention scores are O(1) (``torch_port_utils._contraction_scaled_qk``)
PHI4_TOL = 1e-5


@pytest.fixture(scope="module")
def phi4_pair():
    return models("float32", arch="phi4-mini-3.8b")


def test_phi4_prefill_and_forward_match_reference(phi4_pair):
    """Prefill with ``true_len`` (reference: Pallas flash at head_dim 128 in
    interpret mode; port: the flash wrapper's plain version) and the full
    forward, on phi4-mini-3.8b's head layout at a small width."""
    jm, jp, tm, tp = phi4_pair
    assert tm.cfg.resolved_head_dim == 128 and tm.cfg.n_heads // tm.cfg.n_kv_heads == 3
    toks = np.stack([prompt(jm.cfg, 31, 16), prompt(jm.cfg, 32, 16)])
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks),
                             "true_len": jnp.asarray(11, jnp.int32)}, max_len=24)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks), "true_len": 11},
                        max_len=24)
    assert max_err(jl, tl) < PHI4_TOL
    assert tuple(tc["k"].shape) == jc["pattern"]["0"]["k"].shape
    assert max_err(jm.forward(jp, jnp.asarray(toks)),
                   tm.forward(tp, torch.from_numpy(toks))) < PHI4_TOL


def test_phi4_paged_decode_steps_match_reference(phi4_pair):
    """Paged decode at head_dim 128 (reference: Pallas paged kernel in
    interpret mode; port: the paged wrapper's plain version) on fragmented
    page tables, per-row clocks crossing page boundaries."""
    jm, jp, tm, tp = phi4_pair
    jc, tc = _staggered(jm, jp, tm, tp)
    pt, maxp = 4, 5
    tables = np.random.default_rng(7).permutation(3 * maxp).astype(np.int32).reshape(3, maxp)
    kp = _to_pages(jc["pattern"]["0"]["k"], 16, pt, tables)
    vp = _to_pages(jc["pattern"]["0"]["v"], 16, pt, tables)
    jcache = {"pos": jc["pos"], "block_tables": jnp.asarray(tables),
              "pattern": {"0": {"k_pages": jnp.asarray(kp), "v_pages": jnp.asarray(vp)}}}
    tcache = {"pos": tc["pos"].clone(), "block_tables": torch.from_numpy(tables),
              "k_pages": torch.from_numpy(kp.copy()), "v_pages": torch.from_numpy(vp.copy())}
    tok = np.array([8, 6, 4], np.int32)
    for _ in range(5):
        jl, jcache = jm.decode_step(jp, jcache, jnp.asarray(tok))
        tl, tcache = tm.decode_step(tp, tcache, torch.from_numpy(tok))
        assert max_err(jl, tl) < PHI4_TOL
        tok = np.array(jnp.argmax(jl, -1), np.int32)
        assert tok.tolist() == tl.argmax(-1).tolist()


def test_admitted_configs_have_kernels_at_their_shapes():
    """Every registered config the model admits has its shapes among the
    instantiations of each kernel its serving path launches, with a working
    set that fits: flash prefill and paged decode for the dense decoders,
    flash for the hybrid's local layers, the SSD scan for mamba2.  A config
    admitted without them would build and then fail on the card, as
    phi4-mini-3.8b did at head_dim 128."""
    from repro_torch.configs import get_config, list_configs
    from repro_torch.core.planner import MemoryPlanner
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.kernels import paged_attention as tpa
    from repro_torch.kernels import ssd_scan as tssd
    from repro_torch.models.transformer import _unsupported
    fits = lambda blocks: MemoryPlanner.check_smem(blocks)["fits"]
    admitted = [n for n in list_configs() if not _unsupported(get_config(n))]
    assert {"qwen2-0.5b", "phi4-mini-3.8b", "mamba2-130m", "recurrentgemma-9b",
            "mistral-nemo-12b", "starcoder2-15b", "chameleon-34b"} <= set(admitted)
    for name in admitted:
        cfg = get_config(name)
        kinds = set(cfg.block_pattern) | set(cfg.tail_pattern)
        hd, group = cfg.resolved_head_dim, cfg.n_heads // cfg.n_kv_heads
        if kinds & {"attn", "local"}:
            assert hd in tfa.HEAD_DIMS, (name, hd)
            assert all(fits(tfa.smem_blocks(hd, dt)) for dt in tfa.DTYPE_CODES), name
        if "attn" in kinds:
            assert hd in tpa.HEAD_DIMS, (name, hd)
            assert all(fits(tpa.smem_blocks(group, hd, dt)) for dt in tpa.DTYPE_CODES), name
        if "mamba2" in kinds:
            assert (cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_groups) in tssd.SHAPES, name
            assert all(fits(tssd.smem_blocks(launch)) for launch in tssd.LAUNCHES), name
