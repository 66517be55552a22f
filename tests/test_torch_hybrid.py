"""The recurrentgemma slice as a model: the port's hybrid ``Transformer``
(rec, rec, local groups plus a rec tail, GeGLU, gemma embedding scaling, an
untied head, rolling local caches) against the reference on the same
(converted) weights at ``recurrentgemma-9b``'s smoke size, f32, a local
window of 8.  The reference runs its Pallas RG-LRU and flash kernels in
interpret mode (tests/conftest.py sets it); the port runs its kernel
wrappers, which take the plain versions for these CPU tensors.

f32 tolerance: max-abs 1e-4 on logits of magnitude ~1, as for the dense and
mamba2 models (tests/test_torch_model.py): the layers agree to ~1e-7 of
their scale, and eight layers of XLA-vs-PyTorch sum orders leave ~2e-5 on
the logits.  Cache leaves get 1e-5 of their largest value: the scaled
embedding (x sqrt(d_model)) makes K reach ~15.  bf16 is checked loosely
(0.25): the two frameworks round at different places.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.kernels import ops as jops
from repro.models import RunOpts as JRunOpts
from repro.models import Transformer as JTransformer
from repro.models import attention as jattn
from repro_torch.configs import get_config as tget_config
from repro_torch.core.planner import MemoryPlanner
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.models import RunOpts as TRunOpts
from repro_torch.models import Transformer as TTransformer
from repro_torch.models import attention as tattn
from repro_torch.models import params_from_jax
from repro_torch.models.transformer import F32_LEAVES
from repro_torch.runtime.serve_lib import layer_kinds
from torch_port_utils import max_err, prompt, ref_params

TOL = {"float32": 1e-4, "bfloat16": 0.25}
REL_CACHE = 1e-5
ARCH = "recurrentgemma-9b"


def cache_close(want, got) -> bool:
    return max_err(want, got) <= REL_CACHE * max(1.0, float(np.abs(np.asarray(want)).max()))


def hybrid_cfgs(dtype: str = "float32"):
    """(reference, port) smoke configs: 2 x (rec, rec, local) + (rec, rec),
    d_model 64, 4 heads over 1 KV head of 16, lru 64, window 8, vocab 512."""
    return (jget_config(ARCH).smoke().with_overrides(dtype=dtype),
            tget_config(ARCH).smoke().with_overrides(dtype=dtype))


def hybrid_models(dtype: str = "float32", *, seed: int = 0, use_kernels: bool = True):
    """(jax model, jax params, port model, port params) on the same weights,
    zero-initialised leaves randomised.  With ``use_kernels`` both sides
    take their kernel routes (the reference's Pallas flash and RG-LRU in
    interpret mode; the port's wrappers)."""
    jcfg, tcfg = hybrid_cfgs(dtype)
    jparams, np_tree = ref_params(jcfg, seed)
    jopts = JRunOpts(attention_impl="pallas" if use_kernels else "full",
                     use_kernels=use_kernels)
    topts = TRunOpts(attention_impl="kernel" if use_kernels else "full",
                     use_kernels=use_kernels)
    tm = TTransformer(tcfg, topts, device="cpu")
    return JTransformer(jcfg, jopts), jparams, tm, tm.load(params_from_jax(np_tree))


def ref_rec_leaf(jcache, name):
    """The reference's per-kind rec cache leaf in the port's layout: the
    rec layers' leaves stacked in execution order (groups, then the tail)."""
    groups = [np.asarray(jcache["pattern"][str(i)][name][g])
              for g in range(np.asarray(jcache["pattern"]["0"][name]).shape[0])
              for i in (0, 1)]
    tail = [np.asarray(jcache["tail"][k][name]) for k in sorted(jcache["tail"])]
    return np.stack(groups + tail)


@pytest.fixture(scope="module")
def pair():
    return hybrid_models()


# --------------------------------------------------------------------------
# decode attention over a windowed or rolling cache
# --------------------------------------------------------------------------


@pytest.mark.parametrize("window,rolling", [(0, False), (5, False), (8, True)],
                         ids=["global", "window", "rolling"])
def test_attend_decode_window_and_rolling_match_reference(window, rolling):
    rng = np.random.default_rng(window)
    q = rng.standard_normal((3, 1, 1, 4, 16)).astype(np.float32)
    k = rng.standard_normal((3, 8, 1, 16)).astype(np.float32)
    v = rng.standard_normal((3, 8, 1, 16)).astype(np.float32)
    pos = np.array([2, 7, 19 if rolling else 6], np.int32)
    want = jattn.attend_decode(*(jnp.asarray(a) for a in (q, k, v, pos)),
                               window=window, rolling=rolling)
    got = tattn.attend_decode(*(torch.from_numpy(a) for a in (q, k, v, pos)),
                              window=window, rolling=rolling)
    assert max_err(want, got) < 1e-5


# --------------------------------------------------------------------------
# the hybrid model
# --------------------------------------------------------------------------


def test_registered_config_is_accepted_and_narrow():
    """The port runs recurrentgemma-9b as registered; the kinds follow the
    reference's order (pattern x groups, then the tail)."""
    cfg = tget_config(ARCH)
    m = TTransformer(cfg, device="cpu")
    assert m.kind == "hybrid"
    assert m.kinds == ["rec", "rec", "local"] * 12 + ["rec", "rec"]
    assert layer_kinds(cfg).count("rec") == 26
    with pytest.raises(ValueError, match="the port runs"):
        TTransformer(cfg.with_overrides(tail_pattern=("local", "rec")), device="cpu")


def test_hybrid_forward_matches_reference(pair):
    """The kernel routes (reference: Pallas flash + RG-LRU, interpret mode),
    a sequence 2.5x the window."""
    jm, jp, tm, tp = pair
    toks = np.stack([prompt(jm.cfg, 31, 20), prompt(jm.cfg, 32, 20)])
    got = tm.forward(tp, torch.from_numpy(toks))
    assert got.shape == (2, 20, jm.cfg.padded_vocab)
    assert max_err(jm.forward(jp, jnp.asarray(toks)), got) < TOL["float32"]


@pytest.mark.parametrize("s", [5, 13], ids=["shorter-than-window", "past-window"])
def test_hybrid_prefill_and_decode_match_reference(pair, s):
    """Prefill builds the same rolling K/V windows and rec states; greedy
    decode steps from it, on past the window, give the same logits."""
    jm, jp, tm, tp = pair
    toks = np.stack([prompt(jm.cfg, 40 + s, s), prompt(jm.cfg, 41 + s, s)])
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)})
    assert max_err(jl, tl) < TOL["float32"]
    assert tc["pos"].tolist() == np.asarray(jc["pos"]).tolist() == [s, s]
    c = min(s, jm.cfg.local_window)
    for name in ("k", "v"):
        assert tuple(tc[name].shape) == jc["pattern"]["2"][name].shape == (2, 2, c, 1, 16)
        assert cache_close(jc["pattern"]["2"][name], tc[name])
    for name in ("conv", "h"):
        assert cache_close(ref_rec_leaf(jc, name), tc[name])
    assert tc["h"].dtype == torch.float32
    tok = np.array(jnp.argmax(jl, -1), np.int32)
    for _ in range(12):
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(tok))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(tok))
        assert max_err(jl, tl) < TOL["float32"]
        tok = np.array(jnp.argmax(jl, -1), np.int32)
        assert tok.tolist() == tl.argmax(-1).tolist()
    assert tc["pos"].tolist() == [s + 12] * 2
    assert cache_close(jc["pattern"]["2"]["k"], tc["k"])
    assert cache_close(ref_rec_leaf(jc, "h"), tc["h"])


def test_rolling_window_cache_beyond_window(pair):
    """Port of tests/test_decode_consistency.py's rolling-window case:
    prefill 4 tokens into a cache of max_len 24, then decode far past the
    window (3x); every step's logits equal the whole-sequence forward's, the
    port's and the reference's."""
    jm, jp, tm, tp = pair
    s = 24
    toks = prompt(jm.cfg, 50, s)[None, :]
    want = tm.forward(tp, torch.from_numpy(toks))
    jwant = jm.forward(jp, jnp.asarray(toks))
    _, cache = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :4])}, max_len=s)
    assert tuple(cache["k"].shape[2:]) == (4, 1, 16)
    full = tm.init_cache(1, s)                     # the engine's batch cache
    assert tuple(full["k"].shape) == (2, 1, jm.cfg.local_window, 1, 16)
    full["pos"][0] = cache["pos"][0]
    for name in ("k", "v", "conv", "h"):
        full[name][:, :, :cache[name].shape[2]] = cache[name]
    errs, jerrs = [], []
    for t in range(4, s):
        logits, full = tm.decode_step(tp, full, torch.from_numpy(toks[:, t]))
        errs.append(float((logits - want[:, t]).abs().max()))
        jerrs.append(max_err(jwant[:, t], logits))
    assert max(errs) < TOL["float32"], errs
    assert max(jerrs) < TOL["float32"], jerrs


def test_bf16_hybrid_forward_is_close():
    jm, jp, tm, tp = hybrid_models("bfloat16", seed=1)
    toks = np.stack([prompt(jm.cfg, 60, 14)])
    tl = tm.forward(tp, torch.from_numpy(toks))
    assert tl.dtype == torch.bfloat16
    assert max_err(jm.forward(jp, jnp.asarray(toks)), tl) < TOL["bfloat16"]


# --------------------------------------------------------------------------
# parameters: bridge, load dtypes, leaf-by-leaf init, cache layout
# --------------------------------------------------------------------------


def test_bridge_converts_pattern_tail_and_lm_head():
    jcfg, _ = hybrid_cfgs()
    _, np_tree = ref_params(jcfg, seed=3)
    p = params_from_jax(np_tree)
    assert len(p["layers"]) == jcfg.n_layers == 8
    order = [(str(i), g) for g in range(2) for i in range(3)]
    for layer, (i, g) in zip(p["layers"], order):
        if i == "2":
            assert np.array_equal(layer["attn"]["wq"].numpy(),
                                  np_tree["pattern"]["2"]["attn"]["wq"][g])
        else:
            assert np.array_equal(layer["lru"]["w_a"].numpy(),
                                  np_tree["pattern"][i]["lru"]["w_a"][g])
            assert np.array_equal(layer["w_branch"].numpy(),
                                  np_tree["pattern"][i]["w_branch"][g])
    for layer, k in zip(p["layers"][6:], ("0", "1")):
        assert np.array_equal(layer["w_out"].numpy(), np_tree["tail"][k]["w_out"])
        assert np.array_equal(layer["mlp"]["w_gate"].numpy(),
                              np_tree["tail"][k]["mlp"]["w_gate"])
    assert np.array_equal(p["lm_head"].numpy(), np_tree["lm_head"])
    assert tuple(p["lm_head"].shape) == tuple(p["embed"].shape) == (jcfg.padded_vocab, 64)


def test_load_keeps_gate_leaves_f32():
    """The reference reads the RG-LRU gate leaves in f32 at every use: a
    bf16 model that loaded them in bf16 would compute something else, which
    no f32 test would notice."""
    jcfg, tcfg = hybrid_cfgs("bfloat16")
    _, np_tree = ref_params(jcfg, seed=4)
    tm = TTransformer(tcfg, TRunOpts(), device="cpu")
    lp = tm.load(params_from_jax(np_tree))
    rec = lp["layers"][0]
    for name in ("w_a", "b_a", "w_x", "b_x", "lam"):
        assert name in F32_LEAVES and rec["lru"][name].dtype == torch.float32, name
    for name in ("w_conv", "b_conv"):
        assert rec[name].dtype == torch.float32, name
    for name in ("w_branch", "w_gate", "w_out"):
        assert rec[name].dtype == torch.bfloat16, name
    assert lp["lm_head"].dtype == lp["embed"].dtype == torch.bfloat16
    assert lp["layers"][2]["attn"]["wq"].dtype == torch.bfloat16
    assert rec["norm"]["scale"].dtype == torch.float32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_loaded_equals_load_of_init(dtype):
    """Leaf-by-leaf init draws the same numbers as ``load(init(...))``."""
    _, tcfg = hybrid_cfgs(dtype)
    tm = TTransformer(tcfg, TRunOpts(), device="cpu")
    a = tm.load(tm.init(torch.Generator().manual_seed(7)))
    b = tm.init_loaded(torch.Generator().manual_seed(7))
    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    assert len(la) == len(lb) > 0
    assert jax.tree_util.tree_structure(a) == jax.tree_util.tree_structure(b)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_cache_spec_stacks_leaves_per_kind():
    _, tcfg = hybrid_cfgs("bfloat16")
    tm = TTransformer(tcfg, TRunOpts(), device="cpu")
    for max_len, c in ((99, 8), (5, 5)):
        assert tm.cache_spec(3, max_len) == {
            "pos": ((3,), torch.int32),
            "k": ((2, 3, c, 1, 16), torch.bfloat16),
            "v": ((2, 3, c, 1, 16), torch.bfloat16),
            "conv": ((6, 3, tcfg.conv_width - 1, 64), torch.bfloat16),
            "h": ((6, 3, 64), torch.float32)}


# --------------------------------------------------------------------------
# the flash kernel at head dim 256
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_matches_pallas_at_head_dim_256(dtype):
    """recurrentgemma's local attention: 4 heads over one KV head of 256,
    window 16 over 40 positions (the plain version, what the wrapper runs
    for CPU tensors, against the reference's Pallas kernel)."""
    rng = np.random.default_rng(256)
    q = rng.standard_normal((1, 40, 1, 4, 256)).astype(np.float32)
    k = rng.standard_normal((1, 40, 1, 256)).astype(np.float32)
    v = rng.standard_normal((1, 40, 1, 256)).astype(np.float32)
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    want = jops.flash_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                                causal=True, window=16, block_q=16, block_k=16,
                                interpret=True)
    got = tops.flash_attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                               causal=True, window=16)
    assert max_err(want, got) < {"float32": 2e-5, "bfloat16": 2e-2}[dtype]


def test_flash_smem_working_set_at_head_dim_256():
    """The wide design's f32 K and V tiles of 32 x 256 floats: 64 KB of
    dynamic shared memory (the D=64 design keeps its padded static tiles)."""
    assert MemoryPlanner.check_smem(tfa.smem_blocks(256)) == {
        "bytes": 65536, "budget": 227 * 1024, "fits": True,
        "utilization": 65536 / (227 * 1024)}
    assert MemoryPlanner.smem_footprint(tfa.smem_blocks(64)) == 2 * 32 * 65 * 4
    assert tfa.instance(256) == 256


@pytest.mark.cuda
def test_flash_kernel_at_head_dim_256_matches_plain_version_on_the_card():
    """Run on the card by ``python -m pytest -m cuda tests``: H=16 over one
    KV head, window 2048, a prompt past the window, bf16 and f32."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: run on the card with "
                    "`python -m pytest -m cuda tests`")
    g = torch.Generator(device="cuda").manual_seed(0)
    for dt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        q = torch.randn(1, 2100, 1, 16, 256, generator=g, device="cuda").to(dt)
        k = torch.randn(1, 2100, 1, 256, generator=g, device="cuda").to(dt)
        v = torch.randn(1, 2100, 1, 256, generator=g, device="cuda").to(dt)
        before = tops.flash_attention.launches
        got = tops.flash_attention(q, k, v, causal=True, window=2048)
        want = tattn.attend(q, k, v, impl="plain", causal=True, window=2048)
        torch.cuda.synchronize()
        assert tops.flash_attention.launches == before + 1
        assert float((got.float() - want.float()).abs().max()) < tol
