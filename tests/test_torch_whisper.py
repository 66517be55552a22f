"""whisper-small, the ``("xattn",)`` encoder-decoder, against the reference
at its ``smoke()`` size in f32 (2 encoder and 2 decoder layers, d_model 64,
4 heads of 16 over 4 KV heads, 16 frames): the sinusoid table, the bridge,
the encoder, ``forward`` with frames, prefill and 12 cached decode steps
with other frames in each row, ``max_len`` below and above the prompt, the
serving steps of ``runtime.serve_lib``, the full-size schema and cache, and
the refusals.  The reference runs its Pallas flash kernel in interpret mode
(tests/conftest.py; its encoder's self-attention is non-causal), the port
its flash wrapper's plain version.

Weights: the reference's, every zero leaf randomised (``ref_params``), with
``wq``/``wk`` of every attention (the encoder's, the decoder's self- and
cross-attention) redrawn at 1/sqrt(d_model).  At 4 heads the reference's
init takes 4 as their fan-in, so q and k come out ~4 an element and the
softmax nearly one-hot: f32 rounding then moves logits by ~1e-5 in both
packages alike (each as far from a float64 run of the port as from the
other), which is a sensitivity of the weights and not a difference.

Tolerances: f32 encoder output, logits and caches max-abs 1e-5 (observed
~1e-6); greedy token streams exact; the sinusoid 1e-6 absolute.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_leaves

from repro.configs import get_config as jget_config
from repro.models import RunOpts as JRunOpts
from repro.models import Transformer as JTransformer
from repro.models.schema import count_params as jcount_params
from repro.runtime import serve_lib as jserve_lib
from repro_torch.configs import get_config
from repro_torch.models import RunOpts, Transformer, params_from_jax
from repro_torch.models.layers import sinusoid
from repro_torch.models.schema import P
from repro_torch.runtime import serve_lib
from repro_torch.runtime.serve_lib import Request
from repro_torch.serving import ServeEngine
from test_torch_graphs import _HostTraffic
from torch_port_utils import max_err, ref_params

ARCH = "whisper-small"
TOL = 1e-5


def _redraw_qk(np_tree, d_model: int) -> None:
    """wq and wk of every attention redrawn to std 1/sqrt(d_model), in
    place (the module docstring says why)."""
    rng = np.random.default_rng(d_model)
    blocks = [np_tree["pattern"]["0"], np_tree["encoder"]["blocks"]]
    for block in blocks:
        for name in ("attn", "xattn"):
            for w in ("wq", "wk"):
                if name in block:
                    leaf = block[name][w]
                    block[name][w] = (rng.standard_normal(leaf.shape)
                                      / np.sqrt(d_model)).astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    """(reference model, its params, numpy tree, port model, loaded params)."""
    jcfg = jget_config(ARCH).smoke()
    tcfg = get_config(ARCH).smoke()
    _, np_tree = ref_params(jcfg, 0)
    _redraw_qk(np_tree, jcfg.d_model)
    jp = jax.tree.map(jnp.asarray, np_tree)
    jm = JTransformer(jcfg, JRunOpts(attention_impl="pallas"))
    tm = Transformer(tcfg, RunOpts(attention_impl="kernel"), device="cpu")
    return jm, jp, np_tree, tm, tm.load(params_from_jax(np_tree))


def _frames(cfg, b: int, seed: int) -> np.ndarray:
    """One (encoder_seq, d_model) array of stub frame embeddings per row."""
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)


def _tokens(cfg, b: int, s: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def test_sinusoid_matches_reference_at_full_width():
    """d=768 over positions 0-1499, f32: the reference's f32 positions
    times its float64 numpy frequencies, cast before the product."""
    jm = JTransformer(jget_config(ARCH).with_overrides(dtype="float32"))
    want = jm._sinusoid(jnp.arange(1500))
    got = sinusoid(torch.arange(1500), 768, torch.float32)
    assert got.shape == (1500, 768) and got.dtype == torch.float32
    assert max_err(want, got) < 1e-6


def test_bridge_carries_encoder_and_cross_leaves(pair):
    """Every reference leaf arrives, once, with its shape: the decoder's
    xnorm/xattn, the encoder's blocks one dict per layer and its final
    norm, and nothing else (no biases: whisper's ``qkv_bias`` is False)."""
    jm, _, np_tree, tm, tp = pair
    cfg = tm.cfg
    raw = params_from_jax(np_tree)
    assert len(raw["layers"]) == cfg.n_layers
    assert len(raw["encoder"]["blocks"]) == cfg.encoder_layers
    layer = raw["layers"][0]
    assert set(layer) == {"attn", "xnorm", "xattn", "mlp_norm", "mlp"}
    assert set(layer["xattn"]) == set(layer["attn"]) == {"norm", "wq", "wk", "wv", "wo"}
    assert set(layer["mlp"]) == {"w_up", "w_down"}
    assert set(raw["encoder"]["blocks"][0]) == {"attn", "mlp_norm", "mlp"}
    assert set(raw["encoder"]["final_norm"]) == {"scale", "bias"}
    keys = jax.tree_util.DictKey
    per_layer = sum(np.asarray(a).shape[0] if path[0] == keys("pattern")
                    or path[:2] == (keys("encoder"), keys("blocks")) else 1
                    for path, a in jax.tree_util.tree_leaves_with_path(np_tree))
    assert len(tree_leaves(raw)) == per_layer == 61
    assert (sum(t.numel() for t in tree_leaves(raw))
            == sum(np.asarray(a).size for a in jax.tree.leaves(np_tree)))

    def shapes(schema):
        if isinstance(schema, P):
            return tuple(schema.shape)
        items = schema.items() if isinstance(schema, dict) else enumerate(schema)
        return {k: shapes(v) for k, v in items}

    def got(tree):
        if isinstance(tree, torch.Tensor):
            return tuple(tree.shape)
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        return {k: got(v) for k, v in items}
    assert got(raw) == shapes(tm.schema())
    np.testing.assert_array_equal(raw["encoder"]["blocks"][1]["attn"]["wv"].numpy(),
                                  np.asarray(np_tree["encoder"]["blocks"]["attn"]["wv"])[1])
    np.testing.assert_array_equal(raw["layers"][1]["xattn"]["wo"].numpy(),
                                  np.asarray(np_tree["pattern"]["0"]["xattn"]["wo"])[1])


def test_encode_matches_reference(pair):
    jm, jp, _, tm, tp = pair
    frames = _frames(tm.cfg, 2, 3)
    want = jm._encode(jp, jnp.asarray(frames), training=False)
    got = tm._encode(tp, torch.from_numpy(frames))
    assert got.shape == frames.shape
    assert max_err(want, got) < TOL


def test_forward_with_frames_matches_reference(pair):
    jm, jp, _, tm, tp = pair
    toks, frames = _tokens(tm.cfg, 2, 9, 5), _frames(tm.cfg, 2, 6)
    want = jm.forward(jp, jnp.asarray(toks), jnp.asarray(frames))
    got = tm.forward(tp, torch.from_numpy(toks), torch.from_numpy(frames))
    assert got.shape == (2, 9, tm.cfg.padded_vocab)
    assert max_err(want, got) < TOL
    assert np.asarray(jnp.argmax(want, -1)).tolist() == got.argmax(-1).tolist()


def _check_cache(jc, tc, names=("k", "v", "xk", "xv")):
    assert tc["pos"].tolist() == np.asarray(jc["pos"]).tolist()
    for name in names:
        want = jc["pattern"]["0"][name]
        assert tuple(tc[name].shape) == want.shape, name
        assert max_err(want, tc[name]) < TOL, name


@pytest.mark.parametrize("max_len", [20, 5])
def test_prefill_and_decode_steps_match_reference(pair, max_len):
    """B=2 with other frames in each row, prompt of 7: prefill, then 12
    greedy decode steps, logits at each step, the streams, and the
    ``k``/``v``/``xk``/``xv`` leaves (the reference's stacked
    ``pattern["0"]`` layout is the port's).  ``max_len`` 5 is below the
    prompt: the cache keeps the first 5 positions and every step writes at
    the last index, as the reference's ``min(pos, C - 1)``."""
    jm, jp, _, tm, tp = pair
    cfg = tm.cfg
    toks, frames = _tokens(cfg, 2, 7, 11), _frames(cfg, 2, 12)
    assert not np.allclose(frames[0], frames[1])
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)},
                        max_len=max_len)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks),
                             "frames": torch.from_numpy(frames)}, max_len=max_len)
    assert max_err(jl, tl) < TOL
    _check_cache(jc, tc)
    xk = tc["xk"]
    tok = np.asarray(jnp.argmax(jl, -1), np.int32)
    streams = [[], []]
    for _ in range(12):
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(tok))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(tok.copy()))
        assert max_err(jl, tl) < TOL
        tok = np.asarray(jnp.argmax(jl, -1), np.int32)
        assert tok.tolist() == tl.argmax(-1).tolist()
        for row, t in zip(streams, tok.tolist()):
            row.append(t)
    assert tc["xk"] is xk                     # read, never rewritten
    _check_cache(jc, tc)
    assert streams[0] != streams[1]


def test_serve_lib_steps_on_the_cpu(pair):
    """``build_prefill_step`` with a batch of {"tokens", "frames"} and the
    eager slab step (``build_decode_step(graphs=False)``) against the
    reference's jitted steps: logits and streams, the cross cache kept."""
    jm, jp, _, tm, tp = pair
    cfg = tm.cfg
    toks, frames = _tokens(cfg, 3, 4, 21), _frames(cfg, 3, 22)
    hooks = []
    prefill = serve_lib.build_prefill_step(tm, None, max_len=16, trace_hook=hooks.append)
    decode = serve_lib.build_decode_step(tm, None, graphs=False)
    jprefill = jserve_lib.build_prefill_step(jm, None, max_len=16)
    jdecode = jserve_lib.build_decode_step(jm, None, donate=False)
    jl, jc = jprefill(jp, {"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)})
    tl, tc = prefill(tp, {"tokens": torch.from_numpy(toks),
                          "frames": torch.from_numpy(frames)})
    assert len(hooks) == 1 and prefill.stats()["n_captures"] == 0
    assert max_err(jl, tl) < TOL
    xv = tc["xv"].clone()
    tok = np.asarray(jnp.argmax(jl, -1), np.int32)
    for _ in range(4):
        jl, jc = jdecode(jp, jc, jnp.asarray(tok))
        tl, tc = decode(tp, tc, torch.from_numpy(tok.copy()))
        assert max_err(jl, tl) < TOL
        tok = np.asarray(jnp.argmax(jl, -1), np.int32)
        assert tok.tolist() == tl.argmax(-1).tolist()
    assert torch.equal(tc["xv"], xv)
    _check_cache(jc, tc)


def test_full_size_schema_cache_and_accounting():
    """whisper-small at full size, abstractly: the parameter count equals
    the reference's schema and lies in its ``test_configs`` band; the cache
    spec is the reference's (k/v over max_len 448, xk/xv over 1500 frames,
    bf16); ``cache_bytes_per_token`` and ``state_bytes`` are the
    reference's, which leave the cross cache out."""
    jcfg, cfg = jget_config(ARCH), get_config(ARCH)
    tm = Transformer(cfg, device="cpu")
    n = sum(math.prod(p.shape) for p in tree_leaves(tm.schema()))
    assert n == jcount_params(JTransformer(jcfg).schema())
    assert 0.22e9 <= n <= 0.26e9
    spec = tm.cache_spec(8, 448)
    jspec = JTransformer(jcfg).cache_spec(8, 448)
    assert spec["pos"] == ((8,), torch.int32)
    for name in ("k", "v", "xk", "xv"):
        want = jspec["pattern"]["0"][name]
        assert spec[name] == (want.shape, torch.bfloat16)
    assert spec["xk"][0] == (12, 8, 1500, 12, 64) and spec["k"][0] == (12, 8, 448, 12, 64)
    assert serve_lib.cache_bytes_per_token(cfg) == jserve_lib.cache_bytes_per_token(jcfg)
    assert serve_lib.state_bytes(cfg) == jserve_lib.state_bytes(jcfg) == 0
    cross = 2 * math.prod(spec["xk"][0][:1] + spec["xk"][0][2:]) * 2
    assert cross == 55_296_000                # one request's xk + xv, left out


def test_decode_step_is_capture_safe(monkeypatch):
    """The xattn decode step and the slab step on ``meta`` tensors: no op
    reads a value on the host or takes a host tensor, and no tensor is
    built on the host for the device (the cross position is made once, at
    init)."""
    cfg = get_config(ARCH).smoke()
    params = Transformer(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    model = Transformer(cfg, RunOpts(attention_impl="full"), device="meta")
    p = model.load(params)
    cache = model.init_cache(3, 16)
    tokens = torch.zeros(3, dtype=torch.int32, device="meta")
    slab = serve_lib.build_decode_step(model, None)
    real_tensor = torch.tensor
    built = []

    def tensor(data, *a, device=None, **kw):
        if device is not None and torch.device(device).type != "cpu":
            built.append((data, device))
        return real_tensor(data, *a, device=device, **kw)
    monkeypatch.setattr(torch, "tensor", tensor)
    with _HostTraffic() as mode:
        _, new = model.decode_step(p, cache, tokens)
        slab(p, cache, tokens)
    assert mode.seen == [] and built == []
    assert new["xk"] is cache["xk"] and new["xv"] is cache["xv"]


@pytest.mark.parametrize("over,why", [
    (dict(rope=True), "rope True"), (dict(encoder_layers=0), "0 encoder layers"),
    (dict(norm="rmsnorm"), "norm rmsnorm"), (dict(act="swiglu"), "act swiglu")])
def test_xattn_admits_whisper_only(over, why):
    """The port runs ``("xattn",)`` as whisper has it: with an encoder,
    LayerNorm, the GELU MLP and no RoPE; anything else is refused, and so
    is an encoder on another pattern."""
    cfg = get_config(ARCH).smoke()
    Transformer(cfg, device="cpu")
    with pytest.raises(ValueError, match="the port runs") as err:
        Transformer(cfg.with_overrides(**over), device="cpu")
    assert why in str(err.value)
    with pytest.raises(ValueError, match="encoder-decoder on pattern"):
        Transformer(cfg.with_overrides(block_pattern=("attn",), rope=True), device="cpu")


def test_prefill_refuses_missing_or_misshapen_frames(pair):
    *_, tm, tp = pair
    toks = torch.from_numpy(_tokens(tm.cfg, 1, 4, 1))
    with pytest.raises(ValueError, match="needs frames"):
        tm.prefill(tp, {"tokens": toks})
    with pytest.raises(ValueError, match="needs frames"):
        tm.forward(tp, toks)
    short = torch.zeros(1, tm.cfg.encoder_seq - 1, tm.cfg.d_model)
    with pytest.raises(ValueError, match="encoder_seq"):
        tm.prefill(tp, {"tokens": toks, "frames": short})


def test_engine_loss_and_device_refusals(pair):
    """The engine has no path for frames (the reference's fails at its first
    prefill, with a KeyError); training needs frames and the plain paths
    (the kernels have no backward); no card, no model."""
    *_, tm, tp = pair
    with pytest.raises(ValueError, match="encoder frames"):
        ServeEngine(tm, tp, sample_trace=[Request(1, 8, 4, 0)], max_len=32, max_batch=2)
    toks = torch.zeros(1, 5, dtype=torch.int32)
    train = Transformer(tm.cfg, RunOpts(attention_impl="full", use_kernels=False),
                        device="cpu")
    with pytest.raises(ValueError, match="needs frames"):
        train.loss_fn(train.init(torch.Generator().manual_seed(0)), {"tokens": toks})
    with pytest.raises(ValueError, match="no backward"):
        tm.loss_fn(tp, {"tokens": toks, "frames": torch.zeros(1, 16, 64)})
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Transformer(get_config(ARCH))


def test_profile_serve_cli_on_the_cpu(capsys):
    """``launch/profile_serve.py --arch whisper-small`` profiles the serving
    steps (no engine takes frames): prefill, then decode."""
    from repro_torch.launch import profile_serve
    profile_serve.main(["--arch", ARCH, "--preset", "tiny", "--device", "cpu",
                        "--batch", "2", "--prompt-len", "4", "--max-len", "16",
                        "--steps", "2"])
    out = capsys.readouterr().out
    assert "[profile] whisper-small-tiny prefill batch=2 prompt=4 frames=" in out
    assert "[profile] whisper-small-tiny decode batch=2 graphs=False" in out
