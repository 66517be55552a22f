"""The compiled prefill, on the CPU: ``Transformer.prefill`` with ``true_len``
as a device tensor against the reference's prefill with a traced
``true_len`` (one jitted executable per rung, as the reference's engine
compiles it), for every ``true_len`` of one rung of the prompt ladder; the
padded prefill's capture safety on ``meta`` tensors; ``build_prefill_step``'s
options and hook; and the engine's token streams against the reference's
with prompts sharing a rung.

Three layouts, each at a small width: qwen2-0.5b's (G = 7, head dim 16),
phi4-mini-3.8b's (G = 3, head dim 128) and starcoder2-15b's (G = 12,
LayerNorm, the biased gelu MLP, q/k/v biases).  The reference runs its
Pallas flash kernel in interpret mode (tests/conftest.py), the port the
flash wrapper's plain version.

Tolerances (f32): logits max-abs 1e-5 with equal argmaxes; ``pos`` exact;
K/V at the positions below ``true_len`` within 1e-5 of their largest
magnitude (``test_torch_dense``'s limit); the same prefill with ``true_len``
as an int, and a (B,) ``true_len`` against the rows run one at a time,
bitwise; token streams, scheduler and page-pool decisions exact.

The card's tests (graph replays against eager prefill, recapture, the
engine's captures) are in ``test_torch_prefill_graphs_card.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving import ServeEngine as JServeEngine
from repro_torch.models import RunOpts, Transformer, params_from_jax
from repro_torch.runtime.serve_lib import build_prefill_step
from repro_torch.serving import ServeEngine
from test_torch_graphs import _HostTraffic
from test_torch_serving import SUMMARY, _assert_same, _workload
from torch_port_utils import arch_params, max_err, models, prompt, small_cfgs

TOL = 1e-5
ARCHS = ["qwen2-0.5b", "phi4-mini-3.8b", "starcoder2-15b"]
RUNG = 16                           # a rung of the ladder: true_len 9..16 pads to it


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return models("float32", arch=request.param)


def _padded(cfg, n: int, rid: int = 7) -> np.ndarray:
    """A prompt of ``n`` tokens zero-padded to the rung, as the engine pads."""
    out = np.zeros((1, RUNG), np.int32)
    out[0, :n] = prompt(cfg, rid, n)
    return out


def test_tensor_true_len_matches_the_reference_at_every_length_of_a_rung(pair):
    """One jitted reference prefill (``true_len`` traced) and one port
    prefill per ``true_len`` in 9..16, on the same padded prompt buffer."""
    jm, jp, tm, tp = pair
    jprefill = jax.jit(lambda p, t, n: jm.prefill(p, {"tokens": t, "true_len": n}))
    for n in range(RUNG // 2 + 1, RUNG + 1):
        toks = _padded(jm.cfg, n)
        jl, jc = jprefill(jp, jnp.asarray(toks), jnp.asarray(n, jnp.int32))
        tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks),
                                 "true_len": torch.tensor(n, dtype=torch.int32)})
        assert max_err(jl, tl) < TOL, n
        assert int(jnp.argmax(jl[0])) == int(tl[0].argmax())
        assert tc["pos"].dtype == torch.int32
        assert tc["pos"].tolist() == np.asarray(jc["pos"]).tolist() == [n]
        for name in ("k", "v"):
            want = np.asarray(jc["pattern"]["0"][name])[:, :, :n]
            assert tuple(tc[name].shape) == jc["pattern"]["0"][name].shape
            got = tc[name][:, :, :n]
            assert max_err(want, got) < TOL * max(1.0, float(np.abs(want).max())), n


def test_int_and_tensor_true_len_give_identical_results(pair):
    """``true_len`` as a Python int (the eager callers), a 0-d tensor and
    a (B,) tensor: the same logits and cache bit for bit; a (B,)
    ``true_len`` gives each row what that row's own prefill gives."""
    _, _, tm, tp = pair
    toks = torch.from_numpy(np.concatenate([_padded(tm.cfg, 11, 3),
                                            _padded(tm.cfg, 14, 4)]))
    lens = torch.tensor([11, 14], dtype=torch.int32)
    batched, bc = tm.prefill(tp, {"tokens": toks, "true_len": lens})
    assert bc["pos"].tolist() == [11, 14]
    for row, n in enumerate((11, 14)):
        one = {"tokens": toks[row:row + 1]}
        a, ac = tm.prefill(tp, {**one, "true_len": n})
        b, bc1 = tm.prefill(tp, {**one, "true_len": torch.tensor(n, dtype=torch.int32)})
        assert torch.equal(a, b) and all(torch.equal(ac[k], bc1[k]) for k in ac)
        assert float((batched[row] - a[0]).abs().max()) < TOL
        assert int(batched[row].argmax()) == int(a[0].argmax())


@pytest.mark.parametrize("arch", ARCHS)
def test_padded_prefill_is_capture_safe(arch, monkeypatch):
    """The padded prefill on ``meta`` tensors, ``true_len`` a 0-d and a
    (B,) meta tensor, directly and through the eager ``build_prefill_step``:
    no op reads a value on the host or takes a host tensor, and no tensor
    is built on the host for the device."""
    jcfg, cfg = small_cfgs("float32", arch)
    _, np_tree = arch_params(arch, jcfg)
    opts = RunOpts(attention_impl="full", use_kernels=False)
    model = Transformer(cfg, opts, device="meta")
    p = model.load(params_from_jax(np_tree))
    step = build_prefill_step(model, None)
    real_tensor = torch.tensor
    built = []

    def tensor(data, *a, device=None, **kw):
        if device is not None and torch.device(device).type != "cpu":
            built.append((data, device))
        return real_tensor(data, *a, device=device, **kw)
    monkeypatch.setattr(torch, "tensor", tensor)
    with _HostTraffic() as mode:
        for b, true_len in ((1, torch.empty((), dtype=torch.int32, device="meta")),
                            (2, torch.empty((2,), dtype=torch.int32, device="meta"))):
            batch = {"tokens": torch.zeros((b, RUNG), dtype=torch.int32, device="meta"),
                     "true_len": true_len}
            logits, cache = model.prefill(p, batch)
            step(p, batch)
    assert mode.seen == [] and built == []
    assert logits.shape == (2, cfg.padded_vocab) and cache["pos"].shape == (2,)


def test_prefill_step_options_and_hook(pair):
    """``graphs=True`` needs a CUDA model; on the CPU every prompt runs
    eagerly and the hook fires once per (shape, has ``true_len``)
    signature, whatever ``true_len``'s value or type."""
    _, _, tm, tp = pair
    with pytest.raises(ValueError, match="CUDA"):
        build_prefill_step(tm, None, graphs=True)
    seen = []
    step = build_prefill_step(tm, None, trace_hook=seen.append)
    assert not step.graphs
    toks = torch.from_numpy(_padded(tm.cfg, 12))
    want, _ = tm.prefill(tp, {"tokens": toks, "true_len": 12})
    for n in (12, torch.tensor(12, dtype=torch.int32), 9):
        step(tp, {"tokens": toks, "true_len": n})
    step(tp, {"tokens": toks})
    step(tp, {"tokens": toks[:, :8], "true_len": 5})
    assert [(tuple(b["tokens"].shape), "true_len" in b) for b in seen] == [
        ((1, 16), True), ((1, 16), False), ((1, 8), True)]
    assert step.stats() == {"graphs": False, "n_captures": 0, "n_replays": 0,
                            "graph_pool_bytes": 0}
    got, _ = step(tp, {"tokens": toks, "true_len": 12})
    assert torch.equal(got, want)


@pytest.mark.parametrize("max_len,rungs", [
    (32, [8, 16, 32]), (100, [8, 16, 32, 64, 100]), (8, [8]), (5, [5]),
    (1024, [8, 16, 32, 64, 128, 256, 512, 1024])])
def test_prefill_rungs(pair, max_len, rungs):
    """The ladder: powers of two from 8, the top one capped at max_len (8
    rungs at max_len 1024).  A prompt is padded to the smallest rung that
    holds it, with ``true_len`` a 0-d tensor; past max_len it goes in as it
    is, without ``true_len`` (an eager prefill on the card)."""
    _, _, tm, tp = pair
    eng = ServeEngine(tm, tp, sample_trace=_workload(tm.cfg, [(1, 4, 4, 4, 0)])[1],
                      max_len=max_len, max_batch=2, page_tokens=8, attn_mode="paged")
    assert eng.prefill_rungs() == rungs
    for n in (1, rungs[0], rungs[-1] - 1, max_len, max_len + 3):
        batch = eng._prefill_batch(torch.ones(n, dtype=torch.int32))
        padded = batch["tokens"].shape[1]
        if n > max_len:
            assert "true_len" not in batch and padded == n
            continue
        assert padded == min(r for r in rungs if r >= n)
        assert batch["true_len"].shape == () and int(batch["true_len"]) == n
        assert int(batch["tokens"].sum()) == n          # zero padding


@pytest.mark.parametrize("max_len", [32, 100])
def test_engine_warms_every_rung_like_the_reference(pair, max_len):
    """Warmup, largest rung first: one prefill compile per rung, as the
    reference's ``warmup()`` pre-compiles them, and none while serving
    prompts of rungs 8, 16 and 32."""
    jm, jp, tm, tp = pair
    shapes = [(1, 9, 4, 4, 0), (2, 3, 4, 4, 0), (3, 30, 4, 4, 1), (4, 17, 4, 4, 2)]
    jt, tt, jl, tl = _workload(jm.cfg, shapes)
    kw = dict(max_len=max_len, max_batch=2, page_tokens=8, attn_mode="paged")
    jeng = JServeEngine(jm, jp, sample_trace=jt, **kw)
    teng = ServeEngine(tm, tp, sample_trace=tt, **kw)
    jeng.warmup()
    teng.warmup()
    warm = len(teng.prefill_rungs())
    assert teng.prefill_compiles == jeng.prefill_compiles == warm
    js, ts = jeng.run(jl), teng.run(tl)
    _assert_same(jeng, js, teng, ts)
    assert teng.prefill_compiles == jeng.prefill_compiles == warm


def test_engine_streams_match_the_reference_with_prompts_sharing_a_rung(pair):
    """Prompts of 9-16 tokens (all rung 16), one of 5 (rung 8) and one of
    23 (rung 32), staggered through 3 slots in paged mode: token streams,
    summaries and page-pool decisions equal the reference's, and one
    prefill compile per rung used."""
    jm, jp, tm, tp = pair
    lengths = [9, 16, 12, 5, 14, 23, 10]
    shapes = [(i + 1, n, 4, 5 + i % 3, i) for i, n in enumerate(lengths)]
    jt, tt, jl, tl = _workload(jm.cfg, shapes)
    kw = dict(max_len=32, max_batch=3, page_tokens=8, attn_mode="paged")
    jeng = JServeEngine(jm, jp, sample_trace=jt, **kw)
    teng = ServeEngine(tm, tp, sample_trace=tt, **kw)
    js, ts = jeng.run(jl), teng.run(tl)
    assert ts["n_completed"] == len(shapes)
    _assert_same(jeng, js, teng, ts)
    assert {k: ts[k] for k in SUMMARY} == {k: js[k] for k in SUMMARY}
    assert teng.prefill_compiles == jeng.prefill_compiles == 3
