"""The compiled prefill on the card: one CUDA graph per rung of the prompt
ladder, held against the same prefill run eagerly.  Every test here needs
an NVIDIA GPU and nvcc (marker ``cuda``) and skips without them; the file
imports no JAX, so the card's run needs nothing of the reference.

A small qwen2-0.5b layout at head dim 64 (a width the flash kernel takes),
in f32 and bf16: graph replays and eager calls run the same kernels in the
same order, so logits, ``pos`` and K/V are expected bit for bit.
"""
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.models import RunOpts, Transformer
from repro_torch.runtime.serve_lib import Request, build_prefill_step
from repro_torch.serving import GenRequest, ServeEngine

MAX_LEN = 64


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: run on the card with "
                    "`python -m pytest -m cuda tests`")


def _model(dtype="float32"):
    cfg = get_config("qwen2-0.5b").with_overrides(
        n_layers=2, d_model=128, n_heads=14, n_kv_heads=2, head_dim=64,
        d_ff=256, vocab_size=512, dtype=dtype)
    model = Transformer(cfg, RunOpts(attention_impl="kernel"), device="cuda")
    return model, model.init_loaded(torch.Generator(device="cuda").manual_seed(0))


def _padded(cfg, n: int, rung: int, seed: int) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    toks = torch.zeros((1, rung), dtype=torch.int32)
    toks[0, :n] = torch.randint(0, cfg.vocab_size, (n,), generator=g, dtype=torch.int32)
    return toks.cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_graphed_prefill_equals_eager_at_every_rung_on_the_card(card, dtype):
    """Each rung (8, 16, 32, 64) captured once, then replayed for three
    true lengths in it: logits, argmax, ``pos`` and K/V equal to the eager
    prefill of the same batch, each replay launching the flash kernel once
    a layer."""
    model, params = _model(dtype)
    graphs = build_prefill_step(model, None, graphs=True)
    eager = build_prefill_step(model, None, graphs=False)
    for rung in (64, 32, 16, 8):
        for i, n in enumerate((rung, rung // 2 + 1, max(1, rung // 4))):
            batch = {"tokens": _padded(model.cfg, n, rung, 31 * rung + i),
                     "true_len": torch.full((), n, dtype=torch.int32, device="cuda")}
            ops.reset_launches()
            logits, cache = graphs(params, batch)
            torch.cuda.synchronize()
            if i:       # the capture's own call replays once too
                assert ops.flash_attention.launches == model.cfg.n_layers
            want, want_cache = eager(params, batch)
            assert torch.equal(logits, want), (rung, n)
            assert int(logits[0].argmax()) == int(want[0].argmax())
            assert cache["pos"].tolist() == [n]
            for name in ("k", "v"):
                assert torch.equal(cache[name], want_cache[name]), (rung, n, name)
    stats = graphs.stats()
    assert stats["n_captures"] == 4 and stats["n_replays"] == 12
    assert stats["graph_pool_bytes"] > 0


@pytest.mark.cuda
def test_another_params_object_recaptures_on_the_card(card):
    """A prefill graph is bound to the parameters it was captured with:
    another params object (here the same values, copied) captures again,
    and both give the eager result."""
    model, params = _model()
    other = {k: v for k, v in params.items()}
    other["final_norm"] = {k: v.clone() for k, v in params["final_norm"].items()}
    seen = []
    step = build_prefill_step(model, None, graphs=True, trace_hook=seen.append)
    batch = {"tokens": _padded(model.cfg, 11, 16, 5),
             "true_len": torch.full((), 11, dtype=torch.int32, device="cuda")}
    want, _ = model.prefill(params, batch)
    a = step(params, batch)[0].clone()
    step(params, batch)
    assert step.n_captures == 1
    b = step(other, batch)[0].clone()
    assert step.n_captures == 2 == len(seen)
    assert torch.equal(a, want) and torch.equal(b, want)


@pytest.mark.cuda
def test_engine_captures_every_rung_at_warmup_and_none_while_serving(card):
    """Paged qwen2 under preemption churn, prompts 3-48 (every rung of a
    max_len of 64): warmup captures one prefill graph per rung into a pool
    apart from the decode runner's; the run captures nothing and gives the
    eager engine's token streams, prefill counts and launches."""
    model, params = _model()
    g = torch.Generator().manual_seed(3)
    lengths = [5, 48, 9, 33, 16, 12, 47, 24, 8, 40, 3, 30]
    trace = [Request(rid=i + 1, prompt_len=n, gen_len=4, arrival=2 * i)
             for i, n in enumerate(lengths)]
    live = [GenRequest(rid=r.rid, prompt=torch.randint(0, model.cfg.vocab_size,
                                                       (r.prompt_len,), generator=g,
                                                       dtype=torch.int32),
                       gen_len=10 + r.rid % 5, arrival=r.arrival) for r in trace]
    out = {}
    for graphs in (False, True):
        eng = ServeEngine(model, params, sample_trace=trace, max_len=MAX_LEN,
                          max_batch=4, page_tokens=8, attn_mode="paged", graphs=graphs)
        eng.warmup()
        warm = eng.prefill_compiles
        assert warm == len(eng.prefill_rungs()) == 4
        ops.reset_launches()
        summary = eng.run(live)
        torch.cuda.synchronize()
        assert eng.prefill_compiles == warm
        stats = eng.prefill.stats()
        if graphs:
            assert stats["n_captures"] == 4
            assert tuple(eng.prefill.pool) != tuple(eng.runner._pool)
            assert stats["graph_pool_bytes"] > 0
        out[graphs] = (eng.completed, {fn.__name__: fn.launches for fn in ops.WRAPPERS},
                       eng.prefill_calls, summary["n_preemptions"])
    assert out[True] == out[False]
    assert out[True][3] > 0
