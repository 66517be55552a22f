"""The compiled decode step: the runner's static-buffer step (one CUDA graph
per bucket on the card), the slab decode step of ``build_decode_step``, the
launch accounting of captured graphs, and the engine's admission and replan
options (``use_runner``, ``replan_interval``, ``hbm_budget``, ``metrics``),
held against the reference's ``ServeEngine`` on the same trace, prompts and
converted weights in f32.

The tests marked ``cuda`` capture real graphs and skip without a card; the
CPU tests run the same steps eagerly (``graphs=False``, the only mode a CPU
model takes).
"""
import math

import jax.numpy as jnp
import pytest
import torch

from repro.runtime.serve_lib import Request as JRequest
from repro.serving import GenRequest as JGenRequest
from repro.serving import ServeEngine as JServeEngine
from repro.serving import pages as jpages
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.models import RunOpts, Transformer
from repro_torch.runtime.serve_lib import Request as TRequest
from repro_torch.runtime.serve_lib import build_decode_step, build_prefill_step
from repro_torch.serving import DecodeRunner, ServeEngine, ServeMetrics, bucket_ladder
from repro_torch.serving import GenRequest as TGenRequest
from repro_torch.serving import pages as tpages
from torch_capture_check import HostTraffic as _HostTraffic
from torch_port_utils import MOE_SMALL, SMALL, models, prompt

PAGE_STATS = ("page_tokens", "page_bytes", "n_pages", "used_pages",
              "n_pool_resize", "n_reopt", "n_incr_replans", "n_full_replans",
              "planned_peak", "max_peak", "overflow_peak", "n_replan_requests",
              "replan_causes")
SUMMARY = ("n_requests", "n_completed", "n_steps", "tokens", "tokens_discarded",
           "prefill_tokens", "ttft_steps_mean", "max_concurrent", "n_preemptions")


@pytest.fixture(scope="module")
def pair():
    return models("float32")


def _workload(cfg, shapes):
    """shapes: (rid, prompt_len, profiled gen, live gen, arrival)."""
    jt = [JRequest(rid=r, prompt_len=n, gen_len=g, arrival=a) for r, n, g, _, a in shapes]
    tt = [TRequest(rid=r, prompt_len=n, gen_len=g, arrival=a) for r, n, g, _, a in shapes]
    jl = [JGenRequest(rid=r, prompt=jnp.asarray(prompt(cfg, r, n)), gen_len=gl, arrival=a)
          for r, n, _, gl, a in shapes]
    tl = [TGenRequest(rid=r, prompt=torch.from_numpy(prompt(cfg, r, n)), gen_len=gl,
                      arrival=a) for r, n, _, gl, a in shapes]
    return jt, tt, jl, tl


def _churn(n=12):
    """The profile says short generations, live traffic runs longer: the
    pool is undersized, so decode-outrun preemptions and replans churn."""
    return [(i + 1, 5 + (3 * i) % 12, 4, 10 + (i + 1) % 7, 2 * i) for i in range(n)]


def _run_both(pair, shapes, **kw):
    jm, jp, tm, tp = pair
    jt, tt, jl, tl = _workload(jm.cfg, shapes)
    jeng = JServeEngine(jm, jp, sample_trace=jt, **kw)
    teng = ServeEngine(tm, tp, sample_trace=tt, **kw)
    return jeng, jeng.run(jl), teng, teng.run(tl)


def _assert_same(jeng, js, teng, ts):
    assert teng.completed == jeng.completed            # token-exact, every rid
    assert {k: ts[k] for k in SUMMARY} == {k: js[k] for k in SUMMARY}
    jkv, tkv = jeng.kv.stats(), teng.kv.stats()
    assert {k: tkv[k] for k in PAGE_STATS} == {k: jkv[k] for k in PAGE_STATS}
    assert (teng.step_count, teng.decode_steps) == (jeng.step_count, jeng.decode_steps)


# --------------------------------------------------------------------------
# the engine's options against the reference
# --------------------------------------------------------------------------


def test_slab_decode_matches_reference_under_churn(pair):
    """``use_runner=False``: every slot decodes each step through the
    full-batch slab step, idle slots included, in gather mode."""
    jeng, js, teng, ts = _run_both(pair, _churn(), max_len=64, max_batch=4,
                                   page_tokens=8, use_runner=False)
    assert teng.runner is None and not teng.graphs
    assert ts["n_preemptions"] > 0 and ts["n_completed"] == 12
    _assert_same(jeng, js, teng, ts)
    assert teng.decode_compiles == jeng.decode_compiles == 1


def test_slab_decode_equals_the_runner(pair):
    """The slab step and the bucketed runner decode the same tokens."""
    _, _, tm, tp = pair
    out = {}
    for use_runner in (False, True):
        _, tt, _, tl = _workload(tm.cfg, _churn(8))
        eng = ServeEngine(tm, tp, sample_trace=tt, max_len=64, max_batch=4,
                          page_tokens=8, use_runner=use_runner)
        out[use_runner] = (eng.run(tl)["n_preemptions"], eng.completed)
    assert out[False] == out[True]


def test_paged_mode_needs_the_runner_in_both(pair):
    jm, jp, tm, tp = pair
    jt, tt, _, _ = _workload(jm.cfg, [(1, 8, 4, 4, 0)])
    for eng, m, p, trace in ((JServeEngine, jm, jp, jt), (ServeEngine, tm, tp, tt)):
        with pytest.raises(ValueError, match="use_runner"):
            eng(m, p, sample_trace=trace, max_len=32, max_batch=2, page_tokens=8,
                use_runner=False, attn_mode="paged")


def _busy(eng_cls, model, params, cfg, gen_cls, interval):
    """Three requests that never let the engine go idle for 32 steps."""
    req = JRequest if eng_cls is JServeEngine else TRequest
    trace = [req(rid=i + 1, prompt_len=8, gen_len=4, arrival=0) for i in range(3)]
    eng = eng_cls(model, params, sample_trace=trace, max_len=64, max_batch=3,
                  page_tokens=8, replan_interval=interval)
    for r in trace:
        p = prompt(cfg, r.rid, r.prompt_len)
        eng.enqueue(gen_cls(rid=r.rid, prompt=jnp.asarray(p) if eng_cls is JServeEngine
                            else torch.from_numpy(p), gen_len=40, arrival=0))
    while not eng.sched.idle and eng.step_count < 32:
        eng.step()
    assert not eng.sched.idle                       # still under load
    return eng.kv.stats()


@pytest.mark.parametrize("interval", [None, 4, 64])
def test_replan_interval_matches_reference_under_sustained_load(pair, interval):
    """The reference's ``test_replan_interval_fires_under_sustained_load``
    in both packages: the interval clock closes §4.3 epochs while busy,
    None only when idle; the replan counts and causes agree."""
    jm, jp, tm, tp = pair
    js = _busy(JServeEngine, jm, jp, jm.cfg, JGenRequest, interval)
    ts = _busy(ServeEngine, tm, tp, tm.cfg, TGenRequest, interval)
    assert {k: ts[k] for k in PAGE_STATS} == {k: js[k] for k in PAGE_STATS}
    if interval == 4:
        assert ts["n_reopt"] >= 1                   # replanned while busy
    if interval is None:
        assert ts["n_reopt"] == 0                   # idle-only: starved


def test_hbm_budget_caps_admission_like_the_reference(pair):
    """A budget that fits two concurrent requests' planned pool: admission
    is capped at 2 of 4 slots, in both packages alike."""
    jm, _, tm, _ = pair
    shapes = _churn(10)
    jt, tt, _, _ = _workload(jm.cfg, shapes)
    budget = tpages.concurrency_bytes(tm.cfg, tt, 8, 2)
    assert budget == jpages.concurrency_bytes(jm.cfg, jt, 8, 2)
    assert tpages.max_concurrency(tm.cfg, tt, 8, budget, hi=4) == 2
    jeng, js, teng, ts = _run_both(pair, shapes, max_len=64, max_batch=4,
                                   page_tokens=8, hbm_budget=budget, reserve_pages=2)
    assert teng.sched.cap == jeng.sched.cap == 2
    assert ts["max_concurrent"] == 2 and ts["n_completed"] == 10
    _assert_same(jeng, js, teng, ts)


def test_metrics_object_is_the_one_filled(pair):
    _, _, tm, tp = pair
    _, tt, _, tl = _workload(tm.cfg, _churn(4))
    m = ServeMetrics()
    eng = ServeEngine(tm, tp, sample_trace=tt, max_len=64, max_batch=4,
                      page_tokens=8, metrics=m)
    summary = eng.run(tl)
    assert eng.metrics is m
    assert m.summary()["n_completed"] == summary["n_completed"] == 4


def test_unported_options_raise(pair):
    """Anything but a DeviceMesh is refused; graphs=True with a mesh is
    refused on a CPU model as without one (graphs under a mesh capture on
    the card)."""
    _, _, tm, tp = pair
    trace = [TRequest(rid=1, prompt_len=8, gen_len=4, arrival=0)]
    with pytest.raises(TypeError, match="DeviceMesh"):
        ServeEngine(tm, tp, sample_trace=trace, max_len=32, max_batch=2,
                    mesh=object())
    for build in (build_prefill_step, build_decode_step):
        with pytest.raises(TypeError, match="DeviceMesh"):
            build(tm, object())
    with pytest.raises(ValueError, match="needs a model on a CUDA device"):
        ServeEngine(tm, tp, sample_trace=trace, max_len=32, max_batch=2,
                    mesh=object(), graphs=True)
    for build in (build_prefill_step, build_decode_step):
        with pytest.raises(ValueError, match="needs a model on a CUDA device"):
            build(tm, object(), graphs=True)


# --------------------------------------------------------------------------
# build_prefill_step and build_decode_step
# --------------------------------------------------------------------------


def test_step_factories_fire_their_hook_once_per_shape(pair):
    _, _, tm, tp = pair
    seen = []
    prefill = build_prefill_step(tm, None, max_len=32, trace_hook=seen.append)
    toks = torch.from_numpy(prompt(tm.cfg, 1, 16))[None]
    logits, cache = prefill(tp, {"tokens": toks})
    prefill(tp, {"tokens": toks + 1})                   # same shape: no hook
    prefill(tp, {"tokens": toks, "true_len": 12})       # padded: a new one
    prefill(tp, {"tokens": toks[:, :8]})
    assert [(int(b["tokens"].shape[1]), "true_len" in b) for b in seen] == [
        (16, False), (16, True), (8, False)]
    assert cache["k"].shape[2] == 32

    hooked = []
    decode = build_decode_step(tm, None, trace_hook=hooked.append)
    tok = toks[:, -1].clone()
    want, _ = tm.decode_step(tp, {k: v.clone() for k, v in cache.items()}, tok)
    got, out = decode(tp, cache, tok)
    assert out is cache and int(cache["pos"][0]) == 17      # updated in place
    assert torch.equal(got, want)
    decode(tp, cache, tok)
    assert len(hooked) == 1
    with pytest.raises(ValueError, match="CUDA"):
        build_decode_step(tm, None, graphs=True)


# --------------------------------------------------------------------------
# the runner's static-buffer step
# --------------------------------------------------------------------------


def test_static_buffer_step_matches_decode_step_on_isolated_rows(pair):
    """``graphs=False``: the step a graph captures, run eagerly.  Real rows'
    logits equal ``decode_step`` over the whole batch, a partial batch is
    padded to its bucket, and ``step()``'s logits are the caller's own: the
    next call does not overwrite them."""
    _, _, tm, tp = pair
    runner = DecodeRunner(tm, max_batch=4)
    assert not runner.graphs and runner.stats()["graph_pool_bytes"] == 0
    toks = torch.stack([torch.from_numpy(prompt(tm.cfg, r, 10)) for r in range(4)])
    _, cache = tm.prefill(tp, {"tokens": toks}, max_len=16)
    tok_vec = toks[:, -1].clone()
    ref_logits, _ = tm.decode_step(tp, {k: v.clone() for k, v in cache.items()},
                                   tok_vec.clone())
    held = {}
    for n in (1, 3, 4):
        logits, _ = runner.step(tp, {k: v.clone() for k, v in cache.items()},
                                tok_vec.clone(), list(range(n)))
        held[n] = (logits, logits.clone())
        assert logits.shape[0] == n
        assert float((logits - ref_logits[:n]).abs().max()) < 1e-5
    for logits, copy in held.values():
        assert torch.equal(logits, copy)
    assert runner.stats()["n_compiled"] == 2 == runner.n_compiles   # buckets 1, 4


def test_step_greedy_updates_only_the_running_rows(pair):
    _, _, tm, tp = pair
    runner = DecodeRunner(tm, max_batch=4)
    toks = torch.stack([torch.from_numpy(prompt(tm.cfg, r, 10)) for r in range(4)])
    _, cache = tm.prefill(tp, {"tokens": toks}, max_len=16)
    before = {k: v.clone() for k, v in cache.items()}
    tokens = toks[:, -1].clone().int()
    nxt, _, _ = runner.step_greedy(tp, cache, tokens, [1, 2, 3])
    assert nxt.shape == (3,) and tokens[1:].tolist() == nxt.tolist()
    assert int(tokens[0]) == int(toks[0, -1])
    assert torch.equal(cache["k"][:, 0], before["k"][:, 0])
    assert cache["pos"].tolist() == [10, 11, 11, 11]


def test_graphs_need_a_cuda_model(pair):
    _, _, tm, tp = pair
    with pytest.raises(ValueError, match="CUDA"):
        DecodeRunner(tm, max_batch=2, graphs=True)
    with pytest.raises(ValueError, match="CUDA"):
        ServeEngine(tm, tp, sample_trace=[TRequest(1, 8, 4, 0)], max_len=32,
                    max_batch=2, graphs=True)


# --------------------------------------------------------------------------
# what capture needs of the code: no host traffic, launches counted per replay
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mamba2-130m", "recurrentgemma-9b",
                                  "granite-moe-1b-a400m", "qwen3-moe-30b-a3b"])
def test_decode_steps_are_capture_safe(arch, monkeypatch):
    """The decode step, the runner's step and the slab step of each
    pattern, and of the MoE decoders (the router, top-k, the stable sort,
    ``searchsorted``, dispatch and combine), on ``meta`` tensors: no op reads
    a value on the host or takes a host tensor, and no tensor is built on
    the host for the device (``torch.tensor(..., device=...)`` is a copy a
    capture refuses)."""
    cfg = get_config(arch)
    over = {"qwen2-0.5b": SMALL, **MOE_SMALL}.get(arch)
    cfg = (cfg.with_overrides(**over) if over else cfg.smoke()
           ).with_overrides(dtype="float32")
    opts = RunOpts(attention_impl="full", use_kernels=False)
    params = Transformer(cfg, opts, device="cpu").init(torch.Generator().manual_seed(0))
    model = Transformer(cfg, opts, device="meta")
    p = model.load(params)
    cache = model.init_cache(4, 32)
    tokens = torch.zeros(4, dtype=torch.int32, device="meta")
    runner = DecodeRunner(model, max_batch=4)
    slots = torch.tensor([2, 0, 0, 0], device="meta")
    slab = build_decode_step(model, None)
    real_tensor = torch.tensor
    built = []

    def tensor(data, *a, device=None, **kw):
        if device is not None and torch.device(device).type != "cpu":
            built.append((data, device))
        return real_tensor(data, *a, device=device, **kw)
    monkeypatch.setattr(torch, "tensor", tensor)
    with _HostTraffic() as mode:
        model.decode_step(p, cache, tokens)
        runner._step_fn(p, cache, tokens, slots)
        slab(p, cache, tokens)
    assert mode.seen == [] and built == []


def test_captured_launches_count_once_per_replay():
    """A capture runs nothing: the counts a wrapper took while being
    captured are put back, and each replay adds them."""
    ops.reset_launches()
    ops.paged_attention.launches = 5
    with ops.CapturedLaunches() as rec:
        ops.paged_attention.launches += 24      # as 24 captured layers would
        ops.flash_attention.launches += 1
    assert rec.counts == {"flash_attention": 1, "paged_attention": 24,
                          "ssd_scan": 0, "rglru_scan": 0}
    assert (ops.paged_attention.launches, ops.flash_attention.launches) == (5, 0)
    for _ in range(3):
        rec.replayed()
    assert (ops.paged_attention.launches, ops.flash_attention.launches) == (77, 3)
    ops.reset_launches()


def test_serve_cli_without_the_runner(capsys):
    from repro_torch.launch import serve
    serve.main(["--device", "cpu", "--no-runner", "--requests", "3",
                "--max-batch", "2", "--max-len", "32"])
    out = capsys.readouterr().out
    assert "[decode:slab]" in out and "graphs=False" in out
    assert "completed 3/3 requests" in out and "[runner]" not in out


# --------------------------------------------------------------------------
# on the card: real graphs against the same steps run eagerly
# --------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: run on the card with "
                    "`python -m pytest -m cuda tests`")


def _card_model(arch):
    """A small model on the card: qwen2 at head_dim 64 (a width the paged
    kernel takes) with the kernels; recurrentgemma's smoke size with plain
    prefill (its head_dim 16 is no flash width; decode runs no kernel)."""
    if arch == "qwen2-0.5b":
        cfg = get_config(arch).with_overrides(
            n_layers=2, d_model=128, n_heads=14, n_kv_heads=2, head_dim=64,
            d_ff=256, vocab_size=512, dtype="float32")
        opts, mode = RunOpts(attention_impl="kernel"), "paged"
    else:
        cfg = get_config(arch).smoke().with_overrides(dtype="float32")
        opts, mode = RunOpts(attention_impl="full", use_kernels=False), "gather"
    model = Transformer(cfg, opts, device="cuda")
    return model, model.init_loaded(torch.Generator(device="cuda").manual_seed(0)), mode


def _card_churn(cfg, n=12):
    trace = [TRequest(rid=i + 1, prompt_len=5 + (3 * i) % 12, gen_len=4, arrival=2 * i)
             for i in range(n)]
    live = [TGenRequest(rid=r.rid, prompt=torch.from_numpy(prompt(cfg, r.rid, r.prompt_len)),
                        gen_len=10 + r.rid % 7, arrival=r.arrival) for r in trace]
    return trace, live


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "recurrentgemma-9b"])
def test_graphs_equal_eager_under_preemption_churn_on_the_card(card, arch):
    """Graph and eager runs of one churned trace (slots reused; for qwen2
    also preemptions, page-table rows rewritten and replans): the same
    token streams, the same kernel launches, warmup leaving the cache
    bitwise as it was, and the capture count flat after warmup."""
    model, params, mode = _card_model(arch)
    out = {}
    for graphs in (False, True):
        trace, live = _card_churn(model.cfg)
        eng = ServeEngine(model, params, sample_trace=trace, max_len=64, max_batch=4,
                          page_tokens=8, attn_mode=mode, graphs=graphs)
        before = {k: v.clone() for k, v in eng.cache.items()}
        eng.warmup()
        torch.cuda.synchronize()
        assert all(torch.equal(eng.cache[k], v) for k, v in before.items())
        warm = eng.runner.n_compiles
        assert warm == len(bucket_ladder(4))
        ops.reset_launches()
        summary = eng.run(live)
        torch.cuda.synchronize()
        assert eng.runner.n_compiles == warm
        out[graphs] = (eng.completed, {fn.__name__: fn.launches for fn in ops.WRAPPERS},
                       summary["n_preemptions"], summary["kv_n_reopt"])
        if graphs:
            assert eng.runner.stats()["graph_pool_bytes"] > 0
    assert out[True] == out[False]
    if mode == "paged":     # a recurrent request's state page never grows
        assert out[True][2] > 0 and out[True][3] > 0
        assert out[True][1]["paged_attention"] > 0


@pytest.mark.cuda
def test_another_cache_recaptures_on_the_card(card):
    """A graph is bound to the cache it was captured with: a call with
    another cache captures again (counted), and each cache decodes as it
    would eagerly."""
    model, params, _ = _card_model("qwen2-0.5b")
    toks = torch.stack([torch.from_numpy(prompt(model.cfg, r, 10)) for r in range(2)]).cuda()
    _, cache = model.prefill(params, {"tokens": toks}, max_len=16)
    caches = [{k: v.clone() for k, v in cache.items()} for _ in range(3)]
    tokens = [toks[:, -1].int().clone() for _ in range(3)]
    graph, eager = DecodeRunner(model, max_batch=2), DecodeRunner(model, max_batch=2,
                                                                  graphs=False)
    graph.warmup(params, caches[0], tokens[0])
    assert graph.n_compiles == 2
    a, _, _ = graph.step_greedy(params, caches[0], tokens[0], [0, 1])
    b, _, _ = graph.step_greedy(params, caches[1], tokens[1], [0, 1])
    assert graph.n_compiles == 3                        # bucket 2 recaptured
    c, _, _ = eager.step_greedy(params, caches[2], tokens[2], [0, 1])
    assert a.tolist() == b.tolist() == c.tolist()
    for k in cache:
        assert torch.equal(caches[0][k], caches[2][k])
        assert torch.equal(caches[1][k], caches[2][k])


@pytest.mark.cuda
def test_slab_step_graph_equals_eager_on_the_card(card):
    """``build_decode_step`` captured and eager: the same tokens and caches
    over four slab steps, one hook call each."""
    model, params, _ = _card_model("recurrentgemma-9b")
    toks = torch.stack([torch.from_numpy(prompt(model.cfg, r, 10)) for r in range(3)]).cuda()
    _, cache = model.prefill(params, {"tokens": toks}, max_len=16)
    hooks = {True: [], False: []}
    steps = {g: build_decode_step(model, None, graphs=g, trace_hook=hooks[g].append)
             for g in (True, False)}
    caches = {g: {k: v.clone() for k, v in cache.items()} for g in (True, False)}
    tok = {g: toks[:, -1].int().clone() for g in (True, False)}
    for _ in range(4):
        for g in (True, False):
            logits, _ = steps[g](params, caches[g], tok[g])
            tok[g] = logits.argmax(-1).int()
        assert torch.equal(tok[True], tok[False])
    assert all(torch.equal(caches[True][k], caches[False][k]) for k in cache)
    assert len(hooks[True]) == len(hooks[False]) == 1
    assert math.isfinite(float(logits.abs().max()))
