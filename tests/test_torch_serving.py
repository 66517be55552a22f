"""The slice as a whole: the port's continuous-batching ServeEngine against
the reference's on the same trace, prompts and (converted) weights, in f32.

Paged decode runs the reference's Pallas paged kernel (interpret mode) and
flash prefill its Pallas flash kernel; the port runs its kernel wrappers,
which take the plain versions for these CPU tensors.  Greedy token streams
must be identical for every request, and the scheduler and page pool must
make the same decisions: preemptions, §4.3 replans and page counts.
"""
import jax.numpy as jnp
import pytest
import torch

from repro.runtime.serve_lib import Request as JRequest
from repro.serving import GenRequest as JGenRequest
from repro.serving import ServeEngine as JServeEngine
from repro_torch.obs.metrics import MetricsRegistry, use_registry
from repro_torch.runtime.serve_lib import Request as TRequest
from repro_torch.serving import DecodeRunner, ServeEngine, bucket_ladder
from repro_torch.serving import GenRequest as TGenRequest
from torch_port_utils import models, prompt

PAGE_STATS = ("page_tokens", "page_bytes", "n_pages", "used_pages",
              "n_pool_resize", "exec_n_pages", "exec_live_pages", "n_reopt",
              "n_incr_replans", "n_full_replans", "planned_peak", "max_peak",
              "overflow_peak", "n_replan_requests", "replan_causes")
SUMMARY = ("n_requests", "n_completed", "n_steps", "tokens",
           "tokens_discarded", "prefill_tokens", "ttft_steps_mean",
           "max_concurrent", "n_preemptions")


@pytest.fixture(scope="module")
def pair():
    return models("float32")


def _workload(cfg, shapes):
    """shapes: (rid, prompt_len, profiled gen, live gen, arrival)."""
    jt = [JRequest(rid=r, prompt_len=n, gen_len=g, arrival=a) for r, n, g, _, a in shapes]
    tt = [TRequest(rid=r, prompt_len=n, gen_len=g, arrival=a) for r, n, g, _, a in shapes]
    jl = [JGenRequest(rid=r, prompt=jnp.asarray(prompt(cfg, r, n)), gen_len=gl, arrival=a)
          for r, n, _, gl, a in shapes]
    tl = [TGenRequest(rid=r, prompt=torch.from_numpy(prompt(cfg, r, n)), gen_len=gl, arrival=a)
          for r, n, _, gl, a in shapes]
    return jt, tt, jl, tl


def _run_both(pair, shapes, **kw):
    jm, jp, tm, tp = pair
    jt, tt, jl, tl = _workload(jm.cfg, shapes)
    jeng = JServeEngine(jm, jp, sample_trace=jt, attn_mode="paged", **kw)
    teng = ServeEngine(tm, tp, sample_trace=tt, attn_mode="paged", **kw)
    return jeng, jeng.run(jl), teng, teng.run(tl)


def _assert_same(jeng, js, teng, ts):
    assert teng.completed == jeng.completed            # token-exact, every rid
    assert {k: ts[k] for k in SUMMARY} == {k: js[k] for k in SUMMARY}
    jkv, tkv = jeng.kv.stats(), teng.kv.stats()
    assert {k: tkv[k] for k in PAGE_STATS} == {k: jkv[k] for k in PAGE_STATS}
    assert teng.step_count == jeng.step_count
    assert teng.decode_steps == jeng.decode_steps


def test_staggered_admissions_token_identical(pair):
    """Mid-stream admissions with unequal prompts (per-slot clocks), prompts
    crossing the prefill padding ladder's rungs, and the page size chosen by
    the planner (``page_tokens=None``)."""
    shapes = [(1, 5, 8, 8, 0), (2, 11, 8, 8, 1), (3, 17, 8, 8, 3), (4, 7, 8, 8, 5),
              (5, 16, 6, 9, 6), (6, 30, 6, 5, 7)]
    jeng, js, teng, ts = _run_both(pair, shapes, max_len=64, max_batch=4,
                                   page_tokens=None)
    assert ts["n_completed"] == len(shapes) and ts["max_concurrent"] >= 2
    _assert_same(jeng, js, teng, ts)


def test_preemption_churn_token_identical(pair):
    """The profile says short generations; live traffic runs much longer, so
    the pool is undersized and decode-outrun preemptions churn the batch
    (restarts, page recycling, table-row rewrites, §4.3 replans)."""
    shapes = [(i + 1, 5 + (3 * i) % 12, 4, 10 + (i + 1) % 7, 2 * i)
              for i in range(16)]
    jeng, js, teng, ts = _run_both(pair, shapes, max_len=64, max_batch=4,
                                   page_tokens=8)
    assert ts["n_preemptions"] > 0 and ts["kv_n_reopt"] > 0
    assert ts["n_completed"] == len(shapes)
    _assert_same(jeng, js, teng, ts)


def test_gather_mode_matches_paged(pair):
    """The contiguous-cache runner path decodes the same tokens as the paged
    path on a churn workload (the reference's paged-vs-gather gate)."""
    _, _, tm, tp = pair
    shapes = [(i + 1, 4 + (5 * i) % 13, 4, 9 + i % 5, 2 * i) for i in range(10)]
    out = {}
    for mode in ("gather", "paged"):
        _, tt, _, tl = _workload(tm.cfg, shapes)
        eng = ServeEngine(tm, tp, sample_trace=tt, max_len=64, max_batch=4,
                          page_tokens=8, attn_mode=mode)
        out[mode] = (eng.run(tl), eng.completed)
    assert out["paged"][1] == out["gather"][1]
    assert out["paged"][0]["n_preemptions"] == out["gather"][0]["n_preemptions"]


def test_warmup_keeps_compile_counters_flat(pair):
    _, _, tm, tp = pair
    shapes = [(i + 1, 3 + 4 * i, 4, 6, i) for i in range(6)]
    _, tt, _, tl = _workload(tm.cfg, shapes)
    eng = ServeEngine(tm, tp, sample_trace=tt, max_len=32, max_batch=4,
                      page_tokens=8, attn_mode="paged")
    reg = MetricsRegistry()
    with use_registry(reg):
        eng.warmup()
        warm = (eng.runner.n_compiles, eng.prefill_compiles)
        counter = reg.counter("runner_compile_total").value
        summary = eng.run(tl)
    assert warm == (len(bucket_ladder(4)), 3)           # buckets; ladder 8,16,32
    assert (eng.runner.n_compiles, eng.prefill_compiles) == warm
    assert reg.counter("runner_compile_total").value == counter
    assert summary["n_completed"] == len(shapes)


def test_runner_buckets_and_padding(pair):
    _, _, tm, tp = pair
    runner = DecodeRunner(tm, max_batch=8)
    assert bucket_ladder(6) == (1, 2, 4, 6)
    assert [runner.bucket_for(n) for n in (1, 2, 3, 5, 8)] == [1, 2, 4, 8, 8]
    with pytest.raises(ValueError):
        runner.bucket_for(9)
    # padding by repeating the last slot leaves the real rows' logits alone
    toks = torch.stack([torch.from_numpy(prompt(tm.cfg, r, 10)) for r in range(4)])
    _, cache = tm.prefill(tp, {"tokens": toks}, max_len=16)
    tok_vec = toks[:, -1].clone()
    ref_logits, _ = tm.decode_step(tp, {k: v.clone() for k, v in cache.items()},
                                   tok_vec.clone())
    for n in (1, 3):                                     # 3 pads up to bucket 4
        logits, _ = DecodeRunner(tm, max_batch=4).step(
            tp, {k: v.clone() for k, v in cache.items()}, tok_vec.clone(),
            list(range(n)))
        assert logits.shape[0] == n
        assert float((logits - ref_logits[:n]).abs().max()) < 1e-5


@pytest.mark.parametrize("attn", ["gather", "paged"])
def test_serve_cli_on_cpu(attn, capsys):
    """The launch driver end to end at the tiny preset on an explicit CPU."""
    from repro_torch.launch import serve
    serve.main(["--device", "cpu", "--attn", attn, "--requests", "4",
                "--max-batch", "2", "--max-len", "32"])
    out = capsys.readouterr().out
    assert "[paged pool] page_tokens=" in out and "[decode:runner]" in out
    assert "completed 4/4 requests" in out


def test_profile_cli_on_cpu(capsys):
    from repro_torch.launch import profile_serve
    profile_serve.main(["--preset", "tiny", "--device", "cpu", "--batch", "2",
                        "--prompt-len", "8", "--max-len", "32", "--steps", "2"])
    assert "[profile] qwen2-0.5b-tiny batch=2" in capsys.readouterr().out


# --------------------------------------------------------------------------
# mamba2: O(1)-state requests, unpadded prefill, gather-mode decode
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mamba2_pair():
    from test_torch_ssm import mamba2_models
    return mamba2_models("float32")


def test_mamba2_engine_matches_reference_under_churn(mamba2_pair):
    """Staggered admissions and finishes through 4 slots; live generations
    outrun the profile.  Each request holds one state-sized page that never
    grows; prompts go in unpadded (one prefill shape per distinct prompt
    length, a length under the conv width among them) and prefill runs the
    SSD wrapper (the reference: its chunked scan)."""
    jm, jp, tm, tp = mamba2_pair
    shapes = [(i + 1, (3, 2, 9, 6)[i % 4], 4, 5 + (3 * i) % 7, i) for i in range(10)]
    jt, tt, jl, tl = _workload(jm.cfg, shapes)
    kw = dict(max_len=32, max_batch=4, page_tokens=None, attn_mode="gather")
    jeng = JServeEngine(jm, jp, sample_trace=jt, **kw)
    teng = ServeEngine(tm, tp, sample_trace=tt, **kw)
    jeng.warmup()
    teng.warmup()
    assert teng.prefill_compiles == jeng.prefill_compiles == 0   # no ladder
    js, ts = jeng.run(jl), teng.run(tl)
    assert ts["n_completed"] == len(shapes) and ts["max_concurrent"] >= 3
    _assert_same(jeng, js, teng, ts)
    assert teng.prefill_compiles == jeng.prefill_compiles == 4
    assert teng.kv.stats()["used_pages"] == 0
    assert teng.runner.n_compiles == len(bucket_ladder(4))


def test_paged_mode_refuses_a_recurrent_model(mamba2_pair):
    jm, jp, tm, tp = mamba2_pair
    jt, tt, _, _ = _workload(jm.cfg, [(1, 4, 4, 4, 0)])
    for eng, m, p, trace in ((JServeEngine, jm, jp, jt), (ServeEngine, tm, tp, tt)):
        with pytest.raises(ValueError, match="pure-attention"):
            eng(m, p, sample_trace=trace, max_len=16, max_batch=2, attn_mode="paged")


def test_mamba2_cli_on_cpu(capsys):
    """Both launch drivers at mamba2-130m's tiny preset on an explicit CPU
    (gather mode: the default of serve, the only mode profile_serve picks)."""
    from repro_torch.launch import profile_serve, serve
    serve.main(["--device", "cpu", "--arch", "mamba2-130m", "--requests", "3",
                "--max-batch", "2", "--max-len", "32"])
    out = capsys.readouterr().out
    assert "[paged pool] page_tokens=" in out and "completed 3/3 requests" in out
    profile_serve.main(["--arch", "mamba2-130m", "--preset", "tiny", "--device", "cpu",
                        "--batch", "2", "--prompt-len", "8", "--max-len", "32",
                        "--steps", "2"])
    assert "[profile] mamba2-130m-tiny batch=2 prompt=8 attn=gather" in capsys.readouterr().out


# --------------------------------------------------------------------------
# recurrentgemma: rec states and rolling local windows, unpadded prefill,
# gather-mode decode
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def hybrid_pair():
    from test_torch_hybrid import hybrid_models
    return hybrid_models("float32")


def test_recurrentgemma_engine_matches_reference_under_churn(hybrid_pair):
    """Staggered admissions and finishes through 4 slots, live generations
    outrunning the profile.  Prompts of 2 to 20 tokens against a window of
    8: shorter ones merge a prefill window of their own length into the
    slot's rolling buffer, longer ones a full window in rolling order, and
    decode runs past the window.  Prefill runs the RG-LRU and flash
    wrappers (the reference: its plain scan and its Pallas flash)."""
    jm, jp, tm, tp = hybrid_pair
    lens = (3, 13, 5, 20, 9, 2)
    shapes = [(i + 1, lens[i % 6], 4, 5 + (3 * i) % 9, i) for i in range(10)]
    jt, tt, jl, tl = _workload(jm.cfg, shapes)
    kw = dict(max_len=40, max_batch=4, page_tokens=None, attn_mode="gather")
    jeng = JServeEngine(jm, jp, sample_trace=jt, **kw)
    teng = ServeEngine(tm, tp, sample_trace=tt, **kw)
    jeng.warmup()
    teng.warmup()
    assert teng.prefill_compiles == jeng.prefill_compiles == 0   # no ladder
    assert not ServeEngine.pads_prefill(tm.cfg)
    js, ts = jeng.run(jl), teng.run(tl)
    assert ts["n_completed"] == len(shapes) and ts["max_concurrent"] >= 3
    _assert_same(jeng, js, teng, ts)
    assert teng.prefill_compiles == jeng.prefill_compiles == len(set(lens))
    assert teng.kv.stats()["used_pages"] == 0
    assert teng.cache["k"].shape[2] == jm.cfg.local_window


def test_recurrentgemma_cli_on_cpu(capsys):
    """Both launch entry points at recurrentgemma-9b's tiny preset (window 64) on
    an explicit CPU, with prompts past the window."""
    from repro_torch.launch import profile_serve, serve
    serve.main(["--device", "cpu", "--arch", "recurrentgemma-9b", "--requests", "3",
                "--max-batch", "2", "--prompt-len", "70", "--gen-len", "4",
                "--max-len", "96"])
    out = capsys.readouterr().out
    assert "[paged pool] page_tokens=" in out and "completed 3/3 requests" in out
    profile_serve.main(["--arch", "recurrentgemma-9b", "--preset", "tiny", "--device",
                        "cpu", "--batch", "2", "--prompt-len", "8", "--max-len", "32",
                        "--steps", "2"])
    assert ("[profile] recurrentgemma-9b-tiny batch=2 prompt=8 attn=gather"
            in capsys.readouterr().out)


# --------------------------------------------------------------------------
# phi4-mini-3.8b's attention shape: head_dim 128, G = 3
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def phi4_pair():
    return models("float32", arch="phi4-mini-3.8b")


def test_phi4_engine_matches_reference_paged_and_gather(phi4_pair):
    """The engine at phi4-mini-3.8b's head layout against the reference's in
    paged mode (reference: Pallas paged decode and flash prefill at head_dim
    128 in interpret mode; port: the wrappers' plain versions), staggered
    admissions over the prefill ladder; then the port's gather mode decodes
    the same greedy token streams."""
    _, _, tm, tp = phi4_pair
    shapes = [(1, 5, 6, 6, 0), (2, 11, 6, 7, 1), (3, 17, 6, 5, 2), (4, 9, 6, 8, 4),
              (5, 14, 6, 6, 5)]
    jeng, js, teng, ts = _run_both(phi4_pair, shapes, max_len=48, max_batch=4,
                                   page_tokens=8)
    assert ts["n_completed"] == len(shapes) and ts["max_concurrent"] >= 2
    _assert_same(jeng, js, teng, ts)
    _, tt, _, tl = _workload(tm.cfg, shapes)
    gather = ServeEngine(tm, tp, sample_trace=tt, max_len=48, max_batch=4,
                         page_tokens=8, attn_mode="gather")
    gather.run(tl)
    assert gather.completed == teng.completed


# --------------------------------------------------------------------------
# the slab decode (use_runner=False) on the recurrent patterns
# --------------------------------------------------------------------------


@pytest.mark.parametrize("models_pair", ["mamba2_pair", "hybrid_pair"])
def test_slab_decode_of_recurrent_models_matches_reference(models_pair, request):
    """``use_runner=False`` advances every slot's state each step, idle
    slots included; a slot's state is replaced whole at its next admission,
    so the streams, summaries and page counts equal the reference's."""
    jm, jp, tm, tp = request.getfixturevalue(models_pair)
    lens = (3, 13, 5, 9)
    shapes = [(i + 1, lens[i % 4], 4, 5 + (3 * i) % 7, i) for i in range(8)]
    jt, tt, jl, tl = _workload(jm.cfg, shapes)
    kw = dict(max_len=40, max_batch=4, page_tokens=None, attn_mode="gather",
              use_runner=False)
    jeng = JServeEngine(jm, jp, sample_trace=jt, **kw)
    teng = ServeEngine(tm, tp, sample_trace=tt, **kw)
    js, ts = jeng.run(jl), teng.run(tl)
    assert ts["n_completed"] == len(shapes) and ts["max_concurrent"] >= 3
    _assert_same(jeng, js, teng, ts)
    assert teng.decode_compiles == jeng.decode_compiles == 1
