"""The port's seeded load generator (``repro_torch.serving.loadgen``, a copy
of the reference's) against ``repro.serving.loadgen``: byte-identical
traces, the same prompts, generation lengths, priorities and arrivals, the
same refusals; and the load cells (``repro_torch.launch.load``) served
on the CPU and, marked ``cuda``, on the card."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.serving import LoadGen as JLoadGen
from repro.serving import LoadSpec as JLoadSpec
from repro.serving import TrafficClass as JTrafficClass
from repro.serving import make_loadgen as jmake_loadgen
from repro_torch.launch import load
from repro_torch.serving import LoadGen, LoadSpec, TrafficClass, make_loadgen

ARRIVALS = ("poisson", "diurnal", "burst")


def _classes(cls, on: bool):
    return (cls("interactive", priority=1, weight=0.4),
            cls("batch", priority=0, weight=0.6)) if on else ()


def _specs(arrival, classes, seed, **kw):
    kw = dict(n_requests=24, arrival=arrival, mean_interarrival=1.5, seed=seed,
              prompt_mean=40, prompt_max=200, **kw)
    return (JLoadSpec(classes=_classes(JTrafficClass, classes), **kw),
            LoadSpec(classes=_classes(TrafficClass, classes), **kw))


def _rows(reqs):
    return [(r.rid, r.gen_len, r.priority, r.arrival) for r in reqs]


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("classes", [False, True], ids=["untagged", "two-classes"])
@pytest.mark.parametrize("arrival", ARRIVALS)
def test_traces_and_requests_match_the_reference(arrival, classes, seed):
    jspec, tspec = _specs(arrival, classes, seed)
    jlt, tlt = JLoadGen(jspec).trace(), LoadGen(tspec).trace()
    assert tlt.to_bytes() == jlt.to_bytes()
    assert tlt.span_steps == jlt.span_steps and tlt.class_of == jlt.class_of
    for jitter in (0, 4):
        jr = JLoadGen(jspec).gen_requests(512, gen_jitter=jitter, trace=jlt)
        tr = LoadGen(tspec).gen_requests(512, gen_jitter=jitter, trace=tlt)
        assert _rows(tr) == _rows(jr)
        for a, b in zip(jr, tr):
            assert b.prompt.dtype == np.int32 and np.array_equal(a.prompt, b.prompt)
    # without ``trace=`` the generator realizes its own, the same one
    assert _rows(LoadGen(tspec).gen_requests(512)) == _rows(JLoadGen(jspec).gen_requests(512))


def test_the_vocabulary_moves_the_live_lengths_in_both():
    """Prompt tokens and generation jitter share one random stream, so the
    vocabulary size decides the jittered lengths: the load CLI's tiny
    preset keeps the registered vocabulary for that reason."""
    jspec, tspec = _specs("burst", True, 0)
    for vocab in (512, 151_936):
        assert (_rows(LoadGen(tspec).gen_requests(vocab, gen_jitter=4))
                == _rows(JLoadGen(jspec).gen_requests(vocab, gen_jitter=4)))
    assert (_rows(LoadGen(tspec).gen_requests(512, gen_jitter=4))
            != _rows(LoadGen(tspec).gen_requests(151_936, gen_jitter=4)))


@pytest.mark.parametrize("bad", [dict(arrival="uniform"), dict(n_requests=0)])
def test_the_same_refusals(bad):
    with pytest.raises(ValueError) as jerr:
        JLoadSpec(**bad)
    with pytest.raises(ValueError) as terr:
        LoadSpec(**bad)
    assert str(terr.value) == str(jerr.value)


def test_make_loadgen_matches_the_reference():
    kw = dict(seed=5, mean_interarrival=3.0, prompt_mean=20, gen_max=40)
    j = jmake_loadgen("diurnal", 40, classes=_classes(JTrafficClass, True), **kw)
    t = make_loadgen("diurnal", 40, classes=_classes(TrafficClass, True), **kw)
    assert dataclasses.asdict(t.spec) == dataclasses.asdict(j.spec)
    assert t.trace().to_bytes() == j.trace().to_bytes()


@pytest.mark.parametrize("cell", sorted(load.CELLS))
def test_the_load_cells_match_the_reference_generator(cell):
    """The load cells realize the same traces in both packages."""
    spec = load.CELLS[cell]["spec"]
    jspec = JLoadSpec(**{**dataclasses.asdict(spec),
                         "classes": _classes(JTrafficClass, bool(spec.classes))})
    assert dataclasses.asdict(jspec) == dataclasses.asdict(spec)
    assert LoadGen(spec).trace().to_bytes() == JLoadGen(jspec).trace().to_bytes()


@pytest.mark.parametrize("cell", sorted(load.CELLS))
def test_load_cell_on_the_cpu(cell, tmp_path, capsys):
    """One load cell at tiny width, 6 requests, through ``run_cell``: every
    request completes, spans are conserved, each request's first-token stamp
    falls inside its first decode phase's prefill, the SLO report covers the
    cell's classes, and the trace it writes passes the schema gate."""
    from repro_torch.models import Transformer
    from repro_torch.obs import load_chrome_trace, plan_rectangles, validate_chrome_trace
    cfg = load.cell_config(cell, "tiny")
    model = Transformer(cfg, load.CELLS[cell]["opts"], device="cpu")
    params = model.init_loaded(torch.Generator().manual_seed(0))
    lt, sample, live = load.traffic(cell, cfg.vocab_size, n_requests=6)
    eng = load.make_engine(model, params, cell, sample)
    eng.warmup()
    path = tmp_path / "load.json"
    run = load.run_cell(eng, cell, lt, live, trace_path=str(path))
    assert run.summary["n_completed"] == 6
    spans = run.tracker.finished()
    assert len(spans) == 6 and not run.tracker.conservation_violations()
    for s in spans:
        prefill = next(p for p in s.phases if p.kind == "decode").start_ts
        assert prefill <= run.first_token_us[s.rid] <= s.finish_ts
    assert sorted(run.slo["classes"]) == sorted(load.CELLS[cell]["slo"])
    assert run.slo["n_requests"] == 6
    load.report(run, cell)
    out = capsys.readouterr().out
    assert "completed=6 " in out and "conservation_violations=[]" in out
    assert f"[load:{cell}] TTFT steps" in out and "drift planned_peak=" in out
    trace = load_chrome_trace(str(path))
    validate_chrome_trace(trace)
    assert trace == run.trace and plan_rectangles(trace, "kv-pool")


@pytest.mark.parametrize("cell,steps,preemptions", [
    ("qwen2-burst-tight", 111, 2), ("mamba2-diurnal-tight", 136, 0)])
def test_load_cli_on_the_cpu(cell, steps, preemptions, tmp_path, capsys):
    """The load CLI serves the whole cell (32 requests) at tiny width: the
    step clock the card's ``[load:*]`` phases reproduce at full width, and a
    trace that passes the schema gate."""
    from repro_torch.obs import load_chrome_trace, validate_chrome_trace
    path = tmp_path / "load.json"
    load.main(["--cell", cell, "--preset", "tiny", "--device", "cpu",
               "--trace", str(path)])
    out = capsys.readouterr().out
    assert f"steps={steps}," in out and "completed=32 " in out
    assert f"preemptions={preemptions} " in out and "conservation_violations=[]" in out
    assert "[trace] " in out
    validate_chrome_trace(load_chrome_trace(str(path)))


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: run on the card with "
                    "`python -m pytest -m cuda tests`")


@pytest.mark.cuda
def test_traced_load_cell_on_the_card(card, tmp_path):
    """qwen2's burst cell (8 requests) on a small qwen2 that the kernels take
    (head_dim 64, 14 heads over 2), traced with graphs and eagerly: the same
    step-clock spans and token streams, conserved spans, a trace that
    validates, and both attention kernels launched."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import Transformer
    from repro_torch.obs import validate_chrome_trace
    cell = "qwen2-burst-tight"
    cfg = get_config("qwen2-0.5b").with_overrides(
        n_layers=2, d_model=128, n_heads=14, n_kv_heads=2, head_dim=64, d_ff=256,
        dtype="float32")
    model = Transformer(cfg, load.CELLS[cell]["opts"], device="cuda")
    params = model.init_loaded(torch.Generator(device="cuda").manual_seed(0))
    lt, sample, live = load.traffic(cell, cfg.vocab_size, n_requests=8)
    out = {}
    for graphs in (False, True):
        eng = load.make_engine(model, params, cell, sample, graphs=graphs)
        eng.warmup()
        ops.reset_launches()
        run = load.run_cell(eng, cell, lt, live, trace_path=str(tmp_path / "t.json"))
        assert run.summary["n_completed"] == 8
        assert not run.tracker.conservation_violations()
        validate_chrome_trace(run.trace)
        launches = {fn.__name__: fn.launches for fn in ops.WRAPPERS}
        assert launches["paged_attention"] > 0 and launches["flash_attention"] > 0
        out[graphs] = (eng.completed, load.step_spans(run.tracker), launches)
    assert out[True] == out[False]
