"""CUDA graphs under a ``DeviceMesh`` and for the encoder-decoder's
prefill with frames, on the card: every test needs an NVIDIA GPU and nvcc
(marker ``cuda``) and skips without them; the file imports no JAX.  The CPU
side (binding, capture safety, the frames body against the reference) is
``test_torch_mesh_graphs.py``.

Graph replays and eager calls run the same kernels in the same order, so
logits, caches and token streams are expected bit for bit.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.launch.mesh import end_process_group, one_card_mesh
from repro_torch.models import RunOpts, Transformer
from repro_torch.runtime import serve_lib
from repro_torch.runtime.serve_lib import Request
from repro_torch.serving import GenRequest, ServeEngine, bucket_ladder

WHISPER = "whisper-small"


def _whisper_batch(cfg, b: int, s: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
            "frames": rng.standard_normal((b, cfg.encoder_seq, cfg.d_model)).astype(
                np.float32)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: run on the card with "
                    "`python -m pytest -m cuda tests`")


def _card_qwen2():
    """qwen2 at head dim 64 (a width the paged kernel takes), f32, the
    kernels on."""
    cfg = get_config("qwen2-0.5b").with_overrides(
        n_layers=2, d_model=128, n_heads=14, n_kv_heads=2, head_dim=64,
        d_ff=256, vocab_size=512, dtype="float32")
    model = Transformer(cfg, RunOpts(attention_impl="kernel"), device="cuda")
    return model, model.init_loaded(torch.Generator(device="cuda").manual_seed(0))


def _card_trace(cfg, n: int = 10):
    rng = np.random.default_rng(4)
    trace = [Request(rid=i + 1, prompt_len=int(rng.integers(5, 30)), gen_len=6,
                     arrival=i) for i in range(n)]
    live = [GenRequest(rid=r.rid, prompt=torch.from_numpy(rng.integers(
        0, cfg.vocab_size, r.prompt_len).astype(np.int32)), gen_len=r.gen_len + r.rid % 5,
        arrival=r.arrival) for r in trace]
    return trace, live


@pytest.mark.cuda
def test_mesh_engine_graphs_equal_eager_and_unsharded_on_the_card(card):
    """``ServeEngine`` on the one-card NCCL mesh with graphs: one capture
    per bucket and per rung at ``warmup()``, none in the run, every
    prefill a replay; token streams and launches equal to the eager mesh
    run and to the unsharded graphed run."""
    model, params = _card_qwen2()
    runs = {}
    mesh = one_card_mesh()
    try:
        for name, m, graphs in (("mesh:eager", mesh, False), ("mesh:graphs", mesh, None),
                                ("graphs", None, None)):
            trace, live = _card_trace(model.cfg)
            eng = ServeEngine(model, params, sample_trace=trace, max_len=64, max_batch=4,
                              page_tokens=8, attn_mode="paged", mesh=m, graphs=graphs)
            eng.warmup()
            warm = (eng.runner.n_compiles, eng.prefill.stats()["n_captures"])
            ops.reset_launches()
            eng.run(live)
            torch.cuda.synchronize()
            pstats = eng.prefill.stats()
            runs[name] = dict(streams=dict(eng.completed), warm=warm,
                              after=(eng.runner.n_compiles, pstats["n_captures"]),
                              replays=pstats["n_replays"], prefills=eng.prefill_calls,
                              launches={fn.__name__: fn.launches for fn in ops.WRAPPERS},
                              graphs=eng.graphs)
            del eng
    finally:
        end_process_group()
    g = runs["mesh:graphs"]
    n_rungs = 4                                        # 8, 16, 32, 64
    assert g["graphs"] and g["warm"] == g["after"] == (len(bucket_ladder(4)), n_rungs)
    assert g["replays"] == n_rungs + g["prefills"]     # warmup's calls, then each prefill
    assert runs["mesh:eager"]["streams"] == g["streams"] == runs["graphs"]["streams"]
    assert g["launches"] == runs["mesh:eager"]["launches"] == runs["graphs"]["launches"]
    assert g["launches"]["paged_attention"] > 0 and g["launches"]["flash_attention"] > 0


def _card_whisper(seed: int):
    cfg = get_config(WHISPER).smoke().with_overrides(dtype="float32")
    model = Transformer(cfg, RunOpts(attention_impl="kernel"), device="cuda")
    return model, model.init_loaded(torch.Generator(device="cuda").manual_seed(seed))


def _cuda_batch(cfg, b: int, seed: int) -> dict:
    return {k: torch.from_numpy(v).cuda() for k, v in _whisper_batch(cfg, b, 4, seed).items()}


@pytest.mark.cuda
def test_whisper_graphed_prefill_equals_eager_on_the_card(card):
    """whisper's prefill with frames captured once per signature: logits
    and every cache leaf bit for bit the eager prefill's, the flash kernel
    launched once per encoder and decoder layer a replay (the first call
    also runs the step once eagerly before its capture); other frames of
    the shape replay it, another ``params`` captures again, and a graphed
    decode on the graph's cache reads the next prefill's cache without a
    capture."""
    model, params = _card_whisper(0)
    _, params2 = _card_whisper(1)
    cfg = model.cfg
    graphed = serve_lib.build_prefill_step(model, None, max_len=16)
    eager = serve_lib.build_prefill_step(model, None, max_len=16, graphs=False)
    assert graphed.graphs
    hooks = []
    decode = serve_lib.build_decode_step(model, None, trace_hook=hooks.append)
    per_replay = cfg.n_layers + cfg.encoder_layers
    for i, (p, seed) in enumerate(((params, 1), (params, 2), (params2, 3))):
        batch = _cuda_batch(cfg, 2, seed)
        ops.reset_launches()
        logits, cache = graphed(p, batch)
        torch.cuda.synchronize()
        assert ops.flash_attention.launches == (2, 1, 1)[i] * per_replay
        want_l, want_c = eager(p, batch)
        assert torch.equal(logits, want_l)
        assert all(torch.equal(cache[k], want_c[k]) for k in want_c)
        assert graphed.stats()["n_captures"] == (1, 1, 2)[i]
        if p is params:
            tok = logits.argmax(-1).int()
            got, _ = decode(p, cache, tok)
            want, _ = serve_lib.build_decode_step(model, None, graphs=False)(
                p, want_c, tok)
            assert torch.equal(got, want) and len(hooks) == 1
    assert graphed.stats()["n_replays"] == 3 and graphed.stats()["graph_pool_bytes"] > 0
