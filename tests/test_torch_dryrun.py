"""The port's dry run (``launch/{dryrun,aten_analysis,mesh}``) against the
reference's: at smoke size (B=2, S=64), the reference's step lowered on a
one-device CPU mesh and read through ``hlo_analysis.analyze`` and
``memory_analysis``, the port's traced on fake tensors and read through
``aten_analysis``.

Dot FLOPs are equal for prefill, decode and training without and under
full remat, for qwen2-0.5b, granite-moe-1b-a400m, recurrentgemma-9b and
whisper-small.  mamba2-130m's differ where the two plain SSD paths compute
other products, held exactly where the cause is matched:

  * the port computes ``C·Bᵀ`` once per group (G) and broadcasts it to the
    heads; the reference repeats B and C to the H heads first, so each
    chunk's ``C·Bᵀ`` costs it ``2·B·q²·N·(H - G)`` more, once in a forward
    (prefill), three times in training without remat (the forward and the
    two products of its backward) and four times under full remat (the
    recomputed forward besides);
  * without remat the reference's backward, the VJP of its ``lax.scan``
    over the chunks, also computes a ``2·B·q·H·P·N`` product per layer
    that the port's autograd skips: one a layer at one chunk (held here),
    three a layer at four chunks of 16 (read with ``ssd_chunk=16`` on both
    sides: 79,429,632 against 75,890,688 of which 2,752,512 is the C·Bᵀ
    term).

The train steps' argument bytes (state and batch) equal the reference's
``argument_size_in_bytes`` exactly for every arch."""
import contextlib
import functools
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.configs import get_config as jget
from repro.launch import hlo_analysis
from repro.models import RunOpts as JRunOpts
from repro.models import Transformer as JTransformer
from repro.optim.adamw import AdamWConfig as JAdamW
from repro.runtime import serve_lib as jserve
from repro.runtime import train_lib as jtrain
from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.liveness import trace
from repro_torch.launch import aten_analysis, dryrun, mesh, roofline

B, S = 2, 64
EXACT = ("qwen2-0.5b", "granite-moe-1b-a400m", "recurrentgemma-9b", "whisper-small")
STEPS = [("prefill", False), ("decode", False), ("train", True), ("train", False)]
STEP_IDS = ["prefill", "decode", "train-none", "train-full"]


@functools.lru_cache(maxsize=None)
def _ref(arch: str, kind: str, no_remat: bool) -> dict:
    """The reference's ``lower_cell`` + ``analyze_cell`` at smoke size on a
    one-device mesh."""
    cfg = jget(arch).smoke()
    model = JTransformer(cfg, JRunOpts())
    one = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    specs = {"tokens": jax.ShapeDtypeStruct((B, S + 1 if kind == "train" else S), jnp.int32)}
    if cfg.is_encoder_decoder:
        specs["frames"] = jax.ShapeDtypeStruct((B, cfg.encoder_seq, cfg.d_model),
                                               jnp.dtype(cfg.dtype))
    if kind == "train":
        acfg, topts = JAdamW(), jtrain.TrainOpts(remat=not no_remat)
        step, _ = jtrain.build_train_step(model, one, acfg, topts, batch_sds=specs)
        lowered = step.lower(jtrain.abstract_state(model, acfg, topts), specs)
    elif kind == "prefill":
        step = jserve.build_prefill_step(model, one, batch_sds=specs, max_len=S)
        lowered = step.lower(model.abstract(), specs)
    else:
        step = jserve.build_decode_step(model, one, batch=B, max_len=S)
        lowered = step.lower(model.abstract(), model.cache_spec(B, S),
                             jax.ShapeDtypeStruct((B,), jnp.int32))
    compiled = lowered.compile()
    s = hlo_analysis.analyze(compiled.as_text())
    return {"dot_flops": s.dot_flops, "hbm_bytes": s.hbm_bytes,
            "argument_bytes": compiled.memory_analysis().argument_size_in_bytes}


def _args(*extra):
    return dryrun.build_parser().parse_args(["--device", "cpu", *extra])


@functools.lru_cache(maxsize=None)
def _port(arch: str, kind: str, no_remat: bool) -> dict:
    args = _args(*(["--no-remat"] if no_remat else []))
    gm, meta = dryrun.trace_step(get_config(arch).smoke(), ShapeConfig("smoke", S, B, kind),
                                 args)
    meta.update(arch=arch, shape="smoke", mesh_tag="single")
    return dryrun.analyze_cell(gm, meta, args)


@pytest.mark.parametrize("kind,no_remat", STEPS, ids=STEP_IDS)
@pytest.mark.parametrize("arch", EXACT)
def test_dot_flops_equal_the_reference(arch, kind, no_remat):
    assert _port(arch, kind, no_remat)["aten"]["dot_flops"] == _ref(arch, kind, no_remat)[
        "dot_flops"]


def _cb_term(cfg) -> float:
    """The reference's extra C·Bᵀ FLOPs over the port's in one forward."""
    q = min(256, S)                           # RunOpts.ssd_chunk, both packages
    return cfg.n_layers * (S // q) * 2.0 * B * q * q * cfg.ssm_state * (
        cfg.ssm_heads - cfg.ssm_groups)


@pytest.mark.parametrize("kind,no_remat", STEPS, ids=STEP_IDS)
def test_mamba2_dot_flops_differ_by_the_named_products(kind, no_remat):
    cfg = get_config("mamba2-130m").smoke()
    got = _port("mamba2-130m", kind, no_remat)["aten"]["dot_flops"]
    want = _ref("mamba2-130m", kind, no_remat)["dot_flops"]
    times = {("prefill", False): 1, ("decode", False): 0, ("train", False): 4,
             ("train", True): 3}[(kind, no_remat)]
    residual = want - got - times * _cb_term(cfg)
    q = min(256, S)
    scan_vjp = cfg.n_layers * 2.0 * B * q * cfg.ssm_heads * cfg.ssm_head_dim * cfg.ssm_state
    assert residual == (scan_vjp if (kind, no_remat) == ("train", True) else 0.0)
    assert (cfg.ssm_heads, cfg.ssm_groups) == (8, 1) and _cb_term(cfg) > 0


@pytest.mark.parametrize("no_remat", [True, False], ids=["none", "full"])
@pytest.mark.parametrize("arch", [*EXACT, "mamba2-130m"])
def test_train_state_bytes_equal_the_reference_arguments(arch, no_remat):
    got = _port(arch, "train", no_remat)
    assert got["memory_analysis"]["argument_bytes"] == _ref(arch, "train", no_remat)[
        "argument_bytes"]
    # the in-place update returns the whole state but count and step as aliases
    assert got["memory_analysis"]["alias_bytes"] == got["memory_analysis"][
        "argument_bytes"] - B * (S + 1) * 4 - 8 - (
            B * get_config(arch).smoke().encoder_seq * 64 * 4
            if get_config(arch).is_encoder_decoder else 0)


@pytest.mark.parametrize("kind,no_remat", STEPS, ids=STEP_IDS)
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mamba2-130m", "whisper-small"])
def test_hbm_bytes_cover_the_inputs_and_outputs(arch, kind, no_remat):
    m = _port(arch, kind, no_remat)
    ma = m["memory_analysis"]
    assert m["aten"]["hbm_bytes"] >= ma["argument_bytes"] + ma["output_bytes"] > 0
    assert m["aten"]["coll_bytes"] == 0 and m["aten"]["n_while"] == 0 and not m["aten"]["trips"]
    assert ma["temp_bytes"] > 0 and m["fits"]["fits"]
    assert m["fits"]["retained_plus_dsa"] == (ma["argument_bytes"] + ma["constant_bytes"]
                                              + ma["temp_bytes"])


def test_views_count_no_bytes_and_products_count_their_flops():
    x = torch.zeros((4, 6))
    w = torch.zeros((6, 8))
    views = trace(lambda a: a.reshape(-1).view(2, 12)[0].unsqueeze(0).expand(3, 12).t(), x)
    assert aten_analysis.analyze(views).hbm_bytes == 0
    # a reshape that must copy is a launch of its own: read once, written once
    assert aten_analysis.analyze(trace(lambda a: a.t().reshape(-1), x)).hbm_bytes == 2 * 96
    # an in-place op is a launch too: it reads its destination and writes it
    inplace = trace(lambda a: a.add_(1.0).mul_(2.0), x)
    assert aten_analysis.analyze(inplace).hbm_bytes == 2 * (2 * 96)
    assert _io(inplace) == {"argument_bytes": 96, "constant_bytes": 0, "output_bytes": 0,
                            "alias_bytes": 96}
    # copy_ reads its source and writes its destination without reading it
    assert aten_analysis.analyze(trace(lambda a, b: a.copy_(b), x, x.clone())).hbm_bytes == 2 * 96
    # a scatter (a cache row) reads its indices and values and writes as many
    # elements of the destination, not the whole buffer
    row = trace(lambda a, i, v: a.index_put_((i,), v), x, torch.zeros(1, dtype=torch.long),
                torch.zeros((1, 6)))
    assert aten_analysis.analyze(row).hbm_bytes == 8 + 24 + 24
    s = aten_analysis.analyze(trace(lambda a: a * 2.0, x))
    assert (s.hbm_bytes, s.dot_flops) == (2 * 96, 0)
    s = aten_analysis.analyze(trace(lambda a, b: a @ b, x, w))
    assert s.dot_flops == 2 * 4 * 6 * 8 and s.hbm_bytes == 96 + 192 + 128
    bias = torch.zeros(8)
    s = aten_analysis.analyze(trace(lambda a, b, c: torch.nn.functional.linear(a, b.t(), c),
                                    x, w, bias))
    assert s.dot_flops == 2 * 4 * 6 * 8
    bmm = trace(lambda a, b: torch.einsum("bij,bjk->bik", a, b),
                torch.zeros((3, 4, 5)), torch.zeros((3, 5, 7)))
    assert aten_analysis.analyze(bmm).dot_flops == 2 * 3 * 4 * 7 * 5
    assert _io(trace(lambda a, b: (a @ b, a), x, w)) == {
        "argument_bytes": 96 + 192, "constant_bytes": 0, "output_bytes": 128,
        "alias_bytes": 96}


def _io(gm) -> dict:
    """``analyze_cell``'s input and output bytes of a traced graph."""
    ma = dryrun.analyze_cell(gm, {})["memory_analysis"]
    return {k: ma[k] for k in ("argument_bytes", "constant_bytes", "output_bytes",
                               "alias_bytes")}


def test_the_decode_step_updates_its_cache_in_place():
    m = _port("qwen2-0.5b", "decode", False)
    cfg = get_config("qwen2-0.5b").smoke()
    kv = 2 * cfg.n_layers * B * S * cfg.n_kv_heads * cfg.resolved_head_dim * 4
    assert m["memory_analysis"]["alias_bytes"] == kv + B * 4          # k, v and pos
    assert m["memory_analysis"]["output_bytes"] == B * cfg.padded_vocab * 4


def test_one_card_mesh():
    one = mesh.make_production_mesh()
    assert mesh.describe(one) == {"axes": {"data": 1, "model": 1}, "n_devices": 1}


def test_kernel_paths_are_refused():
    with pytest.raises(ValueError, match="plain paths"):
        dryrun.run_opts_for(SHAPES["train_4k"], _args("--attn-impl", "kernel"))


def _main(*argv) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        dryrun.main(list(argv))
    return out.getvalue()


def test_list_names_every_cell():
    lines = _main("--list").splitlines()
    assert len(lines) == len(ARCHS) * len(SHAPES)
    run = [l.split()[:2] for l in lines if l.endswith("RUN")]
    assert len(run) == sum(get_config(a).supports_shape(SHAPES[s])
                           for a in ARCHS for s in SHAPES)
    assert ["qwen2-0.5b", "long_500k"] not in run and ["mamba2-130m", "long_500k"] in run


def test_cli_cell_at_full_size_feeds_the_roofline(tmp_path):
    """qwen2-0.5b's registered decode_32k cell (B=128 over 32768 tokens of
    cache) on fake CPU tensors: its record loads as a roofline cell."""
    text = _main("--arch", "qwen2-0.5b", "--shape", "decode_32k", "--device", "cpu",
                 "--out", str(tmp_path), "--save-graph")
    assert "[ok]   qwen2-0.5b__decode_32k__single" in text and "fail=0" in text
    meta = json.loads((tmp_path / "qwen2-0.5b__decode_32k__single.json").read_text())
    assert meta["status"] == "ok" and meta["mesh"] == {"data": 1, "model": 1}
    assert (tmp_path / "graph" / "qwen2-0.5b__decode_32k__single.py").exists()
    cfg = get_config("qwen2-0.5b")
    ma = meta["memory_analysis"]
    kv = 2 * cfg.n_layers * 128 * 32768 * cfg.n_kv_heads * cfg.resolved_head_dim * 2
    assert ma["alias_bytes"] == kv + 128 * 4
    (cell,) = roofline.load_cells(str(tmp_path))
    assert (cell.arch, cell.shape, cell.chips, cell.dtype) == (
        "qwen2-0.5b", "decode_32k", 1, "bfloat16")
    assert cell.dominant == "memory" and cell.memory_s * roofline.HBM_BW >= ma[
        "argument_bytes"]
    assert cell.model_flops == roofline.model_flops(cfg, SHAPES["decode_32k"])["model_flops"]
    md = _main("--report", "md", "--out", str(tmp_path)).splitlines()
    assert md[0].split("|")[-3:-1] == [" retained+dsa_GB ", " fits "]
    assert md[2].startswith("| qwen2-0.5b | decode_32k | single") and "| True |" in md[2]
    csv = _main("--report", "csv", "--out", str(tmp_path)).splitlines()
    assert float(csv[1].split(",")[-2]) == pytest.approx(
        meta["fits"]["retained_plus_dsa"] / 1e9, rel=1e-3)


def test_a_failed_cell_writes_its_traceback_and_exits_1(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is valid here")
    with pytest.raises(SystemExit) as e:
        _main("--arch", "qwen2-0.5b", "--shape", "decode_32k", "--out", str(tmp_path))
    assert e.value.code == 1
    meta = json.loads((tmp_path / "qwen2-0.5b__decode_32k__single.json").read_text())
    assert meta["status"] == "fail" and "device='cpu'" in meta["error"]
    assert "Traceback" in meta["traceback"]
