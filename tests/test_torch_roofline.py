"""``repro_torch.launch.roofline`` against ``repro.launch.roofline``: the
analytic counts bit for bit on every registered arch x shape the config
admits and on the card's training cells, the reference's own roofline
tests run on the port, and the cell terms with the H100's constants."""
import ast
import json
from pathlib import Path

import pytest

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget
from repro.configs.base import ShapeConfig as JShape
from repro.launch import roofline as jroof
from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import roofline

CELLS = [(a, s) for a in ARCHS for s in SHAPES if get_config(a).supports_shape(SHAPES[s])]
# chip_smoke.py's [train:*] cells (arch, layers or None, B, S) and a few more
# off the grid
OFF_GRID = [("qwen2-0.5b", 4, 8, 512, "train"), ("granite-moe-1b-a400m", 12, 8, 512, "train"),
            ("whisper-small", None, 8, 448, "train"), ("mamba2-130m", 4, 8, 512, "train"),
            ("recurrentgemma-9b", 5, 1, 2560, "train"), ("qwen2-0.5b", 2, 1, 12288, "train"),
            ("phi4-mini-3.8b", None, 4, 1000, "prefill"), ("starcoder2-15b", None, 3, 777, "decode"),
            ("recurrentgemma-9b", None, 2, 1500, "decode")]
REF_META = {
    "arch": "qwen2-0.5b", "shape": "train_4k", "mesh_tag": "single",
    "mesh": {"data": 16, "model": 16},
    "hlo": {"dot_flops": 1e14, "hbm_bytes": 1e13, "coll_bytes": 1e11},
}


def _port_meta(meta: dict) -> dict:
    """The reference's record as the port's dry run writes it: ``"aten"``
    for ``"hlo"``, no collectives on one card."""
    out = {k: v for k, v in meta.items() if k != "hlo"}
    out["aten"] = dict(meta["hlo"], coll_bytes=0.0)
    return out


def _pair(arch, layers=None):
    j, t = jget(arch), get_config(arch)
    if layers is not None:
        j, t = j.with_overrides(n_layers=layers), t.with_overrides(n_layers=layers)
    return j, t


@pytest.mark.parametrize("arch,shape", CELLS, ids=[f"{a}-{s}" for a, s in CELLS])
def test_model_flops_equal_the_reference_on_every_registered_cell(arch, shape):
    j, t = _pair(arch)
    assert roofline.model_flops(t, SHAPES[shape]) == jroof.model_flops(j, JSHAPES[shape])
    for ctx in (1.0, 2048.5, float(SHAPES[shape].seq_len)):
        assert roofline.fwd_flops_per_token(t, ctx) == jroof.fwd_flops_per_token(j, ctx)
        assert (roofline.fwd_flops_per_token(t, ctx, window_ctx=100.0)
                == jroof.fwd_flops_per_token(j, ctx, window_ctx=100.0))


@pytest.mark.parametrize("arch,layers,b,s,kind", OFF_GRID,
                         ids=[f"{c[0]}-{c[1]}-{c[2]}x{c[3]}-{c[4]}" for c in OFF_GRID])
def test_model_flops_equal_the_reference_off_the_grid(arch, layers, b, s, kind):
    j, t = _pair(arch, layers)
    assert (roofline.model_flops(t, ShapeConfig("cell", s, b, kind))
            == jroof.model_flops(j, JShape("cell", s, b, kind)))
    assert roofline._mamba2_flops(t, 64) == jroof._mamba2_flops(j, 64)


# ---------------------------------------------------------------------------
# the reference's tests/test_roofline.py, on the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_positive_and_ordered(arch):
    cfg = get_config(arch)
    train = roofline.model_flops(cfg, SHAPES["train_4k"])["model_flops"]
    prefill = roofline.model_flops(cfg, SHAPES["prefill_32k"])["model_flops"]
    decode = roofline.model_flops(cfg, SHAPES["decode_32k"])["model_flops"]
    assert train > prefill > decode > 0


def test_dense_train_flops_close_to_6nd():
    cfg = get_config("mistral-nemo-12b")
    shape = SHAPES["train_4k"]
    mf = roofline.model_flops(cfg, shape)["model_flops"]
    six_nd = 6 * 12.2e9 * shape.global_batch * shape.seq_len
    assert 0.7 < mf / six_nd < 1.6


def test_moe_uses_active_params_only():
    cfg = get_config("qwen3-moe-30b-a3b")
    shape = SHAPES["train_4k"]
    mf = roofline.model_flops(cfg, shape)["model_flops"]
    tokens = shape.global_batch * shape.seq_len
    assert mf < 0.5 * 6 * 30e9 * tokens
    assert mf > 0.5 * 6 * 3e9 * tokens


def test_subquadratic_decode_independent_of_context():
    cfg = get_config("mamba2-130m")
    d32 = roofline.model_flops(cfg, SHAPES["decode_32k"])
    d500 = roofline.model_flops(cfg, SHAPES["long_500k"])
    assert (d500["model_flops"] / d500["tokens"]
            == pytest.approx(d32["model_flops"] / d32["tokens"], rel=0.01))


def test_attention_decode_scales_with_context():
    cfg = get_config("mistral-nemo-12b")
    d32 = roofline.model_flops(cfg, SHAPES["decode_32k"])
    attn = 40 * roofline._attn_score_flops(cfg, 32_768)
    assert attn > 0.2 * d32["model_flops"] / d32["tokens"]


# ---------------------------------------------------------------------------
# cell terms on the H100
# ---------------------------------------------------------------------------


def test_cell_terms_are_the_reference_products_over_the_h100():
    """On the reference test's record: the same dot FLOPs and HBM bytes over
    the H100's peak and bandwidth, the same useful ratio; the memory term
    dominates on both machines."""
    ref = jroof.analyze_cell_json(REF_META)
    cell = roofline.analyze_cell_json(_port_meta(REF_META))
    assert cell.chips == ref.chips == 256
    assert cell.dtype == "bfloat16"
    assert cell.compute_s * roofline.PEAK_FLOPS == pytest.approx(
        ref.compute_s * jroof.PEAK_FLOPS, rel=1e-15)
    assert cell.memory_s * roofline.HBM_BW == pytest.approx(
        ref.memory_s * jroof.HBM_BW, rel=1e-15)
    assert cell.useful_ratio == ref.useful_ratio and cell.model_flops == ref.model_flops
    assert cell.coll_s == 0.0
    assert cell.dominant == ref.dominant == "memory"
    assert cell.step_bound_s == cell.memory_s and 0 < cell.fraction < 1


def test_the_peak_follows_the_compute_dtype():
    meta = dict(_port_meta(REF_META), mesh={"data": 1, "model": 1})
    bf16 = roofline.analyze_cell_json(meta)
    f32 = roofline.analyze_cell_json(dict(meta, dtype="float32"))
    assert bf16.compute_s == 1e14 / 989e12 and f32.compute_s == 1e14 / 67e12
    assert f32.ideal_s / bf16.ideal_s == pytest.approx(989 / 67)
    assert roofline.HBM_BW == 3.35e12 and roofline.HBM_BYTES == 85_017_493_504
    with pytest.raises(KeyError):
        roofline.peak_flops("float16")


def test_table_formats_and_load_cells(tmp_path):
    meta = _port_meta(REF_META)
    cells = [roofline.analyze_cell_json(meta)]
    md = roofline.table(cells)
    csv = roofline.table(cells, fmt="csv")
    assert "qwen2-0.5b" in md and "|" in md
    assert csv.splitlines()[0].startswith("arch,shape")
    assert csv.splitlines()[1].split(",")[6] == "memory"
    (tmp_path / "a.json").write_text(json.dumps(dict(meta, status="ok")))
    (tmp_path / "b.json").write_text(json.dumps({"status": "fail", "arch": "qwen2-0.5b"}))
    (tmp_path / "c.json").write_text(json.dumps(dict(meta, status="ok", mesh_tag="multi")))
    loaded = roofline.load_cells(str(tmp_path))
    assert [(c.arch, c.mesh) for c in loaded] == [("qwen2-0.5b", "single")]
    assert len(roofline.load_cells(str(tmp_path), mesh=None)) == 2


def test_roofline_imports_no_torch():
    path = Path(roofline.__file__)
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    assert not roots & {"torch", "jax", "numpy", "repro"}
