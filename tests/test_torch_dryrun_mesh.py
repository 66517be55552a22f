"""The dry run over a mesh (``launch/{mesh,dryrun,aten_analysis,roofline}``
with ``--mesh multi``): steps traced as rank 0 of a fake process group on
fake local shards, against the reference lowered over as many XLA host
devices.

At smoke size (qwen2-0.5b's ``smoke()``, B=4, S=64) over a (pod 2, data 2,
model 2) mesh, the reference in a subprocess
(``tests/torch_dryrun_mesh_reference.py``, 8 host devices) and the port
over a fake (2, 2, 2) mesh:

  * dot FLOPs per device are equal for prefill and decode (both attend
    over the cache as the cache is placed, its rows over ``data`` alone).
    Training (full remat) differs by four weight gradients a layer that
    DTensor forms whole over the model axis where XLA forms each rank's
    half: the q and output projections' (d x H*hd) and two of the MLP's
    (d x d_ff), each ``2 * T * d * n / model`` more FLOPs with T the
    rank's tokens;
  * the per-device argument bytes are equal for every kind, the train
    state's included;
  * collective wire bytes are nonzero on both sides and within a factor 2:
    DTensor issues its own collectives where GSPMD chooses its own (the
    metrics and logits made whole, an all-gather and a chunk for each
    all-to-all of a CPU mesh).

The wire bytes of each functional collective are exact against the
reference's ring formulas on a tiny function; each mesh-only knob reaches
its traced cell; the CLI's ``multi`` and ``both`` records feed the
roofline's collective term.  Every test ends the process group it made."""
import functools
import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.liveness import trace
from repro_torch.launch import aten_analysis, dryrun, mesh, roofline
from repro_torch.launch.mesh import CardMesh, dtensor_tracing, end_process_group, fake_mesh
from repro_torch.runtime import mesh_ctx

B, S = 4, 64
SMALL = (2, 2, 2)
KINDS = ("train", "prefill", "decode")


@pytest.fixture(autouse=True)
def _ends_process_groups():
    yield
    end_process_group()
    assert not torch.distributed.is_initialized()


def _args(*extra):
    return dryrun.build_parser().parse_args(["--device", "cpu", "--mesh", "multi", *extra])


@functools.lru_cache(maxsize=None)
def _port(arch: str, kind: str, *flags: str, batch: int = B) -> dict:
    cfg = get_config(arch).smoke()
    args = _args(*flags)
    gm, meta = dryrun.trace_step(cfg, ShapeConfig("smoke", S, batch, kind), args,
                                 fake_mesh(SMALL, device="cpu"))
    meta.update(arch=arch, shape="smoke", mesh_tag="multi")
    out = dryrun.analyze_cell(gm, meta, args)
    out["n_constants"] = sum(n.op == "get_attr" for n in gm.graph.nodes)
    end_process_group()
    return out


@pytest.fixture(scope="module")
def reference():
    here = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items() if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env["PYTHONPATH"] = os.path.join(here, "..", "src")
    proc = subprocess.run(
        [sys.executable, os.path.join(here, "torch_dryrun_mesh_reference.py"), "--arch",
         "qwen2-0.5b", "--mesh", ",".join(map(str, SMALL)), "--smoke", "--batch", str(B),
         "--seq", str(S), "--kinds", ",".join(KINDS)],
        capture_output=True, text=True, timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [l for l in proc.stdout.splitlines() if l.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


def _named_terms(kind: str) -> float:
    """Port minus reference dot FLOPs per device, term by term (module
    docstring) at qwen2-0.5b's smoke size over (2, 2, 2)."""
    cfg = get_config("qwen2-0.5b").smoke()
    pod, data, model = SMALL
    if kind == "train":
        tokens = B // (pod * data) * S
        half = lambda n: 2.0 * tokens * cfg.d_model * n / model
        return cfg.n_layers * (2 * half(cfg.n_heads * cfg.resolved_head_dim) + 2 * half(cfg.d_ff))
    return 0.0


@pytest.mark.parametrize("kind", KINDS)
def test_dot_flops_per_device_against_the_reference(reference, kind):
    got = _port("qwen2-0.5b", kind)["aten"]["dot_flops"]
    assert got - reference[kind]["dot_flops"] == _named_terms(kind)
    assert _named_terms("prefill") == _named_terms("decode") == 0 < _named_terms("train")


@pytest.mark.parametrize("kind", KINDS)
def test_argument_bytes_per_device_equal_the_reference(reference, kind):
    assert _port("qwen2-0.5b", kind)["memory_analysis"]["argument_bytes"] == reference[kind][
        "argument_bytes"]


@pytest.mark.parametrize("kind", KINDS)
def test_collective_bytes_nonzero_on_both_sides_within_a_factor_2(reference, kind):
    got = _port("qwen2-0.5b", kind)["aten"]
    want = reference[kind]["coll_bytes"]
    assert got["coll_bytes"] > 0 and want > 0
    assert 0.5 <= got["coll_bytes"] / want <= 2.0
    assert sum(got["coll_bytes_by_kind"].values()) == pytest.approx(got["coll_bytes"])
    assert set(got["coll_counts"]) == set(got["coll_bytes_by_kind"])


@pytest.mark.parametrize("arch,batch", [("whisper-small", B), ("recurrentgemma-9b", B),
                                        ("mamba2-130m", 1)])
def test_other_patterns_decode_over_the_mesh(arch, batch):
    """The cross cache's 0-d last-frame position, the rolling window and
    the SSD state decode over the fake mesh too (mamba2 at a batch of 1:
    over a split batch its state's views are strided shards, ~75 s)."""
    got = _port(arch, "decode", batch=batch)
    assert got["aten"]["dot_flops"] > 0 and got["aten"]["coll_bytes"] > 0
    ma = got["memory_analysis"]
    assert got["fits"]["fits"] and ma["constant_bytes"] < 1e-3 * ma["argument_bytes"]


def test_placeholders_are_the_rank_0_shards():
    """The traced train step takes rank 0's local shards: its argument
    bytes are the sum of their bytes, each a fraction of the global leaf,
    and no lifted constant stands in for a state leaf."""
    m = mesh.fake_mesh(SMALL, device="cpu")
    model = dryrun.Transformer(get_config("qwen2-0.5b").smoke(),
                               dryrun.run_opts_for(None, _args(), True), device="cpu")
    mode = dryrun._mode()
    specs = dryrun.input_specs(model.cfg, ShapeConfig("smoke", S, B, "train"), "train")
    fn, shards = dryrun.train_lib.abstract_sharded_step(
        model, m, mode, dryrun.AdamWConfig(), dryrun.train_lib.TrainOpts(), specs)
    with dtensor_tracing():
        gm = trace(fn, *shards)
    placeholders = [n for n in gm.graph.nodes if n.op == "placeholder"]
    assert [tuple(n.meta["val"].shape) for n in placeholders] == [tuple(s.shape) for s in shards]
    local = sum(s.numel() * s.element_size() for s in shards)
    got = _port("qwen2-0.5b", "train")
    assert got["memory_analysis"]["argument_bytes"] == local
    assert got["memory_analysis"]["constant_bytes"] == 0 and got["n_constants"] == 0
    tokens = shards[-1]
    assert tuple(tokens.shape) == (B // 4, S + 1)                # batch over pod x data
    state = dryrun.train_lib.abstract_state(model, mode, dryrun.AdamWConfig())
    whole = sum(t.numel() * t.element_size()
                for t in torch.utils._pytree.tree_leaves(state))
    assert local - tokens.numel() * 4 < whole / 2


def _traced(fn, *shapes):
    m = fake_mesh(SMALL, device="cpu")
    from torch._subclasses.fake_tensor import FakeTensorMode
    mode = FakeTensorMode()
    with mode:
        xs = [torch.empty(s) for s in shapes]
    with dtensor_tracing():
        return trace(lambda *a: fn(m, *a), *xs)


def _funcol(m, x, op: str):
    import torch.distributed._functional_collectives as funcol
    group = (m, 2)                                       # the model axis, g = 2
    if op == "all-gather":
        return funcol.all_gather_tensor(x, 0, group)
    if op == "all-reduce":
        return funcol.all_reduce(x, "sum", group)
    if op == "reduce-scatter":
        return funcol.reduce_scatter_tensor(x, "sum", 0, group)
    if op == "all-to-all":
        return funcol.all_to_all_single(x, None, None, group)
    return funcol.broadcast(x, 0, group)


@pytest.mark.parametrize("op,wire", [
    ("all-gather", 2 * 96 * (1 / 2)),            # result (2x the operand) x (g-1)/g
    ("all-reduce", 2 * 96 * (1 / 2)),            # 2 x size x (g-1)/g
    ("reduce-scatter", 96 * (1 / 2)),            # operand x (g-1)/g
    ("all-to-all", 96 * (1 / 2)),                # result x (g-1)/g
    ("collective-permute", 96.0),                # a broadcast: its size
])
def test_each_collective_kind_moves_the_ring_bytes(op, wire):
    gm = _traced(lambda m, x: _funcol(m, x, op) * 1.0, (4, 6))
    s = aten_analysis.analyze(gm)
    assert s.coll_bytes == wire and s.coll_bytes_by_kind == {op: wire}
    assert s.coll_counts == {op: 1}
    waits = [n for n in gm.graph.nodes if "wait_tensor" in str(n.target)]
    assert len(waits) == 1 and aten_analysis.coll_wire_bytes(waits[0]) is None


def test_a_collective_counts_its_operand_and_result_as_hbm_bytes():
    """The reference counts every top-level op's operands and result, a
    collective's too; ``wait_tensor`` moves nothing and aliases the
    collective's result, so the liveness profile holds one buffer."""
    gm = _traced(lambda m, x: _funcol(m, x, "all-gather"), (4, 6))
    s = aten_analysis.analyze(gm)
    assert s.hbm_bytes == 96 + 2 * 96                   # operand read, result written
    ma = dryrun.analyze_cell(gm, {})["memory_analysis"]
    assert ma["output_bytes"] == 2 * 96 and ma["argument_bytes"] == 96
    # the group size is read off the op, or resolved from its group's name
    node = next(n for n in gm.graph.nodes if "all_gather" in str(n.target))
    assert aten_analysis.group_size(node) == 2
    ar = _traced(lambda m, x: _funcol(m, x, "all-reduce"), (4, 6))
    node = next(n for n in ar.graph.nodes if "all_reduce" in str(n.target))
    assert aten_analysis._arg(node, "group_size") is None and aten_analysis.group_size(node) == 2


def _differs(a: dict, b: dict) -> bool:
    keys = ("dot_flops", "hbm_bytes", "coll_bytes")
    return tuple(a["aten"][k] for k in keys) != tuple(b["aten"][k] for k in keys)


def _smoke_cli(monkeypatch, batch: int = B):
    """The CLI over smoke configs at (batch, S) and the (2, 2, 2) fake mesh."""
    monkeypatch.setattr(dryrun, "get_config", lambda a: get_config(a).smoke())
    monkeypatch.setattr(dryrun, "SHAPES", {
        "prefill_32k": ShapeConfig("prefill_32k", S, batch, "prefill"),
        "decode_32k": ShapeConfig("decode_32k", S, batch, "decode")})
    monkeypatch.setattr(dryrun, "make_production_mesh", lambda *, multi_pod, device:
                        fake_mesh(SMALL, device=device) if multi_pod else CardMesh())


# The knobs that split the sequence or the cache length run at a batch of
# 1 here (as long_500k's): over a split batch, DTensor merges batch and
# sequence into one strided dim and plans each of its redistributions by a
# graph search, ~1.5 min a cell at this size.
@pytest.mark.parametrize("flag,arch,kind,batch", [
    ("--cp-attention", "qwen2-0.5b", "prefill", B),
    ("--moe-grouped", "granite-moe-1b-a400m", "prefill", B),
    ("--sp-residual", "qwen2-0.5b", "prefill", 1),
    ("--ssd-shard-p", "mamba2-130m", "prefill", 1),
    ("--shard-cache-len", "qwen2-0.5b", "decode", 1),
])
def test_each_mesh_only_knob_reaches_its_traced_cell(flag, arch, kind, batch, monkeypatch,
                                                     tmp_path):
    _smoke_cli(monkeypatch, batch)
    shape = {"prefill": "prefill_32k", "decode": "decode_32k"}[kind]
    dryrun.main(["--device", "cpu", "--arch", arch, "--shape", shape, "--mesh", "multi",
                 "--out", str(tmp_path), flag])
    got = json.loads((tmp_path / f"{arch}__{shape}__multi.json").read_text())
    assert got["status"] == "ok" and got["mesh_knobs"] == [flag[2:].replace("-", "_")]
    assert _differs(got, _port(arch, kind, batch=batch))
    assert got["aten"]["coll_bytes"] > 0 and got["fits"]["fits"]
    (cell,) = roofline.load_cells(str(tmp_path), "multi")
    assert cell.chips == 8 and cell.coll_s > 0


def test_a_knob_without_a_mesh_names_the_multi_mesh():
    with pytest.raises(ValueError, match="--mesh multi"):
        dryrun.run_opts_for(None, _args("--sp-residual"), multi_pod=False)
    with pytest.raises(ValueError, match="--mesh multi"):
        dryrun.main(["--device", "cpu", "--arch", "qwen2-0.5b", "--shape", "decode_32k",
                     "--mesh", "both", "--ssd-shard-p"])


@pytest.mark.parametrize("mesh_arg", ["multi", "both"])
def test_multi_records_feed_the_collective_term(mesh_arg, monkeypatch, tmp_path, capsys):
    _smoke_cli(monkeypatch)
    dryrun.main(["--device", "cpu", "--arch", "qwen2-0.5b", "--shape", "decode_32k",
                 "--mesh", mesh_arg, "--out", str(tmp_path)])
    assert "fail=0" in capsys.readouterr().out and not torch.distributed.is_initialized()
    meta = json.loads((tmp_path / "qwen2-0.5b__decode_32k__multi.json").read_text())
    assert meta["mesh"] == dict(zip(mesh.MULTI_POD["axes"], SMALL))
    assert meta["mesh_tag"] == "multi" and meta["aten"]["coll_counts"]
    assert (tmp_path / "qwen2-0.5b__decode_32k__single.json").exists() == (mesh_arg == "both")
    (cell,) = roofline.load_cells(str(tmp_path), "multi")
    assert cell.coll_s == meta["aten"]["coll_bytes"] / roofline.LINK_BW > 0
    assert cell.useful_ratio == cell.model_flops / (8 * meta["aten"]["dot_flops"])
    dryrun.main(["--report", "md", "--mesh", "multi", "--out", str(tmp_path)])
    rows = capsys.readouterr().out.splitlines()[2:]
    assert len(rows) == 1 and rows[0].startswith("| qwen2-0.5b | decode_32k | multi")
    assert float(rows[0].split("|")[6]) > 0                        # coll_s


def test_the_production_mesh_is_the_references():
    m = mesh.make_production_mesh(multi_pod=True, device="cpu")
    assert mesh.describe(m) == {"axes": {"pod": 2, "data": 16, "model": 16}, "n_devices": 512}
    assert torch.distributed.get_world_size() == 512 and torch.distributed.get_rank() == 0
    assert mesh.make_production_mesh(multi_pod=True, device="cpu") is m     # one group
    with pytest.raises(RuntimeError, match="already initialized"):
        mesh.one_card_mesh("cpu")
    with pytest.raises(RuntimeError, match="world size 512"):
        fake_mesh(SMALL, device="cpu")
    end_process_group()
    one = mesh.one_card_mesh("cpu")
    with pytest.raises(RuntimeError, match="already initialized"):
        fake_mesh(SMALL, device="cpu")
    assert mesh_ctx.axis_sizes(one) == {"data": 1, "model": 1}
