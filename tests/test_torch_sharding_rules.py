"""The port's sharding rules (``runtime/{mesh_ctx,sharding_rules,elastic}``
and the schema's logical axes) held exactly against the reference's.

Pure logic on the CPU, with no process group: the port's rule functions
read only a mesh's axis names and sizes, so they get a names-and-sizes
``launch.mesh.CardMesh``; the reference gets a ``jax.sharding.Mesh`` over
its one CPU device repeated (``tests/test_mesh_ctx.py``'s trick).  Meshes:
(data 2, model 4), (16, 16) and (pod 2, data 16, model 16).  Every
registered config's parameter specs are matched leaf by leaf through
``models.bridge.params_from_jax``'s own path map: the reference's spec tree
goes through it with each leaf replaced by its index, so the port's leaf at
each place names the reference leaf (and layer) it came from; a stacked
leaf's spec is the reference's less its leading ``layers`` entry.
"""
import itertools

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from repro.configs import get_config as jget_config
from repro.models import RunOpts as JRunOpts
from repro.models import Transformer as JTransformer
from repro.models.schema import logical_axes as jlogical_axes
from repro.runtime import elastic as jelastic
from repro.runtime import mesh_ctx as jmesh_ctx
from repro.runtime import sharding_rules as jrules
from repro_torch.configs import ARCHS
from repro_torch.configs import get_config as tget_config
from repro_torch.launch.mesh import CardMesh
from repro_torch.models import RunOpts, Transformer, params_from_jax
from repro_torch.models.schema import logical_axes
from repro_torch.runtime import elastic, mesh_ctx, sharding_rules

MESHES = [(("data", "model"), (2, 4)), (("data", "model"), (16, 16)),
          (("pod", "data", "model"), (2, 16, 16))]


def _jmesh(names, shape):
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices() * n)[:n].reshape(shape), names)


@pytest.fixture(scope="module", params=MESHES, ids=lambda m: "x".join(map(str, m[1])))
def meshes(request):
    names, shape = request.param
    return _jmesh(names, shape), CardMesh(names, shape)


def _spec(s) -> tuple:
    return tuple(s.spec) if hasattr(s, "spec") else tuple(s)


RULE_SETS = [jmesh_ctx.ACTIVATION_RULES, jrules.PARAM_RULES, jrules.CACHE_RULES,
             dict(jmesh_ctx.ACTIVATION_RULES, seq=("model",), ssm_p=("model",)),
             {"heads": ("model",), "batch": ("pod", "data"), "x": "data",
              "both": ("data", "model"), "rev": ("model", "data")}]
LOGICAL = sorted({k for r in RULE_SETS for k in r} | {None, "absent"}, key=str)
DIMS = [None, 1, 2, 3, 4, 6, 8, 16, 24, 32, 64, 256, 512, 896]


def test_rule_tables_equal_the_reference():
    assert mesh_ctx.ACTIVATION_RULES == jmesh_ctx.ACTIVATION_RULES
    assert sharding_rules.PARAM_RULES == jrules.PARAM_RULES
    assert sharding_rules.CACHE_RULES == jrules.CACHE_RULES


def test_resolve_matches_the_reference(meshes):
    jm, tm = meshes
    for rules, logical, dim in itertools.product(RULE_SETS, LOGICAL, DIMS):
        assert (mesh_ctx._resolve(rules, logical, tm, dim)
                == jmesh_ctx._resolve(rules, logical, jm, dim)), (rules, logical, dim)


def test_resolve_cases_of_test_mesh_ctx():
    mesh = CardMesh(("data", "model"), (2, 4))
    rules = {"heads": ("model",)}
    assert mesh_ctx._resolve(rules, "heads", mesh, 8) == "model"
    assert mesh_ctx._resolve(rules, "heads", mesh, 6) is None
    assert mesh_ctx._resolve(rules, "heads", mesh, None) == "model"
    pod = CardMesh(("pod", "data", "model"), (2, 2, 2))
    assert mesh_ctx._resolve({"batch": ("pod", "data")}, "batch", pod, 8) == ("pod", "data")
    assert mesh_ctx._resolve({"batch": ("pod", "data")}, "batch", pod, 2) == "pod"


def test_spec_for_and_spec_from_axes_match_the_reference(meshes):
    jm, tm = meshes
    rng = np.random.default_rng(0)
    for rules in RULE_SETS:
        for _ in range(150):
            n = int(rng.integers(1, 6))
            axes = tuple(LOGICAL[i] for i in rng.integers(0, len(LOGICAL), n))
            dims = tuple(int(DIMS[i + 1]) for i in rng.integers(0, len(DIMS) - 1, n))
            t = mesh_ctx.spec_for(*axes, rules=rules, mesh=tm, dims=dims)
            assert t == _spec(jmesh_ctx.spec_for(*axes, rules=rules, mesh=jm, dims=dims))
            assert isinstance(t, mesh_ctx.PartitionSpec) and len(t) == n
            assert (sharding_rules.spec_from_axes(axes, dims, tm, rules)
                    == _spec(jrules.spec_from_axes(axes, dims, jm, rules)))
    # the dedup of test_mesh_ctx: "model" only once, left to right
    spec = mesh_ctx.spec_for("batch", "seq", "heads", mesh=tm, dims=(32, 32, 32),
                             rules=dict(mesh_ctx.ACTIVATION_RULES, seq=("model",)))
    assert [s for s in spec if s is not None].count("model") == 1


def _ref_index_tree(jspecs):
    """The reference's spec tree with each leaf replaced by its index times
    10_000 (an array over the layers of a stacked leaf, each plus its
    layer), and the list of (path, spec, stacked) by index."""
    flat = []

    def rec(tree, path):
        out = {}
        for k, v in tree.items():
            p = path + (k,)
            if isinstance(v, dict):
                out[k] = rec(v, p)
                continue
            stacked = "pattern" in p or p[:2] == ("encoder", "blocks")
            flat.append((p, _spec(v), stacked))
            code = (len(flat) - 1) * 10_000
            out[k] = (np.arange(v.shape[0], dtype=np.float32) + code if stacked
                      else np.float32(code))
        return out
    return rec(jspecs, ()), flat


def _leaves_with_paths(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves_with_paths(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves_with_paths(v, path + (i,))
    else:
        yield path, tree


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _shaped(jspecs, jschema):
    """NamedShardings carry no shape: pair each with its schema leaf's."""
    if isinstance(jspecs, dict):
        return {k: _shaped(v, jschema[k]) for k, v in jspecs.items()}

    class S:
        spec = jspecs.spec
        shape = jschema.shape
    return S


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_and_logical_axes_match_the_reference(arch, meshes):
    jm, tm = meshes
    jmodel = JTransformer(jget_config(arch))
    tmodel = Transformer(tget_config(arch), RunOpts(), device="cpu")
    jschema, tschema = jmodel.schema(), tmodel.schema()
    jspecs = _shaped(jrules.param_specs(jschema, jm), jschema)
    jaxes = jlogical_axes(jschema)
    index_tree, flat = _ref_index_tree(jspecs)
    ported = params_from_jax(index_tree)
    tspecs = sharding_rules.param_specs(tschema, tm)
    taxes = logical_axes(tschema)
    seen = set()
    n = 0
    for path, leaf in _leaves_with_paths(ported):
        code = int(leaf.item())
        idx, layer = divmod(code, 10_000)
        jpath, jspec, stacked = flat[idx]
        seen.add(idx)
        want_spec = jspec[1:] if stacked else jspec
        want_axes = _get(jaxes, jpath)[1:] if stacked else _get(jaxes, jpath)
        assert tuple(_get(tspecs, path)) == want_spec, (path, jpath, layer)
        assert _get(taxes, path) == want_axes, (path, jpath)
        assert tuple(_get(tschema, path).shape) == tuple(
            _get(jschema, jpath).shape)[1 if stacked else 0:]
        n += 1
    assert seen == set(range(len(flat))) and n == len(list(_leaves_with_paths(tspecs)))


def _jcache_leaves(jmodel, batch, max_len):
    sds = jmodel.cache_spec(batch, max_len)
    paths = jax.tree_util.tree_flatten_with_path(sds)[0]
    return {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in kp): leaf
            for kp, leaf in paths}


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "phi4-mini-3.8b", "granite-moe-1b-a400m",
                                  "whisper-small", "recurrentgemma-9b", "mamba2-130m"])
@pytest.mark.parametrize("rules", [None, {"cache": ("model",)}], ids=["default", "cache_len"])
def test_cache_specs_per_leaf_name_match_the_reference(arch, rules, meshes):
    """Each leaf of the port's flat cache (one leading layers dim over the
    layers of its kind) gets the reference's spec for the leaf of that name
    (its stacked ``pattern`` leaf, whose layers dim is unsharded too)."""
    jm, tm = meshes
    batch, max_len = 32, 512
    jmodel = JTransformer(jget_config(arch))
    tmodel = Transformer(tget_config(arch), RunOpts(), device="cpu")
    jspecs = jrules.cache_specs(jmodel.cache_spec(batch, max_len), jm, rules=rules)
    jflat = {tuple(getattr(k, "key", None) for k in kp): _spec(s)
             for kp, s in jax.tree_util.tree_flatten_with_path(
                 jspecs, is_leaf=lambda x: hasattr(x, "spec"))[0]}
    tspec = tmodel.cache_spec(batch, max_len)
    tspecs = sharding_rules.cache_specs(tspec, tm, rules=rules)
    assert set(tspecs) == set(tspec)
    for name, spec in tspecs.items():
        want = {s for p, s in jflat.items() if p[-1] == name and
                (name == "pos" or "pattern" in p)}
        assert len(want) == 1 and spec == want.pop(), (name, spec)
        assert len(spec) == len(tspec[name][0])


def test_paged_pool_specs_split_kv_heads(meshes):
    _, tm = meshes
    tmodel = Transformer(tget_config("qwen3-moe-30b-a3b"), RunOpts(), device="cpu")
    spec = tmodel.paged_cache_spec(32, n_pages=64, page_tokens=16, pages_per_req=4)
    specs = sharding_rules.cache_specs(spec, tm)
    kv = tmodel.cfg.n_kv_heads
    model = mesh_ctx.axis_sizes(tm)["model"]
    want = "model" if kv % model == 0 else None
    for name in ("k_pages", "v_pages"):
        assert specs[name] == (None, None, None, want, None)
    assert specs["block_tables"] == (None, None)
    assert specs["pos"] == sharding_rules.cache_specs({"pos": (32,)}, tm)["pos"]


BATCHES = [{"tokens": (8, 17)}, {"tokens": (1, 9), "mask": (1, 9)},
           {"tokens": (32, 4097), "frames": (32, 1500, 768)},
           {"tokens": (2,), "true_len": (2,)}, {"tokens": (512, 2), "extra": (512, 3, 5)}]


@pytest.mark.parametrize("batch", BATCHES, ids=lambda b: "-".join(b))
def test_batch_specs_match_the_reference(batch, meshes):
    jm, tm = meshes
    jb = {k: jax.ShapeDtypeStruct(v, np.int32) for k, v in batch.items()}
    want = {k: _spec(v) for k, v in jrules.batch_specs(jb, jm).items()}
    assert sharding_rules.batch_specs(batch, tm) == want
    assert sharding_rules.batch_specs({k: (v, None) for k, v in batch.items()}, tm) == want


@pytest.mark.parametrize("knobs", list(itertools.product([False, True], repeat=4)))
def test_run_opts_mesh_rules_match_the_reference(knobs):
    kw = dict(zip(("cp_attention", "moe_grouped", "sp_residual", "ssd_shard_p"), knobs))
    assert RunOpts(**kw).mesh_rules() == JRunOpts(**kw).mesh_rules()


def test_factor_mesh_and_shrink_plan_match_the_reference():
    for n in [1, 2, 3, 4, 6, 8, 12, 16, 24, 48, 64, 96, 128, 256, 384, 512, 1000]:
        for max_model in (1, 2, 8, 16, 64):
            assert (elastic.factor_mesh(n, max_model)
                    == jelastic.factor_mesh(n, max_model))
    for old, new in [(256, 128), (512, 256), (8, 4), (4, 2), (16, 12), (4, 4)]:
        assert elastic.shrink_plan(old, new) == jelastic.shrink_plan(old, new)


def test_placements_of_a_spec():
    """Shard on each mesh dim a spec names, Replicate elsewhere and on a
    mesh dim of size 1."""
    from torch.distributed.tensor import Replicate, Shard
    tm = CardMesh(("pod", "data", "model"), (2, 2, 4))
    spec = mesh_ctx.PartitionSpec(("pod", "data"), None, "model")
    assert mesh_ctx.placements(spec, tm) == (Shard(0), Shard(0), Shard(2))
    assert mesh_ctx.placements(mesh_ctx.PartitionSpec(), tm) == (Replicate(),) * 3
    one = CardMesh()
    assert mesh_ctx.placements(mesh_ctx.PartitionSpec("data", "model"), one) == (
        Replicate(), Replicate())
    with pytest.raises(ValueError, match="twice"):
        mesh_ctx.placements(("model", "model"), tm)
    assert repr(spec) == "PartitionSpec(('pod', 'data'), None, 'model')"


def test_shard_is_the_identity_without_a_mesh():
    import torch
    x = torch.ones(2, 3)
    assert mesh_ctx.shard(x, "batch", "embed") is x
    assert mesh_ctx.current_mesh() is None
    with pytest.raises(ValueError, match="no mesh"):
        mesh_ctx.spec_for("batch")
