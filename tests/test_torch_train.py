"""The port's training path against the reference's: the f32 loss and its
gradients, AdamW steps through ``build_train_step``, microbatching, int8
gradient compression, the LR schedule, the synthetic pipeline, checkpoints,
the fault controller and the training CLI, on the tiny qwen2 (2 layers,
G=7) with reference weights converted by ``params_from_jax``.

Tolerances: the loss within 1e-5 relative; the whole gradient (every leaf
flattened into one vector) and the whole parameter vector after three
AdamW steps within 1e-5 relative in L2.  Both packages sum in f32 in other
orders, and each is ~8e-6 from a float64 run of the port on the worst leaf,
so leaves are held together rather than one by one."""
import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
from torch.utils._pytree import tree_leaves, tree_map

from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticPipeline as JPipeline
from repro.models import RunOpts as JRunOpts
from repro.models import Transformer as JTransformer
from repro.optim import adamw as jadamw
from repro.optim import grad_compress as jgc
from repro.runtime import train_lib as jtrain_lib
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, SyntheticPipeline
from repro_torch.launch import train as train_cli
from repro_torch.models import RunOpts, Transformer, params_from_jax
from repro_torch.optim import adamw, grad_compress
from repro_torch.runtime import train_lib
from repro_torch.runtime.fault import SimulatedFailure, TrainController
from torch_port_utils import ref_params, small_cfgs

LOSS_TOL = 1e-5
VEC_TOL = 1e-5
ACFG = adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
JACFG = jadamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)


def _vec_rel(got, want) -> float:
    """L2 error of the flattened leaves over the L2 norm of ``want``'s."""
    g = torch.cat([t.detach().double().flatten() for t in got])
    w = torch.cat([torch.as_tensor(np.asarray(t, np.float64)).flatten() for t in want])
    return float((g - w).norm() / w.norm())


def _port_leaves_of(jax_tree):
    return tree_leaves(params_from_jax(jax.tree.map(np.asarray, jax_tree)))


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = small_cfgs()
    jparams, np_tree = ref_params(jcfg)
    jm = JTransformer(jcfg)
    tm = Transformer(tcfg, RunOpts(attention_impl="full", use_kernels=False),
                     device="cpu")
    pipe = JPipeline(JDataConfig(vocab_size=jcfg.vocab_size, seq_len=16,
                                 global_batch=4, seed=0))
    return jm, jparams, np_tree, tm, pipe


def _check_loss_and_gradients(jm, jparams, np_tree, tm, batch):
    (jloss, jaux), jgrads = jax.value_and_grad(
        lambda p, b: jm.loss_fn(p, b, remat=False), has_aux=True)(
            jparams, {"tokens": jnp.asarray(batch["tokens"])})
    params = params_from_jax(np_tree)
    leaves = [t.requires_grad_() for t in tree_leaves(params)]
    loss, aux = tm.loss_fn(params, {"tokens": torch.from_numpy(batch["tokens"])},
                           remat=False)
    grads = torch.autograd.grad(loss, leaves)
    loss = loss.detach()
    assert abs(float(loss) - float(jloss)) <= LOSS_TOL * abs(float(jloss))
    assert abs(float(aux["ce"].detach()) - float(jaux["ce"])) <= LOSS_TOL * abs(float(jaux["ce"]))
    assert _vec_rel(grads, _port_leaves_of(jgrads)) <= VEC_TOL


def test_loss_and_gradients_match_the_reference(setup):
    jm, jparams, np_tree, tm, pipe = setup
    _check_loss_and_gradients(jm, jparams, np_tree, tm, pipe.batch_at(0))


@pytest.mark.parametrize("loss_chunk", [5, 8])
def test_chunked_loss_and_gradients_match_the_reference(loss_chunk):
    """``loss_impl="chunked"`` in both packages: a chunk of 5 leaves S=16 a
    padded tail (pad, mask and per-chunk sum), a chunk of 8 divides it; a
    vocab of 500 (padded to 512) brings in the padded-vocab bias."""
    jcfg, tcfg = (c.with_overrides(vocab_size=500) for c in small_cfgs())
    jparams, np_tree = ref_params(jcfg)
    jm = JTransformer(jcfg, JRunOpts(loss_impl="chunked", loss_chunk=loss_chunk))
    tm = Transformer(tcfg, RunOpts(attention_impl="full", use_kernels=False,
                                   loss_impl="chunked", loss_chunk=loss_chunk),
                     device="cpu")
    pipe = JPipeline(JDataConfig(vocab_size=jcfg.vocab_size, seq_len=16,
                                 global_batch=4, seed=0))
    _check_loss_and_gradients(jm, jparams, np_tree, tm, pipe.batch_at(0))


def test_adamw_steps_match_the_reference(setup):
    """Three steps of ``build_train_step`` from the same weights on the same
    pipeline batches: losses and the parameters after them."""
    jm, jparams, np_tree, tm, pipe = setup
    jopts = jtrain_lib.TrainOpts(remat=False, donate=False)
    jstep, _ = jtrain_lib.build_train_step(jm, None, JACFG, jopts)
    jstate = {"params": jparams, "opt": jadamw.init(jparams),
              "step": jnp.zeros((), jnp.int32)}
    params = params_from_jax(np_tree)
    state = {"params": params, "opt": adamw.init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    step, none = train_lib.build_train_step(tm, None, ACFG,
                                            train_lib.TrainOpts(remat=False))
    assert none is None
    for i in range(3):
        b = pipe.batch_at(i)
        jstate, jm_ = jstep(jstate, {"tokens": jnp.asarray(b["tokens"])})
        state, m = step(state, {"tokens": torch.from_numpy(b["tokens"])})
        assert abs(float(m["loss"]) - float(jm_["loss"])) <= LOSS_TOL * float(jm_["loss"])
        assert abs(float(m["lr"]) - float(jm_["lr"])) <= 1e-7 * float(jm_["lr"])
    assert int(state["step"]) == int(jstate["step"]) == 3
    assert int(state["opt"]["count"]) == 3
    assert _vec_rel(tree_leaves(state["params"]),
                    _port_leaves_of(jstate["params"])) <= VEC_TOL
    assert _vec_rel(tree_leaves(state["opt"]["m"]),
                    _port_leaves_of(jstate["opt"]["m"])) <= 1e-4


def test_microbatches_accumulate_the_full_batch_gradient(setup):
    *_, tm, pipe = setup
    b = {"tokens": torch.from_numpy(pipe.batch_at(0)["tokens"])}
    out = {}
    for n in (1, 2):
        gen = torch.Generator().manual_seed(0)
        state = train_lib.init_state(tm, gen, ACFG)
        step, _ = train_lib.build_train_step(
            tm, None, ACFG, train_lib.TrainOpts(microbatches=n, remat=False))
        state, m = step(state, b)
        out[n] = (float(m["loss"]), float(m["grad_norm"]), tree_leaves(state["params"]))
    assert abs(out[2][0] - out[1][0]) <= LOSS_TOL * out[1][0]
    assert abs(out[2][1] - out[1][1]) <= 1e-5 * out[1][1]
    assert _vec_rel(out[2][2], [t.detach().numpy() for t in out[1][2]]) <= VEC_TOL
    with pytest.raises(ValueError, match="microbatches"):
        train_lib._split_microbatches(b, 3)


def test_grad_compress_matches_the_reference():
    rng = np.random.default_rng(5)
    grads = {"a": rng.standard_normal((33, 7)).astype(np.float32),
             "b": [rng.standard_normal(5).astype(np.float32) * 1e-3]}
    err = tree_map(lambda a: (0.01 * rng.standard_normal(a.shape)).astype(np.float32),
                   grads)
    jdeq, jerr = jgc.compress_decompress(jax.tree.map(jnp.asarray, grads),
                                         jax.tree.map(jnp.asarray, err))
    tdeq, terr = grad_compress.compress_decompress(tree_map(torch.from_numpy, grads),
                                                   tree_map(torch.from_numpy, err))
    for got, want in zip(tree_leaves(tdeq) + tree_leaves(terr),
                         jax.tree.leaves(jdeq) + jax.tree.leaves(jerr)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-7)
    params = tree_map(torch.from_numpy, grads)
    assert grad_compress.compression_ratio(params) == pytest.approx(
        jgc.compression_ratio(jax.tree.map(jnp.asarray, grads)))


def test_compressed_step_runs_and_keeps_an_error_state(setup):
    *_, tm, pipe = setup
    opts = train_lib.TrainOpts(remat=False, compress_grads=True)
    state = train_lib.init_state(tm, torch.Generator().manual_seed(0), ACFG, opts)
    assert "err" in state
    step, _ = train_lib.build_train_step(tm, None, ACFG, opts)
    losses = []
    for i in range(3):
        state, m = step(state, {"tokens": torch.from_numpy(pipe.batch_at(i)["tokens"])})
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert any(float(e.abs().max()) > 0 for e in tree_leaves(state["err"]))


def test_lr_schedule_matches_the_reference():
    cfg = adamw.AdamWConfig(lr=3e-4, warmup_steps=5, total_steps=40)
    jcfg = jadamw.AdamWConfig(lr=3e-4, warmup_steps=5, total_steps=40)
    got = [float(adamw.schedule(cfg, torch.tensor(s, dtype=torch.int32)))
           for s in range(45)]
    want = [float(jadamw.schedule(jcfg, jnp.asarray(s, jnp.int32))) for s in range(45)]
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("step", [0, 1, 17])
def test_pipeline_batches_are_byte_identical(step):
    cfg = dict(vocab_size=1000, seq_len=24, global_batch=6, seed=3, n_hosts=2,
               host_id=1)
    got = SyntheticPipeline(DataConfig(**cfg)).batch_at(step)
    want = JPipeline(JDataConfig(**cfg)).batch_at(step)
    assert got["tokens"].dtype == want["tokens"].dtype == np.int32
    assert got["tokens"].tobytes() == want["tokens"].tobytes()


def test_checkpoint_round_trip(tmp_path):
    state = {"params": {"w": torch.randn(4, 3), "layers": [{"b": torch.randn(2)}],
                        "h": torch.randn(5).bfloat16()},
             "step": torch.tensor(7, dtype=torch.int32)}
    ck = Checkpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3):
        ck.save(s, state, meta={"step": s})
    ck.wait()
    assert ck.all_steps() == [2, 3] and ck.latest_step() == 3
    assert ck.meta(3) == {"step": 3}
    like = tree_map(torch.zeros_like, state)
    back = ck.restore(3, like)
    for got, want in zip(tree_leaves(back), tree_leaves(state)):
        assert got.dtype == want.dtype and torch.equal(got, want)
    saved = state["params"]["w"].clone()
    ck.save(4, state)
    state["params"]["w"].add_(1.0)          # in-place update after save
    ck.wait()
    assert torch.equal(ck.restore(4, like)["params"]["w"], saved)
    with pytest.raises(ValueError, match="structure"):
        ck.restore(4, {"params": {"w": torch.zeros(4, 3)}})


def test_fault_restart_replays_the_same_losses(setup, tmp_path):
    *_, tm, _ = setup
    pipe = SyntheticPipeline(DataConfig(vocab_size=512, seq_len=16, global_batch=4))
    opts = train_lib.TrainOpts(remat=True)

    def controller(d):
        state = train_lib.init_state(tm, torch.Generator().manual_seed(1), ACFG, opts)
        step, _ = train_lib.build_train_step(tm, None, ACFG, opts)
        return TrainController(step_fn=step, state=state, pipeline=pipe,
                               ckpt=Checkpointer(str(d)), ckpt_every=2)

    clean = controller(tmp_path / "a")
    clean.run(5)
    ctl = controller(tmp_path / "b")
    with pytest.raises(SimulatedFailure):
        ctl.run(5, fail_at=3)
    assert ctl.resume() == 2
    ctl.run(3)
    assert ctl.losses == clean.losses


def test_abstract_state_is_fake_and_shaped_like_the_real_one(setup):
    *_, tm, _ = setup
    opts = train_lib.TrainOpts(compress_grads=True)
    fake = train_lib.abstract_state(tm, FakeTensorMode(), ACFG, opts)
    real = train_lib.init_state(tm, torch.Generator().manual_seed(0), ACFG, opts)
    for f, r in zip(tree_leaves(fake), tree_leaves(real)):
        assert isinstance(f, FakeTensor)
        assert f.shape == r.shape and f.dtype == r.dtype


def test_unported_training_paths_raise():
    """Every pattern trains; the kernels have no backward, so a model whose
    RunOpts name them refuses to train (mamba2 here: the SSD kernel), and a
    mesh that is no DeviceMesh is refused."""
    cfg = get_config("mamba2-130m").smoke()
    m = Transformer(cfg, RunOpts(), device="cpu")
    with pytest.raises(ValueError, match="no backward"):
        m.loss_fn(m.init(torch.Generator().manual_seed(0)),
                  {"tokens": torch.zeros(1, 9, dtype=torch.int32)})
    q = Transformer(get_config("qwen2-0.5b").smoke(),
                    RunOpts(attention_impl="full", use_kernels=False), device="cpu")
    with pytest.raises(TypeError, match="DeviceMesh"):
        train_lib.build_train_step(q, object(), ACFG)


def _cli(*argv) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        train_cli.main(list(argv))
    return out.getvalue()


def test_train_cli_runs_planned_remat_on_the_cpu():
    text = _cli("--device", "cpu", "--preset", "tiny", "--steps", "6",
                "--remat", "planned", "--log-every", "3")
    assert "memory plan: peak=" in text
    assert "remat plan: planned(recompute=" in text
    assert "done: 6 steps" in text
    losses = [float(l.split("loss=")[1].split()[0]) for l in text.splitlines()
              if l.startswith("step ")]
    assert len(losses) == 2 and all(np.isfinite(losses))


def test_train_cli_defaults_to_full_remat(monkeypatch):
    """Without ``--remat`` every layer is recomputed: planned loses to full
    in step time and peak on the card (PERF.md section 5)."""
    seen = []
    build = train_lib.build_train_step

    def spy(model, mesh, acfg, opts):
        seen.append(opts.remat)
        return build(model, mesh, acfg, opts)
    monkeypatch.setattr(train_lib, "build_train_step", spy)
    text = _cli("--device", "cpu", "--preset", "tiny", "--steps", "2")
    assert seen == [True] and "remat plan:" not in text
    assert "done: 2 steps" in text


def test_train_cli_writes_a_trace_of_the_planning_phase(tmp_path):
    """``--trace``: the remat search's events and the packed ``activations``
    plan in one Chrome trace that passes the schema gate, with every block
    of the plan rebuilt from the export."""
    from repro_torch.obs import load_chrome_trace, plan_rectangles, validate_chrome_trace
    from repro_torch.obs import get_tracer
    path = tmp_path / "train.json"
    text = _cli("--device", "cpu", "--preset", "tiny", "--steps", "2",
                "--remat", "planned", "--trace", str(path))
    assert "[trace] " in text and f"-> {path}" in text
    assert get_tracer() is None          # the CLI uninstalls its tracer
    trace = load_chrome_trace(str(path))
    validate_chrome_trace(trace)
    rects = plan_rectangles(trace, "activations")
    assert rects and all(r["size"] > 0 for r in rects)
    assert {e["cat"] for e in trace["traceEvents"] if e["ph"] != "M"} >= {"remat", "packing"}


def test_train_cli_needs_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _cli("--steps", "1")
