"""The paper's own nets in the port against ``repro`` on the CPU: the three
CNN variants (``models/cnn.py``) and the LSTM seq2seq (``models/seq2seq.py``)
from the reference's own init bridged over, their ``make_fx`` profiles
against the reference's jaxpr profiles, the batch-scaled profiles of
``launch/paper.py`` against traced ones, and the CLI.

Sizes: each CNN at stages ((1, 8), (2, 16)) (the second stage widens at
its first block, so the inception residual is skipped there and taken at
the next), an odd 17x17 image (max-pooled to 8, then 4), 10 classes,
AlexNet's ``fc`` 32; seq2seq at vocab 64, d 16, 2 layers, 7 tokens,
``infer_len`` 5.  Tolerances: logits 1e-5 of max|logits|, the loss 1e-6,
each gradient 1e-5 relative L2, each parameter after one SGD step 1e-6
relative L2 (measured at most 2.1e-7, 0 and 3.3e-8); greedy tokens exactly.

The two packages profile different graphs of one step (XLA's fused conv
backward and ``concatenate`` against aten's ``convolution_backward`` and
``cat``, which keeps the three branches alive beside their concatenation;
the LSTM's gates as ``split`` views and one ``addmm``), so only the
retained bytes agree to the byte and the rest is held in bands, measured
at two sizes: total bytes 0.72-1.17x the reference's, the liveness lower
bound and the best-fit peak 0.67-1.44x (inception's training step the
highest, seq2seq's the lowest)."""
import dataclasses
import io
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_leaves

from repro.configs.paper_native import CNNS as JCNNS
from repro.configs.paper_native import SEQ2SEQ as JSEQ2SEQ
from repro.core import MemoryPlanner as JPlanner
from repro.core import profile_fn as jprofile_fn
from repro.models import cnn as jcnn
from repro.models import seq2seq as js2s
from repro_torch.core import MemoryPlanner
from repro_torch.launch import paper
from repro_torch.launch import train as train_cli
from repro_torch.models import cnn, cnn_params_from_jax, seq2seq, seq2seq_params_from_jax

CNN_ARCHS = ["paper-alexnet", "paper-resnet50", "paper-inception-resnet"]
TOTAL_BAND = (0.65, 1.25)       # port / reference, total bytes
PEAK_BAND = (0.6, 1.5)          # lower bound and best-fit peak


def _cfgs(arch: str, img: int = 17):
    """The port's tiny cut of ``arch`` and the same config in the reference."""
    if arch == "paper-seq2seq":
        return dataclasses.replace(JSEQ2SEQ, **paper.TINY_S2S), paper.config(arch, "tiny")
    tc = dataclasses.replace(paper.config(arch, "tiny"), img=img)
    return dataclasses.replace(JCNNS[arch], stages=tc.stages, fc=tc.fc,
                               classes=tc.classes, img=img), tc


def _rel(got, want) -> float:
    got, want = got.detach().double(), torch.as_tensor(np.asarray(want, np.float64))
    return float((got - want).norm() / want.norm())


def _images(b: int, img: int, classes: int, seed: int):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, img, img, 3)).astype(np.float32)
    return x, rng.integers(0, classes, (b,)).astype(np.int32)


@pytest.mark.parametrize("arch", CNN_ARCHS)
def test_cnn_matches_the_reference(arch):
    jc, tc = _cfgs(arch)
    jp = jcnn.init_cnn(jc, jax.random.PRNGKey(0))
    x, labels = _images(3, jc.img, jc.classes, seed=1)
    tx, tl = torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(labels)
    params = cnn_params_from_jax(jax.tree.map(np.asarray, jp))
    for name, a in jp.items():                    # HWIO -> OIHW, fc kept
        assert tuple(params[name].shape) == (
            (a.shape[3], a.shape[2], a.shape[0], a.shape[1]) if a.ndim == 4 else a.shape)

    want = np.asarray(jcnn.cnn_forward(jp, jnp.asarray(x), jc))
    got = cnn.cnn_forward(params, tx, tc).numpy()
    assert got.shape == (3, jc.classes)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()

    jloss, jgrads = jax.value_and_grad(jcnn.cnn_loss)(jp, jnp.asarray(x),
                                                      jnp.asarray(labels), jc)
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    loss = cnn.cnn_loss(leaves, tx, tl, tc)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-6
    jgrads = cnn_params_from_jax(jax.tree.map(np.asarray, jgrads))
    for (name, g) in zip(leaves, grads):
        assert _rel(g, jgrads[name].numpy()) <= 1e-5, name

    jl, jnew = jcnn.train_step_fn(jc)(jp, jnp.asarray(x), jnp.asarray(labels))
    tloss, tnew = cnn.train_step_fn(tc)(leaves, tx, tl)
    assert abs(float(tloss) - float(jl)) <= 1e-6
    jnew = cnn_params_from_jax(jax.tree.map(np.asarray, jnew))
    for name, p in tnew.items():
        assert p.requires_grad and _rel(p, jnew[name].numpy()) <= 1e-6, name


def test_max_pool_floors_odd_sizes_as_reduce_window():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 15, 299 % 32, 3)).astype(np.float32)   # 15 x 11
    want = np.asarray(jcnn._pool(jnp.asarray(x)))
    got = cnn._pool(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, 7, 5, 3)
    assert np.array_equal(got, want)


def _s2s_batch(cfg, b: int, length: int, seed: int):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, cfg.vocab, (b, length)).astype(np.int32),
            rng.integers(0, cfg.vocab, (b, length)).astype(np.int32))


def test_seq2seq_matches_the_reference():
    jc, tc = _cfgs("paper-seq2seq")
    jp = js2s.init_seq2seq(jc, jax.random.PRNGKey(1))
    params = seq2seq_params_from_jax(jax.tree.map(np.asarray, jp))
    src, tgt = _s2s_batch(jc, 3, jc.max_len, seed=4)
    jloss, jgrads = jax.value_and_grad(js2s.seq2seq_loss)(jp, jnp.asarray(src),
                                                          jnp.asarray(tgt), jc)
    leaves = [t.requires_grad_() for t in tree_leaves(params)]
    loss = seq2seq.seq2seq_loss(params, torch.from_numpy(src), torch.from_numpy(tgt), tc)
    grads = torch.autograd.grad(loss, leaves)
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-6
    want = tree_leaves(seq2seq_params_from_jax(jax.tree.map(np.asarray, jgrads)))
    for g, w in zip(grads, want):
        if float(w.norm()):
            assert _rel(g, w.numpy()) <= 1e-5
        else:                                      # the last decoder step's unused rows
            assert float(g.abs().max()) == 0.0

    jl, jnew = js2s.train_step_fn(jc)(jp, jnp.asarray(src), jnp.asarray(tgt))
    tl, tnew = seq2seq.train_step_fn(tc)(params, torch.from_numpy(src), torch.from_numpy(tgt))
    assert abs(float(tl) - float(jl)) <= 1e-6
    for p, w in zip(tree_leaves(tnew),
                    tree_leaves(seq2seq_params_from_jax(jax.tree.map(np.asarray, jnew)))):
        assert p.requires_grad and _rel(p, w.numpy()) <= 1e-6

    want = np.asarray(js2s.infer_fn(jc)(jnew, jnp.asarray(src)))
    got = seq2seq.infer_fn(tc)(tnew, torch.from_numpy(src))
    assert got.shape == (3, jc.infer_len)
    assert np.array_equal(got.numpy(), want)


def _jax_profile(arch: str, train: bool, b: int, length: int = 7):
    jc, tc = _cfgs(arch)
    if arch == "paper-seq2seq":
        jp = js2s.init_seq2seq(jc, jax.random.PRNGKey(0))
        s = jax.ShapeDtypeStruct((b, length), jnp.int32)
        if train:
            return jprofile_fn(js2s.train_step_fn(jc), jp, s, s), \
                paper.s2s_profile(tc, b, length, "cpu")
        return jprofile_fn(js2s.infer_fn(jc), jp, s), \
            paper.s2s_profile(tc, b, length, "cpu", train=False)
    jp = jcnn.init_cnn(jc, jax.random.PRNGKey(0))
    x = jax.ShapeDtypeStruct((b, jc.img, jc.img, 3), jnp.float32)
    if train:
        return jprofile_fn(jcnn.train_step_fn(jc), jp, x,
                           jax.ShapeDtypeStruct((b,), jnp.int32)), \
            paper.cnn_profile(tc, b, "cpu")
    return jprofile_fn(lambda p, a: jcnn.cnn_forward(p, a, jc), jp, x), \
        paper.cnn_profile(tc, b, "cpu", train=False)


@pytest.mark.parametrize("arch", [*CNN_ARCHS, "paper-seq2seq"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "infer"])
def test_profiles_against_the_reference(arch, train):
    jprof, tprof = _jax_profile(arch, train, b=4 if train else 1)
    assert tprof.retained_bytes == jprof.retained_bytes
    ratios = {
        "total": tprof.total_bytes / jprof.total_bytes,
        "lower_bound": tprof.liveness_lower_bound() / jprof.liveness_lower_bound(),
        "peak": MemoryPlanner().plan(tprof).peak / JPlanner().plan(jprof).peak,
    }
    assert TOTAL_BAND[0] <= ratios["total"] <= TOTAL_BAND[1], ratios
    for k in ("lower_bound", "peak"):
        assert PEAK_BAND[0] <= ratios[k] <= PEAK_BAND[1], ratios


@pytest.mark.parametrize("arch", [*CNN_ARCHS, "paper-seq2seq"])
def test_scaled_profile_equals_a_traced_one(arch):
    """``max_batches`` scales profiles from two traced batches: the result
    at a third batch is the traced profile, block for block."""
    _, tc = _cfgs(arch)
    if arch == "paper-seq2seq":
        def trace(b):
            return paper._s2s_trace(tc, b, 5, torch.device("cpu"), True)
        want = paper.s2s_profile(tc, 7, 5, "cpu")
    else:
        def trace(b):
            return paper._cnn_trace(tc, b, torch.device("cpu"), True)
        want = paper.cnn_profile(tc, 7, "cpu")
    got = paper.scaled_profile(trace(2), 2, trace(4), 4, 7)
    assert got.blocks == want.blocks
    assert got.retained_bytes == want.retained_bytes
    assert got.clock_end == want.clock_end


def test_max_batches_refuses_a_boundary_its_traces_disagree_with():
    """The DSA boundary is traced at b and b + 1 and must equal the scaled
    profiles there: a trace that is not the scaled one is refused."""
    _, tc = _cfgs("paper-alexnet")

    def trace(b):
        return paper._cnn_trace(tc, b, torch.device("cpu"), True)
    budget = 4 * 10 ** 6
    fits = paper.max_batches(trace, budget, 2)
    assert 0 < fits["naive"] <= fits["pool"] and fits["naive"] <= fits["dsa"]
    dsa = paper.PEAKS["dsa"]
    for b, fit in ((fits["dsa"], True), (fits["dsa"] + 1, False)):
        prof = paper.cnn_profile(tc, b, "cpu")
        assert (prof.retained_bytes + dsa(prof) <= budget) == fit
    with pytest.raises(AssertionError, match="differs from the profile scaled"):
        paper.max_batches(lambda b: trace(b if b in (2, 4) else b + 1), budget, 2)


def _cli(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = paper.main(argv)
    return res, out.getvalue()


def test_paper_cli_cnn_on_the_cpu(tmp_path):
    lp = tmp_path / "alexnet.lp"
    res, text = _cli(["--arch", "paper-alexnet", "--preset", "tiny", "--device", "cpu",
                      "--batch", "4", "--steps", "2", "--hbm-gb", "0.002",
                      "--lp", str(lp)])
    assert "[paper:alexnet] train B=4 img=17: blocks=" in text
    assert "naive=" in text and "DSA=" in text and "max batch in 0.0GB" in text
    fits = res["max_batch"]
    assert 0 < fits["naive"] <= fits["pool"] and fits["naive"] <= fits["dsa"]
    assert len(res["steps"]["loss"]) == 2 and all(np.isfinite(res["steps"]["loss"]))
    assert res["inference"]["finite"]
    assert lp.read_text().startswith("\\ DSA MIP") and "\nMinimize\n" in lp.read_text()


def test_paper_cli_seq2seq_replans_stop_once_every_length_is_seen():
    res, text = _cli(["--arch", "paper-seq2seq", "--preset", "tiny", "--device", "cpu",
                      "--batch", "4", "--lengths", "3,5,7", "--steps", "8",
                      "--hbm-gb", "0.004"])
    steps = res["steps"]
    assert sorted({s["length"] for s in steps[:3]}) == [3, 5, 7]
    reopt = [s["n_reopt"] for s in steps]
    assert reopt == sorted(reopt)
    # the arena replans at the reset after each new length's first step, so
    # from the step after the last new length on the count stays put
    assert reopt[3:] == [len({3, 5, 7}) - 1] * (len(steps) - 3)
    assert steps[-1]["plans_cached"] == 3
    assert all(s["overflow_peak"] == 0 for s in steps[4:])
    assert "n_reopt=2 plans_cached=3" in text
    assert res["tokens"].shape == (1, paper.TINY_S2S["infer_len"])


def test_paper_cli_needs_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        paper.main(["--arch", "paper-alexnet", "--preset", "tiny"])


def test_train_cli_refuses_the_paper_nets_and_names_launch_paper():
    for arch in (*CNN_ARCHS, "paper-seq2seq"):
        with pytest.raises(SystemExit, match="launch.paper"):
            train_cli.main(["--arch", arch, "--device", "cpu", "--preset", "tiny"])
