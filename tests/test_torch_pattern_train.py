"""Training of the patterns beyond the attention decoder against the
reference: whisper-small's ``("xattn",)`` encoder-decoder (its encoder run
first, outside any remat wrap, its output read by every decoder layer's
cross-attention), mamba2-130m's ``("mamba2",)`` SSD stack and
recurrentgemma-9b's ``("rec", "rec", "local")`` groups with their
``("rec", "rec")`` tail, each at the ``tiny`` preset of
``launch.train.reduced_config`` (the reference's, field for field: d_model
64, one head of 64, 2 groups, whisper's 2 encoder layers over 64 frames,
the hybrid's 64-token window), f32, with reference weights converted by
``params_from_jax``: ``loss_fn``'s loss and whole gradient, AdamW steps
through ``build_train_step``, the three remat policies, the grad step's
``make_fx`` profile against the reference's jaxpr profile, frames through
the training helpers and the training CLI.

Weights: ``ref_params`` with ``wq``/``wk`` of every attention (the hybrid's
local layers, whisper's encoder, self- and cross-attention) redrawn at
1/sqrt(d_model).  The reference's init takes the heads axis as their
fan-in; at one head that makes the scores so large that f32 rounding moves
whisper's gradient by ~1e-2 and the hybrid's by ~1.5e-4 in both packages
alike (each as far from a float64 run of the port as from the other), a
sensitivity of the weights and not a difference.  Redrawn, both sit ~4e-7
(whisper) and ~1.5e-6 (the hybrid) from float64.

Tolerances: the loss within 1e-5 relative; the whole gradient and the whole
parameter vector after three AdamW steps within 1e-5 relative in L2, as in
``test_torch_train.py``; remat against no remat exactly (the same ops run
again on the CPU).  The profiles differ in their graphs (one scanned jaxpr
of XLA primitives against the aten ops of an unrolled forward and
backward), so only the retained bytes (f32 masters, tokens and frames)
agree to the byte; the other ratios lie in the bands of ``PROFILE_BANDS``."""
import contextlib
import functools
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_flatten_with_path, tree_leaves

from repro.core import MemoryPlanner as JPlanner
from repro.core import profile_fn as jprofile_fn
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticPipeline as JPipeline
from repro.launch.train import reduced_config as jreduced_config
from repro.models import RunOpts as JRunOpts
from repro.models import Transformer as JTransformer
from repro.optim import adamw as jadamw
from repro.runtime import train_lib as jtrain_lib
from repro_torch.core import MemoryPlanner
from repro_torch.launch import train as train_cli
from repro_torch.models import RunOpts, Transformer, params_from_jax
from repro_torch.optim import adamw
from repro_torch.remat import policy as policy_mod
from repro_torch.runtime import train_lib
from test_torch_train import ACFG, JACFG, LOSS_TOL, VEC_TOL, _port_leaves_of, _vec_rel
from torch_port_utils import ref_params

ARCHS = ("whisper-small", "mamba2-130m", "recurrentgemma-9b")
OPTS = RunOpts(attention_impl="full", use_kernels=False)
BATCH = 2
# (arch, S): the preset's 32 tokens, and the hybrid past its 64-token window
CASES = [(a, None) for a in ARCHS] + [("recurrentgemma-9b", 96)]
# port / reference, grad step at batch 2 x 33 tokens (measured: whisper
# total 1.05, lower bound and peak 0.49; mamba2 2.46 and 0.59; the hybrid
# 1.39 and 0.65).  The port's graph holds more blocks (casts, transposes,
# the unrolled chunk and log-depth scans' pieces) but frees each after its
# last use, where the reference's scan keeps each group's residuals stacked
# for the backward.
PROFILE_BANDS = {
    "whisper-small": {"total": (0.9, 1.2), "peak": (0.4, 0.6)},
    "mamba2-130m": {"total": (2.1, 2.8), "peak": (0.5, 0.7)},
    "recurrentgemma-9b": {"total": (1.2, 1.6), "peak": (0.55, 0.75)},
}


def _redraw_qk(np_tree, d_model: int) -> None:
    """wq and wk of every attention redrawn to std 1/sqrt(d_model), in
    place (the module docstring says why)."""
    rng = np.random.default_rng(d_model)
    blocks = [*np_tree["pattern"].values(), *np_tree.get("tail", {}).values()]
    if "encoder" in np_tree:
        blocks.append(np_tree["encoder"]["blocks"])
    for block in blocks:
        for name in ("attn", "xattn"):
            for w in ("wq", "wk") if name in block else ():
                leaf = block[name][w]
                block[name][w] = (rng.standard_normal(leaf.shape)
                                  / np.sqrt(d_model)).astype(np.float32)


def _setup(arch, ssd_chunk: int = OPTS.ssd_chunk):
    """(reference model, port model, reference params, numpy tree, seq),
    both models at SSD chunk ``ssd_chunk``."""
    jcfg, seq, _ = jreduced_config(arch, "tiny")
    tcfg, _, _ = train_cli.reduced_config(arch, "tiny")
    _, np_tree = ref_params(jcfg)
    _redraw_qk(np_tree, jcfg.d_model)
    return (JTransformer(jcfg, JRunOpts(ssd_chunk=ssd_chunk)),
            Transformer(tcfg, RunOpts(attention_impl="full", use_kernels=False,
                                      ssd_chunk=ssd_chunk), device="cpu"),
            jax.tree.map(jnp.asarray, np_tree), np_tree, seq)


def _value_and_grad(jm, tm, jparams, np_tree, batch):
    """Both packages' (loss, {"ce", "aux"}, gradient as port leaves) on the
    same weights and numpy batch."""
    (jloss, jaux), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss_fn(p, b, remat=False), has_aux=True))(
            jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    params = params_from_jax(np_tree)
    leaves = [t.requires_grad_() for t in tree_leaves(params)]
    loss, aux = tm.loss_fn(params, _torch(batch), remat=False)
    tg = train_lib.leaf_grads(loss, leaves)
    return ((float(jloss), {k: float(v) for k, v in jaux.items()}, _port_leaves_of(jg)),
            (float(loss.detach()), {k: float(v.detach()) for k, v in aux.items()}, tg))


def _batch(cfg, seq: int, b: int = BATCH, seed: int = 0) -> dict:
    """Seeded tokens (b, seq + 1) and, for an encoder-decoder, frames."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, seq + 1)).astype(np.int32)}
    if cfg.is_encoder_decoder:
        out["frames"] = rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return out


def _sds(cfg, seq: int, b: int = BATCH) -> dict:
    """The port's ``{name: (shape, dtype)}`` of ``_batch``."""
    out = {"tokens": ((b, seq + 1), torch.int32)}
    if cfg.is_encoder_decoder:
        out["frames"] = ((b, cfg.encoder_seq, cfg.d_model), torch.float32)
    return out


def _torch(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _profile(arch):
    """The port's no-remat grad-step profile at ``_sds``'s batch, shared by
    the profile test and the remat search."""
    jm, tm, _, _, seq = _setup(arch)
    return train_lib.profile_step(tm, _sds(jm.cfg, seq))


@functools.lru_cache(maxsize=None)
def _grads(arch, seq):
    """``_value_and_grad`` on a seeded batch of ``seq`` tokens (the
    preset's with None), and the port's leaf paths."""
    jm, tm, jparams, np_tree, seq0 = _setup(arch)
    ref, port = _value_and_grad(jm, tm, jparams, np_tree, _batch(jm.cfg, seq or seq0))
    paths = [torch.utils._pytree.keystr(p)
             for p, _ in tree_flatten_with_path(params_from_jax(np_tree))[0]]
    return ref, port, paths


@pytest.mark.parametrize("arch,seq", CASES, ids=lambda v: str(v))
def test_loss_and_gradients_match_the_reference(arch, seq):
    """``value_and_grad`` of the reference's ``loss_fn`` against the port's:
    loss, ``ce``, ``aux`` (zero: no experts) and the whole gradient, every
    leaf together (embedding, norms, the blocks' projections, the SSD's
    per-head vectors, the RG-LRU gates, whisper's encoder).  At S = 96 the
    hybrid's local layers mask keys past their 64-token window."""
    (jloss, jaux, jg), (loss, aux, tg), _ = _grads(arch, seq)
    assert abs(loss - jloss) <= LOSS_TOL * abs(jloss)
    assert abs(aux["ce"] - jaux["ce"]) <= LOSS_TOL * abs(jaux["ce"])
    assert aux["aux"] == jaux["aux"] == 0.0
    assert _vec_rel(tg, jg) <= VEC_TOL


def test_whisper_encoder_leaves_get_the_references_gradients():
    """Every leaf of whisper's encoder (10 a block, 2 blocks here, 12 at
    full size, and its final norm's 2) gets a non-zero gradient equal to
    the reference's, each leaf within 1e-5 relative in L2: the encoder runs
    unwrapped and every decoder layer's cross k/v carry gradient back into
    it.  The decoder's cross-attention ``norm`` (``xnorm`` is applied in its
    place) gets zeros in both packages."""
    (_, _, jg), (_, _, tg), paths = _grads("whisper-small", None)
    enc = [i for i, p in enumerate(paths) if p.startswith("['encoder']")]
    assert len(enc) == 2 * 10 + 2
    for i in enc:
        assert float(tg[i].abs().max()) > 0, paths[i]
        assert _vec_rel([tg[i]], [jg[i]]) <= VEC_TOL, paths[i]
    unused = [i for i, p in enumerate(paths) if "['xattn']['norm']" in p]
    assert len(unused) == 2 * 2
    for i in unused:
        assert not tg[i].any() and not np.asarray(jg[i]).any(), paths[i]


# the reference's chunk scan takes exp(cum_i - cum_j) before it masks i < j:
# over a chunk of 32 or more of the pipeline's tokens the masked entries
# overflow to inf and its gradient turns NaN (``where``'s backward multiplies
# 0 by inf); the port masks before the exponential.  Held at 16 tokens a
# chunk, where the reference's stays finite, and shown apart below.
REF_SAFE_SSD_CHUNK = 16


def _pipeline(cfg, seq):
    enc = cfg.is_encoder_decoder
    return JPipeline(JDataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                 global_batch=BATCH, seed=0,
                                 frames=cfg.encoder_seq if enc else 0,
                                 frame_dim=cfg.d_model if enc else 0))


def test_reference_ssd_gradient_overflows_where_the_ports_does_not():
    """On the pipeline's first batch at the registered 256-token chunk the
    reference's mamba2 gradient has NaN leaves (the embedding, ``a_log``,
    ``dt_bias``), the port's is finite and equals both packages' gradient
    at 16 tokens a chunk, where the reference's is finite."""
    jm, tm, jparams, np_tree, seq = _setup("mamba2-130m")
    batch = _pipeline(jm.cfg, seq).batch_at(0)
    (_, _, jg), (loss, _, tg) = _value_and_grad(jm, tm, jparams, np_tree, batch)
    assert not all(np.isfinite(np.asarray(g)).all() for g in jg)
    assert all(torch.isfinite(g).all() for g in tg)
    safe = _setup("mamba2-130m", REF_SAFE_SSD_CHUNK)
    (_, _, jg16), (loss16, _, tg16) = _value_and_grad(*safe[:4], batch)
    assert abs(loss - loss16) <= LOSS_TOL * abs(loss16)
    assert _vec_rel(tg, jg16) <= VEC_TOL and _vec_rel(tg16, jg16) <= VEC_TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_adamw_steps_match_the_reference(arch):
    """Three steps of ``build_train_step`` from the same weights on the same
    pipeline batches (whisper's with the pipeline's frames), mamba2 at
    ``REF_SAFE_SSD_CHUNK``: losses and the parameters after them."""
    jm, tm, jparams, np_tree, seq = _setup(arch, REF_SAFE_SSD_CHUNK)
    pipe = _pipeline(jm.cfg, seq)
    jstep, _ = jtrain_lib.build_train_step(
        jm, None, JACFG, jtrain_lib.TrainOpts(remat=False, donate=False))
    jstate = {"params": jparams, "opt": jadamw.init(jparams),
              "step": jnp.zeros((), jnp.int32)}
    params = params_from_jax(np_tree)
    state = {"params": params, "opt": adamw.init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    step, _ = train_lib.build_train_step(tm, None, ACFG, train_lib.TrainOpts(remat=False))
    for i in range(3):
        b = pipe.batch_at(i)
        assert ("frames" in b) == jm.cfg.is_encoder_decoder
        jstate, jmet = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        state, m = step(state, _torch(b))
        assert abs(float(m["loss"]) - float(jmet["loss"])) <= LOSS_TOL * abs(float(jmet["loss"]))
    assert _vec_rel(tree_leaves(state["params"]),
                    _port_leaves_of(jstate["params"])) <= VEC_TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_variants_equal_no_remat(arch, monkeypatch):
    """No remat, full remat and the searched policy give the same loss and
    the same gradients to the bit.  Under a policy each pattern group is one
    checkpointed region (the hybrid's rec, rec, local together); the
    hybrid's tail and whisper's encoder run outside any."""
    jm, tm, _, np_tree, seq = _setup(arch)
    jcfg = jm.cfg
    params = params_from_jax(np_tree)
    leaves = [t.requires_grad_() for t in tree_leaves(params)]
    batch = _torch(_batch(jcfg, seq, seed=3))
    regions = []
    inner = policy_mod.checkpoint

    def counting(fn, x, aux, group, *args, **kwargs):
        regions.append([kind for kind, _ in group])
        return inner(fn, x, aux, group, *args, **kwargs)
    monkeypatch.setattr(policy_mod, "checkpoint", counting)

    def run(remat):
        regions.clear()
        loss, _ = tm.loss_fn(params, batch, remat=remat)
        return loss.detach(), train_lib.leaf_grads(loss, leaves), list(regions)

    planned, ev = train_lib.plan_remat_policy(tm, _sds(jcfg, seq), target_ratio=0.9,
                                              max_rounds=1, max_evict=8,
                                              profile=_profile(arch))
    assert planned.mode == "policy" and ev.meta["verified"]
    base_loss, base_grads, none_regions = run(False)
    assert none_regions == []
    for remat in (True, planned):
        loss, g, got = run(remat)
        assert got == [list(jcfg.block_pattern)] * jcfg.n_pattern_groups
        assert torch.equal(loss, base_loss)
        assert all(torch.equal(a, b) for a, b in zip(g, base_grads))


@pytest.mark.parametrize("arch", ARCHS)
def test_grad_step_profile_against_reference(arch):
    """Both packages profile grad(loss) at batch 2 x 33 tokens (whisper's
    with 2 x 64 frames) on abstract inputs: the retained bytes agree to the
    byte, total bytes, the lower bound and the best-fit peak lie in their
    bands, and every block's recompute cost is finite and positive."""
    jm, tm, _, _, seq = _setup(arch)
    jcfg = jm.cfg
    sds = {k: jax.ShapeDtypeStruct(shape, jnp.int32 if dt == torch.int32 else jnp.float32)
           for k, (shape, dt) in _sds(jcfg, seq).items()}
    jprof = jprofile_fn(jax.grad(lambda p, b: jm.loss_fn(p, b, remat=False)[0]),
                        jm.abstract(), sds)
    tprof = _profile(arch)
    assert tprof.retained_bytes == jprof.retained_bytes
    total = tprof.total_bytes / jprof.total_bytes
    lower = tprof.liveness_lower_bound() / jprof.liveness_lower_bound()
    peak = MemoryPlanner().plan(tprof).peak / JPlanner().plan(jprof).peak
    bands = PROFILE_BANDS[arch]
    assert bands["total"][0] <= total <= bands["total"][1], total
    for r in (lower, peak):
        assert bands["peak"][0] <= r <= bands["peak"][1], (lower, peak)
    flops = tprof.meta["block_flops"]
    assert all(0 < flops[b.bid] < float("inf") for b in tprof.blocks)


def test_frames_go_through_the_training_helpers():
    """Whisper's frames through ``profile_step`` (their bytes retained),
    ``max_feasible_batch_planned`` (the largest batch whose step fits) and
    ``build_train_step`` with 2 microbatches, which splits the frames along
    B as it splits the tokens: the same loss and parameters as one batch."""
    jm, tm, _, np_tree, seq = _setup("whisper-small")
    jcfg = jm.cfg
    planner = MemoryPlanner()

    @functools.lru_cache(maxsize=None)
    def prof(b):
        return train_lib.profile_step(tm, _sds(jcfg, seq, b))
    p1, p2 = prof(1), prof(2)
    frame_bytes = jcfg.encoder_seq * jcfg.d_model * 4
    assert p2.retained_bytes - p1.retained_bytes == frame_bytes + (seq + 1) * 4

    def need(b):
        p = prof(b)
        return p.retained_bytes + planner.plan(p).peak
    assert planner.max_feasible_batch_planned(prof, (need(2) + need(3)) // 2, hi=4) == 2
    batch = _torch(_batch(jcfg, seq, b=4, seed=5))
    out = []
    for mb in (1, 2):
        params = params_from_jax(np_tree)
        state = {"params": params, "opt": adamw.init(params),
                 "step": torch.zeros((), dtype=torch.int32)}
        step, _ = train_lib.build_train_step(tm, None, ACFG,
                                             train_lib.TrainOpts(microbatches=mb, remat=False))
        state, m = step(state, batch)
        out.append((float(m["loss"]), tree_leaves(state["params"])))
    assert abs(out[0][0] - out[1][0]) <= LOSS_TOL * abs(out[0][0])
    assert _vec_rel(out[1][1], [t.detach().numpy() for t in out[0][1]]) <= VEC_TOL


def _cli(*argv) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        train_cli.main(list(argv))
    return out.getvalue()


@pytest.mark.parametrize("arch,remat", zip(ARCHS, ("planned", "none", "full")))
def test_train_cli_trains_the_pattern_on_the_cpu(arch, remat):
    """``launch.train --arch <arch> --device cpu --preset tiny`` prints its
    memory plan, with ``planned`` the searched remat plan (down to 0.9 of
    the no-remat peak, which keeps the search short), and two finite
    losses; each policy once."""
    text = _cli("--arch", arch, "--device", "cpu", "--preset", "tiny", "--steps", "2",
                "--log-every", "1", "--remat", remat, "--remat-target", "0.9")
    assert "memory plan: peak=" in text
    assert ("remat plan: planned(recompute=" in text) == (remat == "planned")
    assert f"arch={arch}-tiny" in text and "done: 2 steps" in text
    losses = [float(l.split("loss=")[1].split()[0]) for l in text.splitlines()
              if l.startswith("step ")]
    assert len(losses) == 2 and all(np.isfinite(losses))
