"""``RunOpts.softmax_dtype``: the reference's bf16 score storage in
``attend_full`` (``repro.models.attention.attend_full(softmax_dtype=...)``)
against the port's, forward and gradient, and where the knob reaches.

No reference test covers the storage path, so its tolerances come from
readings over the cases below (numpy-seeded bf16 inputs, two seeds each):
forward max-abs <= 2e-2 (the bf16 attention tolerance; read <= 7.8e-3);
each of dq, dk and dv within 1e-2 relative L2 of the reference's together
(read 3.0e-3 to 3.9e-3: the two autodiffs round the bf16 backward in other
orders), and the port's gradient no further from a float64 softmax
attention of the same inputs than 1.25 x the reference's is (read
0.84-1.01 x).  ``"float32"`` is the old path bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_leaves

from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticPipeline as JPipeline
from repro.models import RunOpts as JRunOpts
from repro.models import Transformer as JTransformer
from repro.models import attention as jattn
from repro_torch.configs import get_config
from repro_torch.models import RunOpts, Transformer, params_from_jax
from repro_torch.models import attention as tattn
from repro_torch.models.layers import upcast
from torch_port_utils import ref_params, small_cfgs

FWD_TOL = 2e-2
GRAD_L2_TOL = 1e-2
YARDSTICK = 1.25

# (Sq, Sk, kv, g, hd, causal, window, q_offset)
CASES = [
    (19, 19, 2, 7, 16, True, 0, 0),         # causal, G = 7
    (19, 19, 2, 7, 16, False, 0, 0),        # non-causal
    (37, 37, 2, 4, 16, True, 6, 0),         # window
    (5, 29, 2, 2, 16, True, 0, 24),         # q_offset (a prefill tail)
    (64, 64, 2, 3, 64, True, 0, 0),         # head dim 64
    (13, 40, 1, 3, 32, False, 0, 0),        # non-causal over other lengths (cross)
]
IDS = ["sq{}_sk{}_kv{}_g{}_hd{}_{}_w{}_off{}".format(
    *c[:5], "causal" if c[5] else "full", *c[6:]) for c in CASES]


def _inputs(case, seed):
    sq, sk, kv, g, hd = case[:5]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((2, sq, kv, g, hd)).astype(np.float32)
    k = rng.standard_normal((2, sk, kv, hd)).astype(np.float32)
    v = rng.standard_normal((2, sk, kv, hd)).astype(np.float32)
    ct = rng.standard_normal((2, sq, kv, g, hd)).astype(np.float32)
    return q, k, v, ct


def _l2(got, want) -> float:
    got = np.concatenate([np.asarray(a, np.float64).ravel() for a in got])
    want = np.concatenate([np.asarray(a, np.float64).ravel() for a in want])
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_bf16_storage_matches_the_reference(case, seed):
    causal, window, q_offset = case[5:]
    masks = dict(causal=causal, window=window, q_offset=q_offset)
    q, k, v, ct = _inputs(case, seed)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want, vjp = jax.vjp(lambda a, b, c: jattn.attend_full(
        a, b, c, softmax_dtype=jnp.bfloat16, **masks), jq, jk, jv)
    want_grads = [np.asarray(g, np.float32) for g in vjp(jnp.asarray(ct, jnp.bfloat16))]

    tq, tk, tv = (torch.from_numpy(a).bfloat16().requires_grad_() for a in (q, k, v))
    tct = torch.from_numpy(ct).bfloat16()
    got = tattn.attend(tq, tk, tv, impl="full", softmax_dtype="bfloat16", **masks)
    assert got.dtype == torch.bfloat16 and got.shape == tq.shape
    grads = [g.float().numpy() for g in torch.autograd.grad(got, (tq, tk, tv), tct)]
    assert np.abs(got.detach().float().numpy() - np.asarray(want, np.float32)).max() <= FWD_TOL
    assert _l2(grads, want_grads) <= GRAD_L2_TOL

    # both against float64 softmax attention of the same (bf16-valued) inputs
    d = [t.detach().double().requires_grad_() for t in (tq, tk, tv)]
    exact = torch.autograd.grad(tattn.attend_full(*d, **masks), d, tct.double())
    exact = [g.numpy() for g in exact]
    assert _l2(grads, exact) <= YARDSTICK * _l2(want_grads, exact)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_float32_is_the_old_path_bit_for_bit(case):
    """The default and ``"float32"`` compute what ``attend_full`` computed
    before the knob: f32 softmax over the upcast scores plus the f32 bias."""
    causal, window, q_offset = case[5:]
    q, k, v, _ = (torch.from_numpy(a).bfloat16() for a in _inputs(case, 0))
    scores = torch.einsum("bqkgh,bskh->bkgqs", q, k) * q.shape[-1] ** -0.5
    q_pos = q_offset + torch.arange(q.shape[1])
    k_pos = torch.arange(k.shape[1])
    ok = torch.ones((q.shape[1], k.shape[1]), dtype=torch.bool)
    if causal:
        ok = ok & (k_pos[None, :] <= q_pos[:, None])
    if window:
        ok = ok & (k_pos[None, :] > (q_pos[:, None] - window))
    probs = torch.softmax(upcast(scores) + torch.where(ok, 0.0, tattn.NEG_INF), dim=-1)
    old = torch.einsum("bkgqs,bskh->bqkgh", probs.to(q.dtype), v)
    masks = dict(causal=causal, window=window, q_offset=q_offset)
    assert torch.equal(tattn.attend_full(q, k, v, **masks), old)
    assert torch.equal(tattn.attend(q, k, v, impl="full", softmax_dtype="float32", **masks),
                       old)


def test_storage_leaves_the_other_impls_alone():
    """``"chunked"`` and ``"plain"`` take no ``softmax_dtype``, as the
    reference's ``"chunked"`` and ``"pallas"``; an unknown dtype raises."""
    q, k, v, _ = (torch.from_numpy(a).bfloat16() for a in _inputs(CASES[2], 0))
    for impl in ("chunked", "plain"):
        kw = dict(impl=impl, causal=True, window=6, chunk=8)
        assert torch.equal(tattn.attend(q, k, v, **kw),
                           tattn.attend(q, k, v, softmax_dtype="bfloat16", **kw))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tattn.attend_full(q, k, v, softmax_dtype="float16")


def _calls(monkeypatch):
    seen = []
    real = tattn.attend_full

    def spy(q, k, v, **kw):
        seen.append((q.shape[1], k.shape[1], kw.get("causal", True),
                     kw.get("softmax_dtype", "float32")))
        return real(q, k, v, **kw)
    monkeypatch.setattr(tattn, "attend_full", spy)
    return seen


def test_softmax_dtype_reaches_where_the_reference_passes_it(monkeypatch):
    """whisper's smoke config (bf16): the loss and ``forward`` pass it to the
    encoder's and the decoder's self-attention, ``prefill`` only to the
    encoder's (the reference's ``apply_prefill`` does not pass it), and
    cross-attention never (the reference's ``attend(qx, kx, vx,
    impl="full", causal=False)``)."""
    cfg = get_config("whisper-small").smoke().with_overrides(dtype="bfloat16")
    model = Transformer(cfg, RunOpts(attention_impl="auto", use_kernels=False,
                                     softmax_dtype="bfloat16"), device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    frames = torch.zeros((1, cfg.encoder_seq, cfg.d_model))
    tokens = torch.zeros((1, 9), dtype=torch.int32)
    enc = [(cfg.encoder_seq, cfg.encoder_seq, False, "bfloat16")] * cfg.encoder_layers
    cross = (8, cfg.encoder_seq, False, "float32")
    seen = _calls(monkeypatch)
    model.loss_fn(params, {"tokens": tokens, "frames": frames}, remat=False)
    assert seen == enc + [(8, 8, True, "bfloat16"), cross] * cfg.n_layers
    seen.clear()
    loaded = model.load(params)
    model.forward(loaded, tokens[:, :8], frames)
    assert seen == enc + [(8, 8, True, "bfloat16"), cross] * cfg.n_layers
    seen.clear()
    model.prefill(loaded, {"tokens": tokens[:, :8], "frames": frames})
    assert seen == enc + [(8, 8, True, "float32"), cross] * cfg.n_layers


def test_hybrid_prefill_keeps_float32_and_forward_takes_the_knob(monkeypatch):
    cfg = get_config("recurrentgemma-9b").smoke()
    model = Transformer(cfg, RunOpts(attention_impl="full", use_kernels=False,
                                     softmax_dtype="bfloat16"), device="cpu")
    params = model.load(model.init(torch.Generator().manual_seed(0)))
    tokens = torch.zeros((1, 12), dtype=torch.int32)
    seen = _calls(monkeypatch)
    model.forward(params, tokens)
    n_local = model.kinds.count("local")
    assert n_local and seen == [(12, 12, True, "bfloat16")] * n_local
    seen.clear()
    model.prefill(params, {"tokens": tokens})
    assert seen == [(12, 12, True, "float32")] * n_local


def test_training_under_storage_matches_the_reference():
    """The tiny qwen2 (2 layers, G = 7) in f32 under ``"full"`` with
    ``softmax_dtype="bfloat16"`` in both packages: the storage dtype is the
    scores' (f32 here), so the two-pass softmax agrees to f32 rounding: the
    loss within 1e-5 relative and the whole gradient within 1e-5 relative
    L2, the training tests' own tolerances."""
    jcfg, tcfg = small_cfgs()
    jparams, np_tree = ref_params(jcfg)
    jm = JTransformer(jcfg, JRunOpts(attention_impl="full", softmax_dtype="bfloat16"))
    tm = Transformer(tcfg, RunOpts(attention_impl="full", use_kernels=False,
                                   softmax_dtype="bfloat16"), device="cpu")
    batch = JPipeline(JDataConfig(vocab_size=jcfg.vocab_size, seq_len=16,
                                  global_batch=4, seed=0)).batch_at(0)
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p, b: jm.loss_fn(p, b, remat=False), has_aux=True)(
            jparams, {"tokens": jnp.asarray(batch["tokens"])})
    params = params_from_jax(np_tree)
    leaves = [t.requires_grad_() for t in tree_leaves(params)]
    loss, _ = tm.loss_fn(params, {"tokens": torch.from_numpy(batch["tokens"])},
                         remat=False)
    grads = torch.autograd.grad(loss, leaves)
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-5 * abs(float(jloss))
    want = [np.asarray(t) for t in tree_leaves(params_from_jax(jax.tree.map(np.asarray,
                                                                            jgrads)))]
    assert _l2([g.numpy() for g in grads], want) <= 1e-5
