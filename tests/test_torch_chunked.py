"""The port's chunked attention against the reference's: ``attend_chunked``
(the online-softmax scan the reference's ``"auto"`` takes past 8192 tokens)
at the edges that bite (a key count no multiple of the chunk, so the last
chunk's padded keys must be masked, with and without ``causal``; a window
that masks whole chunks of a query row; a query offset; G > 1), the
``"auto"`` switch at 8192, and the tiny qwen2's loss and whole gradient
under ``attention_impl="chunked"`` with a chunk shorter than the sequence.

Tolerances: f32 1e-5 max-abs (both packages sum the same chunks in f32, in
other orders inside a product), bf16 2e-2 (the reference's bf16 tolerance:
P is rounded to bf16 before P·V in both); the loss 1e-5 relative and the
whole gradient 1e-5 relative L2, the training tests' own."""
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
from repro_torch.models import RunOpts, Transformer, params_from_jax
from repro_torch.models import attention as tattn
from torch_port_utils import ref_params, small_cfgs

TOL = {"float32": 1e-5, "bfloat16": 2e-2}

# (Sq, Sk, kv, g, hd, causal, window, q_offset, chunk)
CASES = [
    (19, 19, 2, 7, 16, True, 0, 0, 8),          # Sk % chunk != 0, causal
    (19, 19, 2, 7, 16, False, 0, 0, 8),         # padded keys masked without causal
    (13, 40, 1, 3, 32, False, 0, 0, 16),        # non-causal cross lengths, pad 8
    (37, 37, 2, 4, 16, True, 6, 0, 8),          # window: early chunks fully masked
    (5, 29, 2, 2, 16, True, 0, 24, 8),          # q_offset > 0 (a prefill tail)
    (9, 33, 1, 1, 64, True, 10, 24, 4),         # offset + window, G = 1
    (16, 16, 2, 7, 16, True, 0, 0, 64),         # chunk longer than Sk
]


def _qkv(sq, sk, kv, g, hd, dtype, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((2, sq, kv, g, hd)).astype(np.float32)
    k = rng.standard_normal((2, sk, kv, hd)).astype(np.float32)
    v = rng.standard_normal((2, sk, kv, hd)).astype(np.float32)
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    return ([jnp.asarray(a, jd) for a in (q, k, v)],
            [torch.from_numpy(a).to(td) for a in (q, k, v)])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "sq{}_sk{}_kv{}_g{}_hd{}_{}_w{}_off{}_c{}".format(
    c[0], c[1], c[2], c[3], c[4], "causal" if c[5] else "full", *c[6:]))
def test_attend_chunked_matches_the_reference(case, dtype):
    sq, sk, kv, g, hd, causal, window, q_offset, chunk = case
    (jq, jk, jv), (tq, tk, tv) = _qkv(sq, sk, kv, g, hd, dtype, seed=sq * 100 + sk)
    want = np.asarray(jattn.attend_chunked(jq, jk, jv, causal=causal, window=window,
                                           q_offset=q_offset, chunk=chunk), np.float32)
    got = tattn.attend(tq, tk, tv, impl="chunked", causal=causal, window=window,
                       q_offset=q_offset, chunk=chunk)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    assert np.abs(got.float().numpy() - want).max() <= TOL[dtype]
    assert np.isfinite(got.float().numpy()).all()


def test_attend_chunked_equals_full_attention_in_float64():
    """Where no row is wholly masked, the scan computes softmax attention:
    over float64 inputs it equals ``attend_full`` to the rounding of its f32
    accumulators (m, l and acc are f32, as in the reference)."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((1, 23, 2, 3, 8)))
    k = torch.from_numpy(rng.standard_normal((1, 23, 2, 8)))
    v = torch.from_numpy(rng.standard_normal((1, 23, 2, 8)))
    for causal, window in ((True, 0), (True, 5), (False, 0)):
        full = tattn.attend_full(q, k, v, causal=causal, window=window)
        chunked = tattn.attend_chunked(q, k, v, causal=causal, window=window, chunk=4)
        assert torch.allclose(full, chunked, atol=1e-6, rtol=0)


@pytest.mark.parametrize("seq,impl", [(1, "full"), (8192, "full"), (8193, "chunked"),
                                      (32768, "chunked")])
def test_auto_switches_at_8192_as_the_reference(seq, impl):
    jcfg, tcfg = small_cfgs()
    tm = Transformer(tcfg, RunOpts(attention_impl="auto", use_kernels=False), device="cpu")
    jm = JTransformer(jcfg, JRunOpts(attention_impl="auto"))
    assert tm._attn_impl(seq) == jm._attn_impl(seq, training=True) == impl
    # any other choice is taken at every length
    for other in ("full", "chunked", "kernel", "plain"):
        assert Transformer(tcfg, RunOpts(attention_impl=other),
                           device="cpu")._attn_impl(seq) == other


@pytest.mark.parametrize("attn_chunk", [5, 16])
def test_chunked_training_loss_and_gradient_match_the_reference(attn_chunk):
    """The tiny qwen2 (2 layers, G = 7) at S=16 under the chunked scan in
    both packages: a chunk of 5 leaves a padded last chunk, 16 is one."""
    jcfg, tcfg = small_cfgs()
    jparams, np_tree = ref_params(jcfg)
    jm = JTransformer(jcfg, JRunOpts(attention_impl="chunked", attn_chunk=attn_chunk))
    tm = Transformer(tcfg, RunOpts(attention_impl="chunked", attn_chunk=attn_chunk,
                                   use_kernels=False), device="cpu")
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
    got = torch.cat([g.double().flatten() for g in grads])
    want = torch.cat([torch.as_tensor(np.asarray(t, np.float64)).flatten()
                      for t in tree_leaves(params_from_jax(jax.tree.map(np.asarray, jgrads)))])
    assert float((got - want).norm() / want.norm()) <= 1e-5
