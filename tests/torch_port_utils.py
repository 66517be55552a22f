"""Shared set-up for the ``test_torch_*`` files: small GQA configs with the
head grouping (and the other distinguishing features) of each dense
config the port runs, reference parameters with every zero-initialised
leaf (biases, norm scales) randomised so the ``qkv_bias``, MLP bias,
LayerNorm bias and ``(1 + scale)`` paths carry weight, and the same
parameters converted for the port."""
import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config as jget_config
from repro.models import RunOpts as JRunOpts
from repro.models import Transformer as JTransformer
from repro_torch.configs import get_config as tget_config
from repro_torch.models import RunOpts as TRunOpts
from repro_torch.models import Transformer as TTransformer
from repro_torch.models import params_from_jax

# G = 7 query heads per kv head, as at full width (the ``tiny`` preset has G=1)
SMALL = dict(n_layers=2, d_model=64, n_heads=14, n_kv_heads=2, head_dim=16,
             d_ff=128, vocab_size=512)


# phi4-mini-3.8b's head dim (128) and grouping (G = 3) at a small width
PHI4_SMALL = dict(n_layers=2, d_model=384, n_heads=3, n_kv_heads=1, d_ff=512,
                  vocab_size=512)


# the untied dense configs at a small width, each keeping what sets it apart
# (registered act, norm, qkv_bias, rope_theta and untied head kept as is):
#   mistral-nemo-12b: G = 4, attention width 4 x 16 = 64 against d_model 96
#   starcoder2-15b:   G = 12, LayerNorm, the biased tanh-gelu MLP, q/k/v biases
#   chameleon-34b:    G = 8
DENSE_SMALL = {
    "mistral-nemo-12b": dict(n_layers=2, d_model=96, n_heads=4, n_kv_heads=1,
                             head_dim=16, d_ff=128, vocab_size=512),
    "starcoder2-15b": dict(n_layers=2, d_model=96, n_heads=12, n_kv_heads=1,
                           head_dim=8, d_ff=128, vocab_size=512),
    "chameleon-34b": dict(n_layers=2, d_model=128, n_heads=8, n_kv_heads=1,
                          head_dim=16, d_ff=128, vocab_size=512),
}
# the MoE decoders at a small width, with their registered experts, top-k,
# capacity factor and head (tied or not) kept as is:
#   granite-moe-1b-a400m: E = 32, k = 8, tied, G = 2
#   qwen3-moe-30b-a3b:    E = 128, k = 8, untied, G = 8, attention width
#                         8 x 16 = 128 against d_model 64
MOE_SMALL = {
    "granite-moe-1b-a400m": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                                 head_dim=16, d_ff=32, vocab_size=512),
    "qwen3-moe-30b-a3b": dict(n_layers=2, d_model=64, n_heads=8, n_kv_heads=1,
                              head_dim=16, d_ff=48, vocab_size=512),
}
# layouts whose few heads make the reference's init draw large q and k
# (``_contraction_scaled_qk``)
SCALED_QK = {"phi4-mini-3.8b", *DENSE_SMALL, *MOE_SMALL}


def small_cfgs(dtype: str = "float32", arch: str = "qwen2-0.5b"):
    """(reference config, port config) — equal dataclasses, one per package:
    qwen2-0.5b at ``SMALL``, phi4-mini-3.8b at ``PHI4_SMALL`` or a config of
    ``DENSE_SMALL`` or ``MOE_SMALL`` at its layout."""
    over = {"phi4-mini-3.8b": PHI4_SMALL, **DENSE_SMALL, **MOE_SMALL}.get(arch, SMALL)
    return (jget_config(arch).with_overrides(dtype=dtype, **over),
            tget_config(arch).with_overrides(dtype=dtype, **over))


def ref_params(cfg, seed: int = 0):
    """Reference parameters (jax tree, numpy tree); zero leaves randomised."""
    params = JTransformer(cfg).init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)

    def fill(a):
        a = np.asarray(a)
        if not a.any():
            a = (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        return a

    np_tree = jax.tree.map(fill, params)
    return jax.tree.map(jnp.asarray, np_tree), np_tree


def _contraction_scaled_qk(cfg, np_tree):
    """wq and wk redrawn to std 1/sqrt(d_model), the fan-in of their
    contraction.  The reference's init takes the heads axis of a (D, H, hd)
    projection as its fan-in: at 3 heads over 1 (phi4's layout; the small
    layouts of ``DENSE_SMALL`` too have one kv head) that makes q and k ~10-20 an
    element and the scores ~200, a near one-hot softmax whose near ties
    amplify f32 rounding ~1000x (a float64 run of the port moves such decode
    logits by 1e-4).  Both packages get the same redrawn leaves."""
    rng = np.random.default_rng(cfg.d_model)
    for name in ("wq", "wk"):
        leaf = np_tree["pattern"]["0"]["attn"][name]
        np_tree["pattern"]["0"]["attn"][name] = (
            rng.standard_normal(leaf.shape) / np.sqrt(cfg.d_model)).astype(np.float32)
    return jax.tree.map(jnp.asarray, np_tree), np_tree


def arch_params(arch: str, cfg, seed: int = 0):
    """``ref_params``, with q and k redrawn for the layouts of ``SCALED_QK``."""
    jparams, np_tree = ref_params(cfg, seed)
    if arch in SCALED_QK:
        jparams, np_tree = _contraction_scaled_qk(cfg, np_tree)
    return jparams, np_tree


def models(dtype: str = "float32", *, seed: int = 0, jax_impl: str = "pallas",
           port_impl: str = "kernel", arch: str = "qwen2-0.5b"):
    """(jax model, jax params, port model, port params) on the same weights.
    ``jax_impl="pallas"`` runs the reference's flash kernel in interpret mode
    (tests/conftest.py sets it), the counterpart of the port's kernel path."""
    jcfg, tcfg = small_cfgs(dtype, arch)
    jparams, np_tree = arch_params(arch, jcfg, seed)
    jm = JTransformer(jcfg, JRunOpts(attention_impl=jax_impl))
    tm = TTransformer(tcfg, TRunOpts(attention_impl=port_impl), device="cpu")
    return jm, jparams, tm, tm.load(params_from_jax(np_tree))


def prompt(cfg, rid: int, n: int) -> np.ndarray:
    return np.random.default_rng(1000 + rid).integers(
        0, cfg.vocab_size, size=n).astype(np.int32)


def max_err(jax_array, tensor) -> float:
    return float(np.abs(np.asarray(jax_array, np.float32)
                        - tensor.detach().float().numpy()).max())
