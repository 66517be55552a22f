"""Shared set-up for the ``test_torch_*`` files: one small GQA config with
qwen2-0.5b's head grouping, reference parameters with every zero-initialised
leaf (biases, norm scales) randomised so the ``qkv_bias`` and ``(1 + scale)``
paths carry weight, and the same parameters converted for the port."""
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


def small_cfgs(dtype: str = "float32"):
    """(reference config, port config) — equal dataclasses, one per package."""
    return (jget_config("qwen2-0.5b").with_overrides(dtype=dtype, **SMALL),
            tget_config("qwen2-0.5b").with_overrides(dtype=dtype, **SMALL))


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


def models(dtype: str = "float32", *, seed: int = 0, jax_impl: str = "pallas",
           port_impl: str = "kernel"):
    """(jax model, jax params, port model, port params) on the same weights.
    ``jax_impl="pallas"`` runs the reference's flash kernel in interpret mode
    (tests/conftest.py sets it), the counterpart of the port's kernel path."""
    jcfg, tcfg = small_cfgs(dtype)
    jparams, np_tree = ref_params(jcfg, seed)
    jm = JTransformer(jcfg, JRunOpts(attention_impl=jax_impl))
    tm = TTransformer(tcfg, TRunOpts(attention_impl=port_impl), device="cpu")
    return jm, jparams, tm, tm.load(params_from_jax(np_tree))


def prompt(cfg, rid: int, n: int) -> np.ndarray:
    return np.random.default_rng(1000 + rid).integers(
        0, cfg.vocab_size, size=n).astype(np.int32)


def max_err(jax_array, tensor) -> float:
    return float(np.abs(np.asarray(jax_array, np.float32)
                        - tensor.detach().float().numpy()).max())
