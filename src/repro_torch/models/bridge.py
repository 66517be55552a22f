"""Reference parameters -> port parameters.

``params_from_jax`` takes the reference's parameter pytree as numpy arrays
(``jax.tree.map(np.asarray, Transformer.init(key))``) and returns the port's
nested dict: the stacked (G, ...) leading axis of ``pattern["0"]`` is split
into one dict per layer, every other layout is kept as is (attention: ``wq``
(D,H,hd), ``wo`` (H,hd,D), ``w_up``/``w_gate`` (D,F), ``w_down`` (F,D);
mamba2: ``w_in``, ``w_conv``, ``b_conv``, ``dt_bias``, ``a_log``,
``d_skip``, ``norm_scale``, ``w_out``; tied ``embed`` (padded_vocab, D)).  Leaves come back as f32 CPU tensors; ``Transformer.load``
moves and casts them.
"""
from __future__ import annotations

import numpy as np
import torch


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _layer(tree, i: int):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return _tensor(np.asarray(tree)[i])


def _first_leaf(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


def params_from_jax(tree) -> dict:
    pattern = tree["pattern"]
    if set(pattern) != {"0"} or "tail" in tree or "lm_head" in tree:
        raise ValueError("only tied-embedding single-kind patterns convert")
    n_layers = np.asarray(_first_leaf(pattern["0"])).shape[0]
    return {"embed": _tensor(tree["embed"]),
            "final_norm": {"scale": _tensor(tree["final_norm"]["scale"])},
            "layers": [_layer(pattern["0"], i) for i in range(n_layers)]}
