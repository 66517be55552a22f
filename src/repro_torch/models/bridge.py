"""Reference parameters -> port parameters.

``params_from_jax`` takes the reference's parameter pytree as numpy arrays
(``jax.tree.map(np.asarray, Transformer.init(key))``) and returns the port's
nested dict: the stacked (G, ...) leading axis of each ``pattern[str(i)]``
is split into one dict per layer and the layers are interleaved in
execution order (group g runs pattern position 0, 1, ... before group
g + 1), followed by the ``tail`` blocks; every other layout is kept as is
(attention: ``wq`` (D,H,hd), ``wo`` (H,hd,D), ``w_up``/``w_gate`` (D,F),
``w_down`` (F,D); MoE: ``w_router`` (D,E), ``w_gate``/``w_up`` (E,D,F),
``w_down`` (E,F,D); mamba2: ``w_in``, ``w_conv``, ``b_conv``, ``dt_bias``,
``a_log``, ``d_skip``, ``norm_scale``, ``w_out``; rec: ``w_branch``,
``w_gate``, ``w_conv``, ``b_conv``, ``w_out``, ``lru``; ``embed``
(padded_vocab, D) and, untied, ``lm_head`` of the same shape; every norm
with all its leaves, a LayerNorm's ``bias`` too; the ungated MLP's
``b_up``/``b_down``; an xattn block's ``xnorm`` and ``xattn``, the second
attention's leaves).  An encoder-decoder's ``encoder`` keeps its keys: its
stacked (encoder_layers, ...) ``blocks`` become a list of one attn block
dict per encoder layer, in order, and its ``final_norm`` is kept as is.
Leaves come back as f32 CPU tensors; ``Transformer.load`` moves and casts
them.
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


def _unstacked(tree):
    if isinstance(tree, dict):
        return {k: _unstacked(v) for k, v in tree.items()}
    return _tensor(tree)


def _first_leaf(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


def params_from_jax(tree) -> dict:
    pattern = tree["pattern"]
    n_pat = len(pattern)
    if set(pattern) != {str(i) for i in range(n_pat)}:
        raise ValueError(f"pattern keys {sorted(pattern)} are not 0..{n_pat - 1}")
    n_groups = np.asarray(_first_leaf(pattern["0"])).shape[0]
    layers = [_layer(pattern[str(i)], g)
              for g in range(n_groups) for i in range(n_pat)]
    tail = tree.get("tail", {})
    layers += [_unstacked(tail[str(i)]) for i in range(len(tail))]
    out = {"embed": _tensor(tree["embed"]),
           "final_norm": _unstacked(tree["final_norm"])}
    if "lm_head" in tree:
        out["lm_head"] = _tensor(tree["lm_head"])
    out["layers"] = layers
    if "encoder" in tree:
        blocks = tree["encoder"]["blocks"]
        n_enc = np.asarray(_first_leaf(blocks)).shape[0]
        out["encoder"] = {"blocks": [_layer(blocks, i) for i in range(n_enc)],
                          "final_norm": _unstacked(tree["encoder"]["final_norm"])}
    return out


def cnn_params_from_jax(tree) -> dict:
    """The reference's CNN parameters (``repro.models.cnn.init_cnn``, as
    numpy arrays) -> the port's: conv kernels HWIO -> OIHW, ``fc1``/``fc2``
    kept (in, out)."""
    out = {}
    for name, a in tree.items():
        a = np.asarray(a)
        out[name] = _tensor(a.transpose(3, 2, 0, 1) if a.ndim == 4 else a)
    return out


def seq2seq_params_from_jax(tree) -> dict:
    """The reference's seq2seq parameters (``repro.models.seq2seq.
    init_seq2seq``, as numpy arrays) -> the port's, layouts kept: both
    embeddings (vocab, d), ``enc``/``dec`` lists of ``{wx, wh, b}``,
    ``out`` (d, vocab)."""
    return {
        "embed_src": _tensor(tree["embed_src"]),
        "embed_tgt": _tensor(tree["embed_tgt"]),
        "enc": [_unstacked(layer) for layer in tree["enc"]],
        "dec": [_unstacked(layer) for layer in tree["dec"]],
        "out": _tensor(tree["out"]),
    }
