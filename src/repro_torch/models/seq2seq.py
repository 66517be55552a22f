"""Paper-native seq2seq (Sutskever et al. 2014): the LSTM encoder-decoder
(port of ``repro.models.seq2seq``).

The paper's §5.3 workload: variable-length inputs make the propagation
non-hot across mini-batches, which exercises the reoptimization path
(profiles re-traced per length bucket).  The LSTM runs as a Python loop
over time steps, as the reference's does, so each step's buffers show in
the profile (not ``nn.LSTM``, not cuDNN's fused LSTM).  f32; the tensors'
device decides where it runs.
"""
from __future__ import annotations

import math

import torch

from ..configs.paper_native import Seq2SeqConfig
from ..optim.sgd import sgd_step


def _lstm_params(generator: torch.Generator, d_in: int, d_h: int) -> dict:
    s = 1.0 / math.sqrt(d_in + d_h)
    dev = generator.device
    return {"wx": s * torch.randn((d_in, 4 * d_h), generator=generator, device=dev),
            "wh": s * torch.randn((d_h, 4 * d_h), generator=generator, device=dev),
            "b": torch.zeros((4 * d_h,), device=dev)}


def init_seq2seq(cfg: Seq2SeqConfig, generator: torch.Generator) -> dict:
    """The reference's parameter tree (``embed_src``, ``embed_tgt``,
    ``enc``/``dec`` lists of ``{wx, wh, b}``, ``out`` (d, vocab)) and
    scales, drawn from ``generator`` on its device (not the reference's
    draws: ``seq2seq_params_from_jax`` bridges its init)."""
    d, dev = cfg.d_model, generator.device

    def normal(*shape):
        return 0.02 * torch.randn(shape, generator=generator, device=dev)
    return {
        "embed_src": normal(cfg.vocab, d),
        "embed_tgt": normal(cfg.vocab, d),
        "enc": [_lstm_params(generator, d, d) for _ in range(cfg.layers)],
        "dec": [_lstm_params(generator, d, d) for _ in range(cfg.layers)],
        "out": normal(d, cfg.vocab),
    }


def _lstm_cell(p: dict, x, state):
    """Gates i, f, g, o; the forget gate's bias +1."""
    h, c = state
    z = x @ p["wx"] + h @ p["wh"] + p["b"]
    i, f, g, o = torch.chunk(z, 4, dim=-1)
    c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return h, (h, c)


def _run_lstm(p: dict, xs, state):
    """xs: (S, B, D) -> (hs (S, B, D), final state), one step at a time."""
    hs = []
    for t in range(xs.shape[0]):
        h, state = _lstm_cell(p, xs[t], state)
        hs.append(h)
    return torch.stack(hs), state


def _encode(params: dict, src, cfg: Seq2SeqConfig) -> list:
    """The encoder layers' final (h, c) states; src (B, S_in)."""
    b, d = src.shape[0], cfg.d_model
    x = params["embed_src"][src.t()]                       # (S_in, B, D)
    states = []
    for layer in params["enc"]:
        zeros = torch.zeros((b, d), dtype=x.dtype, device=x.device)
        x, st = _run_lstm(layer, x, (zeros, zeros))
        states.append(st)
    return states


def seq2seq_loss(params: dict, src, tgt, cfg: Seq2SeqConfig):
    """src: (B, S_in), tgt: (B, S_out) integer ids; mean ``-log p`` of
    ``tgt.T[1:]`` under ``logits[:-1]``."""
    y = params["embed_tgt"][tgt.t()]
    for layer, st in zip(params["dec"], _encode(params, src, cfg)):
        y, _ = _run_lstm(layer, y, st)
    logits = y @ params["out"]                              # (S_out, B, V)
    logp = torch.log_softmax(logits[:-1], dim=-1)
    return -logp.gather(-1, tgt.t()[1:].long()[..., None]).mean()


def train_step_fn(cfg: Seq2SeqConfig):
    """``step(params, src, tgt) -> (loss, new_params)``: plain SGD at 0.01,
    the reference's; the leaves of ``params`` must require grad."""
    def step(params, src, tgt):
        return sgd_step(seq2seq_loss(params, src, tgt, cfg), params, 0.01)
    return step


def infer_fn(cfg: Seq2SeqConfig):
    """Greedy generation of ``cfg.infer_len`` tokens from token 0 (the
    paper's 100 words): ``infer(params, src) -> (B, infer_len)`` int64, each
    the first maximum's index, as ``jnp.argmax`` picks it."""
    @torch.no_grad()
    def infer(params, src):
        states = _encode(params, src, cfg)
        tok = torch.zeros((src.shape[0],), dtype=torch.long, device=src.device)
        outs = []
        for _ in range(cfg.infer_len):
            y = params["embed_tgt"][tok]
            new_states = []
            for layer, st in zip(params["dec"], states):
                y, st = _lstm_cell(layer, y, st)
                new_states.append(st)
            states = new_states
            tok = torch.argmax(y @ params["out"], dim=-1)
            outs.append(tok)
        return torch.stack(outs, dim=1)
    return infer
