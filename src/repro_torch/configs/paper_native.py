"""Paper-native model configs (Sekiyama et al. §5.1): CNNs + seq2seq.

These are *reduced JAX re-creations* of the paper's benchmark families —
enough structure to produce realistic memory profiles for the Fig. 2/3/4
reproductions (conv/pool/fc pyramids with branching for the inception case;
an LSTM encoder-decoder with variable-length inputs for the reoptimization
experiment).  They are not part of the assigned arch x shape matrix.
"""
from __future__ import annotations

from dataclasses import dataclass

from .base import register, ModelConfig


@dataclass(frozen=True)
class CNNConfig:
    name: str
    stages: tuple        # per stage: (blocks, channels)
    fc: int
    classes: int = 1000
    inception: bool = False   # widen with parallel branches (GoogLeNet-style)
    img: int = 224


CNNS = {
    "paper-alexnet": CNNConfig("paper-alexnet", stages=((1, 64), (1, 192), (3, 384)),
                               fc=4096),
    "paper-resnet50": CNNConfig("paper-resnet50",
                                stages=((3, 256), (4, 512), (6, 1024), (3, 2048)),
                                fc=0),
    "paper-inception-resnet": CNNConfig(
        "paper-inception-resnet",
        stages=((5, 320), (10, 1088), (5, 2080)), fc=0, inception=True, img=299),
}


@dataclass(frozen=True)
class Seq2SeqConfig:
    name: str
    vocab: int = 40_000
    d_model: int = 512
    layers: int = 2
    max_len: int = 50          # training sentences cut to 50 words (paper §5.3)
    infer_len: int = 100       # inference always generates 100 words (paper §5.3)


SEQ2SEQ = Seq2SeqConfig("paper-seq2seq")

# Registered thin stand-ins so `--arch paper-*` resolves through the registry.
for _n in ["paper-alexnet", "paper-resnet50", "paper-inception-resnet"]:
    register(ModelConfig(
        name=_n, family="paper-cnn", n_layers=sum(b for b, _ in CNNS[_n].stages),
        d_model=CNNS[_n].stages[-1][1], n_heads=1, n_kv_heads=1, d_ff=CNNS[_n].fc,
        vocab_size=CNNS[_n].classes, rope=False, block_pattern=("cnn",),
        source="paper §5.1"))

register(ModelConfig(
    name="paper-seq2seq", family="paper-rnn", n_layers=SEQ2SEQ.layers,
    d_model=SEQ2SEQ.d_model, n_heads=1, n_kv_heads=1, d_ff=4 * SEQ2SEQ.d_model,
    vocab_size=SEQ2SEQ.vocab, rope=False, block_pattern=("lstm",),
    source="paper §5.1 (Sutskever et al. 2014)"))
