"""Decoder over block patterns (port of ``repro.models.transformer`` for
``block_pattern=("attn",)``, the dense GQA decoder and, with ``n_experts``,
the MoE decoder, ``("mamba2",)``, the attention-free SSD stack,
``("rec", "rec", "local")`` with a tail, the Griffin hybrid of RG-LRU blocks
and local attention, and ``("xattn",)`` with an encoder, whisper's
encoder-decoder: non-causal attn blocks over stub frame embeddings plus a
sinusoid table, then decoder blocks of causal self-attention,
cross-attention over the encoder output and the MLP, with no RoPE and no
decoder position embedding, as in the reference).

Entry points, with the reference's contracts:
  * ``loss_fn(params, batch)``        — training forward (+ CE loss, + 0.01
                                        x the MoE aux term) over f32 master
                                        parameters, every pattern
  * ``prefill(params, batch)``        — inference forward, builds the cache
  * ``decode_step(params, cache, t)`` — one-token step over the contiguous
                                        cache or, when the cache carries
                                        ``block_tables``, the paged pool
  * ``forward(params, tokens[, frames])`` — logits for every position

Parameters are a plain nested dict: ``embed`` (padded_vocab, D), tied with
the output head unless an ``lm_head`` of the same shape is present,
``final_norm``, and ``layers``, one dict per layer in execution order with
the reference's layouts (every norm ``{"scale"}`` for RMSNorm, ``{"scale",
"bias"}`` for LayerNorm; attention: ``wq`` (D,H,hd), ``wo`` (H,hd,D), where
H hd may differ from D (mistral-nemo-12b); MLP: ``w_up`` (D,F) and
``w_down`` (F,D) with ``w_gate`` (D,F) when gated, else with ``b_up`` (F,)
and ``b_down`` (D,) when ``qkv_bias`` is set; MoE: ``w_router`` (D,E),
``w_gate``/``w_up`` (E,D,F) and ``w_down`` (E,F,D); mamba2: ``w_in`` (D,proj),
``w_conv`` (K,conv_dim), ``w_out`` (d_inner,D) and per-head vectors; rec:
``w_branch``/``w_gate`` (D,lru), ``w_conv`` (K,lru), ``w_out`` (lru,D), the
gates ``lru`` and an MLP; xattn: ``attn``, ``xnorm``, ``xattn`` (the
attention leaves again), ``mlp_norm`` and ``mlp``), and for an
encoder-decoder ``encoder``: ``blocks``, one attn block dict per encoder
layer, and its ``final_norm``.  Caches are dicts of tensors with a leading layer
axis over the layers of one kind (attention: ``k``/``v`` (L,B,C,kv,hd);
mamba2: ``conv`` (L,B,K-1,conv_dim) and ``ssm`` (L,B,H,P,N) f32; hybrid:
``k``/``v`` over the local layers with C = min(local_window, max_len),
``conv`` (n_rec,B,K-1,lru) and ``h`` (n_rec,B,lru) f32; xattn: ``k``/``v``
and the cross cache ``xk``/``xv`` (L,B,encoder_seq,kv,hd)), so the batch
axis is 1 for every leaf; decode updates them in place and returns the same
tensors.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import is_fake
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..runtime import mesh_ctx
from ..runtime.device import resolve_device
from ..runtime.serve_lib import layer_kinds
from . import attention as attn
from . import moe as moe_lib
from . import rglru as rglru_lib
from . import ssm as ssm_lib
from .layers import (GATED_ACTS, apply_norm, apply_rope, embed_lookup, mlp, rope_angles,
                     sinusoid, sinusoid_freqs, upcast)
from .schema import P, Schema, abstract_params, init_params

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float64": torch.float64}    # float64: a yardstick for f32 runs
# leaves the reference reads in f32 (``astype(float32)``) or casts at each
# use to another dtype than the compute dtype: kept f32 at load.  ``bias`` is
# a LayerNorm's; the MLP's ``b_up``/``b_down`` and the q/k/v biases are cast
# to the compute dtype, as the reference's ``cdt`` casts them.  The MoE
# router is read in f32; the expert leaves are in the compute dtype.
F32_LEAVES = frozenset({"scale", "bias", "norm_scale", "dt_bias", "a_log", "d_skip",
                        "w_conv", "b_conv", "w_a", "b_a", "w_x", "b_x", "lam",
                        "w_router"})
HYBRID_PATTERN = ("rec", "rec", "local")
AUTO_FULL_MAX = 8192                  # "auto": the longest sequence "full" takes


@dataclass(frozen=True)
class RunOpts:
    """Runtime knobs independent of the architecture spec."""
    # kernel (flash CUDA kernel) | full | chunked | plain | auto (the
    # reference's rule: full up to AUTO_FULL_MAX tokens, chunked past them)
    attention_impl: str = "kernel"
    attn_chunk: int = 1024            # KV chunk of the chunked attention
    use_kernels: bool = True          # SSD / RG-LRU scans through the CUDA kernels
    ssd_chunk: int = 256              # chunk length of the plain SSD path
    rglru_block: int = 256            # block length of the plain RG-LRU scan
    loss_impl: str = "full"           # full | chunked (training CE)
    loss_chunk: int = 512             # sequence chunk of the chunked CE
    # float32 | bfloat16: score storage of "full" attention where the
    # reference passes it (training, forward and the encoder; not prefill's
    # self-attention nor cross-attention)
    softmax_dtype: str = "float32"
    # ---- the reference's sharding knobs, read only under a mesh --------------
    cp_attention: bool = False        # context-parallel attention over model
    moe_grouped: bool = False         # hierarchical MoE dispatch per data shard
    sp_residual: bool = False         # Megatron-SP: residual stream seq->model
    ssd_shard_p: bool = False         # shard SSD head_dim P over model (H may not divide)

    def mesh_rules(self) -> Optional[dict]:
        """Activation rules the knobs add to ``mesh_ctx.ACTIVATION_RULES``."""
        rules = {}
        if self.sp_residual:
            rules["seq"] = ("model",)
        if self.ssd_shard_p:
            rules["ssm_p"] = ("model",)
        return rules or None


def _norm_schema(cfg) -> Schema:
    """RMSNorm: a zero ``scale`` (applied as ``1 + scale``); LayerNorm: a
    ``scale`` of ones and a zero ``bias``."""
    if cfg.norm == "rmsnorm":
        return {"scale": P((cfg.d_model,), (None,), init="zeros")}
    return {"scale": P((cfg.d_model,), (None,), init="ones"),
            "bias": P((cfg.d_model,), (None,), init="zeros")}


def _attn_schema(cfg) -> Schema:
    hd = cfg.resolved_head_dim
    s: Schema = {
        "norm": _norm_schema(cfg),
        "wq": P((cfg.d_model, cfg.n_heads, hd), ("embed", "heads", "head_dim")),
        "wk": P((cfg.d_model, cfg.n_kv_heads, hd), ("embed", "kv_heads", "head_dim")),
        "wv": P((cfg.d_model, cfg.n_kv_heads, hd), ("embed", "kv_heads", "head_dim")),
        "wo": P((cfg.n_heads, hd, cfg.d_model), ("heads", "head_dim", "embed"),
                scale=1.0 / math.sqrt(cfg.n_heads * hd)),
    }
    if cfg.qkv_bias:
        s["bq"] = P((cfg.n_heads, hd), ("heads", "head_dim"), init="zeros")
        s["bk"] = P((cfg.n_kv_heads, hd), ("kv_heads", "head_dim"), init="zeros")
        s["bv"] = P((cfg.n_kv_heads, hd), ("kv_heads", "head_dim"), init="zeros")
    return s


def _mamba2_schema(cfg) -> Schema:
    d_in = cfg.d_inner
    g, n, h = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    conv_dim = d_in + 2 * g * n
    return {
        "norm": _norm_schema(cfg),
        "w_in": P((cfg.d_model, 2 * d_in + 2 * g * n + h), ("embed", None)),
        "w_conv": P((cfg.conv_width, conv_dim), (None, None), scale=0.1),
        "b_conv": P((conv_dim,), (None,), init="zeros"),
        "dt_bias": P((h,), (None,), init="zeros"),
        "a_log": P((h,), (None,), init="ones", scale=1.0),
        "d_skip": P((h,), (None,), init="ones"),
        "norm_scale": P((d_in,), (None,), init="zeros"),
        "w_out": P((d_in, cfg.d_model), (None, "embed")),
    }


def _mlp_schema(cfg) -> Schema:
    """The experts' leaves when the config has ``n_experts``; else the gated
    MLP's ``w_gate``, or the ungated one's biases when the config has
    ``qkv_bias`` (starcoder2)."""
    if cfg.n_experts:
        e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
        return {"w_router": P((d, e), ("embed", "experts")),
                "w_gate": P((e, d, f), ("experts", "embed", "expert_mlp")),
                "w_up": P((e, d, f), ("experts", "embed", "expert_mlp")),
                "w_down": P((e, f, d), ("experts", "expert_mlp", "embed"))}
    s: Schema = {"w_up": P((cfg.d_model, cfg.d_ff), ("embed", "mlp")),
                 "w_down": P((cfg.d_ff, cfg.d_model), ("mlp", "embed"))}
    if cfg.act in GATED_ACTS:
        s["w_gate"] = P((cfg.d_model, cfg.d_ff), ("embed", "mlp"))
    elif cfg.qkv_bias:
        s["b_up"] = P((cfg.d_ff,), ("mlp",), init="zeros")
        s["b_down"] = P((cfg.d_model,), (None,), init="zeros")
    return s


def _rec_schema(cfg) -> Schema:
    """Griffin recurrent residual block: RG-LRU mixer + its own MLP."""
    lru, nb = cfg.lru_width, cfg.n_heads      # block-diagonal gates, one per head
    bs = lru // nb
    return {
        "mlp_norm": _norm_schema(cfg),
        "mlp": _mlp_schema(cfg),
        "norm": _norm_schema(cfg),
        "w_branch": P((cfg.d_model, lru), ("embed", "lru")),
        "w_gate": P((cfg.d_model, lru), ("embed", "lru")),
        "w_conv": P((cfg.conv_width, lru), (None, "lru"), scale=0.1),
        "b_conv": P((lru,), ("lru",), init="zeros"),
        "w_out": P((lru, cfg.d_model), ("lru", "embed")),
        "lru": {"w_a": P((nb, bs, bs), ("heads", None, None)),
                "b_a": P((nb, bs), ("heads", None), init="zeros"),
                "w_x": P((nb, bs, bs), ("heads", None, None)),
                "b_x": P((nb, bs), ("heads", None), init="zeros"),
                "lam": P((lru,), ("lru",), init="ones", scale=1.0)},
    }


def _block_schema(kind: str, cfg) -> Schema:
    if kind == "mamba2":
        return _mamba2_schema(cfg)
    if kind == "rec":
        return _rec_schema(cfg)
    s: Schema = {"attn": _attn_schema(cfg)}
    if kind == "xattn":                 # cross-attention over the encoder output
        s["xnorm"] = _norm_schema(cfg)
        s["xattn"] = _attn_schema(cfg)
    s["mlp_norm"] = _norm_schema(cfg)
    s["mlp"] = _mlp_schema(cfg)
    return s


def _unsupported(cfg) -> list[str]:
    """What of ``cfg`` the port does not run yet (empty when it runs it)."""
    out = []
    pattern = tuple(cfg.block_pattern)
    hybrid = pattern == HYBRID_PATTERN
    if hybrid:
        if not set(cfg.tail_pattern) <= {"rec"} or cfg.family != "hybrid":
            out.append(f"hybrid tail {cfg.tail_pattern} / family {cfg.family}")
        if (cfg.act != "geglu" or not cfg.rope or not cfg.local_window
                or not cfg.lru_width or cfg.lru_width % cfg.n_heads):
            out.append(f"hybrid with act {cfg.act} / rope {cfg.rope} / window "
                       f"{cfg.local_window} / lru {cfg.lru_width}")
    elif pattern not in (("attn",), ("mamba2",), ("xattn",)) or cfg.tail_pattern:
        out.append(f"pattern {cfg.block_pattern} + {cfg.tail_pattern}")
    dense = pattern == ("attn",)
    xattn = pattern == ("xattn",)
    if cfg.is_encoder_decoder and not xattn:
        out.append(f"encoder-decoder on pattern {cfg.block_pattern}")
    if xattn and (not cfg.is_encoder_decoder or not cfg.encoder_seq
                  or cfg.norm != "layernorm" or cfg.act != "gelu" or cfg.rope
                  or cfg.local_window or cfg.family == "hybrid"):
        out.append(f"xattn with {cfg.encoder_layers} encoder layers over "
                   f"{cfg.encoder_seq} frames / norm {cfg.norm} / act {cfg.act} / "
                   f"rope {cfg.rope} / window {cfg.local_window} / family {cfg.family}")
    if cfg.n_experts and (not dense or cfg.tail_pattern or cfg.family != "moe"
                          or cfg.norm != "rmsnorm"
                          or not 0 < cfg.top_k <= cfg.n_experts):
        out.append(f"experts on pattern {cfg.block_pattern} + {cfg.tail_pattern} / "
                   f"family {cfg.family} / norm {cfg.norm} / top_k {cfg.top_k}")
    if dense and (cfg.act not in ("swiglu", "gelu") or not cfg.rope):
        out.append(f"act {cfg.act} / rope {cfg.rope}")
    if dense and (cfg.family == "hybrid" or cfg.local_window):
        out.append(f"dense pattern with family {cfg.family} / local window "
                   f"{cfg.local_window}")
    if pattern == ("mamba2",) and (cfg.rope or cfg.family != "ssm"
                                   or not cfg.tie_embeddings):
        out.append(f"mamba2 with rope {cfg.rope} / family {cfg.family} / "
                   f"tied {cfg.tie_embeddings}")
    if cfg.norm not in (("rmsnorm", "layernorm") if dense or xattn else ("rmsnorm",)):
        out.append(f"norm {cfg.norm}")
    if cfg.dtype not in DTYPES:
        out.append(f"dtype {cfg.dtype}")
    return out


def _prefill_pos(true_len, b: int, s: int, device) -> torch.Tensor:
    """A prefill's (B,) int32 cache position: ``s``, or ``true_len`` (an
    int, or a 0-d or (B,) integer tensor, copied on the device)."""
    if isinstance(true_len, torch.Tensor):
        pos = true_len.to(device=device, dtype=torch.int32)
        return pos.reshape(-1).expand(b).clone()
    return torch.full((b,), s if true_len is None else int(true_len),
                      dtype=torch.int32, device=device)


def _last_hidden(x, pos, true_len):
    """(B, 1, D): each row's hidden state at ``pos - 1``, gathered on the
    device (the reference's dynamic slice); the last one without
    ``true_len``.  Under a mesh, on each rank's rows."""
    if true_len is None:
        return x[:, -1:, :]
    axes = ("batch", None, None)
    return mesh_ctx.run_local(
        lambda xl, pl: xl.gather(1, (pl.long() - 1)[:, None, None].expand(-1, 1, xl.shape[-1])),
        (x, pos), (axes, ("batch",)), [(axes, (x.shape[0], 1, x.shape[2]))])


def _embed_rows(table, tokens):
    """``embed_lookup(table, tokens)``.  Under a mesh the table stays split
    over the vocabulary (on ``model``): each rank looks up the tokens its
    rows hold, zeros elsewhere, and the partial sums meet at the next
    shard (the vocab-parallel embedding)."""
    mesh = mesh_ctx.current_mesh()
    if mesh is None:
        return embed_lookup(table, tokens)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    tab = mesh_ctx.shard(table, "vocab", None)
    tok = mesh_ctx.shard(tokens, "batch", "seq")
    # every rank of a vocab split looks up the same tokens (whole there)
    tok = tok.redistribute(mesh, [Replicate() if isinstance(t, Shard) else p
                                  for t, p in zip(tab.placements, tok.placements)])
    lo = mesh_ctx.local_offset(tab, 0)

    def rows(t, k):
        idx = k.long() - lo
        ok = (idx >= 0) & (idx < t.shape[0])
        out = embed_lookup(t, idx.clamp(0, t.shape[0] - 1))
        return out * ok[..., None].to(out.dtype)
    vocab = [isinstance(p, Shard) for p in tab.placements]
    out = [Partial() if v else p for v, p in zip(vocab, tok.placements)]
    tab_grad = [p if v else (Partial() if isinstance(q, Shard) else Replicate())
                for v, p, q in zip(vocab, tab.placements, tok.placements)]
    return local_map(rows, out_placements=out,
                     in_placements=(tab.placements, tok.placements),
                     in_grad_placements=(tab_grad, tok.placements),
                     device_mesh=mesh)(tab, tok)


def _layers(params):
    """The layers' parameters one at a time, each gathered over the FSDP
    axis as it is reached (``mesh_ctx.gather_fsdp``)."""
    return (mesh_ctx.gather_fsdp(p) for p in params["layers"])


def _lm_table(params):
    """The output projection (``lm_head``, else the tied embedding),
    gathered over the FSDP axis."""
    return mesh_ctx.gather_fsdp(params.get("lm_head", params["embed"]))


def _gold_logp(lf, targets, mask):
    """``log_softmax(lf)[gold] * mask`` per position.  Under a mesh it runs
    on each rank's rows (``mesh_ctx.run_local``): DTensor's backward of
    ``gather`` builds its zeros whole, the global logits' size on every
    rank."""
    logp = torch.log_softmax(lf, dim=-1)
    return logp.gather(-1, targets[..., None].long())[..., 0] * mask


def _shard_residual(x):
    """The residual stream's sharding between blocks (the reference's
    ``shard(x, "batch", "seq", "embed")``), and after each residual add
    within one: GSPMD carries a block's closing constraint back through
    its adds, DTensor places forward only, and would otherwise scatter a
    partial sum over the sequence."""
    return mesh_ctx.shard(x, "batch", "seq", "embed")


def _batch_rows(cache):
    """``arange`` over the batch rows of a contiguous (L, B, C, kv, hd) cache
    that this rank holds (all B without a mesh), built once a decode step
    for ``_write_rows``."""
    c = cache.to_local() if mesh_ctx.is_dtensor(cache) else cache
    return torch.arange(c.shape[1], device=c.device)


def _write_rows(cache, i, slot, new, rows):
    """``cache[i, b, slot[b]] = new[b]`` for every row b, in place: a decode
    token's K or V into layer ``i`` of a contiguous (L, B, C, kv, hd) cache;
    ``rows`` is ``_batch_rows(cache)``.  Under a mesh, on this rank's rows
    and heads; where the cache length is split (``shard_cache_len``), only
    the rank holding a row's slot writes it."""
    def put(c, n, sl, offsets):
        idx = sl - offsets[2]
        if offsets[2] == 0 and c.shape[2] == cache.shape[2]:
            c[i, rows, idx] = n
            return
        # rows whose slot another rank holds write back what they read
        # (static shapes, no boolean indexing: the dry run traces this)
        ok = (idx >= 0) & (idx < c.shape[2])
        idx = idx.clamp(0, c.shape[2] - 1)
        c[i, rows, idx] = torch.where(ok.reshape(-1, *([1] * (n.ndim - 1))), n,
                                      c[i, rows, idx])
    mesh_ctx.write_local(cache, [(new, {1: 0, 3: 1, 4: 2}), (slot, {1: 0})], put)


def _write_pages(pages, i, page, off, new):
    """``pages[i, page[b], off[b]] = new[b]`` in place: a decode token's K or
    V into layer ``i`` of the paged pool (L, P, pt, kv, hd).  Under a mesh
    each rank writes every row into its heads of the pool."""
    def put(pg, n, pa, of, offsets):
        del offsets
        pg[i, pa, of] = n
    mesh_ctx.write_local(pages, [(new, {3: 1, 4: 2}), (page, {}), (off, {})], put)


def _write_prefix(cache, i, new, n: int):
    """``cache[i, :, :n] = new[:, :n]`` in place: a prefill's K or V (B, S,
    kv, hd) into layer ``i`` of its (L, B, C, kv, hd) cache."""
    def put(c, nw, offsets):
        del offsets
        c[i, :, :n] = nw[:, :n]
    mesh_ctx.write_local(cache, [(new, {1: 0, 3: 2, 4: 3})], put)


class Transformer:
    def __init__(self, cfg: ModelConfig, opts: RunOpts = RunOpts(),
                 device=None):
        """``device=None`` means the card; raises ``RuntimeError`` without one."""
        unsupported = _unsupported(cfg)
        if unsupported:
            raise ValueError(f"{cfg.name}: the port runs dense and MoE attention "
                             f"decoders, mamba2 stacks, the rec/rec/local "
                             f"hybrid and the xattn encoder-decoder only "
                             f"({'; '.join(unsupported)})")
        self.cfg = cfg
        self.kinds = layer_kinds(cfg)
        self.kind = ("hybrid" if tuple(cfg.block_pattern) == HYBRID_PATTERN
                     else cfg.block_pattern[0])
        self.opts = opts
        self.device = resolve_device(device)
        self.compute_dtype = DTYPES[cfg.dtype]
        # gemma-style embed scaling by sqrt(d) rounded to the compute dtype,
        # the reference's numerics (a product of two bf16 values rounds once
        # either way); a Python number, so that no host tensor is copied in
        # while a CUDA graph is captured and fake tensors (profiles) mix
        # with it
        self._embed_scale = (float(torch.tensor(math.sqrt(cfg.d_model),
                                                dtype=self.compute_dtype))
                             if cfg.family == "hybrid" else None)
        # the encoder-decoder's cross-attention position, the last frame's
        # (every frame valid), made once on the device for the same reason
        self._enc_last = (torch.tensor(cfg.encoder_seq - 1, dtype=torch.int32,
                                       device=self.device)
                          if cfg.is_encoder_decoder else None)
        # the encoder's sinusoid frequencies, made once on the device for the
        # same reason (``_encode``)
        self._enc_freqs = (sinusoid_freqs(cfg.d_model).to(self.device)
                           if cfg.is_encoder_decoder else None)

    # ---- schema / params ------------------------------------------------------
    def schema(self) -> Schema:
        cfg = self.cfg
        s: Schema = {
            "embed": P((cfg.padded_vocab, cfg.d_model), ("vocab", "embed"), scale=0.02),
            "final_norm": _norm_schema(cfg),
        }
        if not cfg.tie_embeddings:
            s["lm_head"] = P((cfg.padded_vocab, cfg.d_model), ("vocab", "embed"),
                             scale=0.02)
        s["layers"] = [_block_schema(kind, cfg) for kind in self.kinds]
        if cfg.is_encoder_decoder:
            s["encoder"] = {"blocks": [_block_schema("attn", cfg)
                                       for _ in range(cfg.encoder_layers)],
                            "final_norm": _norm_schema(cfg)}
        return s

    def init(self, generator: torch.Generator):
        """f32 master parameters drawn from ``generator`` (on its device)."""
        return init_params(self.schema(), generator, dtype=torch.float32)

    def abstract(self, mode):
        """f32 master parameters as fake tensors of ``mode`` (a
        ``FakeTensorMode``) on this model's device: shapes without memory,
        for profiling a full-width step."""
        with mode:
            return abstract_params(self.schema(), self.device, torch.float32)

    def init_loaded(self, generator: torch.Generator):
        """``load(init(generator))`` — the same draws, so the same numbers —
        made one leaf at a time: each f32 master is cast as soon as it is
        drawn, so the peak is the loaded model plus its largest f32 leaf
        rather than every f32 master at once (58 GB for recurrentgemma-9b)."""
        return init_params(self.schema(), generator, dtype=torch.float32,
                           leaf=self._load_leaf)

    def _load_leaf(self, key: str, t: torch.Tensor) -> torch.Tensor:
        dt = torch.float32 if key in F32_LEAVES else self.compute_dtype
        return t.to(device=self.device, dtype=dt)

    def load(self, params):
        """Parameters on this model's device, cast once to the compute dtype.

        The reference casts each f32 weight at every use (``cdt``); one cast
        at load gives the same numbers.  ``F32_LEAVES`` stay f32 because the
        reference reads them in f32 (norm scales, the SSD's per-head vectors)
        or casts them elsewhere than to the compute dtype (the conv weights:
        to the compute dtype in prefill, to f32 in decode).  The RG-LRU gate
        leaves are among them: loaded in bf16 they would compute something
        else than the reference, which reads them in f32 at every use."""
        def rec(tree, key=""):
            if isinstance(tree, dict):
                return {k: rec(v, k) for k, v in tree.items()}
            if isinstance(tree, list):
                return [rec(v) for v in tree]
            return self._load_leaf(key, tree)
        return rec(params)

    # ---- shared pieces -----------------------------------------------------------
    def _norm(self, x, p):
        """The config's norm (RMSNorm or LayerNorm) with the leaves of ``p``."""
        return apply_norm(x, p, self.cfg.norm)

    def _rope(self, positions):
        """(cos, sin) at ``positions``; None without RoPE (whisper), as the
        reference's ``_rope`` returns."""
        if not self.cfg.rope:
            return None
        return rope_angles(positions, self.cfg.resolved_head_dim,
                           self.cfg.rope_theta)

    def _attn_impl(self, seq_len: int) -> str:
        """``RunOpts.attention_impl``, with ``"auto"`` resolved as the
        reference's ``_attn_impl`` resolves it: ``"full"`` up to
        ``AUTO_FULL_MAX`` tokens, ``"chunked"`` past them."""
        impl = self.opts.attention_impl
        if impl != "auto":
            return impl
        return "full" if seq_len <= AUTO_FULL_MAX else "chunked"

    def _attend(self, q, k, v, prefill=False, **masks):
        """Attention over a whole sequence (training, prefill, forward and
        the encoder) by ``_attn_impl`` of its length.  ``prefill`` (a
        decoder's self-attention in ``prefill``) keeps f32 scores whatever
        ``softmax_dtype`` says, as the reference's prefill does."""
        cp = self.opts.cp_attention
        if cp:
            # context parallelism: q's sequence over the model axis, k and v
            # whole there, so the S^2 work splits even where the head
            # counts do not divide the model axis
            q = mesh_ctx.shard(q, "batch", "seq_cp", "kv_heads", None, "head_dim")
        ctx = attn.attend(q, k, v, impl=self._attn_impl(q.shape[1]),
                          chunk=self.opts.attn_chunk,
                          softmax_dtype="float32" if prefill else self.opts.softmax_dtype,
                          seq_axis="seq_cp" if cp else "seq", **masks)
        if cp:
            ctx = mesh_ctx.shard(ctx, "batch", None, "kv_heads", None, "head_dim")
        return ctx

    def _attn_qkv(self, x, p, rope_cs):
        h = self._norm(x, p["attn"]["norm"])
        q, k, v = attn.qkv_project(h, p["attn"], self.cfg)
        if rope_cs is None:
            return q, k, v
        return apply_rope(q, *rope_cs), apply_rope(k, *rope_cs), v

    def _finish_block(self, x, ctx, p, cross=()):
        """Self-attention's residual, then with ``cross`` (``_cross``'s
        arguments) cross-attention's, then the MLP's."""
        x = _shard_residual(x + attn.out_project(ctx, p["attn"], self.cfg))
        if cross:
            x = self._cross(x, p, *cross)
        return self._mlp_residual(x, p)

    def _cross(self, x, p, kx, vx, pos=None):
        """Cross-attention's residual: ``xnorm`` (the encoder output gets
        none), queries from the decoder stream over the encoder's keys and
        values, non-causal: the reference's ``impl="full"`` over a sequence,
        a plain product outside any kernel, or with ``pos`` (the last
        frame's position) ``attend_decode`` over the cross cache.  Its
        scores stay f32 whatever ``softmax_dtype`` says: the reference's
        cross-attention does not pass it."""
        qx = attn.q_project(self._norm(x, p["xnorm"]), p["xattn"], self.cfg)
        ctx = (attn.attend(qx, kx, vx, impl="full", causal=False) if pos is None
               else attn.attend_decode(qx, kx, vx, pos))
        return _shard_residual(x + attn.out_project(ctx, p["xattn"], self.cfg))

    def _encode(self, params, frames):
        """Whisper's encoder over stub frame embeddings (B, F, D): the
        frames in the compute dtype plus the sinusoid table, the encoder's
        attn blocks with non-causal self-attention (the flash kernel under
        ``attention_impl="kernel"``), its final norm.  Each block's leaves go
        through ``load`` first: a no-op over loaded parameters, the casts of
        the f32 masters in training, which the encoder runs unwrapped by
        remat, as the reference's ``_encode`` does."""
        dt = self.compute_dtype
        pos = torch.arange(frames.shape[1], device=frames.device)
        # the frequencies made at init (a CUDA graph capture takes no host
        # copy); a traced profile's fake frames take the host table, a
        # constant, as the reference's jaxpr does
        freqs = None if is_fake(frames) else self._enc_freqs
        x = frames.to(dt) + sinusoid(pos, self.cfg.d_model, dt, freqs)[None]
        x = _shard_residual(x)
        for p in params["encoder"]["blocks"]:
            p = mesh_ctx.gather_fsdp(self.load(p))
            q, k, v = self._attn_qkv(x, p, None)
            ctx = self._attend(q, k, v, causal=False)
            x = self._finish_block(x, ctx, p)
        return self._norm(x, params["encoder"]["final_norm"])

    def _frames(self, frames, what: str):
        if frames is None:
            raise ValueError(f"{what}: {self.cfg.name} is an encoder-decoder and "
                             "needs frames (B, encoder_seq, d_model)")
        return frames

    def _mlp_residual(self, x, p):
        """The MLP's residual; with ``n_experts`` the MoE FFN, whose aux term
        only a loss reads (the reference's steps drop it)."""
        h = self._norm(x, p["mlp_norm"])
        if self.cfg.n_experts:
            return _shard_residual(x + moe_lib.moe_mlp(
                h, p["mlp"], self.cfg, self.compute_dtype,
                grouped=self.opts.moe_grouped, need_aux=False)[0])
        return _shard_residual(x + mlp(h, p["mlp"], self.cfg.act))

    def _embed_in(self, params, tokens):
        """The rows of ``tokens`` in the compute dtype, times ``sqrt(d_model)``
        in that dtype for the hybrid: the reference's ``_embed_in``
        order, so over f32 masters the scale reaches the embedding's
        gradient as it does there (over loaded rows the cast is a no-op)."""
        x = _shard_residual(_embed_rows(params["embed"], tokens))
        x = x.to(self.compute_dtype)
        if self._embed_scale is not None:
            x = x * self._embed_scale
        return x

    def logits(self, params, x):
        out = x @ _lm_table(params).t()
        return mesh_ctx.shard(out, "batch", "seq", "vocab")

    # ---- training -----------------------------------------------------------------
    def _train_block(self, kind, x, p, rope_cs, enc):
        """One block of ``kind`` over f32 master leaves, cast to the compute
        dtype here, inside the checkpointed region of its group: the casts
        are saved or recomputed with the group, and gradients reach the f32
        masters through them, as through the reference's per-use ``cdt``
        (its ``_apply_block``).  Returns ``(x, aux)``: the MoE FFN's Switch
        aux term with ``n_experts``, else None (the reference's
        ``co.get("aux", 0.0)``)."""
        cfg, opts, cdt = self.cfg, self.opts, self.compute_dtype
        p = mesh_ctx.gather_fsdp(self.load(p))
        if kind == "mamba2":
            h = self._norm(x, p["norm"])
            return _shard_residual(x + ssm_lib.mamba2_block(
                h, p, cfg, cdt, chunk=opts.ssd_chunk, use_kernel=False)), None
        if kind == "rec":
            h = self._norm(x, p["norm"])
            x = _shard_residual(x + rglru_lib.recurrent_block(
                h, p, cfg, cdt, use_kernel=False, block=opts.rglru_block))
            return self._mlp_residual(x, p), None
        q, k, v = self._attn_qkv(x, p, rope_cs)
        ctx = self._attend(q, k, v, causal=True,
                           window=cfg.local_window if kind == "local" else 0)
        if kind == "xattn":
            return self._finish_block(x, ctx, p, attn.kv_project(enc, p["xattn"], cfg)), None
        if not cfg.n_experts:
            return self._finish_block(x, ctx, p), None
        x = _shard_residual(x + attn.out_project(ctx, p["attn"], cfg))
        y, aux = moe_lib.moe_mlp(self._norm(x, p["mlp_norm"]), p["mlp"], cfg, cdt,
                                 grouped=opts.moe_grouped, need_aux=True)
        return _shard_residual(x + y), aux

    def _train_group(self, x, aux, group, rope_cs, enc):
        """The blocks of ``group`` ((kind, leaves) pairs) in order, adding
        their aux terms to ``aux`` (None until the first) in layer order."""
        for kind, p in group:
            x, a = self._train_block(kind, x, p, rope_cs, enc)
            if a is not None:
                aux = a if aux is None else aux + a
        return x, aux

    def _run_stack(self, params, x, rope_cs, enc, remat):
        """The reference's ``_run_stack``: each group of ``len(block_pattern)``
        layers under ``RematPolicy.coerce(remat).wrap`` (the hybrid's rec,
        rec, local in one checkpointed region), then the ``tail_pattern``
        layers unwrapped -> (x, the aux terms summed in order, or None: the
        reference's 0 + aux_0 + aux_1 + ..., less the 0)."""
        from ..remat.policy import RematPolicy
        n_pat = len(self.cfg.block_pattern)
        n_body = len(self.kinds) - len(self.cfg.tail_pattern)
        pairs = list(zip(self.kinds, params["layers"]))
        wrapped = RematPolicy.coerce(remat).wrap(self._train_group)
        aux = None
        for i in range(0, n_body, n_pat):
            x, aux = wrapped(x, aux, pairs[i:i + n_pat], rope_cs, enc)
        return self._train_group(x, aux, pairs[n_body:], rope_cs, enc)

    def _train_logits(self, params, x):
        table = _lm_table(params)
        out = x.to(self.compute_dtype) @ table.to(self.compute_dtype).t()
        return mesh_ctx.shard(out, "batch", "seq", "vocab")

    def _pad_bias(self, device):
        cfg = self.cfg
        if cfg.padded_vocab == cfg.vocab_size:
            return None
        return torch.where(torch.arange(cfg.padded_vocab, device=device) < cfg.vocab_size,
                           0.0, -1e30)

    def _nll_sum(self, logits, targets, mask):
        """Masked sum of ``lse - gold`` (the reference's form), as
        ``-log_softmax[gold]``: ``logsumexp``'s backward is one C++ function
        that holds three logits-sized f32 temporaries at once, two more
        than the op-level profile (which frees each after its last use)
        can see; ``log_softmax``'s backward is one op."""
        lf = upcast(logits)
        bias = self._pad_bias(lf.device)
        if bias is not None:
            lf = lf + bias
        rows = mesh_ctx.run_local(_gold_logp, (lf, targets, mask),
                                  (("batch", "seq", None), ("batch", "seq"), ("batch", "seq")),
                                  [(("batch", "seq"), tuple(targets.shape))])
        return -rows.sum()

    def _ce(self, logits, targets, mask):
        """Mean next-token NLL over the mask; padded-vocab logits get -1e30."""
        return self._nll_sum(logits, targets, mask) / mask.sum().clamp(min=1.0)

    def _chunk_nll(self, params, xc, tc, mc):
        return self._nll_sum(self._train_logits(params, xc), tc, mc)

    def _loss_from_h(self, params, x, targets, mask):
        opts = self.opts
        if opts.loss_impl == "full":
            return self._ce(self._train_logits(params, x), targets, mask)
        if opts.loss_impl != "chunked":
            raise ValueError(f"unknown loss_impl {opts.loss_impl!r}")
        # sequence chunks, each checkpointed (the reference's @jax.checkpoint
        # in its scan), so no chunk's logits outlive its own backward
        c = opts.loss_chunk
        pad = (-x.shape[1]) % c
        if pad:
            x = F.pad(x, (0, 0, 0, pad))
            targets = F.pad(targets, (0, pad))
            mask = F.pad(mask, (0, pad))
        tot = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(0, x.shape[1], c):
            tot = tot + checkpoint(self._chunk_nll, params, x[:, i:i + c],
                                   targets[:, i:i + c], mask[:, i:i + c],
                                   use_reentrant=False)
        return tot / mask.sum().clamp(min=1.0)

    def loss_fn(self, params, batch, *, remat=True):
        """batch: {"tokens": (B, S+1) int32[, "mask": (B, S+1)][, "frames":
        (B, F, D)]} over f32 master ``params`` (``init`` or
        ``params_from_jax``, not ``load``'s cast copies) -> (loss, {"ce",
        "aux"}), with ``loss = ce + 0.01 * aux`` and ``aux`` the layers' MoE
        aux terms summed in layer order (zero without experts), as the
        reference's ``_run_stack`` carries it.  An encoder-decoder needs
        ``frames``: its encoder runs first, outside any remat wrap, and every
        decoder layer's cross-attention reads its output.

        ``remat`` is the legacy bool or a ``repro_torch.remat.RematPolicy``:
        each pattern group runs under ``RematPolicy.coerce(remat).wrap``, the
        tail and the encoder unwrapped.  No kernel has a backward, in either
        package, so RunOpts naming a kernel path raise ``ValueError``: the
        SSD and RG-LRU blocks take their plain scans, and attention takes
        ``"auto"`` (the trainer's: full up to 8192 tokens, chunked past
        them), ``"full"``, ``"chunked"`` or ``"plain"``."""
        if self.opts.attention_impl == "kernel" or self.opts.use_kernels:
            raise ValueError("loss_fn: the CUDA kernels have no backward; train with "
                             "RunOpts(attention_impl='auto', use_kernels=False)")
        tokens = batch["tokens"]
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
        mask = batch.get("mask")
        mask = (torch.ones(targets.shape, dtype=torch.float32, device=tokens.device)
                if mask is None else mask[:, 1:].float())
        x = self._embed_in(params, inputs)
        rope_cs = self._rope(torch.arange(inputs.shape[1], device=tokens.device)[None, :])
        enc = (self._encode(params, self._frames(batch.get("frames"), "loss_fn"))
               if self.kind == "xattn" else None)
        x, aux = self._run_stack(params, x, rope_cs, enc, remat)
        x = self._norm(x, params["final_norm"])
        ce = self._loss_from_h(params, x, targets, mask)
        if aux is None:
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return ce + 0.01 * aux, {"ce": ce, "aux": aux}

    # ---- serving: caches -----------------------------------------------------------
    def _local_len(self, max_len: int) -> int:
        """Cache length of a local layer: a rolling window buffer."""
        return min(self.cfg.local_window, max_len)

    def cache_spec(self, batch: int, max_len: int) -> dict:
        """{name: (shape, dtype)} of the contiguous decode cache.  Mamba2
        layers hold O(1) state: the conv window and the f32 SSD state; the
        hybrid's local layers a rolling window of K/V and its rec layers the
        conv window and the f32 RG-LRU state; the encoder-decoder's layers
        also the cross K/V over the encoder's frames, ``xk``/``xv``
        (L,B,encoder_seq,kv,hd), which prefill fills and decode only reads."""
        cfg = self.cfg
        spec = {"pos": ((batch,), torch.int32)}
        if self.kind == "hybrid":
            n_local = self.kinds.count("local")
            n_rec = self.kinds.count("rec")
            kvs = (n_local, batch, self._local_len(max_len), cfg.n_kv_heads,
                   cfg.resolved_head_dim)
            spec["k"] = (kvs, self.compute_dtype)
            spec["v"] = (kvs, self.compute_dtype)
            spec["conv"] = ((n_rec, batch, cfg.conv_width - 1, cfg.lru_width),
                            self.compute_dtype)
            spec["h"] = ((n_rec, batch, cfg.lru_width), torch.float32)
            return spec
        if self.kind == "mamba2":
            conv_dim = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
            spec["conv"] = ((cfg.n_layers, batch, cfg.conv_width - 1, conv_dim),
                            self.compute_dtype)
            spec["ssm"] = ((cfg.n_layers, batch, cfg.ssm_heads,
                            cfg.ssm_head_dim, cfg.ssm_state), torch.float32)
            return spec
        kvs = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
        spec["k"] = (kvs, self.compute_dtype)
        spec["v"] = (kvs, self.compute_dtype)
        if self.kind == "xattn":
            xs = (cfg.n_layers, batch, cfg.encoder_seq, cfg.n_kv_heads,
                  cfg.resolved_head_dim)
            spec["xk"] = (xs, self.compute_dtype)
            spec["xv"] = (xs, self.compute_dtype)
        return spec

    def _cache_leaf(self, name: str, shape: tuple, device, zero: bool = True):
        """A cache leaf in the compute dtype, zero-filled or (``zero=False``,
        for a leaf that is written whole before it is read) left
        uninitialised; under a mesh a DTensor placed by
        ``sharding_rules.cache_specs``."""
        mesh = mesh_ctx.current_mesh()
        if mesh is None:
            make = torch.zeros if zero else torch.empty
            return make(shape, dtype=self.compute_dtype, device=device)
        from torch.distributed.tensor import empty, zeros
        from ..runtime.sharding_rules import cache_specs
        spec = cache_specs({name: shape}, mesh)[name]
        return (zeros if zero else empty)(shape, dtype=self.compute_dtype, device_mesh=mesh,
                                          placements=mesh_ctx.placements(spec, mesh))

    def init_cache(self, batch: int, max_len: int) -> dict:
        return {k: torch.zeros(s, dtype=dt, device=self.device)
                for k, (s, dt) in self.cache_spec(batch, max_len).items()}

    def paged_cache_spec(self, batch: int, *, n_pages: int, page_tokens: int,
                         pages_per_req: int) -> dict:
        """Per-layer k/v *pools* shared by the whole batch, plus one page-table
        row and position per slot.  Pool leaves carry no batch axis."""
        cfg = self.cfg
        pool = (cfg.n_layers, n_pages, page_tokens, cfg.n_kv_heads,
                cfg.resolved_head_dim)
        return {"pos": ((batch,), torch.int32),
                "block_tables": ((batch, pages_per_req), torch.int32),
                "k_pages": (pool, self.compute_dtype),
                "v_pages": (pool, self.compute_dtype)}

    def init_paged_cache(self, batch: int, *, n_pages: int, page_tokens: int,
                         pages_per_req: int) -> dict:
        spec = self.paged_cache_spec(batch, n_pages=n_pages,
                                     page_tokens=page_tokens,
                                     pages_per_req=pages_per_req)
        return {k: torch.zeros(s, dtype=dt, device=self.device)
                for k, (s, dt) in spec.items()}

    # ---- public: decode (one token for every sequence in the batch) --------------
    @torch.no_grad()
    def decode_step(self, params, cache, tokens):
        """tokens: (B,) int32 -> (logits (B, Vp), cache).

        ``cache["pos"]`` is a (B,) per-slot position vector: each row attends
        and writes at its own offset.  A cache carrying ``block_tables``
        selects the paged path.  KV leaves are updated in place; the cross
        cache ``xk``/``xv`` is read at every frame and returned as is."""
        if "block_tables" in cache:
            return self._decode_step_paged(params, cache, tokens)
        if self.kind == "mamba2":
            return self._decode_step_mamba2(params, cache, tokens)
        if self.kind == "hybrid":
            return self._decode_step_hybrid(params, cache, tokens)
        pos = cache["pos"]
        k_cache, v_cache = cache["k"], cache["v"]
        x = self._embed_in(params, tokens[:, None])
        rope_cs = self._rope(pos[:, None])
        slot = pos.clamp(max=k_cache.shape[2] - 1).long()
        rows = _batch_rows(k_cache)
        cross = ()
        for i, p in enumerate(_layers(params)):
            q, k, v = self._attn_qkv(x, p, rope_cs)
            _write_rows(k_cache, i, slot, k[:, 0], rows)
            _write_rows(v_cache, i, slot, v[:, 0], rows)
            ctx = attn.attend_decode(q, k_cache[i], v_cache[i], pos)
            if self.kind == "xattn":
                cross = (cache["xk"][i], cache["xv"][i], self._enc_last)
            x = self._finish_block(x, ctx, p, cross)
        x = self._norm(x, params["final_norm"])
        logits = self.logits(params, x)[:, 0, :]
        return logits, {**cache, "pos": pos + 1}

    def _decode_step_mamba2(self, params, cache, tokens):
        """One token through every mamba2 layer; the conv windows and SSD
        states are replaced in place."""
        x = self._embed_in(params, tokens[:, None])
        for i, p in enumerate(_layers(params)):
            h = self._norm(x, p["norm"])
            y, st = ssm_lib.mamba2_block_decode(
                h[:, 0], {"conv": cache["conv"][i], "ssm": cache["ssm"][i]},
                p, self.cfg, self.compute_dtype)
            x = x + y[:, None, :]
            cache["conv"][i] = st["conv"]
            cache["ssm"][i] = st["ssm"]
        x = self._norm(x, params["final_norm"])
        logits = self.logits(params, x)[:, 0, :]
        return logits, {"pos": cache["pos"] + 1, "conv": cache["conv"],
                        "ssm": cache["ssm"]}

    def _decode_step_hybrid(self, params, cache, tokens):
        """One token through the rec and local layers in order.  A local
        layer writes its K/V at ``pos % C`` of its rolling window and attends
        to the filled part of it; a rec layer replaces its conv window and
        RG-LRU state in place."""
        cfg = self.cfg
        pos = cache["pos"]
        x = self._embed_in(params, tokens[:, None])
        rope_cs = self._rope(pos[:, None])
        slot = (pos % cache["k"].shape[2]).long()
        rows = _batch_rows(cache["k"])
        i_local = i_rec = 0
        for kind, p in zip(self.kinds, _layers(params)):
            if kind == "local":
                k_cache, v_cache = cache["k"][i_local], cache["v"][i_local]
                q, k, v = self._attn_qkv(x, p, rope_cs)
                _write_rows(cache["k"], i_local, slot, k[:, 0], rows)
                _write_rows(cache["v"], i_local, slot, v[:, 0], rows)
                ctx = attn.attend_decode(q, k_cache, v_cache, pos,
                                         window=cfg.local_window, rolling=True)
                x = self._finish_block(x, ctx, p)
                i_local += 1
                continue
            h = self._norm(x, p["norm"])
            y, st = rglru_lib.recurrent_block_decode(
                h[:, 0], {"conv": cache["conv"][i_rec], "h": cache["h"][i_rec]},
                p, cfg, self.compute_dtype)
            x = self._mlp_residual(x + y[:, None, :], p)
            cache["conv"][i_rec] = st["conv"]
            cache["h"][i_rec] = st["h"]
            i_rec += 1
        x = self._norm(x, params["final_norm"])
        logits = self.logits(params, x)[:, 0, :]
        return logits, {"pos": pos + 1, "k": cache["k"], "v": cache["v"],
                        "conv": cache["conv"], "h": cache["h"]}

    def _hybrid_layers(self, params, x, max_len: Optional[int] = None):
        """The rec and local layers over a whole sequence.  With ``max_len``
        also returns the decode cache's leaves: each local layer's last
        ``C = min(local_window, max_len)`` K/V rows in rolling order (position
        t at index t % C; a prompt shorter than C fills indices [0, S) of a
        length-S buffer), each rec layer's conv window and final state."""
        cfg = self.cfg
        s = x.shape[1]
        rope_cs = self._rope(torch.arange(s, device=x.device)[None, :])
        ks, vs, convs, hs = [], [], [], []
        for kind, p in zip(self.kinds, _layers(params)):
            if kind == "local":
                q, k, v = self._attn_qkv(x, p, rope_cs)
                ctx = self._attend(q, k, v, prefill=max_len is not None, causal=True,
                                   window=cfg.local_window)
                x = self._finish_block(x, ctx, p)
                if max_len is not None:
                    c = min(self._local_len(max_len), s)
                    start = s - c
                    ks.append(torch.roll(k[:, start:], start % c, dims=1))
                    vs.append(torch.roll(v[:, start:], start % c, dims=1))
                continue
            h = self._norm(x, p["norm"])
            y, st = rglru_lib.recurrent_block_prefill(
                h, p, cfg, self.compute_dtype, use_kernel=self.opts.use_kernels,
                block=self.opts.rglru_block)
            x = self._mlp_residual(x + y, p)
            convs.append(st["conv"])
            hs.append(st["h"])
        if max_len is None:
            return x, None
        return x, {"k": torch.stack(ks), "v": torch.stack(vs),
                   "conv": torch.stack(convs), "h": torch.stack(hs)}

    def _mamba2_layer(self, x, p):
        """Residual mamba2 block over a whole sequence -> (x, decode state)."""
        h = self._norm(x, p["norm"])
        y, st = ssm_lib.mamba2_block_prefill(
            h, p, self.cfg, self.compute_dtype, chunk=self.opts.ssd_chunk,
            use_kernel=self.opts.use_kernels)
        return _shard_residual(x + y), st

    def _decode_step_paged(self, params, cache, tokens):
        """One decode step against the paged pools: the new token's KV is
        written to (tables[b, pos//pt], pos%pt) and attention reads the pool
        through the table — no gathered copy of any request's KV.  Duplicate
        (page, offset) pairs from runner slot padding write identical
        values."""
        pos = cache["pos"]
        tables = cache["block_tables"]
        k_pages, v_pages = cache["k_pages"], cache["v_pages"]
        pt = k_pages.shape[2]
        x = self._embed_in(params, tokens[:, None])
        rope_cs = self._rope(pos[:, None])
        page = tables.gather(1, (pos // pt).long()[:, None])[:, 0].long()
        off = (pos % pt).long()
        for i, p in enumerate(_layers(params)):
            q, k, v = self._attn_qkv(x, p, rope_cs)
            _write_pages(k_pages, i, page, off, k[:, 0])
            _write_pages(v_pages, i, page, off, v[:, 0])
            ctx = attn.attend_paged_decode(q, k_pages[i], v_pages[i], tables,
                                           pos)
            x = self._finish_block(x, ctx, p)
        x = self._norm(x, params["final_norm"])
        logits = self.logits(params, x)[:, 0, :]
        return logits, {"pos": pos + 1, "block_tables": tables,
                        "k_pages": k_pages, "v_pages": v_pages}

    # ---- public: prefill -----------------------------------------------------------
    @torch.no_grad()
    def prefill(self, params, batch, max_len: Optional[int] = None):
        """batch: {"tokens": (B,S)[, "frames": (B,F,D)][, "true_len": int or
        integer tensor]} -> (last-pos logits, cache).

        An encoder-decoder needs ``frames``, F = ``cfg.encoder_seq`` of them
        (the cross cache's length): the encoder runs once and each layer's
        cross K/V over its output fill ``xk``/``xv``.

        ``true_len`` supports length-bucketed prompts: tokens beyond it are
        padding — the returned logits are read at position ``true_len - 1``
        and the cache position starts there, so the padded tail is masked out
        of every later decode step until it is overwritten.  As the
        reference takes a traced scalar, ``true_len`` may be a 0-d or (B,)
        integer tensor on the model's device: it is then read there, by a
        gather, and never on the host, so one CUDA graph of a padded length
        serves every ``true_len`` (``runtime.serve_lib.build_prefill_step``).
        Only attention caches are pad-safe: a mamba2 or RG-LRU state
        integrates every input token, and MoE capacity counts the pad
        tokens, so callers pass those prompts unpadded.  Mamba2 and rec
        prefill run the SSD and RG-LRU kernels when ``RunOpts.use_kernels``
        is set (the reference's prefill always runs the plain scans; the
        results agree to rounding)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        true_len = batch.get("true_len")
        b, s = tokens.shape
        max_len = max_len or s
        x = self._embed_in(params, tokens)
        pos = _prefill_pos(true_len, b, s, x.device)
        if self.kind == "hybrid":
            x, cache = self._hybrid_layers(params, x, max_len)
            cache["pos"] = pos
            x = self._norm(x, params["final_norm"])
            return self.logits(params, _last_hidden(x, pos, true_len))[:, 0, :], cache
        if self.kind == "mamba2":
            states = []
            for p in _layers(params):
                x, st = self._mamba2_layer(x, p)
                states.append(st)
            cache = {"pos": pos,
                     "conv": torch.stack([st["conv"] for st in states]),
                     "ssm": torch.stack([st["ssm"] for st in states])}
            x = self._norm(x, params["final_norm"])
            return self.logits(params, _last_hidden(x, pos, true_len))[:, 0, :], cache
        rope_cs = self._rope(torch.arange(s, device=tokens.device)[None, :])
        kv_shape = (cfg.n_layers, b, max_len, cfg.n_kv_heads,
                    cfg.resolved_head_dim)
        k_all = self._cache_leaf("k", kv_shape, x.device)
        v_all = self._cache_leaf("v", kv_shape, x.device)
        cache = {"pos": pos, "k": k_all, "v": v_all}
        enc = None
        if self.kind == "xattn":
            frames = self._frames(batch.get("frames"), "prefill")
            if frames.shape[1] != cfg.encoder_seq:
                raise ValueError(f"prefill: {frames.shape[1]} frames; the cross "
                                 f"cache holds encoder_seq={cfg.encoder_seq}")
            enc = self._encode(params, frames)
            xs = (cfg.n_layers, b, cfg.encoder_seq) + kv_shape[3:]
            cache["xk"] = self._cache_leaf("xk", xs, x.device, zero=False)
            cache["xv"] = self._cache_leaf("xv", xs, x.device, zero=False)
        n = min(s, max_len)
        cross = ()
        for i, p in enumerate(_layers(params)):
            q, k, v = self._attn_qkv(x, p, rope_cs)
            ctx = self._attend(q, k, v, prefill=True, causal=True)
            if enc is not None:
                cross = attn.kv_project(enc, p["xattn"], cfg)
                _write_prefix(cache["xk"], i, cross[0], cfg.encoder_seq)
                _write_prefix(cache["xv"], i, cross[1], cfg.encoder_seq)
            x = self._finish_block(x, ctx, p, cross)
            _write_prefix(k_all, i, k, n)
            _write_prefix(v_all, i, v, n)
        x = self._norm(x, params["final_norm"])
        return self.logits(params, _last_hidden(x, pos, true_len))[:, 0, :], cache

    # ---- public: inference forward (no cache) -----------------------------------------
    @torch.no_grad()
    def forward(self, params, tokens, frames=None):
        """Logits at every position; an encoder-decoder reads ``frames``
        (B, F, D) through its encoder first."""
        x = self._embed_in(params, tokens)
        if self.kind == "hybrid":
            x, _ = self._hybrid_layers(params, x)
            return self.logits(params, self._norm(x, params["final_norm"]))
        if self.kind == "mamba2":
            for p in _layers(params):
                x, _ = self._mamba2_layer(x, p)
            return self.logits(params, self._norm(x, params["final_norm"]))
        rope_cs = self._rope(torch.arange(tokens.shape[1],
                                          device=tokens.device)[None, :])
        enc = (self._encode(params, self._frames(frames, "forward"))
               if self.kind == "xattn" else None)
        cross = ()
        for p in _layers(params):
            q, k, v = self._attn_qkv(x, p, rope_cs)
            ctx = self._attend(q, k, v, causal=True)
            if enc is not None:
                cross = attn.kv_project(enc, p["xattn"], self.cfg)
            x = self._finish_block(x, ctx, p, cross)
        x = self._norm(x, params["final_norm"])
        return self.logits(params, x)
