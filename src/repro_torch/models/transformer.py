"""Dense GQA decoder (port of ``repro.models.transformer`` for
``block_pattern=("attn",)``).

Entry points, with the reference's contracts:
  * ``prefill(params, batch)``        — inference forward, builds the cache
  * ``decode_step(params, cache, t)`` — one-token step over the contiguous
                                        cache or, when the cache carries
                                        ``block_tables``, the paged pool
  * ``forward(params, tokens)``       — logits for every position

Parameters are a plain nested dict: ``embed`` (padded_vocab, D) tied with
the output head, ``final_norm``, and ``layers``, one dict per layer with the
reference's layouts (``wq`` (D,H,hd), ``wo`` (H,hd,D), ``w_up``/``w_gate``
(D,F), ``w_down`` (F,D)).  Caches are dicts of tensors with a leading layer
axis; decode updates their KV leaves in place and returns the same tensors.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from ..configs.base import ModelConfig
from ..runtime.device import resolve_device
from . import attention as attn
from .layers import apply_rope, embed_lookup, mlp, rms_norm, rope_angles
from .schema import P, Schema, init_params

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class RunOpts:
    """Runtime knobs independent of the architecture spec."""
    attention_impl: str = "kernel"    # kernel (flash CUDA kernel) | full


def _attn_schema(cfg) -> Schema:
    hd = cfg.resolved_head_dim
    s: Schema = {
        "norm": {"scale": P((cfg.d_model,), init="zeros")},
        "wq": P((cfg.d_model, cfg.n_heads, hd)),
        "wk": P((cfg.d_model, cfg.n_kv_heads, hd)),
        "wv": P((cfg.d_model, cfg.n_kv_heads, hd)),
        "wo": P((cfg.n_heads, hd, cfg.d_model),
                scale=1.0 / math.sqrt(cfg.n_heads * hd)),
    }
    if cfg.qkv_bias:
        s["bq"] = P((cfg.n_heads, hd), init="zeros")
        s["bk"] = P((cfg.n_kv_heads, hd), init="zeros")
        s["bv"] = P((cfg.n_kv_heads, hd), init="zeros")
    return s


def _block_schema(cfg) -> Schema:
    return {"attn": _attn_schema(cfg),
            "mlp_norm": {"scale": P((cfg.d_model,), init="zeros")},
            "mlp": {"w_up": P((cfg.d_model, cfg.d_ff)),
                    "w_down": P((cfg.d_ff, cfg.d_model)),
                    "w_gate": P((cfg.d_model, cfg.d_ff))}}


class Transformer:
    def __init__(self, cfg: ModelConfig, opts: RunOpts = RunOpts(),
                 device=None):
        """``device=None`` means the card; raises ``RuntimeError`` without one."""
        unsupported = []
        if tuple(cfg.block_pattern) != ("attn",) or cfg.tail_pattern:
            unsupported.append(f"pattern {cfg.block_pattern} + {cfg.tail_pattern}")
        if cfg.is_encoder_decoder or cfg.n_experts:
            unsupported.append("encoder-decoder / MoE")
        if cfg.norm != "rmsnorm" or cfg.act != "swiglu" or not cfg.rope:
            unsupported.append(f"norm {cfg.norm} / act {cfg.act} / rope {cfg.rope}")
        if not cfg.tie_embeddings or cfg.family == "hybrid" or cfg.local_window:
            unsupported.append("untied head / hybrid / local window")
        if cfg.dtype not in DTYPES:
            unsupported.append(f"dtype {cfg.dtype}")
        if unsupported:
            raise ValueError(f"{cfg.name}: the port runs dense attention "
                             f"decoders only ({'; '.join(unsupported)})")
        self.cfg = cfg
        self.opts = opts
        self.device = resolve_device(device)
        self.compute_dtype = DTYPES[cfg.dtype]

    # ---- schema / params ------------------------------------------------------
    def schema(self) -> Schema:
        cfg = self.cfg
        return {
            "embed": P((cfg.padded_vocab, cfg.d_model), scale=0.02),
            "final_norm": {"scale": P((cfg.d_model,), init="zeros")},
            "layers": [_block_schema(cfg) for _ in range(cfg.n_layers)],
        }

    def init(self, generator: torch.Generator):
        """f32 master parameters drawn from ``generator`` (on its device)."""
        return init_params(self.schema(), generator, dtype=torch.float32)

    def load(self, params):
        """Parameters on this model's device, cast once to the compute dtype.

        The reference casts each f32 weight at every use (``cdt``); one cast
        at load gives the same numbers.  Norm scales stay f32 because the
        reference reads them in f32."""
        def rec(tree, key=""):
            if isinstance(tree, dict):
                return {k: rec(v, k) for k, v in tree.items()}
            if isinstance(tree, list):
                return [rec(v) for v in tree]
            dt = torch.float32 if key == "scale" else self.compute_dtype
            return tree.to(device=self.device, dtype=dt)
        return rec(params)

    # ---- shared pieces -----------------------------------------------------------
    def _rope(self, positions):
        return rope_angles(positions, self.cfg.resolved_head_dim,
                           self.cfg.rope_theta)

    def _attn_qkv(self, x, p, rope_cs):
        h = rms_norm(x, p["attn"]["norm"]["scale"])
        q, k, v = attn.qkv_project(h, p["attn"], self.cfg)
        return apply_rope(q, *rope_cs), apply_rope(k, *rope_cs), v

    def _finish_block(self, x, ctx, p):
        x = x + attn.out_project(ctx, p["attn"], self.cfg)
        return x + mlp(rms_norm(x, p["mlp_norm"]["scale"]), p["mlp"])

    def logits(self, params, x):
        return x @ params["embed"].t()

    # ---- serving: caches -----------------------------------------------------------
    def cache_spec(self, batch: int, max_len: int) -> dict:
        """{name: (shape, dtype)} of the contiguous decode cache."""
        cfg = self.cfg
        kvs = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
        return {"pos": ((batch,), torch.int32),
                "k": (kvs, self.compute_dtype), "v": (kvs, self.compute_dtype)}

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
        selects the paged path.  KV leaves are updated in place."""
        if "block_tables" in cache:
            return self._decode_step_paged(params, cache, tokens)
        pos = cache["pos"]
        k_cache, v_cache = cache["k"], cache["v"]
        x = embed_lookup(params["embed"], tokens[:, None])
        rope_cs = self._rope(pos[:, None])
        rows = torch.arange(tokens.shape[0], device=tokens.device)
        slot = pos.clamp(max=k_cache.shape[2] - 1).long()
        for i, p in enumerate(params["layers"]):
            q, k, v = self._attn_qkv(x, p, rope_cs)
            k_cache[i, rows, slot] = k[:, 0]
            v_cache[i, rows, slot] = v[:, 0]
            ctx = attn.attend_decode(q, k_cache[i], v_cache[i], pos)
            x = self._finish_block(x, ctx, p)
        x = rms_norm(x, params["final_norm"]["scale"])
        logits = self.logits(params, x)[:, 0, :]
        return logits, {"pos": pos + 1, "k": k_cache, "v": v_cache}

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
        x = embed_lookup(params["embed"], tokens[:, None])
        rope_cs = self._rope(pos[:, None])
        page = tables.gather(1, (pos // pt).long()[:, None])[:, 0].long()
        off = (pos % pt).long()
        for i, p in enumerate(params["layers"]):
            q, k, v = self._attn_qkv(x, p, rope_cs)
            k_pages[i, page, off] = k[:, 0]
            v_pages[i, page, off] = v[:, 0]
            ctx = attn.attend_paged_decode(q, k_pages[i], v_pages[i], tables,
                                           pos)
            x = self._finish_block(x, ctx, p)
        x = rms_norm(x, params["final_norm"]["scale"])
        logits = self.logits(params, x)[:, 0, :]
        return logits, {"pos": pos + 1, "block_tables": tables,
                        "k_pages": k_pages, "v_pages": v_pages}

    # ---- public: prefill -----------------------------------------------------------
    @torch.no_grad()
    def prefill(self, params, batch, max_len: Optional[int] = None):
        """batch: {"tokens": (B,S)[, "true_len": int]} -> (last-pos logits,
        cache).

        ``true_len`` supports length-bucketed prompts: tokens beyond it are
        padding — the returned logits are read at position ``true_len - 1``
        and the cache position starts there, so the padded tail is masked out
        of every later decode step until it is overwritten."""
        cfg = self.cfg
        tokens = batch["tokens"]
        true_len = batch.get("true_len")
        b, s = tokens.shape
        max_len = max_len or s
        x = embed_lookup(params["embed"], tokens)
        rope_cs = self._rope(torch.arange(s, device=tokens.device)[None, :])
        kv_shape = (cfg.n_layers, b, max_len, cfg.n_kv_heads,
                    cfg.resolved_head_dim)
        k_all = torch.zeros(kv_shape, dtype=self.compute_dtype, device=x.device)
        v_all = torch.zeros_like(k_all)
        n = min(s, max_len)
        for i, p in enumerate(params["layers"]):
            q, k, v = self._attn_qkv(x, p, rope_cs)
            ctx = attn.attend(q, k, v, impl=self.opts.attention_impl,
                              causal=True)
            x = self._finish_block(x, ctx, p)
            k_all[i, :, :n] = k[:, :n]
            v_all[i, :, :n] = v[:, :n]
        pos0 = s if true_len is None else int(true_len)
        cache = {"pos": torch.full((b,), pos0, dtype=torch.int32,
                                   device=x.device),
                 "k": k_all, "v": v_all}
        x = rms_norm(x, params["final_norm"]["scale"])
        last = x[:, pos0 - 1:pos0, :]
        return self.logits(params, last)[:, 0, :], cache

    # ---- public: inference forward (no cache) -----------------------------------------
    @torch.no_grad()
    def forward(self, params, tokens):
        x = embed_lookup(params["embed"], tokens)
        rope_cs = self._rope(torch.arange(tokens.shape[1],
                                          device=tokens.device)[None, :])
        for p in params["layers"]:
            q, k, v = self._attn_qkv(x, p, rope_cs)
            ctx = attn.attend(q, k, v, impl=self.opts.attention_impl,
                              causal=True)
            x = self._finish_block(x, ctx, p)
        x = rms_norm(x, params["final_norm"]["scale"])
        return self.logits(params, x)
