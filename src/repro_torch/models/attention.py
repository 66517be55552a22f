"""Attention blocks: global GQA with RoPE (port of ``repro.models.attention``).

Implementations for full sequences (selected via ``impl``):
  * "full"   — materialized scores, plain PyTorch (the reference's default);
  * "kernel" — the flash-attention kernel wrapper (``kernels.ops``), the
               counterpart of the reference's ``impl="pallas"``.

Decode-time attention has two cache layouts: ``attend_decode`` over the
contiguous per-slot batch cache, and ``attend_paged_decode`` straight off the
paged pool (per-request page tables consumed inside the CUDA kernel).

GQA is computed with separate (kv_heads, group) axes — no materialized
repeat of K/V.
"""
from __future__ import annotations

import torch

from ..kernels import ops as kops

NEG_INF = -1e30


def qkv_project(x, p, cfg):
    """x: (B,S,D) -> q (B,S,kv,g,hd), k/v (B,S,kv,hd)."""
    b, s, d = x.shape
    hd = cfg.resolved_head_dim
    n_kv = cfg.n_kv_heads
    g = cfg.n_heads // n_kv
    q = (x @ p["wq"].reshape(d, -1)).reshape(b, s, cfg.n_heads, hd)
    k = (x @ p["wk"].reshape(d, -1)).reshape(b, s, n_kv, hd)
    v = (x @ p["wv"].reshape(d, -1)).reshape(b, s, n_kv, hd)
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    return q.reshape(b, s, n_kv, g, hd), k, v


def out_project(ctx, p, cfg):
    b, s = ctx.shape[:2]
    ctx = ctx.reshape(b, s, cfg.n_heads * cfg.resolved_head_dim)
    return ctx @ p["wo"].reshape(-1, p["wo"].shape[-1])


def attend_full(q, k, v, *, causal=True, window=0, q_offset=0):
    """q: (B,Sq,kv,g,hd); k/v: (B,Sk,kv,hd).  Scores in the compute dtype,
    softmax in f32 (the reference's ``softmax_dtype=float32``)."""
    hd = q.shape[-1]
    scale = hd ** -0.5
    scores = torch.einsum("bqkgh,bskh->bkgqs", q, k) * scale
    q_pos = q_offset + torch.arange(q.shape[1], device=q.device)
    k_pos = torch.arange(k.shape[1], device=q.device)
    ok = torch.ones((q.shape[1], k.shape[1]), dtype=torch.bool, device=q.device)
    if causal:
        ok &= k_pos[None, :] <= q_pos[:, None]
    if window:
        ok &= k_pos[None, :] > (q_pos[:, None] - window)
    bias = torch.where(ok, 0.0, NEG_INF)
    probs = torch.softmax(scores.float() + bias, dim=-1).to(q.dtype)
    return torch.einsum("bkgqs,bskh->bqkgh", probs, v)


def attend(q, k, v, *, impl="kernel", causal=True, window=0, q_offset=0):
    if impl == "kernel":
        return kops.flash_attention(q, k, v, causal=causal, window=window,
                                    q_offset=q_offset)
    if impl == "full":
        return attend_full(q, k, v, causal=causal, window=window,
                           q_offset=q_offset)
    raise ValueError(f"unknown attention impl {impl!r}")


def attend_decode(q, k_cache, v_cache, cache_pos):
    """q: (B,1,kv,g,hd); caches: (B,C,kv,hd); cache_pos: (B,) per-slot
    positions — row b attends to cache indices <= cache_pos[b]."""
    hd = q.shape[-1]
    scale = hd ** -0.5
    s = torch.einsum("bqkgh,bskh->bkgqs", q, k_cache).float() * scale
    idx = torch.arange(k_cache.shape[1], device=q.device)
    valid = idx[None, :] <= cache_pos.reshape(-1, 1)
    s = s + torch.where(valid[:, None, None, None, :], 0.0, NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bkgqs,bskh->bqkgh", p, v_cache)


def attend_paged_decode(q, k_pages, v_pages, tables, cache_pos):
    """Decode attention straight off the paged pool — no gather, no copy.

    q: (B,1,kv,g,hd); k/v pools: (P,pt,kv,hd) shared by the whole batch;
    tables: (B,maxp) int32 page-index rows (token t of row b lives at
    (tables[b, t//pt], t%pt)); cache_pos: (B,) int32 per-slot positions — row
    b attends to token indices <= cache_pos[b]."""
    ctx = kops.paged_attention(q[:, 0].contiguous(), k_pages, v_pages, tables,
                               cache_pos)
    return ctx[:, None]                                 # (B,1,kv,g,hd)
