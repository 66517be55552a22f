"""Plain PyTorch versions of the CUDA kernels (port of ``repro.kernels.ref``).

They run wherever the tensors lie: the kernel wrappers in ``ops`` take them
for CPU tensors, and ``chip_smoke.py`` holds each kernel against them on the
card.  Both compute in float32 and return the input dtype.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def ref_attention_bhsd(q, k, v, *, causal=True, window=0, q_offset=0):
    """q: (B,H,Sq,D); k/v: (B,KV,Sk,D).  Materialized-softmax reference."""
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    rep = h // kv
    kf = k.repeat_interleave(rep, dim=1).float()
    vf = v.repeat_interleave(rep, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) / math.sqrt(d)
    q_pos = q_offset + torch.arange(sq, device=q.device)
    k_pos = torch.arange(sk, device=q.device)
    ok = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        ok &= k_pos[None, :] <= q_pos[:, None]
    if window:
        ok &= k_pos[None, :] > (q_pos[:, None] - window)
    s = torch.where(ok[None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype)


def ref_paged_attention(q, k_pages, v_pages, tables, positions):
    """Gather-then-softmax version of the paged decode kernel.

    q: (B,KV,G,hd); k/v pools: (P,pt,KV,hd); tables: (B,maxp) int32;
    positions: (B,) — row b attends to token indices <= positions[b].
    Token t of row b lives at (tables[b, t // pt], t % pt)."""
    b, kv, g, hd = q.shape
    pt = k_pages.shape[1]
    maxp = tables.shape[1]
    idx_t = tables.long()
    k = k_pages[idx_t].reshape(b, maxp * pt, kv, hd).float()
    v = v_pages[idx_t].reshape(b, maxp * pt, kv, hd).float()
    s = torch.einsum("bkgh,bskh->bkgs", q.float(), k) / math.sqrt(hd)
    idx = torch.arange(maxp * pt, device=q.device)
    valid = idx[None, :] <= positions.long()[:, None]
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgs,bskh->bkgh", p, v).to(q.dtype)
