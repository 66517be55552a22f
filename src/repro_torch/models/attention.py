"""Attention blocks: global GQA with RoPE (port of ``repro.models.attention``).

Implementations for full sequences (selected via ``impl``):
  * "full"   — materialized scores, plain PyTorch (the reference's default);
  * "chunked" — the online-softmax loop over KV chunks (``attend_chunked``),
               O(Sq * chunk) live scores: what the reference's ``"auto"``
               takes past 8192 tokens;
  * "kernel" — the flash-attention kernel wrapper (``kernels.ops``), the
               counterpart of the reference's ``impl="pallas"``;
  * "plain"  — the flash kernel's plain version (scores in f32) on any
               device: what the kernel is held against.

Decode-time attention has two cache layouts: ``attend_decode`` over the
contiguous per-slot batch cache, and ``attend_paged_decode`` straight off the
paged pool (per-request page tables consumed inside the CUDA kernel).

GQA is computed with separate (kv_heads, group) axes — no materialized
repeat of K/V, so the kv_heads axis can be model-sharded.

Under a mesh (``runtime.mesh_ctx.use_mesh``) q, k and v are sharded by
their logical axes, and attention over a sequence (every impl, the flash
kernel among them) and the paged kernel run under ``local_map`` on the
heads (and rows) each rank holds: heads are independent, so each rank's
call is the whole computation for its heads.  A q split over the
sequence (context parallelism, or the sequence-parallel residual) passes
each rank's global ``q_offset``, with k and v whole along the sequence.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from ..kernels import ops as kops
from ..runtime import mesh_ctx
from .layers import upcast

NEG_INF = -1e30


def qkv_project(x, p, cfg):
    """x: (B,S,D) -> q (B,S,kv,g,hd), k/v (B,S,kv,hd)."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    n_kv = cfg.n_kv_heads
    g = cfg.n_heads // n_kv
    q = _heads_product(x, p, "q", cfg).reshape(b, s, cfg.n_heads, hd)
    k = _heads_product(x, p, "k", cfg).reshape(b, s, n_kv, hd)
    v = _heads_product(x, p, "v", cfg).reshape(b, s, n_kv, hd)
    return _shard_q(q.reshape(b, s, n_kv, g, hd)), _shard_kv(k), _shard_kv(v)


def _heads_product(x, p, name: str, cfg):
    """``x @ w{name}`` (+ ``b{name}``) as a flat (B, S, heads * hd) product,
    placed as its heads will be (``_place_heads``): the bias is added to
    the flat product, before the placement, since a bias split over its
    heads would split the sum whatever the kv heads divide."""
    y = x @ _flat(p[f"w{name}"])
    if cfg.qkv_bias:
        y = y + mesh_ctx.pin(p[f"b{name}"].reshape(-1))
    return _place_heads(y, cfg.n_kv_heads)


def _flat(w):
    """A (d, heads, hd) projection weight as (d, heads * hd), its gradient
    pinned to the view's placements (``mesh_ctx.pin``)."""
    return mesh_ctx.pin(w.reshape(w.shape[0], -1))


def _place_heads(y, n_kv: int):
    """Place a head projection's flat (B, S, heads * hd) product as its
    heads will be: split over the ``kv_heads`` mesh axes when ``n_kv``
    divides by them, else whole.  DTensor may split the flat dim whatever
    the heads, and then refuses to view it as an uneven split of them (14
    heads over a 16-way model axis).  ``y`` itself without a mesh."""
    if mesh_ctx.current_mesh() is None:
        return y
    split = mesh_ctx.spec_for("kv_heads", dims=(n_kv,))[0] is not None
    return mesh_ctx.shard(y, "batch", "seq", "kv_heads" if split else None)


def _shard_q(q):
    return mesh_ctx.shard(q, "batch", "seq", "kv_heads", None, "head_dim")


def _shard_kv(k):
    return mesh_ctx.shard(k, "batch", "seq", "kv_heads", "head_dim")


def _project(x, p, name: str, heads: int, cfg):
    b, s, _ = x.shape
    return _heads_product(x, p, name, cfg).reshape(b, s, heads, cfg.resolved_head_dim)


def q_project(x, p, cfg):
    """``qkv_project``'s q alone (cross-attention's queries)."""
    q = _project(x, p, "q", cfg.n_heads, cfg)
    return _shard_q(q.reshape(*q.shape[:2], cfg.n_kv_heads, -1, cfg.resolved_head_dim))


def kv_project(x, p, cfg):
    """``qkv_project``'s k and v alone (cross-attention's keys and values,
    from the encoder output)."""
    return (_shard_kv(_project(x, p, "k", cfg.n_kv_heads, cfg)),
            _shard_kv(_project(x, p, "v", cfg.n_kv_heads, cfg)))


def out_project(ctx, p, cfg):
    b, s = ctx.shape[:2]
    ctx = _place_heads(ctx.reshape(b, s, cfg.n_heads * cfg.resolved_head_dim),
                       cfg.n_kv_heads)
    return ctx @ mesh_ctx.pin(p["wo"].reshape(-1, p["wo"].shape[-1]))


def attend_full(q, k, v, *, causal=True, window=0, q_offset=0,
                softmax_dtype="float32"):
    """q: (B,Sq,kv,g,hd); k/v: (B,Sk,kv,hd).  Scores in the compute dtype,
    softmax in f32 (``softmax_dtype="float32"``).

    ``softmax_dtype="bfloat16"`` is the reference's score storage policy:
    the S² scores, the mask bias and ``exp(s - m)`` stay in the scores'
    dtype (bf16 in a bf16 model), the row max ``m`` is taken detached (its
    ``stop_gradient``), the row sum accumulates in f32 and the
    probabilities are ``p / l`` in ``p``'s dtype."""
    if softmax_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"softmax_dtype {softmax_dtype!r}: float32 or bfloat16")
    hd = q.shape[-1]
    scale = hd ** -0.5
    scores = torch.einsum("bqkgh,bskh->bkgqs", q, k) * scale
    q_pos = q_offset + torch.arange(q.shape[1], device=q.device)
    k_pos = torch.arange(k.shape[1], device=q.device)
    # out of place: a selective checkpoint caches ``ok`` and refuses a
    # cached tensor that was later written
    ok = torch.ones((q.shape[1], k.shape[1]), dtype=torch.bool, device=q.device)
    if causal:
        ok = ok & (k_pos[None, :] <= q_pos[:, None])
    if window:
        ok = ok & (k_pos[None, :] > (q_pos[:, None] - window))
    bias = torch.where(ok, 0.0, NEG_INF)
    if softmax_dtype == "float32":
        probs = torch.softmax(upcast(scores) + bias, dim=-1).to(q.dtype)
    else:
        # each S² tensor is dropped once the next exists: this path is there
        # to hold fewer bytes (autograd keeps what its backward needs)
        s = scores + bias.to(scores.dtype)
        del scores
        p = torch.exp(s - s.detach().amax(dim=-1, keepdim=True))
        del s
        l = p.sum(dim=-1, keepdim=True, dtype=torch.float32)
        probs = (p / l.to(p.dtype)).to(q.dtype)
        del p
    return torch.einsum("bkgqs,bskh->bqkgh", probs, v)


def attend_chunked(q, k, v, *, causal=True, window=0, q_offset=0, chunk=1024):
    """The reference's online-softmax scan over KV chunks, a Python loop in
    place of its ``lax.scan``.  K/V are padded to a multiple of ``chunk`` and
    the padded keys masked (``k_pos < sk``) whatever the masks; m, l and acc
    stay f32, P·V runs in q's dtype.  A row whose chunks are all masked so
    far keeps m at NEG_INF: the ``exp(m - m_new)`` of its first unmasked
    chunk wipes what they summed, as in the reference."""
    b, sq, n_kv, g, hd = q.shape
    sk = k.shape[1]
    chunk = min(chunk, sk)
    pad = (-sk) % chunk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    scale = hd ** -0.5
    q_pos = q_offset + torch.arange(sq, device=q.device)
    m = torch.full((b, n_kv, g, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, n_kv, g, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, n_kv, g, sq, hd), dtype=torch.float32, device=q.device)
    for start in range(0, k.shape[1], chunk):
        kb, vb = k[:, start:start + chunk], v[:, start:start + chunk]
        k_pos = start + torch.arange(chunk, device=q.device)
        s = torch.einsum("bqkgh,bskh->bkgqs", q, kb).float() * scale
        ok = (k_pos < sk)[None, :]
        if causal:
            ok = ok & (k_pos[None, :] <= q_pos[:, None])
        if window:
            ok = ok & (k_pos[None, :] > (q_pos[:, None] - window))
        s = s + torch.where(ok, 0.0, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgqs,bskh->bkgqh", p.to(q.dtype), vb).float()
        m = m_new
    ctx = (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
    return ctx.permute(0, 3, 1, 2, 4)                  # (B,Sq,kv,g,hd)


def attend(q, k, v, *, impl="kernel", causal=True, window=0, q_offset=0, chunk=1024,
           softmax_dtype="float32", seq_axis="seq"):
    """``softmax_dtype`` reaches ``"full"`` only, as in the reference.

    Under a mesh every impl runs through ``local_map`` on each rank's rows
    and kv heads (heads are independent, so each rank's call is the whole
    computation for its heads, and the kernel gets plain tensors).
    ``seq_axis`` is q's logical sequence axis (``"seq_cp"`` under context
    parallelism): where it splits q's sequence over a mesh axis, each
    rank's block starts at its own global ``q_offset``, and k and v stay
    whole along the sequence, their kv heads split as q's are."""
    if impl == "kernel":
        fn = kops.flash_attention
    elif impl == "full":
        fn = functools.partial(attend_full, softmax_dtype=softmax_dtype)
    elif impl == "chunked":
        fn = functools.partial(attend_chunked, chunk=chunk)
    elif impl == "plain":
        fn = kops.flash_attention_plain
    else:
        raise ValueError(f"unknown attention impl {impl!r}")
    kw = dict(causal=causal, window=window)
    mesh = mesh_ctx.current_mesh()
    if mesh is None:
        return fn(q, k, v, q_offset=q_offset, **kw)
    q_axes = ("batch", seq_axis, "kv_heads", None, "head_dim")
    spec = mesh_ctx.spec_for(*q_axes, dims=tuple(q.shape))
    kv_axes = ("batch", None, "kv_heads" if spec[2] is not None else None, "head_dim")
    if spec[1] is not None:
        if not isinstance(spec[1], str):
            raise ValueError(f"attend: q's sequence over {spec[1]}: one mesh axis only")
        n = mesh_ctx.axis_sizes(mesh)[spec[1]]
        q_offset = q_offset + mesh_ctx.coordinate(spec[1]) * (q.shape[1] // n)
    return mesh_ctx.run_local(lambda ql, kl, vl: fn(ql, kl, vl, q_offset=q_offset, **kw),
                              (q, k, v), (q_axes, kv_axes, kv_axes), [(q_axes, q.shape)])


def attend_decode(q, k_cache, v_cache, cache_pos, *, window=0, rolling=False):
    """q: (B,1,kv,g,hd); caches: (B,C,kv,hd); cache_pos: (B,) per-slot
    positions — row b attends to cache indices <= cache_pos[b], and with a
    ``window`` to those > cache_pos[b] - window.

    ``rolling=True`` means the cache is a circular window buffer (local
    attention): position t lives at index t % C, so every filled index is
    inside the window and only the fill mask ``idx < min(pos + 1, C)``
    applies.

    Under a mesh whose cache length is whole on each rank, this runs on each
    rank's rows and kv heads of the cache, as the cache is placed (rows
    over ``data`` alone: ``sharding_rules.CACHE_RULES``), by
    ``mesh_ctx.run_local``:
    DTensor's einsum would merge a split batch and split heads into one
    strided dim, whose every later redistribution it plans by a graph
    search, and rows over (pod, data) would gather the cache.  With the
    cache length split (``shard_cache_len``) it runs on DTensors, so the
    softmax and context sums meet across the model axis."""
    split_len = mesh_ctx.is_dtensor(k_cache) and any(
        getattr(pl, "dim", None) == 1 for pl in k_cache.placements)
    if mesh_ctx.current_mesh() is None or split_len:
        return _attend_decode(q, k_cache, v_cache, cache_pos, window, rolling)
    from ..runtime.sharding_rules import CACHE_RULES
    kv = mesh_ctx.spec_for("batch", None, "kv_heads", "head_dim", rules=CACHE_RULES,
                           dims=tuple(k_cache.shape))
    q_spec = mesh_ctx.PartitionSpec(kv[0], None, kv[2], None, None)
    # per-row positions split as the rows; a 0-d one (cross-attention's
    # last frame) is every rank's
    pos_spec = mesh_ctx.PartitionSpec(*[kv[0]][:cache_pos.ndim])
    return mesh_ctx.run_local(
        lambda ql, kl, vl, pl: _attend_decode(ql, kl, vl, pl, window, rolling),
        (q, k_cache, v_cache, cache_pos), (q_spec, kv, kv, pos_spec),
        [(q_spec, q.shape)])


def _attend_decode(q, k_cache, v_cache, cache_pos, window, rolling):
    hd = q.shape[-1]
    scale = hd ** -0.5
    s = torch.einsum("bqkgh,bskh->bkgqs", q, k_cache).float() * scale
    c = k_cache.shape[1]
    idx = torch.arange(c, device=q.device)[None, :]
    pos = cache_pos.reshape(-1, 1)
    if rolling:
        valid = idx < torch.clamp(pos + 1, max=c)
    else:
        valid = idx <= pos
        if window:
            valid &= idx > pos - window
    s = s + torch.where(valid[:, None, None, None, :], 0.0, NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bkgqs,bskh->bqkgh", p, v_cache)


def attend_paged_decode(q, k_pages, v_pages, tables, cache_pos):
    """Decode attention straight off the paged pool — no gather, no copy.

    q: (B,1,kv,g,hd); k/v pools: (P,pt,kv,hd) shared by the whole batch;
    tables: (B,maxp) int32 page-index rows (token t of row b lives at
    (tables[b, t//pt], t%pt)); cache_pos: (B,) int32 per-slot positions — row
    b attends to token indices <= cache_pos[b]."""
    q = q[:, 0]
    q_axes = ("batch", "kv_heads", None, "head_dim")
    pool_axes = (None, None, "kv_heads", "head_dim")
    ctx = mesh_ctx.run_local(
        lambda ql, kp, vp, t, pos: kops.paged_attention(ql.contiguous(), kp, vp, t, pos),
        (q, k_pages, v_pages, tables, cache_pos),
        (q_axes, pool_axes, pool_axes, ("batch", None), ("batch",)),
        [(q_axes, q.shape)])
    return ctx[:, None]                                 # (B,1,kv,g,hd)
