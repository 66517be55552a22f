"""Plain PyTorch versions of the CUDA kernels (port of ``repro.kernels.ref``).

They run wherever the tensors lie: the kernel wrappers in ``ops`` take them
for CPU tensors, and ``chip_smoke.py`` holds each kernel against them on the
card.  The attention versions compute in float32 and return the input
dtype; the SSD and RG-LRU versions return float32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

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


def ref_paged_attention_split(q, k_pages, v_pages, tables, positions, chunk):
    """The split-KV kernel's algebra in plain PyTorch, for the tests: the
    table's reach cut into chunks of ``chunk`` tokens, a partial (acc, m, l)
    per chunk with masked tokens at p = 0, a chunk wholly past the position
    as the empty partial (0, NEG_INF, 0), then the combine
    ``sum_s acc_s e^(m_s - M) / sum_s l_s e^(m_s - M)`` with M the max over
    the chunks.  Same arguments as ``ref_paged_attention``."""
    b, kv, g, hd = q.shape
    pt = k_pages.shape[1]
    n_tok = tables.shape[1] * pt
    n_split = -(-n_tok // chunk)
    pad = n_split * chunk - n_tok
    idx_t = tables.long()
    k = F.pad(k_pages[idx_t].reshape(b, n_tok, kv, hd).float(), (0, 0, 0, 0, 0, pad))
    v = F.pad(v_pages[idx_t].reshape(b, n_tok, kv, hd).float(), (0, 0, 0, 0, 0, pad))
    s = torch.einsum("bkgh,bskh->bkgs", q.float(), k) / math.sqrt(hd)
    valid = (torch.arange(n_split * chunk, device=q.device)[None, :]
             <= positions.long()[:, None])[:, None, None, :]          # (B,1,1,S)
    s = torch.where(valid, s, NEG_INF).reshape(b, kv, g, n_split, chunk)
    valid = valid.reshape(b, 1, 1, n_split, chunk)
    m = s.amax(-1)                                                   # (B,KV,G,n)
    p = torch.where(valid, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(-1)
    acc = torch.einsum("bkgnc,bnckh->bkgnh", p, v.reshape(b, n_split, chunk, kv, hd))
    m_all = m.amax(-1, keepdim=True)
    w = torch.exp(m - m_all)
    out = (acc * w[..., None]).sum(-2) / torch.clamp((l * w).sum(-1), min=1e-30)[..., None]
    return out.to(q.dtype)


def ref_ssd(x, dta, b_mat, c_mat, h0=None):
    """Sequential SSD recurrence, the oracle of the chunk scan.  x: (B,S,H,P)
    dt-scaled; dta: (B,S,H) log-decays; b/c: (B,S,G,N).  Returns
    (y (B,S,H,P) f32, h (B,H,P,N) f32)."""
    bsz, s, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    rep = h // g
    bh = b_mat.float().repeat_interleave(rep, dim=2)
    ch = c_mat.float().repeat_interleave(rep, dim=2)
    hst = (torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
           if h0 is None else h0.float())
    ys = []
    for t in range(s):
        a = torch.exp(dta[:, t].float())[:, :, None, None]          # (B,H,1,1)
        hst = a * hst + torch.einsum("bhn,bhp->bhpn", bh[:, t], x[:, t].float())
        ys.append(torch.einsum("bhn,bhpn->bhp", ch[:, t], hst))
    y = torch.stack(ys, dim=1) if ys else x.new_zeros((bsz, 0, h, p), dtype=torch.float32)
    return y, hst


def ssd_chunk_scan(x, dta, b_mat, c_mat, *, chunk=256, h0=None):
    """Plain version of the SSD chunk-scan kernel: the core of
    ``ssd_chunked`` after dt-scaling, before the D skip.

    x: (B,S,H,P) dt-scaled; dta: (B,S,H) log-decays; b/c: (B,S,G,N).  Per
    chunk of ``chunk`` tokens: the intra-chunk term ``(L o C B^T) x`` with
    ``L[i,j] = exp(cum_i - cum_j)`` for i >= j, the incoming state's term
    ``exp(cum_i) C_i h``, and the state update.  A ragged tail is padded
    with zero x / dta / B / C, which leaves the state unchanged.  Returns
    (y (B,S,H,P) f32, h_final (B,H,P,N) f32)."""
    bsz, s, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    rep = h // g
    q = min(chunk, s)
    pad = (-s) % q
    x, dta = x.float(), dta.float()
    bf, cf = b_mat.float(), c_mat.float()
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dta = F.pad(dta, (0, 0, 0, pad))
        bf = F.pad(bf, (0, 0, 0, 0, 0, pad))
        cf = F.pad(cf, (0, 0, 0, 0, 0, pad))
    nc = x.shape[1] // q
    xc = x.reshape(bsz, nc, q, h, p)
    dtac = dta.reshape(bsz, nc, q, h)
    bc = bf.reshape(bsz, nc, q, g, n)
    cc = cf.reshape(bsz, nc, q, g, n)
    head_group = torch.arange(h, device=x.device) // rep
    causal = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    hst = (torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
           if h0 is None else h0.float())
    ys = []
    for ci in range(nc):
        xq, bq, cq = xc[:, ci], bc[:, ci], cc[:, ci]
        cum = dtac[:, ci].cumsum(dim=1)                               # (B,q,H)
        li = cum[:, :, None, :] - cum[:, None, :, :]                  # (B,q,q,H)
        # mask before the exponential: cum_i - cum_j > 0 above the diagonal
        l_mat = torch.where(causal[None, :, :, None], li, -math.inf).exp()
        cb = torch.einsum("bign,bjgn->bijg", cq, bq)[..., head_group]
        y_intra = torch.einsum("bijh,bjhp->bihp", cb * l_mat, xq)
        bq_h, cq_h = bq[:, :, head_group], cq[:, :, head_group]       # (B,q,H,N)
        y_inter = torch.einsum("bihn,bhpn->bihp",
                               cq_h * cum.exp()[..., None], hst)
        total = cum[:, -1, :]                                         # (B,H)
        decay_out = (total[:, None, :] - cum).exp()                   # (B,q,H)
        hst = (total.exp()[:, :, None, None] * hst
               + torch.einsum("bjhn,bjhp->bhpn", bq_h * decay_out[..., None], xq))
        ys.append(y_intra + y_inter)
    y = torch.cat(ys, dim=1)[:, :s]
    return y, hst


def ssd_chunk_scan_split(x, dta, b_mat, c_mat, *, chunk=64, h0=None):
    """The SSD kernels' decomposition in plain PyTorch, for the tests; same
    arguments and result as ``ssd_chunk_scan``.  Four steps, as the three
    launches take them:

    1. per (row, chunk): ``cum`` of dta inside the chunk, and ``C B^T``
       once per group;
    2. per (row, chunk, head), every chunk at once: the chunk's own state
       from zero, ``s_c = sum_j exp(cum_last - cum_j) x_j B_j^T``;
    3. per (row, head), over the chunks in order from ``h0``:
       ``h_c = exp(cum_last,c) h_{c-1} + s_c``;
    4. per (row, chunk, head), every chunk at once:
       ``y = (C B^T o L) x + exp(cum) C h_{c-1}``, L masked before the
       exponential.

    A ragged tail is padded with zero x / dta / B / C."""
    bsz, s, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    nc = -(-s // chunk)
    pad = nc * chunk - s
    x = F.pad(x.float(), (0, 0, 0, 0, 0, pad)).reshape(bsz, nc, chunk, h, p)
    dta = F.pad(dta.float(), (0, 0, 0, pad)).reshape(bsz, nc, chunk, h)
    bc = F.pad(b_mat.float(), (0, 0, 0, 0, 0, pad)).reshape(bsz, nc, chunk, g, n)
    cc = F.pad(c_mat.float(), (0, 0, 0, 0, 0, pad)).reshape(bsz, nc, chunk, g, n)
    head_group = torch.arange(h, device=x.device) // (h // g)
    # 1.
    cum = dta.cumsum(dim=2)                                         # (B,nc,Q,H)
    cb = torch.einsum("bcign,bcjgn->bcgij", cc, bc)                 # (B,nc,G,Q,Q)
    # 2.
    last = cum[:, :, -1]                                            # (B,nc,H)
    w = (last[:, :, None] - cum).exp()
    states = torch.einsum("bcjhp,bcjhn->bchpn", x * w[..., None],
                          bc[:, :, :, head_group])                  # (B,nc,H,P,N)
    # 3.
    hst = (torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
           if h0 is None else h0.float())
    h_in = []
    for ci in range(nc):
        h_in.append(hst)
        hst = last[:, ci].exp()[..., None, None] * hst + states[:, ci]
    h_in = torch.stack(h_in, dim=1)                                 # (B,nc,H,P,N)
    # 4.
    causal = torch.ones((chunk, chunk), dtype=torch.bool, device=x.device).tril()
    li = cum.permute(0, 1, 3, 2)[..., :, None] - cum.permute(0, 1, 3, 2)[..., None, :]
    l_mat = torch.where(causal, li, -math.inf).exp()                # (B,nc,H,Q,Q)
    y = torch.einsum("bchij,bcjhp->bcihp", cb[:, :, head_group] * l_mat, x)
    y = y + cum.exp()[..., None] * torch.einsum(
        "bcihn,bchpn->bcihp", cc[:, :, :, head_group], h_in)
    return y.reshape(bsz, nc * chunk, h, p)[:, :s], hst


def ssd_chunked(x, dt, a_log, b_mat, c_mat, d_skip, *, chunk=256, h0=None,
                scan=ssd_chunk_scan):
    """SSD over a full sequence (port of ``repro.models.ssm.ssd_chunked``).

    x: (B,S,H,P) inputs; dt: (B,S,H) softplus'd step sizes; a_log: (H,) with
    A = -exp(a_log); b_mat/c_mat: (B,S,G,N); d_skip: (H,).  The dt scaling
    and ``dta = dt * A`` happen before ``scan`` and the D skip after it;
    ``scan`` is the plain ``ssd_chunk_scan`` unless ``ops.ssd_scan`` passes
    the CUDA kernel's launcher.
    Returns (y: (B,S,H,P) f32, h_final: (B,H,P,N) f32).
    """
    a = -torch.exp(a_log.float())                                   # (H,)
    dta = dt.float() * a                                            # log-decay
    xdt = x.float() * dt.float()[..., None]
    y, h_fin = scan(xdt, dta, b_mat, c_mat, chunk=chunk, h0=h0)
    return y + x.float() * d_skip.float()[None, None, :, None], h_fin


def _linear_scan(a, b, dim: int):
    """Inclusive scan of ``h_t = a_t h_{t-1} + b_t`` along ``dim`` from a
    zero state, log-depth (Hillis-Steele): at offset d every step folds in
    the pair d steps earlier, ``(a, b)_t <- (a_{t-d} a_t, a_t b_{t-d} + b_t)``,
    the combine of the reference's ``associative_scan``.  Returns the
    running products of a and the scanned b."""
    n = a.shape[dim]
    d = 1
    while d < n:
        head_a, tail_a = a.narrow(dim, 0, d), a.narrow(dim, d, n - d)
        prev_a, prev_b = a.narrow(dim, 0, n - d), b.narrow(dim, 0, n - d)
        b = torch.cat([b.narrow(dim, 0, d),
                       torch.addcmul(b.narrow(dim, d, n - d), tail_a, prev_b)], dim)
        a = torch.cat([head_a, tail_a * prev_a], dim)
        d *= 2
    return a, b


def ref_rglru(a, b, h0=None, *, block=256):
    """Plain version of the RG-LRU scan kernel: ``h_t = a_t h_{t-1} + b_t``
    over (B,S,L), with ``h0`` (B,L) folded in as ``a_0 h0``.  Two levels,
    both log-depth: every block of ``block`` steps (0: the whole sequence)
    is scanned from a zero state, then the blocks' carries are scanned and
    added back through each block's running products.  A ragged last block
    is padded with the identity (a = 1, b = 0), as the TPU kernel pads.
    Returns y (B,S,L) f32."""
    a, b = a.float(), b.float()
    bsz, s, l = a.shape
    if h0 is not None:
        b = torch.cat([torch.addcmul(b[:, :1], a[:, :1], h0.float()[:, None]),
                       b[:, 1:]], 1)
    q = s if block <= 0 else min(block, s)
    if q == 0:
        return b.clone()
    pad = (-s) % q
    if pad:
        a = F.pad(a, (0, 0, 0, pad), value=1.0)
        b = F.pad(b, (0, 0, 0, pad))
    n = a.shape[1] // q
    prod, y = _linear_scan(a.reshape(bsz, n, q, l), b.reshape(bsz, n, q, l), 2)
    if n > 1:
        _, carry = _linear_scan(prod[:, :, -1], y[:, :, -1], 1)      # (B,n,L)
        h_in = torch.cat([torch.zeros_like(carry[:, :1]), carry[:, :-1]], 1)
        y = torch.addcmul(y, prod, h_in[:, :, None])
    return y.reshape(bsz, n * q, l)[:, :s]


def ref_rglru_segmented(a, b, h0=None, *, seg):
    """The RG-LRU kernel's sum order in plain PyTorch (tests and
    ``chip_smoke.py`` only; the main path never runs it): S is cut into
    segments of ``seg`` steps, the last padded with the identity (a = 1,
    b = 0).  Phase 1 folds every segment from a zero state into its
    aggregate (P = prod a, Y = the segment's last h); phase 2 folds the
    aggregates in order onto the carry (h0 or 0), each segment taking the
    carry before its own fold as its incoming state; phase 3 re-walks every
    segment from that state.  The kernel groups its segments into
    super-chunks of one segment per warp, and every warp folds the
    super-chunk's aggregates onto its carry in the same order, so the
    grouping changes no operation and needs no parameter here.
    (B,S,L) with S >= 1 -> y (B,S,L) f32."""
    a, b = a.float(), b.float()
    bsz, s, l = a.shape
    n = -(-s // seg)
    pad = n * seg - s
    a = F.pad(a, (0, 0, 0, pad), value=1.0).reshape(bsz, n, seg, l)
    b = F.pad(b, (0, 0, 0, pad)).reshape(bsz, n, seg, l)
    prod, agg = a[:, :, 0], b[:, :, 0]
    for u in range(1, seg):
        agg = torch.addcmul(b[:, :, u], a[:, :, u], agg)
        prod = prod * a[:, :, u]
    carry = a.new_zeros(bsz, l) if h0 is None else h0.float()
    h_in = []
    for k in range(n):
        h_in.append(carry)
        carry = torch.addcmul(agg[:, k], prod[:, k], carry)
    h = torch.stack(h_in, 1)                                    # (B,n,L)
    y = torch.empty_like(a)
    for u in range(seg):
        h = torch.addcmul(b[:, :, u], a[:, :, u], h)
        y[:, :, u] = h
    return y.reshape(bsz, n * seg, l)[:, :s]
