"""Mixture-of-Experts FFN: token-choice top-k, capacity-bounded, sort-based
(port of ``repro.models.moe``).

Tokens are stably argsorted by expert id, each gets its position within its
expert by ``searchsorted``, tokens past the capacity
C = ceil(T*k/E * capacity_factor) (at least 8, rounded up to 8) are dropped,
and the experts run as three batched products over an (E, C, d) dispatch
buffer with SiLU gating, whatever ``cfg.act`` says (the reference's MoE FFN
is always SwiGLU).  The router and its softmax are f32; the Switch aux term
is ``E * sum(mean(probs) * frac)``.

Every shape is static (no ``.item()``, ``nonzero`` or boolean-mask
indexing), so a decode step that runs it can be captured in a CUDA graph.
Two writes differ from the reference's scatter-adds, to be deterministic on
the card where adds collide in no fixed order; both give the reference's
values:
  * dispatch: the reference scatter-adds every assignment into the buffer,
    the dropped ones masked to zero at a clamped slot; here each kept
    assignment is copied to its own slot and every dropped one to one spare
    row past the buffer, which is then cut off;
  * combine: the reference scatter-adds each token's k weighted expert
    outputs into (T, d); here they are gathered to (T, k, d) in the order the
    reference adds them (ascending sorted position, so ascending expert id)
    and summed one after another in the compute dtype.

Under autograd (training, ``need_aux=True``) the gradients are the
reference's: the router's reaches it through the renormalised top-k weights
and, for the aux term, through ``mean(probs)`` only (the expert counts are a
scatter of ones and carry none); a dropped assignment is copied to the
spare row, which is cut off, and its combine term is masked, so neither its
token nor its weight gets any gradient, as the reference's ``keep`` mask
gives none.

The hierarchical dispatch (``grouped=True``) gives each data-parallel group
its own capacity: ``_n_data_groups`` is the installed mesh's pod x data
size, 1 without a mesh, where ``moe_mlp(grouped=True)`` runs ungrouped, as
the reference does.

Under a mesh the FFN runs in three ``local_map`` stages at the reference's
shard sites: each rank routes and dispatches the groups it holds (groups
over ``data``), the (G, E, C, d) buffer is split over experts on ``model``
and each rank runs its experts, and the expert outputs are gathered over
``model`` again for each rank's combine.  Every stage runs the same code
as the unsharded path on a slice of groups or experts.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..runtime import mesh_ctx
from .layers import upcast


def capacity(n_tokens: int, top_k: int, n_experts: int, factor: float) -> int:
    c = math.ceil(n_tokens * top_k / n_experts * factor)
    return max(8, ((c + 7) // 8) * 8)   # the reference pads to 8 for its tiling


class Dispatch(NamedTuple):
    """Each group's routing over its Tg*k assignments in sorted order, all
    (G, Tg*k): ``order`` (the stable argsort of the flattened expert ids),
    ``dest`` (buffer row, ``expert * C + min(pos_in_e, C - 1)``), ``keep``
    (``pos_in_e < C``) and ``token_of`` (``order // k``)."""
    order: torch.Tensor
    dest: torch.Tensor
    keep: torch.Tensor
    token_of: torch.Tensor


def _route(xg, w_router, n_experts: int, top_k: int, need_aux: bool):
    """f32 router over (G, Tg, d) -> renormalised top-k weights and expert
    ids (G, Tg, k), and each group's aux term (G,) (None unless
    ``need_aux``)."""
    xf = upcast(xg)
    probs = torch.softmax(xf @ w_router.to(xf.dtype), dim=-1)       # (G, Tg, E)
    top_p, top_i = torch.topk(probs, top_k, dim=-1)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp(min=1e-9)
    if not need_aux:
        return top_p, top_i, None
    g, tg, _ = xg.shape
    me = probs.mean(dim=1)                                           # (G, E)
    counts = torch.zeros_like(me).scatter_add_(
        1, top_i.reshape(g, -1), torch.ones_like(top_p).reshape(g, -1))
    return top_p, top_i, n_experts * (me * (counts / (tg * top_k))).sum(-1)


def _dispatch(top_i, n_experts: int, top_k: int, cap: int) -> Dispatch:
    """The reference's sort-based routing of ``top_i`` (G, Tg, k) at
    capacity ``cap``."""
    g = top_i.shape[0]
    eids = top_i.reshape(g, -1)
    n = eids.shape[1]
    order = torch.argsort(eids, dim=-1, stable=True)
    sorted_eids = eids.gather(1, order)
    experts = torch.arange(n_experts, device=eids.device).expand(g, n_experts)
    seg_start = torch.searchsorted(sorted_eids, experts.contiguous())   # left
    pos_in_e = torch.arange(n, device=eids.device) - seg_start.gather(1, sorted_eids)
    keep = pos_in_e < cap
    dest = sorted_eids * cap + pos_in_e.clamp(max=cap - 1)
    return Dispatch(order, dest, keep, order // top_k)


def _route_and_dispatch(xg, w_router, cfg, compute_dtype, need_aux: bool):
    """Route ``xg`` (G, Tg, d) and fill its (G, E, C, d) dispatch buffer:
    kept assignments to their slots, dropped ones to a spare row that is
    cut off -> (buf, top_p, ``Dispatch``, each group's aux term (G,) or
    None)."""
    g, tg, d = xg.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = capacity(tg, k, e, cfg.capacity_factor)
    top_p, top_i, aux = _route(xg, w_router, e, k, need_aux)
    disp = _dispatch(top_i, e, k, cap)
    rows = torch.arange(g, device=xg.device)[:, None]
    slot = torch.where(disp.keep, disp.dest, e * cap)
    buf = xg.new_zeros((g, e * cap + 1, d), dtype=compute_dtype)
    buf[rows, slot] = xg.to(compute_dtype)[rows, disp.token_of]
    return buf[:, :e * cap].reshape(g, e, cap, d), top_p, disp, aux


def _experts(buf, w_gate, w_up, w_down):
    """The expert FFNs over the (G, E, C, d) buffer, batched over E and G."""
    gate = F.silu(buf @ w_gate)
    h = (buf @ w_up) * gate
    return h @ w_down


def _combine(y, top_p, disp: Dispatch, top_k: int, compute_dtype):
    """Each token's k expert outputs (y: (G, E, C, d)), weighted and summed
    in the reference's order of adds -> (G, Tg, d)."""
    g, e, cap, d = y.shape
    tg = top_p.shape[1]
    y = y.reshape(g, e * cap, d)
    rows = torch.arange(g, device=y.device)[:, None]
    w_sorted = top_p.reshape(g, -1).gather(1, disp.order).to(compute_dtype)
    inv = torch.argsort(disp.order, dim=-1)          # sorted position of (token, j)
    at = inv.reshape(g, tg, top_k).sort(dim=-1).values.reshape(g, tg * top_k)
    contrib = (y[rows, disp.dest.gather(1, at)]
               * disp.keep.gather(1, at)[..., None].to(compute_dtype)
               * w_sorted.gather(1, at)[..., None]).reshape(g, tg, top_k, d)
    out = contrib[:, :, 0]
    for j in range(1, top_k):
        out = out + contrib[:, :, j]
    return out


def moe_groups(xg, p, cfg, compute_dtype, need_aux: bool = True):
    """The MoE FFN over ``xg`` (G, Tg, d), each group with its own capacity
    -> (y (G, Tg, d), aux (None unless ``need_aux``), ``Dispatch``).  Under
    a mesh the three stages run on each rank's groups and experts (see the
    module's docstring); without one ``shard`` and ``run_local`` pass their
    tensors through and the stages run as they are."""
    g, tg, d = xg.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = capacity(tg, k, e, cfg.capacity_factor)
    mapped = mesh_ctx.current_mesh() is not None
    xg = mesh_ctx.shard(xg, "groups", None, "embed")
    grp = ("groups", None)

    def dispatch(x, w):
        buf, top_p, disp, aux = _route_and_dispatch(x, w, cfg, compute_dtype, need_aux)
        if aux is None and mapped:      # local_map wants a tensor for each output
            aux = x.new_zeros((x.shape[0],), dtype=torch.float32)
        return (buf, top_p, *disp, aux)
    out_disp = [(grp, (g, tg * k))] * 4
    buf, top_p, *disp, aux = mesh_ctx.run_local(
        dispatch, (xg, p["w_router"]), (("groups", None, None), (None, None)),
        [(("groups", None, None, None), (g, e, cap, d)),
         (("groups", None, None), (g, tg, k)), *out_disp, (("groups",), (g,))])
    disp = Dispatch(*disp)
    buf = mesh_ctx.shard(buf, "groups", "experts", "capacity", "embed")
    buf_axes = ("groups", "experts", None, None)
    w_axes = ("experts", None, None)
    y = mesh_ctx.run_local(_experts, (buf, p["w_gate"], p["w_up"], p["w_down"]),
                           (buf_axes, w_axes, w_axes, w_axes), [(buf_axes, (g, e, cap, d))])
    y = mesh_ctx.shard(y, "groups", "experts", "capacity", "embed")
    out = mesh_ctx.run_local(
        lambda yl, tp, *ds: _combine(yl, tp, Dispatch(*ds), k, compute_dtype),
        (y, top_p, *disp), (("groups", None, None, None), ("groups", None, None),
                            *[grp] * 4),
        [(("groups", None, None), (g, tg, d))])
    out = mesh_ctx.shard(out, "groups", None, "embed")
    return out, aux.mean() if need_aux else None, disp


def moe_mlp(x, p, cfg, compute_dtype, grouped: bool = False, need_aux: bool = True):
    """x: (B, S, D) -> (y: (B, S, D), aux: scalar f32, or None when
    ``need_aux`` is False: only a loss reads it, and serving skips it).

    ``grouped=True``: the hierarchical dispatch when the mesh has more than
    one data group and B divides by it; without a mesh, ungrouped."""
    b, s, d = x.shape
    if grouped:
        n_groups = _n_data_groups()
        if n_groups > 1 and b % n_groups == 0:
            return _moe_mlp_grouped(x, p, cfg, compute_dtype, n_groups, need_aux)
    y, aux, _ = moe_groups(x.reshape(1, b * s, d), p, cfg, compute_dtype, need_aux)
    return y.reshape(b, s, d), aux


def _n_data_groups() -> int:
    """Data-parallel groups of the installed mesh: its pod x data size, 1
    without a mesh."""
    mesh = mesh_ctx.current_mesh()
    if mesh is None:
        return 1
    sizes = mesh_ctx.axis_sizes(mesh)
    return sizes.get("pod", 1) * sizes.get("data", 1)


def _moe_mlp_grouped(x, p, cfg, compute_dtype, n_groups: int, need_aux: bool = True):
    """Tokens grouped batch-major into ``n_groups``, each with its own
    capacity; the aux term is the mean of the groups'."""
    b, s, d = x.shape
    y, aux, _ = moe_groups(x.reshape(n_groups, b * s // n_groups, d), p, cfg,
                           compute_dtype, need_aux)
    return y.reshape(b, s, d), aux
