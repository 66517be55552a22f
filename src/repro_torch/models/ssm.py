"""Mamba2 block — SSD (state-space duality), chunked prefill and O(1) decode
(port of ``repro.models.ssm``).

Shapes follow the paper (arXiv:2405.21060): d_inner = expand * d_model, H =
d_inner / head_dim SSD heads, G B/C groups of state size N.  The chunked
algorithm computes, per chunk of length Q, the intra-chunk quadratic term
(masked by cumulative decays) and the inter-chunk recurrence on the (H, P, N)
state.  ``ssd_chunked`` (kept in ``kernels.ref``) is the plain version;
``use_kernel=True`` routes the chunk scan through ``kernels.ops.ssd_scan``
(the CUDA kernel for CUDA tensors).  ``ssd_decode``, the one-token recurrence, stays plain PyTorch, as
the reference runs it outside any kernel.

Under a mesh the chunk scan (kernel or plain) runs under ``local_map`` on
each rank's rows and SSD heads, the whole sequence at once, or on its
slice of the head dim P with ``RunOpts.ssd_shard_p`` (the ``ssm_p`` rule):
each head, and each of its P channels, scans alone.

Parameters are the reference's layouts.  ``w_in``/``w_out`` arrive in the
compute dtype; ``w_conv``, ``b_conv``, ``dt_bias``, ``a_log``, ``d_skip`` and
``norm_scale`` stay f32 (``Transformer.load``) and are cast where the
reference casts them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import ops as kops
from ..kernels.ref import ssd_chunked
from ..runtime import mesh_ctx
from .layers import causal_conv1d, conv1d_update, rms_norm


def _proj_sizes(cfg):
    d_in = cfg.d_inner
    g, n = cfg.ssm_groups, cfg.ssm_state
    conv_dim = d_in + 2 * g * n
    return d_in, g, n, conv_dim


def ssd_decode(h_state, x_t, dt_t, a_log, b_t, c_t, d_skip):
    """One-token SSD update.  h_state: (B,H,P,N); x_t: (B,H,P); dt_t: (B,H);
    b_t/c_t: (B,G,N).  Returns (h_new, y (B,H,P) f32)."""
    h, g = x_t.shape[1], b_t.shape[1]
    rep = h // g
    a = -torch.exp(a_log.float())
    decay = torch.exp(dt_t.float() * a)                             # (B,H)
    bh = b_t.float().repeat_interleave(rep, dim=1)                  # (B,H,N)
    ch = c_t.float().repeat_interleave(rep, dim=1)
    xdt = x_t.float() * dt_t.float()[..., None]
    h_new = decay[..., None, None] * h_state + torch.einsum("bhn,bhp->bhpn", bh, xdt)
    y = torch.einsum("bhn,bhpn->bhp", ch, h_new)
    return h_new, y + x_t.float() * d_skip.float()[None, :, None]


def _ssd(xs, dt, p, b_mat, c_mat, chunk, use_kernel):
    """The chunk scan -> (y (B,S,H,P) f32, h_final (B,H,P,N) f32)."""
    scan = kops.ssd_scan if use_kernel else ssd_chunked
    xs = mesh_ctx.shard(xs, "batch", "seq", None, "ssm_p")
    mesh = mesh_ctx.current_mesh()
    if mesh is None:
        return scan(xs, dt, p["a_log"], b_mat, c_mat, p["d_skip"], chunk=chunk)
    bsz, s, h, hp = xs.shape
    g, n = b_mat.shape[2:]
    # heads over the model axis unless P is split there; B/C's groups follow
    # the heads where there are several
    heads = None if mesh_ctx.spec_for("ssm_p", dims=(hp,))[0] else "heads"
    ax = mesh_ctx.spec_for(heads, dims=(h,))[0]
    if ax is not None and g > 1 and g % mesh_ctx.axis_sizes(mesh)[ax]:
        heads = None
    grp = heads if g > 1 else None
    x_axes = ("batch", None, heads, "ssm_p")
    bc_axes = ("batch", None, grp, None)
    return mesh_ctx.run_local(
        lambda x, d, a, b, c, dk: scan(x, d, a, b, c, dk, chunk=chunk),
        (xs, dt, p["a_log"], b_mat, c_mat, p["d_skip"]),
        (x_axes, ("batch", None, heads), (heads,), bc_axes, bc_axes, (heads,)),
        [(x_axes, xs.shape), (("batch", heads, "ssm_p", None), (bsz, h, hp, n))])


def _split_ssm_inputs(xbc, cfg, bsz, s):
    d_in, g, n, _ = _proj_sizes(cfg)
    xs, b_mat, c_mat = torch.split(xbc, [d_in, g * n, g * n], dim=-1)
    return (xs.reshape(bsz, s, cfg.ssm_heads, cfg.ssm_head_dim),
            b_mat.reshape(bsz, s, g, n), c_mat.reshape(bsz, s, g, n))


def _gated_out(y, z, p, compute_dtype):
    y = y.to(compute_dtype)
    y = rms_norm(y * F.silu(z), p["norm_scale"])
    return y @ p["w_out"]


# ---------------------------------------------------------------------------
# Full mamba2 block (in_proj -> conv -> SSD -> gated out_proj)
# ---------------------------------------------------------------------------


def mamba2_block(x, p, cfg, compute_dtype, *, chunk=256, use_kernel=False):
    """x: (B,S,D) -> (B,S,D).  Forward / prefill path without the state."""
    out, _ = mamba2_block_prefill(x, p, cfg, compute_dtype, chunk=chunk,
                                  use_kernel=use_kernel)
    return out


def mamba2_block_prefill(x, p, cfg, compute_dtype, *, chunk=256,
                         use_kernel=False):
    """Like ``mamba2_block`` but also returns the decode state.

    The reference's prefill always runs ``ssd_chunked``; here it takes the
    same ``use_kernel`` switch as ``mamba2_block``, so serving prefill goes
    through the kernel.  ``kops.ssd_scan`` returns the same (y, h_final)."""
    d_in, _, _, conv_dim = _proj_sizes(cfg)
    k = cfg.conv_width
    bsz, s = x.shape[:2]
    zxbcdt = x.to(compute_dtype) @ p["w_in"]
    z, xbc_raw, dt_raw = torch.split(
        zxbcdt, [d_in, conv_dim, zxbcdt.shape[-1] - d_in - conv_dim], dim=-1)
    # conv state = last K-1 raw inputs (pre-activation), zero-padded on the
    # left when the prompt is shorter than the window
    pad = max(0, (k - 1) - s)
    xr = F.pad(xbc_raw, (0, 0, pad, 0)) if pad else xbc_raw
    conv_state = xr[:, xr.shape[1] - (k - 1):, :]
    xbc = F.silu(causal_conv1d(xbc_raw, p["w_conv"], p.get("b_conv")))
    xs, b_mat, c_mat = _split_ssm_inputs(xbc, cfg, bsz, s)
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())
    y, h_fin = _ssd(xs, dt, p, b_mat, c_mat, chunk, use_kernel)
    out = _gated_out(y.reshape(bsz, s, d_in), z, p, compute_dtype)
    return out, {"conv": conv_state, "ssm": h_fin}


def mamba2_block_decode(x_t, state, p, cfg, compute_dtype):
    """x_t: (B,D); state: {"conv": (B,K-1,conv_dim), "ssm": (B,H,P,N)}.
    Returns (out (B,D), new state)."""
    d_in, _, _, conv_dim = _proj_sizes(cfg)
    bsz = x_t.shape[0]
    zxbcdt = x_t.to(compute_dtype) @ p["w_in"]
    z, xbc, dt_raw = torch.split(
        zxbcdt, [d_in, conv_dim, zxbcdt.shape[-1] - d_in - conv_dim], dim=-1)
    conv_state, xbc = conv1d_update(state["conv"], xbc, p["w_conv"],
                                    p.get("b_conv"))
    xbc = F.silu(xbc)
    xs, b_t, c_t = _split_ssm_inputs(xbc[:, None], cfg, bsz, 1)
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())
    ssm_state, y = ssd_decode(state["ssm"], xs[:, 0], dt, p["a_log"],
                              b_t[:, 0], c_t[:, 0], p["d_skip"])
    out = _gated_out(y.reshape(bsz, d_in), z, p, compute_dtype)
    return out, {"conv": conv_state, "ssm": ssm_state}
