"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427; port of
``repro.models.rglru``).

Recurrence (per channel):
    r_t = sigmoid(W_a x_t + b_a)              # recurrence gate
    i_t = sigmoid(W_x x_t + b_x)              # input gate
    log a_t = -c * softplus(Lambda) * r_t     # c = 8
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The residual block is: linear -> causal conv -> RG-LRU on one branch,
linear -> tanh-GeLU gate on the other, multiplied and projected out.  The
scan runs through ``kernels.ops.rglru_scan`` (the CUDA kernel for CUDA
tensors) with ``use_kernel``, else through its plain version
``kernels.ref.ref_rglru``; the kernel's segmented walk and the plain
version's log-depth blocks are two orders of the same recurrence and agree
to rounding.  Under a mesh the gates and the scan run under ``local_map``
on each rank's rows and ``lru`` channels: the recurrence is per channel and
each gate block (one per head) reads its own channels only.

Parameters are the reference's layouts.  ``w_branch``/``w_gate``/``w_out``
arrive in the compute dtype; ``w_conv``/``b_conv`` and the gate leaves
(``lru``: ``w_a``, ``b_a``, ``w_x``, ``b_x``, ``lam``) stay f32
(``Transformer.load``), as the reference reads the gates in f32 at every
use.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import ops as kops
from ..kernels.ref import ref_rglru
from ..runtime import mesh_ctx
from .layers import causal_conv1d, conv1d_update, gelu_tanh

_C = 8.0


def _gates(x, p):
    """x: (..., lru); block-diagonal gates (one block per head).

    Returns (log_a, gated_input) in f32."""
    xf = x.float()
    nb, bs, _ = p["w_a"].shape
    xb = xf.reshape(*xf.shape[:-1], nb, bs)
    r = torch.sigmoid(torch.einsum("...bi,bij->...bj", xb, p["w_a"].float())
                      + p["b_a"].float())
    i = torch.sigmoid(torch.einsum("...bi,bij->...bj", xb, p["w_x"].float())
                      + p["b_x"].float())
    r = r.reshape(xf.shape)
    i = i.reshape(xf.shape)
    log_a = -_C * F.softplus(p["lam"].float()) * r
    a2 = torch.exp(2.0 * log_a)
    beta = torch.sqrt(torch.clamp(1.0 - a2, min=1e-6))
    return log_a, beta * (i * xf)


def rglru_scan(x, p, h0=None, *, use_kernel: bool = False, block: int = 256):
    """x: (B,S,lru) -> (y: (B,S,lru) in x's dtype, h_final: (B,lru) f32).
    ``block`` is the plain scan's block length."""
    def run(xl, w_a, b_a, w_x, b_x, lam):
        log_a, b = _gates(xl, {"w_a": w_a, "b_a": b_a, "w_x": w_x, "b_x": b_x,
                               "lam": lam})
        a = torch.exp(log_a)
        if use_kernel:
            y = kops.rglru_scan(a, b, h0, block=block)
        else:
            y = ref_rglru(a, b, h0, block=block)
        return y.to(xl.dtype), y[:, -1, :]
    args = (x, p["w_a"], p["b_a"], p["w_x"], p["b_x"], p["lam"])
    if mesh_ctx.current_mesh() is None:
        return run(*args)
    if h0 is not None:
        raise ValueError("rglru_scan under a mesh: no h0 (prefill starts from zero)")
    # the lru channels split only where whole gate blocks (heads) do
    lru = "lru" if mesh_ctx.spec_for("heads", dims=(p["w_a"].shape[0],))[0] else None
    bsz, s, width = x.shape
    return mesh_ctx.run_local(
        run, args, (("batch", None, lru), (lru, None, None), (lru, None),
                    (lru, None, None), (lru, None), (lru,)),
        [(("batch", None, lru), (bsz, s, width)), (("batch", lru), (bsz, width))])


def rglru_step(x_t, h_prev, p):
    """x_t: (B,lru); h_prev: (B,lru) -> (y_t, h_new f32)."""
    log_a, b = _gates(x_t, p)
    h_new = torch.exp(log_a) * h_prev.float() + b
    return h_new.to(x_t.dtype), h_new


# ---------------------------------------------------------------------------
# Full Griffin recurrent block
# ---------------------------------------------------------------------------


def recurrent_block(x, p, cfg, compute_dtype, *, use_kernel=False, block=256):
    """x: (B,S,D) -> (B,S,D); forward path without the decode state."""
    out, _ = recurrent_block_prefill(x, p, cfg, compute_dtype,
                                     use_kernel=use_kernel, block=block)
    return out


def recurrent_block_prefill(x, p, cfg, compute_dtype, *, use_kernel=False,
                            block=256):
    """Like ``recurrent_block`` but also returns the decode state.

    The reference's prefill always runs its plain scan; here it takes the
    same ``use_kernel`` switch as ``recurrent_block``, so serving prefill goes
    through the kernel (the results agree to rounding)."""
    k = cfg.conv_width
    xc = x.to(compute_dtype)
    branch_raw = xc @ p["w_branch"]
    # conv state = last K-1 raw branch inputs, zero-padded on the left when
    # the prompt is shorter than the window
    pad = max(0, (k - 1) - x.shape[1])
    br = F.pad(branch_raw, (0, 0, pad, 0)) if pad else branch_raw
    conv_state = br[:, br.shape[1] - (k - 1):, :]
    branch = causal_conv1d(branch_raw, p["w_conv"], p.get("b_conv"))
    branch = mesh_ctx.shard(branch, "batch", "seq", "lru")
    y, h_fin = rglru_scan(branch, p["lru"], use_kernel=use_kernel, block=block)
    gate = gelu_tanh(xc @ p["w_gate"])
    out = (y * gate) @ p["w_out"]
    return out, {"conv": conv_state, "h": h_fin}


def recurrent_block_decode(x_t, state, p, cfg, compute_dtype):
    """x_t: (B,D); state: {"conv": (B,K-1,lru), "h": (B,lru) f32}."""
    xc = x_t.to(compute_dtype)
    branch = xc @ p["w_branch"]
    conv_state, branch = conv1d_update(state["conv"], branch, p["w_conv"],
                                       p.get("b_conv"))
    y, h_new = rglru_step(branch, state["h"], p["lru"])
    gate = gelu_tanh(xc @ p["w_gate"])
    out = (y * gate) @ p["w_out"]
    return out, {"conv": conv_state, "h": h_new.to(state["h"].dtype)}
