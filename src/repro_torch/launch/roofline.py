"""Roofline terms from dry-run records, for one H100 (port of
``repro.launch.roofline``).

Per (arch x shape) cell:
  compute term    = aten dot FLOPs per device / the peak FLOP/s of the
                    cell's compute dtype
  memory term     = aten HBM bytes per device / HBM bandwidth
  collective term = collective wire bytes per device / LINK_BW (0 on one
                    card, which has no link to cross)
plus MODEL_FLOPS = analytic useful flops (6*N_active*D for training), and the
MODEL/aten ratio that exposes remat waste.

The analytic counts are the reference's, unchanged.  The hardware is the
H100 SXM5 ("NVIDIA H100 80GB HBM3") in place of the TPU v5e, and the peak
follows the cell's compute dtype: the port runs f32 with TF32 off, so an f32
cell is held to the CUDA cores' rate, where the reference has one bf16 peak
for every cell.  Pure Python over the port's configs: imports no torch.
"""
from __future__ import annotations

import glob
import json
import os
from dataclasses import dataclass

from ..configs import SHAPES, get_config
from ..configs.base import ModelConfig, ShapeConfig

# NVIDIA H100 SXM5 data sheet, dense rates at the 700 W limit:
PEAK_FLOPS = 989e12            # bf16 on the tensor cores, dense
PEAK_FLOPS_F32 = 67e12         # f32 on the CUDA cores (TF32 off, as the port runs f32)
HBM_BW = 3.35e12               # HBM3, bytes/s
# the memory CUDA reports for an "NVIDIA H100 80GB HBM3" (cudaMemGetInfo's
# total: torch.cuda.get_device_properties(0).total_memory)
HBM_BYTES = 85_017_493_504
PEAKS = {"bfloat16": PEAK_FLOPS, "float32": PEAK_FLOPS_F32}
# Bytes/s per GPU per direction over the link a collective crosses: one
# 400 Gb/s NDR InfiniBand NIC per H100, as in a DGX H100 (8 GPUs, 8
# ConnectX-7 ports).  A 16-wide mesh axis spans two 8-GPU NVLink nodes, so
# every transfer is held to the NIC, uniform across cells, as the
# reference holds each to one ICI link; NVLink 4 gives 450e9 per direction
# within a node.  A data-sheet rate: the port's card machine has one H100,
# and no collective time is measured.
LINK_BW = 50e9


def peak_flops(dtype: str) -> float:
    """The dense peak FLOP/s of a compute dtype (``ModelConfig.dtype``)."""
    return PEAKS[dtype]


# ---------------------------------------------------------------------------
# analytic MODEL_FLOPS
# ---------------------------------------------------------------------------


def _block_kinds(cfg: ModelConfig) -> list:
    body = (list(cfg.block_pattern) * max(1, cfg.n_pattern_groups))[
        : max(0, cfg.n_layers - len(cfg.tail_pattern))]
    return body + list(cfg.tail_pattern)


def _attn_proj_flops(cfg) -> float:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    return 2.0 * (d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd +
                  cfg.n_heads * hd * d)


def _attn_score_flops(cfg, context: float) -> float:
    return 4.0 * cfg.n_heads * cfg.resolved_head_dim * context


def _mlp_flops(cfg) -> float:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.n_experts:
        router = 2.0 * d * cfg.n_experts
        return router + cfg.top_k * 3 * 2.0 * d * f
    n_mats = 3 if cfg.act in ("swiglu", "geglu") else 2
    return n_mats * 2.0 * d * f


def _rec_flops(cfg) -> float:
    d, L = cfg.d_model, cfg.lru_width
    bs = L // cfg.n_heads
    return (3 * 2.0 * d * L                    # branch, gate, out projections
            + 2 * 2.0 * L * bs                 # block-diagonal gates
            + 2.0 * cfg.conv_width * L + 10.0 * L)


def _mamba2_flops(cfg, chunk: int = 256) -> float:
    d = cfg.d_model
    di, h, p = cfg.d_inner, cfg.ssm_heads, cfg.ssm_head_dim
    g, n = cfg.ssm_groups, cfg.ssm_state
    conv_dim = di + 2 * g * n
    proj = 2.0 * d * (2 * di + 2 * g * n + h) + 2.0 * di * d
    conv = 2.0 * cfg.conv_width * conv_dim
    q = chunk
    ssd_per_tok = 2.0 * q * h * n + 2.0 * q * h * p + 4.0 * h * p * n
    return proj + conv + ssd_per_tok


def fwd_flops_per_token(cfg: ModelConfig, context: float,
                        window_ctx: float | None = None) -> float:
    """Forward FLOPs for one token given an (average) attention context."""
    total = 0.0
    for kind in _block_kinds(cfg):
        if kind in ("attn", "xattn"):
            total += _attn_proj_flops(cfg) + _attn_score_flops(cfg, context)
            total += _mlp_flops(cfg)
            if kind == "xattn":
                total += _attn_proj_flops(cfg) + _attn_score_flops(
                    cfg, cfg.encoder_seq)
        elif kind == "local":
            ctx = min(context, window_ctx or cfg.local_window)
            total += _attn_proj_flops(cfg) + _attn_score_flops(cfg, ctx)
            total += _mlp_flops(cfg)
        elif kind == "rec":
            total += _rec_flops(cfg) + _mlp_flops(cfg)   # Griffin: mixer + MLP
        elif kind == "mamba2":
            total += _mamba2_flops(cfg)
    total += 2.0 * cfg.d_model * cfg.padded_vocab          # lm head
    return total


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Global useful FLOPs for the cell (6*N_active*D convention for train)."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        tokens = b * s
        per_tok = fwd_flops_per_token(cfg, context=(s + 1) / 2)
        enc = 0.0
        if cfg.is_encoder_decoder:
            enc_cfg = cfg
            enc_tok = b * cfg.encoder_seq
            enc_per = cfg.encoder_layers * (
                _attn_proj_flops(enc_cfg) +
                _attn_score_flops(enc_cfg, cfg.encoder_seq) +
                _mlp_flops(enc_cfg))
            enc = 3.0 * enc_tok * enc_per
        return {"model_flops": 3.0 * tokens * per_tok + enc, "tokens": tokens}
    if shape.kind == "prefill":
        tokens = b * s
        per_tok = fwd_flops_per_token(cfg, context=(s + 1) / 2)
        return {"model_flops": tokens * per_tok, "tokens": tokens}
    # decode: one token against a full context
    per_tok = fwd_flops_per_token(cfg, context=s)
    return {"model_flops": b * per_tok, "tokens": b}


# ---------------------------------------------------------------------------
# terms per cell
# ---------------------------------------------------------------------------


@dataclass
class Cell:
    arch: str
    shape: str
    mesh: str
    chips: int
    dtype: str
    compute_s: float
    memory_s: float
    coll_s: float
    dominant: str
    model_flops: float
    hlo_flops_global: float
    useful_ratio: float
    raw: dict

    @property
    def ideal_s(self) -> float:
        """Per-device time if only MODEL_FLOPS ran at the dtype's peak."""
        return self.model_flops / (self.chips * peak_flops(self.dtype))

    @property
    def step_bound_s(self) -> float:
        """Roofline step-time lower bound = the dominant term."""
        return max(self.compute_s, self.memory_s, self.coll_s)

    @property
    def fraction(self) -> float:
        """Roofline fraction: useful-compute time / dominant-term time."""
        return self.ideal_s / self.step_bound_s if self.step_bound_s else 0.0


def analyze_cell_json(meta: dict) -> Cell:
    """A dry-run record (``launch.dryrun``'s JSON: its ``"aten"`` summary)
    -> the cell's roofline terms.  The compute dtype is the record's
    ``"dtype"``, else the registered config's.  ``chips`` is the product of
    the record's mesh: 1 for ``single``, 512 for ``multi``."""
    cfg = get_config(meta["arch"])
    shape = SHAPES[meta["shape"]]
    dtype = meta.get("dtype", cfg.dtype)
    chips = 1
    for v in meta["mesh"].values():
        chips *= v
    h = meta["aten"]
    compute_s = h["dot_flops"] / peak_flops(dtype)
    memory_s = h["hbm_bytes"] / HBM_BW
    coll_s = h["coll_bytes"] / LINK_BW
    dominant = max((("compute", compute_s), ("memory", memory_s),
                    ("collective", coll_s)), key=lambda t: t[1])[0]
    mf = model_flops(cfg, shape)["model_flops"]
    hlo_global = h["dot_flops"] * chips
    return Cell(
        arch=meta["arch"], shape=meta["shape"], mesh=meta["mesh_tag"],
        chips=chips, dtype=dtype, compute_s=compute_s, memory_s=memory_s,
        coll_s=coll_s, dominant=dominant, model_flops=mf,
        hlo_flops_global=hlo_global,
        useful_ratio=mf / hlo_global if hlo_global else 0.0, raw=meta)


def load_cells(dirpath: str, mesh: str | None = "single") -> list:
    cells = []
    for f in sorted(glob.glob(os.path.join(dirpath, "*.json"))):
        with open(f) as fh:
            meta = json.load(fh)
        if meta.get("status") != "ok":
            continue
        if mesh and meta.get("mesh_tag") != mesh:
            continue
        cells.append(analyze_cell_json(meta))
    return cells


def table(cells: list, fmt: str = "md", extra=()) -> str:
    """The cells' terms as a markdown (or csv) table; ``extra`` appends
    ``(header, cell -> str)`` columns."""
    hdr = ["arch", "shape", "mesh", "compute_s", "memory_s", "coll_s",
           "dominant", "useful_ratio", "roofline_frac"] + [h for h, _ in extra]
    rows = [[c.arch, c.shape, c.mesh, f"{c.compute_s:.4g}",
             f"{c.memory_s:.4g}", f"{c.coll_s:.4g}", c.dominant,
             f"{c.useful_ratio:.3f}", f"{c.fraction:.3f}"] + [fn(c) for _, fn in extra]
            for c in cells]
    if fmt == "csv":
        return "\n".join([",".join(hdr)] + [",".join(r) for r in rows])
    w = [max(len(h), *(len(r[i]) for r in rows)) if rows else len(h)
         for i, h in enumerate(hdr)]
    out = ["| " + " | ".join(h.ljust(w[i]) for i, h in enumerate(hdr)) + " |",
           "|" + "|".join("-" * (w[i] + 2) for i in range(len(hdr))) + "|"]
    for r in rows:
        out.append("| " + " | ".join(r[i].ljust(w[i]) for i in range(len(hdr)))
                   + " |")
    return "\n".join(out)
