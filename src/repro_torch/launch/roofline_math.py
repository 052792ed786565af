"""Roofline arithmetic: hardware constants, MODEL_FLOPS estimates, and the
three-term analysis of one step's counted costs.

Mirrors ``src/repro/launch/roofline_math.py``: ``model_flops``, ``_avg_ctx``,
``collective_bytes``, ``Roofline`` and ``analyze`` are verbatim; the
hardware constants are one NVIDIA H100 SXM's (NVIDIA's H100 data sheet,
dense rates without sparsity) in place of the TPU's:
  peak   989 TFLOP/s bf16 / card (tensor cores)
  HBM    3.35 TB/s / card
  link   NVLink 4, 450 GB/s / card each direction; one card moves
         nothing over it (``op_cost`` reports ``coll_total = 0``)

MODEL_FLOPS is the *published-architecture* useful work (6*N_active*D for
training), so the counted/MODEL ratio surfaces padding waste, remat
recompute and capacity-factor overhead.  ``analyze`` takes
``launch/op_cost.Costs`` as the reference's takes ``hlo_cost.Costs``.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional, Tuple

from ..configs.base import ArchConfig, ShapeConfig

PEAK_FLOPS = 989e12       # bf16 / card, dense
HBM_BW = 3.35e12          # bytes/s / card
LINK_BW = 450e9           # bytes/s / card, each direction (NVLink 4)

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "f8e4m3fn": 1, "f8e5m2": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8, "c128": 16,
}

COLLECTIVE_OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                  "collective-permute")


# ---------------------------------------------------------------------------
# MODEL_FLOPS (useful work of the published arch; no padding, no remat)
# ---------------------------------------------------------------------------

def _layer_param_flops_per_token(cfg: ArchConfig) -> float:
    """2 * active params per layer (matmul fwd flops per token)."""
    d = cfg.d_model
    total = 0.0
    if cfg.n_heads:
        hd = cfg.resolved_head_dim
        attn_p = d * cfg.n_heads * hd * 2 + d * cfg.n_kv_heads * hd * 2
        total += attn_p
    if cfg.ssm is not None:
        d_inner = cfg.ssm.expand * d
        h = d_inner // cfg.ssm.head_dim
        n, g = cfg.ssm.d_state, 1
        proj = d * (2 * d_inner + 2 * g * n + h) + d_inner * d
        total += proj
    if cfg.moe is not None:
        total += d * cfg.moe.num_experts  # router
        total += cfg.moe.top_k * 3 * d * cfg.moe.d_ff_expert
    elif cfg.d_ff:
        n_mats = 3 if cfg.mlp == "swiglu" else 2
        total += n_mats * d * cfg.d_ff
    return 2.0 * total


def _attn_core_flops_per_token(cfg: ArchConfig, ctx: float) -> float:
    """4 * Hq * hd * ctx (QK^T + AV) per attention layer."""
    if not cfg.n_heads:
        return 0.0
    return 4.0 * cfg.n_heads * cfg.resolved_head_dim * ctx


def _ssm_core_flops_per_token(cfg: ArchConfig) -> float:
    if cfg.ssm is None:
        return 0.0
    d_inner = cfg.ssm.expand * cfg.d_model
    h = d_inner // cfg.ssm.head_dim
    # state update (2*H*P*N mul-add pairs) + output contraction
    return 4.0 * h * cfg.ssm.head_dim * cfg.ssm.d_state


def model_flops(cfg: ArchConfig, shape: ShapeConfig) -> float:
    """Total useful FLOPs of one step of this (arch x shape) cell."""
    S, B = shape.seq_len, shape.global_batch
    d = cfg.d_model
    vocab_f = 2.0 * d * cfg.vocab_size  # unembed per token

    def layer_flops(ctx):
        per = _layer_param_flops_per_token(cfg)
        per += _attn_core_flops_per_token(cfg, ctx)
        per += _ssm_core_flops_per_token(cfg)
        return per

    if shape.kind == "train":
        ctx = _avg_ctx(cfg, S)
        fwd = B * S * (cfg.n_layers * layer_flops(ctx) + vocab_f)
        if cfg.is_encdec:
            enc_ctx = S / 2  # bidirectional, full
            fwd += B * S * cfg.n_encoder_layers * (
                _layer_param_flops_per_token(cfg)
                + _attn_core_flops_per_token(cfg, S))
        if cfg.family == "vlm":
            n_cross = cfg.n_layers // cfg.cross_attn_every
            fwd += B * S * n_cross * _attn_core_flops_per_token(
                cfg, cfg.n_frontend_tokens)
        return 3.0 * fwd  # fwd + 2x bwd
    if shape.kind == "prefill":
        ctx = _avg_ctx(cfg, S)
        fwd = B * S * cfg.n_layers * layer_flops(ctx) + B * vocab_f
        if cfg.is_encdec:
            fwd += B * S * cfg.n_encoder_layers * (
                _layer_param_flops_per_token(cfg)
                + _attn_core_flops_per_token(cfg, S))
        if cfg.family == "vlm":
            n_cross = cfg.n_layers // cfg.cross_attn_every
            fwd += B * S * n_cross * _attn_core_flops_per_token(
                cfg, cfg.n_frontend_tokens)
        return fwd
    # decode: one token against a cache of S
    ctx = min(S, cfg.window) if cfg.window else S
    per_tok = cfg.n_layers * layer_flops(ctx) + vocab_f
    if cfg.window and cfg.global_layers:
        # global layers see the full context
        per_tok += len(cfg.global_layers) * (
            _attn_core_flops_per_token(cfg, S)
            - _attn_core_flops_per_token(cfg, ctx))
    return B * per_tok


def _avg_ctx(cfg: ArchConfig, S: int) -> float:
    if cfg.window:
        n_glob = len(cfg.global_layers)
        w_frac = (cfg.n_layers - n_glob) / cfg.n_layers
        return w_frac * min(cfg.window, S) + (1 - w_frac) * S / 2
    return S / 2.0


# ---------------------------------------------------------------------------
# HLO parsing: collective bytes from the post-SPMD per-device module
# ---------------------------------------------------------------------------

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_OP_RE = re.compile(
    r"=\s*(\([^)]*\)|\S+)\s+(" + "|".join(COLLECTIVE_OPS) + r")(-start)?\(")


def _shape_bytes(shape_str: str) -> float:
    total = 0.0
    for dt, dims in _SHAPE_RE.findall(shape_str):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d.strip():
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def collective_bytes(hlo_text: str) -> Dict[str, float]:
    """Per-device bytes moved by collectives, by op kind.

    We charge the *result* bytes of each collective (the received payload
    per device), with all-reduce counted twice (reduce + broadcast phases of
    a ring). '-done' halves of async pairs are skipped.
    """
    out: Dict[str, float] = {k: 0.0 for k in COLLECTIVE_OPS}
    for line in hlo_text.splitlines():
        m = _OP_RE.search(line)
        if not m:
            continue
        shape_str, op = m.group(1), m.group(2)
        b = _shape_bytes(shape_str)
        out[op] += b * (2.0 if op == "all-reduce" else 1.0)
    out["total"] = sum(out.values())
    return out


# ---------------------------------------------------------------------------
# The three roofline terms
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    hlo_flops: float          # per device
    hlo_bytes: float          # per device
    coll_bytes: float         # per device
    model_flops: float        # whole step, published arch
    n_chips: int

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_ratio(self) -> float:
        """MODEL_FLOPS / (HLO_FLOPs * chips)."""
        tot = self.hlo_flops * self.n_chips
        return self.model_flops / tot if tot else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Achievable fraction of peak on the dominant-term model:
        (MODEL_FLOPS / chips / peak) / bound_s."""
        ideal = self.model_flops / self.n_chips / PEAK_FLOPS
        return ideal / self.bound_s if self.bound_s else 0.0


def analyze(hc, mflops: float, n_chips: int) -> Roofline:
    """hc: op_cost.Costs (per-card totals of one call)."""
    return Roofline(
        compute_s=hc.flops / PEAK_FLOPS,
        memory_s=hc.bytes / HBM_BW,
        collective_s=hc.coll_total / LINK_BW,
        hlo_flops=hc.flops, hlo_bytes=hc.bytes, coll_bytes=hc.coll_total,
        model_flops=mflops, n_chips=n_chips)
