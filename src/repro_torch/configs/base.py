"""Architecture + run configuration system.

One ``ArchConfig`` per assigned architecture lives in ``repro/configs/<id>.py``
with the exact published numbers; ``repro.configs.get(name)`` resolves them.
``reduced()`` derives the CPU-smoke-test variant of any config (same family,
small dims), and ``ShapeConfig`` describes the four assigned input shapes.

Awkward head counts (starcoder2's 36, hymba's 25 on a 16-way model axis)
are handled by the TP-even HeadLayout (models/attention.py, DESIGN.md §10),
so every arch shares the same sharding rules; per-cell rule overrides live
in distributed/sharding.py.

Mirrors ``src/repro/configs/base.py``: a verbatim copy (jax-free
data), so the port imports nothing of the reference package.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned (input shape) cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def is_train(self) -> bool:
        return self.kind == "train"


# The four assigned LM shapes (identical across archs; applicability differs).
TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")
ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # "scatter": capacity-buffer dispatch under GSPMD (baseline)
    # "a2a":     shard_map all_to_all resegmentation (paper-style Send/Recv;
    #            the optimized path, see EXPERIMENTS.md §Perf)
    dispatch: str = "scatter"


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 256  # SSD chunk length (multiple of 128 for MXU alignment)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense|moe|ssm|hybrid|audio|vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default d_model // n_heads
    # attention details
    rope_theta: float = 10_000.0
    qk_norm: bool = False
    window: Optional[int] = None          # sliding-window size (None = full)
    global_layers: Tuple[int, ...] = ()   # layers forced to full attention
    mlp: str = "swiglu"                   # swiglu | gelu
    tie_embeddings: bool = False
    # family extensions
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # enc-dec / vlm frontends (stubs provide precomputed embeddings)
    n_encoder_layers: int = 0
    cross_attn_every: int = 0             # vlm: 1 cross-attn per N layers
    n_frontend_tokens: int = 0            # audio frames / image patches
    # distribution policy marker (all archs resolve through the same
    # rules + HeadLayout; kept for per-arch overrides)
    sharding_mode: str = "tp"
    # whether attention is sub-quadratic (SSM/hybrid) => long_500k runs
    subquadratic: bool = False
    # citation tag from the assignment table
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        assert self.n_heads > 0
        return self.d_model // self.n_heads

    @property
    def is_encdec(self) -> bool:
        return self.n_encoder_layers > 0

    def supports_shape(self, shape: ShapeConfig) -> Tuple[bool, str]:
        """(runs?, reason) for an assigned cell. long_500k needs
        sub-quadratic attention per the assignment."""
        if shape.name == "long_500k" and not self.subquadratic:
            return False, "full attention is O(S^2); skipped per assignment"
        return True, ""

    def reduced(self) -> "ArchConfig":
        """Small same-family config for CPU smoke tests (not dry-run)."""
        def shrink_layers(n):
            return max(2, min(n, 2))
        kw = dict(
            name=self.name + "-reduced",
            n_layers=2 if not self.global_layers else 3,
            d_model=64,
            n_heads=4 if self.n_heads else 0,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            d_ff=128,
            vocab_size=256,
            head_dim=16 if self.n_heads else None,
        )
        if self.global_layers:
            kw["global_layers"] = (0,)
        if self.moe:
            kw["moe"] = dataclasses.replace(
                self.moe, num_experts=4, top_k=min(self.moe.top_k, 2),
                d_ff_expert=64)
        if self.ssm:
            kw["ssm"] = dataclasses.replace(
                self.ssm, d_state=16, head_dim=16, chunk=32)
        if self.n_encoder_layers:
            kw["n_encoder_layers"] = 2
        if self.cross_attn_every:
            kw["cross_attn_every"] = 2
        if self.n_frontend_tokens:
            kw["n_frontend_tokens"] = 16
        if self.window:
            kw["window"] = 16
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Training/serving hyperparameters independent of architecture."""

    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 1000
    param_dtype: str = "float32"     # master weights
    compute_dtype: str = "bfloat16"
    remat_policy: str = "minimal"    # minimal | dots | none
    zero1: bool = True               # shard optimizer moments over data axis
    microbatches: int = 1            # gradient accumulation
    # gradient compression (paper tie-in: the §3.4 encodings applied to the
    # DP all-reduce payload; see train/fault_tolerance.py)
    grad_compression: str = "none"   # none | int8
