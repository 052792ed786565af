"""OLMoE-1B-7B [arXiv:2409.02060; hf] — MoE, 64 experts top-8.

16L d_model=2048 16H (GQA kv=16) per-expert d_ff=1024 vocab=50304.
Every layer is MoE (no shared dense FFN); 1B active / 7B total params.

Mirrors ``src/repro/configs/olmoe_1b_7b.py``: a verbatim copy (jax-free
data), so the port imports nothing of the reference package.
"""
from .base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,                       # per-expert FFN width
    vocab_size=50304,
    head_dim=128,
    qk_norm=True,                    # OLMoE uses QK-norm
    rope_theta=10_000.0,
    moe=MoEConfig(num_experts=64, top_k=8, d_ff_expert=1024),
    sharding_mode="tp",              # 16 heads / 16-way model axis
    source="arXiv:2409.02060; hf",
)
