"""Qwen3-4B [hf:Qwen/Qwen3-8B; hf] — dense, qk_norm, GQA.

36L d_model=2560 32H (GQA kv=8) d_ff=9728 vocab=151936, head_dim=128.

Mirrors ``src/repro/configs/qwen3_4b.py``: a verbatim copy (jax-free
data), so the port imports nothing of the reference package.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-4b",
    family="dense",
    n_layers=36,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_ff=9728,
    vocab_size=151936,
    head_dim=128,                    # explicit (32*128 != 2560)
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    sharding_mode="tp",
    source="hf:Qwen/Qwen3-8B; hf",
)
