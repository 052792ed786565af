"""Granite-3-8B [hf:ibm-granite/granite-3.0-2b-base; hf] — dense, GQA.

40L d_model=4096 32H (GQA kv=8) d_ff=12800 vocab=49155.

Mirrors ``src/repro/configs/granite3_8b.py``: a verbatim copy (jax-free
data), so the port imports nothing of the reference package.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="granite-3-8b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=12800,
    vocab_size=49155,                # padded to 49408 (mult of 256) on device
    head_dim=128,
    rope_theta=10_000.0,
    tie_embeddings=True,
    sharding_mode="tp",
    source="hf:ibm-granite/granite-3.0-2b-base; hf",
)
