"""Phi-3-mini-3.8B [arXiv:2404.14219; unverified] — RoPE SwiGLU GQA(kv=32).

32L d_model=3072 32H (kv=32 => MHA) d_ff=8192 vocab=32064, head_dim=96.

Mirrors ``src/repro/configs/phi3_mini.py``: a verbatim copy (jax-free
data), so the port imports nothing of the reference package.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="phi3-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    head_dim=96,
    rope_theta=10_000.0,
    sharding_mode="tp",
    source="arXiv:2404.14219; unverified",
)
