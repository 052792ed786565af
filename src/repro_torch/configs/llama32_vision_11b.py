"""Llama-3.2-Vision-11B [hf:meta-llama/Llama-3.2-11B-Vision; unverified].

40L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256.
Cross-attention image layers every 5th layer (8 of 40). The vision frontend
is a STUB per the assignment: input_specs() provides precomputed patch
embeddings (B, 6404, d_model) = 4 tiles x 1601 patches, already projected.

Mirrors ``src/repro/configs/llama32_vision_11b.py``: a verbatim copy (jax-free
data), so the port imports nothing of the reference package.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    head_dim=128,
    rope_theta=500_000.0,
    cross_attn_every=5,
    n_frontend_tokens=6404,          # 4 tiles x 1601 patches
    sharding_mode="tp",
    source="hf:meta-llama/Llama-3.2-11B-Vision; unverified",
)
