"""Phi-3.5-MoE-42B-A6.6B [hf:microsoft/Phi-3.5-MoE-instruct; hf].

32L d_model=4096 32H (GQA kv=8) per-expert d_ff=6400 vocab=32064,
MoE 16 experts top-2. 6.6B active / 42B total.

Mirrors ``src/repro/configs/phi35_moe.py``: a verbatim copy (jax-free
data), so the port imports nothing of the reference package.
"""
from .base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6400,                       # per-expert FFN width
    vocab_size=32064,
    head_dim=128,
    rope_theta=10_000.0,
    moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=6400),
    sharding_mode="tp",
    source="hf:microsoft/Phi-3.5-MoE-instruct; hf",
)
