"""SeamlessM4T-medium [arXiv:2308.11596; hf] — enc-dec, multimodal backbone.

12L d_model=1024 16H (kv=16) d_ff=4096 vocab=256206.
12 encoder + 12 decoder layers; the audio frontend is a STUB per the
assignment: input_specs() provides precomputed frame embeddings
(B, seq, d_model) to the encoder.

Mirrors ``src/repro/configs/seamless_m4t_medium.py``: a verbatim copy (jax-free
data), so the port imports nothing of the reference package.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium",
    family="audio",
    n_layers=12,                     # decoder layers
    n_encoder_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,               # padded to 256256 on device
    head_dim=64,
    mlp="gelu",
    rope_theta=10_000.0,
    sharding_mode="tp",
    source="arXiv:2308.11596; hf",
)
