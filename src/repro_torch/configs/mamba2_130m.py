"""Mamba2-130M [arXiv:2405.21060; unverified] — pure SSM (SSD).

24L d_model=768 (attention-free) vocab=50280, ssm_state=128.
d_inner = expand*d_model = 1536; 24 SSD heads of dim 64.
State-space duality: chunked block-matmul form for train/prefill,
O(1)-per-token recurrent form for decode. Sub-quadratic => long_500k runs.

Mirrors ``src/repro/configs/mamba2_130m.py``: a verbatim copy (jax-free
data), so the port imports nothing of the reference package.
"""
from .base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=0,                       # attention-free
    n_kv_heads=0,
    d_ff=0,                          # no FFN; SSD mixer only (paper spec)
    vocab_size=50280,                # padded to 50432 on device
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=256),
    tie_embeddings=True,
    subquadratic=True,
    source="arXiv:2405.21060; unverified",
)
