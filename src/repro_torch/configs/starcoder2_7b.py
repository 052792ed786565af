"""StarCoder2-7B [arXiv:2402.19173; hf] — dense, GQA, RoPE.

32L d_model=4608 36H (GQA kv=4) d_ff=18432 vocab=49152.

36 heads do not divide the 16-way model axis; the HeadLayout machinery
(models/attention.py) pads q/o to (16 kv_eff x 3 group) slots with
hard-masked dead heads, keeping TP sharding even with exact math; the
<=11% padding waste is visible in the roofline useful-ratio (DESIGN.md §10).

Mirrors ``src/repro/configs/starcoder2_7b.py``: a verbatim copy (jax-free
data), so the port imports nothing of the reference package.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-7b",
    family="dense",
    n_layers=32,
    d_model=4608,
    n_heads=36,
    n_kv_heads=4,
    d_ff=18432,
    vocab_size=49152,
    head_dim=128,
    mlp="gelu",
    rope_theta=1_000_000.0,
    source="arXiv:2402.19173; hf",
)
