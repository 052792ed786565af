"""Hymba-1.5B [arXiv:2411.13676; hf] — hybrid: parallel attn + mamba heads.

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16.
Sliding-window attention (1024) in all but 3 global layers {first, middle,
last}; SSM heads run in parallel with attention heads in every layer and the
two branches are mean-fused (per the paper). Sub-quadratic => long_500k runs.

25 heads do not divide the 16-way model axis; HeadLayout pads to
(16 kv_eff x 2 group) slots with hard-masked dead heads (DESIGN.md §10).

Mirrors ``src/repro/configs/hymba_1_5b.py``: a verbatim copy (jax-free
data), so the port imports nothing of the reference package.
"""
from .base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab_size=32001,                # padded to 32256 on device
    head_dim=64,
    window=1024,
    global_layers=(0, 15, 31),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=64, chunk=256),
    subquadratic=True,
    source="arXiv:2411.13676; hf",
)
