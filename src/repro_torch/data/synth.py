"""Synthetic star-schema data for the C-Store §8.1 query harness.

Mirrors ``star_schema`` of ``src/repro/data/synth.py`` verbatim (same
seeded draws, so both packages load identical rows); the token corpus,
meter data and token store belong to the LM-stack slice.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def star_schema(n_fact: int, n_dim: int, seed: int = 0
                ) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """LINEITEM-ish fact + ORDERS-ish dimension (C-Store §8.1 harness)."""
    rng = np.random.default_rng(seed)
    fact = {
        "l_orderkey": rng.integers(0, n_dim, n_fact).astype(np.int64),
        "l_suppkey": rng.integers(0, 100, n_fact).astype(np.int64),
        "l_shipdate": np.sort(rng.integers(0, 365, n_fact)).astype(np.int64),
        "l_qty": rng.integers(1, 50, n_fact).astype(np.int64),
        "l_extprice": np.round(rng.normal(1000, 200, n_fact), 2),
    }
    dim = {
        "o_orderkey": np.arange(n_dim, dtype=np.int64),
        "o_custkey": rng.integers(0, max(10, n_dim // 10),
                                  n_dim).astype(np.int64),
        "o_orderdate": rng.integers(0, 365, n_dim).astype(np.int64),
    }
    return fact, dim
