"""Synthetic data generators: the star schema of the C-Store §8.1 query
harness, and the Zipfian token corpus of the columnar token store.

Mirrors ``star_schema``, ``zipf_tokens`` and ``token_corpus`` of
``src/repro/data/synth.py`` verbatim (same seeded draws, so both packages
load identical rows); ``meter_data`` waits for the dry-run slice.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def zipf_tokens(rng: np.random.Generator, n: int, vocab: int,
                alpha: float = 1.1) -> np.ndarray:
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = ranks ** (-alpha)
    p /= p.sum()
    return rng.choice(vocab, size=n, p=p).astype(np.int64)


def token_corpus(n_docs: int, doc_len: int, vocab: int,
                 seed: int = 0) -> Dict[str, np.ndarray]:
    """(doc_id, pos, token) rows -- the token store's logical table."""
    rng = np.random.default_rng(seed)
    n = n_docs * doc_len
    return {
        "doc_id": np.repeat(np.arange(n_docs, dtype=np.int64), doc_len),
        "pos": np.tile(np.arange(doc_len, dtype=np.int64), n_docs),
        "token": zipf_tokens(rng, n, vocab),
    }


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
