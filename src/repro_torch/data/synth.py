"""Synthetic data generators: the star schema of the C-Store §8.1 query
harness, the Zipfian token corpus of the columnar token store, and the
paper's §8.2.2 meter data (the compression experiment's schema).

Mirrors ``star_schema``, ``zipf_tokens``, ``token_corpus`` and
``meter_data`` of ``src/repro/data/synth.py`` verbatim (same seeded
draws, so both packages load identical rows).
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


def meter_data(n_rows: int, seed: int = 0, *, n_metrics: int = 300,
               n_meters: int = 2000) -> Dict[str, np.ndarray]:
    """Paper §8.2.2: 'a few hundred metrics, a couple of thousand meters,
    readings every 5/10/60 min, 64-bit float values with trends'."""
    rng = np.random.default_rng(seed)
    rows_per_series = max(1, n_rows // (n_metrics * n_meters))
    metric, meter, ts, value = [], [], [], []
    periods = np.array([300, 600, 3600])
    made = 0
    for m in range(n_metrics):
        period = periods[m % 3]
        n_m = min(n_meters, max(1, (n_rows - made) //
                                (rows_per_series * (n_metrics - m))
                                // max(rows_per_series, 1) + 1))
        for mt in range(n_meters):
            k = rows_per_series
            if made + k > n_rows:
                k = n_rows - made
            if k <= 0:
                break
            metric.append(np.full(k, m, np.int64))
            meter.append(np.full(k, mt, np.int64))
            ts.append(1_600_000_000 + period * np.arange(k, dtype=np.int64))
            kind = m % 3
            if kind == 0:      # mostly zeros (paper: 'lots of 0 values')
                v = np.where(rng.random(k) < 0.9, 0.0,
                             rng.normal(50, 5, k).round(1))
            elif kind == 1:    # gradual trend
                v = np.round(100 + 0.1 * np.arange(k) +
                             rng.normal(0, 0.05, k), 2)
            else:              # noisy (but quantized: meters report
                #                  fixed-precision readings)
                v = np.round(rng.normal(0, 100, k), 2)
            value.append(v)
            made += k
        if made >= n_rows:
            break
    return {"metric": np.concatenate(metric)[:n_rows],
            "meter": np.concatenate(meter)[:n_rows],
            "ts": np.concatenate(ts)[:n_rows],
            "value": np.concatenate(value)[:n_rows]}


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
