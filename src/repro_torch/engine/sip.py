"""Sideways Information Passing (paper §6.1): semi-join filters built from a
hash join's build side, pushed into the probe-side Scan so non-joining rows
never flow up the plan.

Filter = a Bloom-style bit array over the build keys; the Scan ANDs the
probe membership test into its row mask.

Mirrors ``src/repro/engine/sip.py``.  The reference hashes in uint32
arithmetic; PyTorch has no full uint32, so the hash runs in int64 with
every product split into 16-bit halves and masked to 32 bits, which keeps
it bit-identical (the same bits are set, the same rows pass).
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

# 32-bit mixers (Knuth/xxhash-style salts)
_SALTS = (0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D)
_M32 = 0xFFFFFFFF


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2^32 for h in [0, 2^32), without int64 overflow."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _hash(keys: torch.Tensor, salt: int, bits: int) -> torch.Tensor:
    h = keys.to(torch.int64) & _M32            # astype(uint32)
    h = _mul32(h, salt)
    h = h ^ (h >> 15)
    h = _mul32(h, 0x27D4EB2F)
    h = h ^ (h >> 13)
    return h % bits


def bloom_build(keys: torch.Tensor, bits: int = 1 << 16,
                k: int = 2) -> torch.Tensor:
    bitarr = torch.zeros(bits, dtype=torch.bool, device=keys.device)
    for i in range(k):
        bitarr[_hash(keys, _SALTS[i], bits)] = True
    return bitarr


def bloom_probe(bitarr: torch.Tensor, keys: torch.Tensor,
                k: int = 2) -> torch.Tensor:
    bits = bitarr.shape[0]
    ok = torch.ones(keys.shape, dtype=torch.bool, device=keys.device)
    for i in range(k):
        ok &= bitarr[_hash(keys, _SALTS[i], bits)]
    return ok


def sip_filter(build_keys: torch.Tensor, probe_column: str,
               bits: int = 1 << 16) -> Callable[[Dict], torch.Tensor]:
    """Build a SIP filter closure for Scan (probe col -> row mask)."""
    bitarr = bloom_build(build_keys, bits)

    def apply(cols: Dict) -> torch.Tensor:
        return bloom_probe(bitarr, cols[probe_column])

    return apply
