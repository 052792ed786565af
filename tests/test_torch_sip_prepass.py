"""Numpy models of the two redesigned algorithms of ``repro_torch.kernels``:
the hash set of ``csrc/semijoin_probe.cu`` and the run fold of
``csrc/onehot_groupby.cu``, held against the reference's Pallas kernels
(interpret mode) and numpy.

Neither kernel runs on the CPU: there the wrappers take their plain
versions, which tests/test_torch_kernel_api.py holds against the
reference.  Here the algorithms themselves are held.  Each model reads
its constants from the ``.cu`` source (the slots, the empty marker, the
fmix32 steps of ``slot_of``, the threads and the chunk of the fold) and
repeats the kernel's arithmetic on chip_smoke.py's ``probe_cases`` and
``fold_cases``, the edge cases on which phase 5 holds the kernels against
their plain versions on the card.

Tolerances: booleans and counts exactly; sums of integer values exactly
(every partial sum stays below 2^24, or every value rounds to 2^30 in
f32); sums of floats within rtol 1e-5 of the float64 sum of the values
cast to f32.
"""
import functools
import re
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.hash_groupby import onehot_groupby as onehot_pallas
from repro.kernels.sip_probe import semijoin_probe as probe_pallas
from repro_torch.kernels import sip_probe

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (the cases phase 5 runs on the card)

CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
SIP_CU = (CSRC / "semijoin_probe.cu").read_text()
FOLD_CU = (CSRC / "onehot_groupby.cu").read_text()
PROBE_CASES = chip_smoke.probe_cases()
FOLD_CASES = chip_smoke.fold_cases()


def _const(src: str, name: str) -> str:
    return re.search(rf"constexpr \w+ {name} = ([^;]+);", src).group(1)


# ------------------------------------------------- the hash set's model --
# semijoin_probe.cu: kMaxBuild, kSlots, kEmpty (lines 37-40), slot_of's
# fmix32 (53-61), insert (63-80), member (82-93)

K_SLOTS = int(_const(SIP_CU, "kSlots"))
K_MAX_BUILD = int(_const(SIP_CU, "kMaxBuild"))
EMPTY = {"INT32_MIN": np.iinfo(np.int32).min}[_const(SIP_CU, "kEmpty")]


def _mix_steps():
    body = re.search(r"slot_of\(int32_t key\) \{(.*?)return h & kMask;",
                     SIP_CU, re.S).group(1)
    return [("shift", int(shift)) if op == "^=" else ("mul", int(mul, 16))
            for op, shift, mul in re.findall(
                r"h (\^=|\*=) (?:h >> (\d+)|(0x[0-9a-f]+)u);", body)]


MIX = _mix_steps()


def slot_of(keys) -> np.ndarray:
    h = np.asarray(keys, dtype=np.int32).reshape(-1).view(np.uint32)
    for op, a in MIX:               # uint32 arrays wrap as the card's do
        h = h ^ (h >> np.uint32(a)) if op == "shift" else h * np.uint32(a)
    return (h & np.uint32(K_SLOTS - 1)).astype(np.int64)


class HashSetModel:
    """The set one CTA builds: linear probing over ``K_SLOTS`` slots, the
    empty marker's own flag, and the -1 rule the wrapper passes in."""

    def __init__(self, build):
        build = np.asarray(build, dtype=np.int32)
        self.slots = np.full(K_SLOTS, EMPTY, np.int32)
        self.has_empty = False
        self.minus_one_member = sip_probe.minus_one_member(len(build))
        for key, s in zip(build.tolist(), slot_of(build).tolist()):
            if key == EMPTY:
                self.has_empty = True
                continue
            while self.slots[s] not in (EMPTY, key):
                s = (s + 1) & (K_SLOTS - 1)
            self.slots[s] = key

    def probe(self, keys):
        """Membership of each key, and the slots each probe read."""
        k = np.asarray(keys, dtype=np.int32).reshape(-1)
        hit = np.zeros(k.shape, bool)
        reads = np.zeros(k.shape, np.int64)
        hit[k == EMPTY] = self.has_empty
        ones = (k == -1) & self.minus_one_member
        hit[ones] = True
        active = ~((k == EMPTY) | ones)
        s = slot_of(k)
        while active.any():
            idx = np.flatnonzero(active)
            v = self.slots[s[idx]]
            reads[idx] += 1
            found = v == k[idx]
            hit[idx[found]] = True
            stop = found | (v == EMPTY)
            active[idx[stop]] = False
            go = idx[~stop]
            s[go] = (s[go] + 1) & (K_SLOTS - 1)
        return hit.reshape(np.shape(keys)), reads.reshape(np.shape(keys))


def test_model_constants_mirror_the_sources():
    assert (K_SLOTS, K_MAX_BUILD) == (16384, sip_probe.MAX_BUILD)
    assert K_MAX_BUILD * 4 <= K_SLOTS            # load at most 0.25
    assert MIX == [("shift", 16), ("mul", 0x85EBCA6B), ("shift", 13),
                   ("mul", 0xC2B2AE35), ("shift", 16)]
    assert int(_const(FOLD_CU, "kThreads")) * int(_const(FOLD_CU, "kChunk")) \
        == chip_smoke.PREPASS_BLOCK


@pytest.mark.parametrize("name", list(PROBE_CASES))
def test_hash_set_model_matches_pallas_and_isin(name):
    keys, build = PROBE_CASES[name]
    got, _ = HashSetModel(build).probe(keys)
    padded = np.r_[build, np.full((-len(build)) % 128, -1, np.int32)]
    np.testing.assert_array_equal(got, np.isin(keys, padded))
    if len(build):          # a (1, 0) block has no Pallas form
        want = np.asarray(probe_pallas(jnp.asarray(keys), jnp.asarray(build),
                                       interpret=True))
        np.testing.assert_array_equal(got, want)
    else:
        assert not got.any()


@pytest.mark.parametrize("name", ["int32_extremes_in_build",
                                  "duplicates_ragged", "one_key_4096_times",
                                  "minus_one_in_build_S128", "empty_build"])
def test_hash_set_holds_each_key_once(name):
    _, build = PROBE_CASES[name]
    model = HashSetModel(build)
    distinct = set(build.tolist())
    assert (model.slots != EMPTY).sum() == len(distinct - {EMPTY})
    assert model.has_empty == (EMPTY in distinct)


@pytest.mark.parametrize("name", ["multiples_of_8192",
                                  "multiples_of_16384"])
def test_multiples_of_the_table_size_probe_in_few_slots(name):
    keys, build = PROBE_CASES[name]
    # at most two slots under key & (slots - 1)
    assert len(set((build & (K_SLOTS - 1)).tolist())) <= 2
    model = HashSetModel(build)
    assert (model.slots != EMPTY).sum() == len(build)     # no overflow
    hit, reads = model.probe(keys)
    # linear probing at load 0.25 reads about 1.2 slots a hit and 1.4 a
    # miss; the slots taken do not depend on the order of the inserts
    assert reads[hit].mean() < 1.5 and reads[~hit].mean() < 2.0
    assert reads.max() <= 16
    _, all_reads = model.probe(build)
    assert all_reads.mean() < 1.5 and all_reads.max() <= 16


@pytest.mark.parametrize("n_build", [0, 1, 14, 100, 127, 128, 129, 4000,
                                     4096])
def test_minus_one_flag_is_the_reference_padding(n_build):
    padded = sip_probe._padded(torch.arange(n_build, dtype=torch.int32) + 5)
    assert sip_probe.minus_one_member(n_build) == bool((padded == -1).any())


# ------------------------------------------------- the run fold's model --
# onehot_groupby.cu: kThreads, kChunk (lines 31-34); the loads (62-82),
# the fold (83-108), the write-out (111-114)

K_THREADS = int(_const(FOLD_CU, "kThreads"))
K_CHUNK = int(_const(FOLD_CU, "kChunk"))


def fold_model(keys, values, domain):
    """Per block row: each thread's chunk of ``K_CHUNK`` columns folded
    into runs of equal in-domain keys (an out-of-domain key skipped), one
    flush per run.  Returns the (nb, domain, 2) table, int counts and f32
    sums, and each row's flushes as (key, rows, sum)."""
    nb, B = keys.shape
    out = np.zeros((nb, domain, 2), np.float32)
    cnt = np.zeros((nb, domain), np.int64)
    v32 = values.astype(np.float32)
    flushes = []
    for r in range(nb):
        row = []
        for start in range(0, B, K_CHUNK):       # tiles of K_THREADS chunks
            run_key, n, acc = -1, 0, np.float32(0)
            for u in range(start, min(start + K_CHUNK, B)):
                key = int(keys[r, u])
                if not 0 <= key < domain:
                    continue
                if key != run_key:
                    if n:
                        row.append((run_key, n, acc))
                    run_key, n, acc = key, 0, np.float32(0)
                n += 1
                acc = np.float32(acc + v32[r, u])
            if n:
                row.append((run_key, n, acc))
        for key, n, acc in row:
            cnt[r, key] += n
            out[r, key, 1] = np.float32(out[r, key, 1] + acc)
        flushes.append(row)
    out[..., 0] = cnt
    return out, flushes


@functools.lru_cache(maxsize=None)
def _folded(name):
    return fold_model(*FOLD_CASES[name])


def _bincount(keys, values, domain):
    nb = keys.shape[0]
    ok = (keys >= 0) & (keys < domain)
    idx = (np.arange(nb)[:, None] * domain + np.where(ok, keys, 0))[ok]
    v = values.astype(np.float32).astype(np.float64)[ok]
    return (np.bincount(idx, minlength=nb * domain).reshape(nb, domain),
            np.bincount(idx, weights=v, minlength=nb * domain)
            .reshape(nb, domain))


def _sums_equal(got, want, values):
    if values.dtype == np.float32:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", list(FOLD_CASES))
def test_fold_model_matches_pallas_and_bincount(name):
    keys, values, domain = FOLD_CASES[name]
    got, _ = _folded(name)
    cnt, s = _bincount(keys, values, domain)
    np.testing.assert_array_equal(got[..., 0], cnt)
    _sums_equal(got[..., 1], s, values)
    want = np.asarray(onehot_pallas(jnp.asarray(keys), jnp.asarray(values),
                                    domain=domain, interpret=True))
    np.testing.assert_array_equal(got[..., 0], want[..., 0])
    _sums_equal(got[..., 1], want[..., 1], values)


@pytest.mark.parametrize("name", list(FOLD_CASES))
def test_fold_adds_each_row_once(name):
    """Every in-domain row lands in exactly one flush, and a chunk flushes
    once per change of in-domain key: an out-of-domain key neither joins
    a run nor splits one, and a run crossing a chunk's edge flushes on
    both sides."""
    keys, values, domain = FOLD_CASES[name]
    _, flushes = _folded(name)
    for r, row in enumerate(flushes):
        ok = (keys[r] >= 0) & (keys[r] < domain)
        assert sum(n for _, n, _ in row) == ok.sum()
        runs = 0
        for start in range(0, keys.shape[1], K_CHUNK):
            k = keys[r, start:start + K_CHUNK]
            k = k[(k >= 0) & (k < domain)]
            runs += (len(k) > 0) + int((k[1:] != k[:-1]).sum())
        assert len(row) == runs


def test_one_run_across_every_chunk_flushes_once_per_chunk():
    keys, _, domain = FOLD_CASES["one_run_across_every_chunk"]
    got, flushes = _folded("one_run_across_every_chunk")
    B = keys.shape[1]
    assert [len(row) for row in flushes] == [B // K_CHUNK] * keys.shape[0]
    assert (got[:, 3, 0] == B).all() and got[:, :3].sum() == 0


def test_out_of_domain_keys_inside_runs_drop_out():
    keys, values, domain = FOLD_CASES["out_of_domain_inside_runs"]
    got, flushes = _folded("out_of_domain_inside_runs")
    # [5, 5, -1, 5, 5, 100, 5, INT32_MIN, 5, INT32_MAX, 99, 99, -1, 99,
    #  0, 0]: one run of 5 and one of 99 and 0 a chunk
    assert [k for k, _, _ in flushes[0][:3]] == [5, 99, 0]
    ok = (keys >= 0) & (keys < domain)
    assert got[0, 5, 0] == 6 * 8 and got[..., 0].sum() == ok.sum()
    assert got[0, 5, 1] == values[0][keys[0] == 5].sum()
