"""Numpy models of two redesigned kernels of ``repro_torch.kernels``:
``seg_preagg``'s global route (``csrc/seg_preagg.cu``: 8-row lanes,
256-row warps, sector skipping, a run fold per lane and a segmented scan
across the warp) and ``rle_filter_agg``'s segment table
(``csrc/rle_filter_agg.cu``: warps mapped to segments and rows, lanes to
runs), held against the reference.

Neither kernel runs on the CPU: there the wrappers take their plain
versions.  Here the algorithms themselves are held.  Each model reads its
constants from the ``.cu`` source and repeats the kernel's steps on
chip_smoke.py's ``global_cases`` (at a small n) and ``filter_cases``, the
inputs on which phases 3 and 5 hold the kernels against their plain
versions on the card.

Tolerances: counts, int sums (wrapping) and int min/max exactly; f32
min/max bit for bit in the kernel's order (-0.0 below +0.0), and equal to
the reference's; f32 sums within rtol 1e-5 of the float64 sum of the f32
values.  ``rle_filter_agg``: values are multiples of 0.25 and lengths at
most 9, so every sum is exact and the outputs equal.
"""
import re
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.rle_scan_agg import rle_filter_agg as filter_pallas
from repro.kernels.seg_preagg import seg_preagg_pallas
from repro_torch.kernels import ops, rle_scan_agg

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (the cases phases 3 and 5 run on the card)

CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
SEG_CU = (CSRC / "seg_preagg.cu").read_text()
FILTER_CU = (CSRC / "rle_filter_agg.cu").read_text()


def _const(src: str, name: str) -> int:
    return int(re.search(rf"constexpr \w+ {name} = (\d+);", src).group(1))


# ------------------------------------- seg_preagg's global route model --
# seg_preagg.cu: kLaneRows (the global route's rows a lane), load_chunk,
# fold_tile, seg_preagg_global_kernel, and the launcher's base row

LANE_ROWS = _const(SEG_CU, "kLaneRows")
SECTOR_ROWS = 8     # int32 rows in a 32-byte sector
WARP = 32
N = 4099            # 16 warps and 3 rows: a ragged last tile
DOMAIN = 1000       # within the Pallas kernel's 1,024-key cap
CASES = chip_smoke.global_cases(N, DOMAIN)
I32 = np.int32


def _bits(x: np.ndarray) -> np.ndarray:
    """Each lane as the kernel keeps it: int32 words (f32 as bits)."""
    return np.ascontiguousarray(x).view(I32) if x.dtype == np.float32 \
        else x.astype(I32)


def _ordered(b: int) -> int:                   # seg_preagg.cu's ``ordered``
    return b if b >= 0 else b ^ 0x7FFFFFFF


def _f32(b: int) -> np.float32:
    return np.array([b], I32).view(np.float32)[0]


def _as_bits(f) -> int:
    return int(np.array([f], np.float32).view(I32)[0])


def _identity(kind: str, is_float: bool) -> int:
    if kind == "sum":
        return 0
    if is_float:
        return 0x7F800000 if kind == "min" else _as_bits(-np.inf)
    return np.iinfo(I32).max if kind == "min" else np.iinfo(I32).min


def _combine(kind: str, is_float: bool, a: int, b: int) -> int:
    if kind == "sum":
        if is_float:
            return _as_bits(np.float32(_f32(a) + _f32(b)))
        return (a + b + 2**31) % 2**32 - 2**31                    # wraps
    if is_float:
        lower = _ordered(b) < _ordered(a)
        return (b if lower else a) if kind == "min" else \
            (b if _ordered(b) > _ordered(a) else a)
    return min(a, b) if kind == "min" else max(a, b)


class GlobalRoute:
    """One call of the global route, row layout and all: chunk c is rows
    [base + 8 c, base + 8 c + 8), a tile is 32 chunks (one per lane).
    ``valid_at`` / ``ptr_at``: the byte addresses mod 16 of the valid
    bytes and of the keys and every value column, from which the launcher
    picks the vector range.  Records every atomic it sends (per output
    lane: key, value) and every key row and sector it reads, and checks
    that each vector load is aligned as the card requires."""

    def __init__(self, keys, valid, domain, valid_at=0, ptr_at=0):
        self.keys, self.valid, self.domain = keys, valid, domain
        self.n = len(keys)
        self.valid_at, self.ptr_at = valid_at, ptr_at
        head16 = (16 - valid_at) % 16
        head = min(head16, self.n)
        agree = (ptr_at + 4 * head) % 16 == 0
        # a head clamped to n aligns nothing: element loads throughout
        self.clamped = agree and head16 > self.n
        self.aligned = agree and head16 <= self.n
        self.base = head % LANE_ROWS - LANE_ROWS \
            if self.aligned and head % LANE_ROWS else 0
        n_chunks = -(-(self.n - self.base) // LANE_ROWS)
        self.n_tiles = -(-n_chunks // WARP)
        self.key_sectors, self.key_rows = set(), set()
        self.merged_tiles = 0

    def _chunk(self, t, lane):
        r0 = self.base + (t * WARP + lane) * LANE_ROWS
        vec = self.aligned and r0 >= 0 and r0 + LANE_ROWS <= self.n
        if vec:     # a uint2 of valid bytes, int4s of keys and values
            assert (self.valid_at + r0) % 8 == 0
            assert (self.ptr_at + 4 * r0) % 16 == 0
        m = 0
        for i in range(LANE_ROWS):
            if 0 <= r0 + i < self.n and self.valid[r0 + i]:
                m |= 1 << i
        return r0, vec, m

    def _load(self, col, r0, vec, m, record=False):
        """load_chunk: the lane's sector when it holds a valid row (vector
        range) or the valid rows one by one; unread words are 0."""
        x = [0] * LANE_ROWS
        if vec:
            if m:
                x = list(col[r0:r0 + LANE_ROWS])
                if record:
                    self.key_sectors.add(r0 // SECTOR_ROWS)
                    self.key_rows.update(range(r0, r0 + LANE_ROWS))
        else:
            for i in range(LANE_ROWS):
                if (m >> i) & 1:
                    x[i] = int(col[r0 + i])
                    if record:
                        self.key_sectors.add((r0 + i) // SECTOR_ROWS)
                        self.key_rows.add(r0 + i)
        return [int(v) for v in x]

    def run(self, lanes):
        """``lanes``: (kind, is_float, int32 words or None for the count)
        in the kernel's order.  Returns each lane's (domain,) words and its
        atomics as (key, value) lists."""
        outs = [np.full(self.domain, _identity(k, f), np.int64)
                for k, f, _ in lanes]
        sent = [[] for _ in lanes]
        for t in range(self.n_tiles):
            chunks = [self._chunk(t, lane) for lane in range(WARP)]
            nonempty = [m != 0 for _, _, m in chunks]
            if not any(nonempty):
                continue
            ks, starts, kf, kl = [], [], [], []
            for r0, vec, m in chunks:
                k = self._load(self.keys, r0, vec, m, record=True)
                st, first, prev = 0, 0, 0
                for i in range(LANE_ROWS):
                    if not (m >> i) & 1:
                        continue
                    k[i] = min(max(k[i], 0), self.domain - 1)
                    if not st:
                        first = k[i]
                    if not st or k[i] != prev:
                        st |= 1 << i
                    prev = k[i]
                ks.append(k)
                starts.append(st)
                kf.append(first)
                kl.append(prev)
            nruns = [bin(s).count("1") for s in starts]
            below = [max([j for j in range(lane) if nonempty[j]],
                         default=None) for lane in range(WARP)]
            above = [min([j for j in range(lane + 1, WARP) if nonempty[j]],
                         default=None) for lane in range(WARP)]
            joins = [nonempty[i] and below[i] is not None
                     and kf[i] == kl[below[i]] for i in range(WARP)]
            merge = any(joins)      # else every lane sends all its runs
            self.merged_tiles += merge
            emit_tail = [nonempty[i] and not (above[i] is not None
                                              and kf[above[i]] == kl[i])
                         for i in range(WARP)]
            head = [nonempty[i] and not (nruns[i] == 1 and joins[i])
                    for i in range(WARP)]
            steps = [0] * WARP
            for s in range(5):                 # __shfl_up_sync of the flags
                d = 1 << s
                old = list(head)
                for i in range(d, WARP):
                    if not old[i]:
                        steps[i] |= 1 << s
                    head[i] = old[i] or old[i - d]
            for j, (kind, is_f, col) in enumerate(lanes):
                comb = lambda a, b: _combine(kind, is_f, a, b)  # noqa: E731

                def send(key, v):
                    sent[j].append((key, v))
                    outs[j][key] = comb(int(outs[j][key]), v)

                carry, first = [], []
                for (r0, vec, m), k, st in zip(chunks, ks, starts):
                    v = [1] * LANE_ROWS if col is None else \
                        self._load(col, r0, vec, m)
                    acc = fst = _identity(kind, is_f)
                    cur = seen = 0
                    for i in range(LANE_ROWS):
                        if not (m >> i) & 1:
                            continue
                        if (st >> i) & 1:
                            if not merge and seen:
                                send(cur, acc)
                            elif seen == 1:
                                fst = acc
                            elif seen > 1:
                                send(cur, acc)           # an interior run
                            seen += 1
                            cur, acc = k[i], v[i]
                        else:
                            acc = comb(acc, v[i])
                    if not merge and seen:
                        send(cur, acc)
                    carry.append(acc)
                    first.append(fst)
                if not merge:
                    continue
                for s in range(5):             # the segmented scan
                    d = 1 << s
                    old = list(carry)
                    for i in range(d, WARP):
                        if (steps[i] >> s) & 1:
                            carry[i] = comb(old[i - d], old[i])
                before = [carry[0]] + carry[:-1]
                for i in range(WARP):
                    if nruns[i] > 1:
                        send(kf[i], comb(before[i], first[i]) if joins[i]
                             else first[i])
                    if emit_tail[i]:
                        send(kl[i], carry[i])
        return [o.astype(I32) for o in outs], sent


def _lanes(vals, aggs):
    lanes = [("sum", False, None)]
    for _, col, kind in aggs:
        if kind != "count":
            v = vals[col]
            lanes.append((kind, v.dtype == np.float32, _bits(v)))
    return lanes


def _runs_per_tile(keys, valid, domain, base):
    """Runs of equal clipped keys among the valid rows of each 256-row
    tile: what the warp merge must send, one atomic each."""
    k = np.clip(keys.astype(np.int64), 0, domain - 1)
    rows = np.arange(len(keys))
    total = 0
    for t in np.unique((rows - base) // (WARP * LANE_ROWS)):
        sel = ((rows - base) // (WARP * LANE_ROWS) == t) & valid
        kk = k[sel]
        total += int(len(kk) > 0) + int((kk[1:] != kk[:-1]).sum())
    return total


def _check_against_reference(name, got):
    """``got``: name -> (domain,) result.  Counts, ints and min/max equal
    to the reference's (Pallas where the domain allows) and f32 min/max bit
    for bit in -0.0 < +0.0 order; f32 sums within rtol 1e-5 of float64."""
    keys, valid, vals, domain, aggs = CASES[name]
    jv = {c: jnp.asarray(v) for c, v in vals.items()}
    refs = [ref.seg_preagg_ref(jnp.asarray(keys), jnp.asarray(valid), jv,
                               domain, aggs)]
    if domain <= 1024:
        refs.append(seg_preagg_pallas(jnp.asarray(keys), jnp.asarray(valid),
                                      jv, domain, aggs, interpret=True))
    k = np.clip(keys.astype(np.int64), 0, domain - 1)
    for out_name, col, kind in (("group_count", "*", "count"),) + aggs:
        g = got[out_name]
        for want in refs:
            w = np.asarray(want[out_name])
            if kind == "sum" and vals[col].dtype == np.float32:
                exact = np.bincount(k[valid], vals[col][valid]
                                    .astype(np.float64), minlength=domain)
                np.testing.assert_allclose(g.astype(np.float64), exact,
                                           rtol=1e-5, atol=0)
            else:
                np.testing.assert_array_equal(g, w)
        if kind in ("min", "max") and vals[col].dtype == np.float32:
            np.testing.assert_array_equal(
                g.view(I32), chip_smoke._f32_minmax_bits(
                    keys, valid, vals[col], domain, kind))


def _model_result(name, valid_at=0, ptr_at=0):
    keys, valid, vals, domain, aggs = CASES[name]
    route = GlobalRoute(keys, valid, domain, valid_at, ptr_at)
    outs, sent = route.run(_lanes(vals, aggs))
    got = {"group_count": outs[0]}
    j = 1
    for out_name, col, kind in aggs:
        if kind == "count":
            got[out_name] = outs[0]
            continue
        got[out_name] = outs[j].view(np.float32) \
            if vals[col].dtype == np.float32 else outs[j]
        j += 1
    return got, sent, route


def test_model_constants_mirror_the_source():
    assert LANE_ROWS == SECTOR_ROWS == 8         # a lane's keys: one sector
    assert "__shfl_up_sync(kFull, carry, 1 << s)" in SEG_CU
    assert "if (!m) return;" in SEG_CU
    assert "vec && head % kLaneRows ? head % kLaneRows - kLaneRows : 0" \
        in SEG_CU
    assert "const bool vec = aligned && head16 <= n;" in SEG_CU
    assert "if (!__any_sync(kFull, r.joins)) {" in SEG_CU
    assert (ops.seg_preagg_route(chip_smoke.GLOBAL_DOMAIN, 0)
            == ops.seg_preagg_route(chip_smoke.GLOBAL_DOMAIN, 6) == "global")


@pytest.mark.parametrize("name", list(CASES))
def test_global_route_model_matches_the_reference(name):
    """Aligned inputs: the results, one atomic per run of equal keys per
    warp (never more than valid rows), and key reads only in the 32-byte
    sectors that hold a valid row."""
    keys, valid, vals, domain, aggs = CASES[name]
    got, sent, route = _model_result(name)
    _check_against_reference(name, got)
    runs = _runs_per_tile(keys, valid, domain, route.base)
    assert all(len(s) == runs for s in sent)
    assert runs <= valid.sum()
    pad = np.r_[valid, np.zeros((-N) % SECTOR_ROWS, bool)]
    assert route.key_sectors == set(np.flatnonzero(
        pad.reshape(-1, SECTOR_ROWS).any(1)).tolist())


@pytest.mark.parametrize("name,head,aligned", [
    ("runs_at_lane_and_warp_edges", 15, True),
    ("half_valid_sectors", 15, True),
    ("out_of_range_inside_runs", 0, False),
    ("int_sums_wrap", 0, False)])
def test_global_route_model_off_alignment(name, head, aligned):
    """A slice at an odd offset (valid bytes 15 rows short of a 16-byte
    boundary: chunk 0 is rows [-1, 7)) and pointers that disagree (every
    chunk by element loads) give the aligned result; a key is read only
    where its chunk holds a valid row."""
    keys, valid, _, _, _ = CASES[name]
    # the valid bytes ``head`` bytes short of a 16-byte boundary; the keys
    # and values aligned at that row, or 4 bytes off it
    got, sent, route = _model_result(name, (16 - head) % 16,
                                     (4 * (aligned - 1) - 4 * head) % 16)
    assert route.aligned == aligned
    _check_against_reference(name, got)
    want, _, _ = _model_result(name)
    for out_name, g in got.items():     # whole-number f32 sums: exact
        np.testing.assert_array_equal(g, want[out_name])
    assert set(np.flatnonzero(valid).tolist()) <= route.key_rows


@pytest.mark.parametrize("n", range(8, 16))
def test_global_route_model_short_slices(n):
    """chip_smoke's short slices: calls shorter than the head that would
    align the valid bytes take element loads (the model asserts that every
    vector load is aligned), and give the aligned layout's result."""
    rng = np.random.default_rng(n)
    lanes_of = lambda i, f: [("sum", False, None), ("sum", False, _bits(i)),
                             ("max", True, _bits(f))]
    clamped = 0
    for m, ok, ov, oi in chip_smoke.short_slice_cases():
        if m != n:
            continue
        assert oi == ok                 # one offset for keys and values
        keys = np.sort(rng.integers(-1, 4, n)).astype(I32)
        valid = rng.random(n) < 0.8
        i = rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(I32)
        f = rng.integers(-8, 8, n).astype(np.float32)
        route = GlobalRoute(keys, valid, DOMAIN, ov % 16, 4 * ok % 16)
        got, _ = route.run(lanes_of(i, f))
        want, _ = GlobalRoute(keys, valid, DOMAIN).run(lanes_of(i, f))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        k = np.clip(keys, 0, DOMAIN - 1)[valid]
        np.testing.assert_array_equal(got[0], np.bincount(k, minlength=DOMAIN))
        clamped += route.clamped
    if n < 15:          # some call's pointers agree at the clamped head
        assert clamped


def test_sorted_keys_send_one_atomic_per_run_and_warp():
    """Runs that end exactly at, and one row past, lane and warp edges:
    lanes whose one run continues the lane below send nothing, so each
    output lane sends one atomic per (run, warp) pair."""
    keys, valid, _, _, _ = CASES["runs_at_lane_and_warp_edges"]
    _, sent, _ = _model_result("runs_at_lane_and_warp_edges")
    pairs = {(int(keys[r]), r // (WARP * LANE_ROWS)) for r in range(N)}
    assert all(len(s) == len(pairs) for s in sent)
    # about 1 in 10 rows starts a run here; the old kernel sent N
    assert len(sent[0]) < N // 8


# ------------------------------------- rle_filter_agg's segment table --
# rle_filter_agg.cu: RLE_FILTER_MAX_SEGS, kThreads, row_lanes, seg_warps,
# the launcher's prefix sums

FILTER_CASES = chip_smoke.filter_cases()
MAX_SEGS = int(re.search(r"#define RLE_FILTER_MAX_SEGS (\d+)",
                         FILTER_CU).group(1))


def _row_lanes(R):
    p = 1
    while p < R:
        p <<= 1
    return p


def filter_layout(segments):
    """Which (segment, row, run) each (warp, lane) of one launch reads, and
    the output row it writes: R <= 32 gives each row next_pow2(R) lanes,
    R > 32 gives it a warp whose lanes stride over its runs."""
    warp_start, out_row, rows = [0], [], 0
    for rv, _ in segments:
        nb, R = rv.shape
        per_warp = 32 // _row_lanes(R) if R <= 32 else 1
        out_row.append(rows)
        rows += nb
        warp_start.append(warp_start[-1] + -(-nb // per_warp))
    reads, writes = [], []
    for w in range(warp_start[-1]):
        s = max(i for i in range(len(segments)) if warp_start[i] <= w)
        nb, R = segments[s][0].shape
        P = 32 if R > 32 else _row_lanes(R)
        for lane in range(32):
            row = (w - warp_start[s]) if R > 32 else \
                (w - warp_start[s]) * (32 // P) + lane // P
            if row >= nb:
                continue
            reads += [(s, row, j) for j in range(lane % P, R, P)]
            if lane % P == 0:
                writes.append((s, row, out_row[s] + row))
    return reads, writes


def test_filter_constants_mirror_the_source():
    assert MAX_SEGS == rle_scan_agg._MAX_SEGS == 64
    assert _const(FILTER_CU, "kThreads") % 32 == 0


@pytest.mark.parametrize("name", list(FILTER_CASES))
def test_filter_layout_reads_each_run_once(name):
    segs, _, _ = FILTER_CASES[name]
    for start in range(0, len(segs), MAX_SEGS):       # one launch each
        part = segs[start:start + MAX_SEGS]
        reads, writes = filter_layout(part)
        want = [(s, r, j) for s, (rv, _) in enumerate(part)
                for r in range(rv.shape[0]) for j in range(rv.shape[1])]
        assert sorted(reads) == want
        assert [o for _, _, o in writes] == list(range(len(writes)))
        assert [(s, r) for s, r, _ in writes] == \
            [(s, r) for s, (rv, _) in enumerate(part)
             for r in range(rv.shape[0])]


@pytest.mark.parametrize("name", list(FILTER_CASES))
def test_filter_many_plain_matches_pallas_per_segment(name):
    segs, lo, hi = FILTER_CASES[name]
    got = ops.rle_filter_agg_many([(torch.from_numpy(v), torch.from_numpy(n))
                                   for v, n in segs], lo=lo, hi=hi).numpy()
    assert got.shape == (sum(v.shape[0] for v, _ in segs), 3)
    # every segment padded to one (rows, 128 k) f32 shape (zero lengths
    # drop out), so the Pallas kernel compiles once a case
    width = 128 * max(1, -(-max(v.shape[1] for v, _ in segs) // 128))
    rows = max(v.shape[0] for v, _ in segs)
    row = 0
    for v, n in segs:
        nb, R = v.shape
        part = got[row:row + nb]
        row += nb
        if not nb:
            continue
        pv = np.zeros((rows, width), np.float32)
        pn = np.zeros((rows, width), np.float32)
        pv[:nb, :R], pn[:nb, :R] = v, n
        want = np.asarray(filter_pallas(jnp.asarray(pv), jnp.asarray(pn),
                                        lo=lo, hi=hi, interpret=True))[:nb]
        np.testing.assert_array_equal(part, want)
        if R == 0:
            np.testing.assert_array_equal(part, [[0, 0, -np.inf]] * nb)


def test_filter_many_is_the_cat_of_single_calls():
    segs, lo, hi = FILTER_CASES["70_segments"]
    t = [(torch.from_numpy(v), torch.from_numpy(n)) for v, n in segs]
    got = ops.rle_filter_agg_many(t, lo=lo, hi=hi)
    each = torch.cat([ops.rle_filter_agg(v, n, lo=lo, hi=hi) for v, n in t])
    assert torch.equal(got, each)
    with pytest.raises(ValueError):
        ops.rle_filter_agg_many([], lo=lo, hi=hi)
    with pytest.raises(ValueError):
        ops.rle_filter_agg_many([(torch.zeros(2, 3), torch.zeros(2, 4))],
                                lo=lo, hi=hi)
