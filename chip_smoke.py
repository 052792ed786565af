#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py            # from the repository root, one GPU

Phases, one line each (any failure raises and the script exits non-zero):

1. the card and software: ``nvidia-smi`` name and power limit, torch and
   CUDA versions;
2. build: every kernel of ``src/repro_torch/kernels/csrc`` compiled by
   ``nvcc`` for sm_90a (one process per source, in parallel), with the
   seconds it took;
3. after the host load of the data below, every column of a lineitem
   and an orders container decoded on the card bit for bit against the
   host decode (FLOAT_SCALED's division included); ``bitunpack_segments``
   bit for bit against its plain version on its edge cases (widths 1, 6,
   21, 31, 32, empty kept lists, 70 segments, word rows and outputs off
   16-byte alignment, block_rows 64 and 98, a base of INT32_MAX;
   ``segment_checks``); bitunpack and
   rle_grouped_agg against their plain PyTorch versions on the card, on
   the payloads of a real lineitem container: bitunpack bit-exact for
   every width 1..32 with and without base; rle_grouped_agg counts
   exact, sums within rtol 1e-5, on one container's runs and on every
   lineitem container's runs in one call (the whole scan of Q4, also
   against numpy); then seg_preagg's edge cases on both of its routes
   (shared-memory and global; ``seg_preagg_case_checks``, with the global
   route's lane fold, warp merge and sector skipping on ``global_cases``:
   runs ending at and one row past lane and warp edges, one key for
   every row and a distinct one, random keys at domain 150,000, all rows
   invalid, half-valid sectors, out-of-range keys inside runs, int sums
   that wrap, f32 min/max over signed zeros and infinities) and
   rle_grouped_agg's on lists of segments (``rle_case_checks``), each
   against the plain version on the card;
4. the main path at TPC-H SF1 cardinalities (6,000,000 lineitem and
   1,500,000 orders rows from ``star_schema(seed=0)``) in the layout of
   ``benchmarks/cstore_queries.py::build_db`` (4 nodes, k_safety=0,
   block_rows=4096, RLE l_shipdate): the seven queries Q1-Q7 through
   ``db.query(...).collect()``, cold then warm, and one query scanning
   ``orders`` as the fact table, each held against a float64 numpy
   oracle (counts and int sums exact, float sums and avgs rtol 1e-4).
   The kernels' launch counters are zeroed just before and read just
   after: every kernel must have launched (each query's line shows its
   launches as bitunpack/seg_preagg/rle_grouped_agg, cold and warm), and
   Q4 launches rle_grouped_agg exactly once cold and once warm.
   seg_preagg is then held against its plain version on the very inputs
   the main path gave it, once per shape (query, rows, domain): ints,
   counts and min/max exact, f32 sums and avgs within rtol 1e-5 of the
   float64 sums (atomics reorder the sums; the row gives the plain
   version's gap to them too).  Then
   one more warm run of each query under torch.profiler gives its
   device time (device kernels only) and busy share;
5. the kernel entry point ``repro_torch.kernels.ops`` at full size on
   the same database (the reference reaches these four kernels only
   through its ``kernels.ops``): ``rle_filter_agg_many`` over the RLE
   l_shipdate runs of every lineitem container, one launch for Q1's
   [180, 180] and one for Q3's [61, 119] (each container's rows equal to
   its own ``rle_filter_agg`` call and the plain version, and the counts,
   sums and max, tail padding subtracted, equal to numpy's);
   ``bitunpack`` then ``delta_decode`` over the DELTA_RANGE
   o_orderkey of every orders container on node 0 (bit for bit equal to
   the host decode); ``onehot_groupby`` on the keys and values the main
   path gave ``seg_preagg`` for Q3 and Qorders (invalid rows keyed -1;
   per-block partials summed equal to ``seg_preagg``'s counts exactly and
   its sums within rtol 1e-5); ``semijoin_probe`` of every lineitem
   container's decoded l_orderkey against the o_orderkeys of the orders
   with o_orderdate 0, the build side cut into chunks of 4096 and OR-ed
   (equal to ``np.isin``).  The launch counters are zeroed before and
   read after this run: each of the four must have launched.  Each
   kernel's outputs are also held against its plain version on the card
   (ints and counts exact, f32 sums within rtol 1e-5), and one float
   ``delta_decode`` case at (123, 4096) within rtol 1e-5 of the running
   magnitude.  Each row also carries the library call's device ms and
   the wrapper's host enqueue us per call.  Then ``api_case_checks``:
   ``semijoin_probe`` and ``onehot_groupby`` against their plain
   versions on the edge cases of ``probe_cases`` / ``fold_cases``
   (INT32_MIN and INT32_MAX on both sides, -1 probes at S % 128 zero and
   not, -1 in the build side, an empty build side, duplicates, one key
   4,096 times, 4,096 multiples of 8,192 and of 16,384; sorted and random
   keys, out-of-domain keys inside runs, one run across every chunk,
   ragged rows, two tiles, int sums that would wrap), aligned and off
   16-byte alignment: booleans and counts exactly, sums within rtol 1e-5;
   and ``rle_filter_agg_many`` on ``filter_cases`` (R = 0, 1, 4, 33, 128,
   mixed R in one launch, empty segments, 70 segments, int32 and f32)
   against its plain version and the per-segment calls, exactly;
6. compressed-domain execution (``compressed_phase``): on the main
   database at ``benchmarks/cstore_queries.py``'s constrained budget
   (max(0.55 (packed + decoded), 2 packed + 1 MiB) over l_shipdate,
   l_suppkey, l_qty, l_extprice), Q2, Q3, Q6 and Q7 in "auto" (each
   must take the compressed scan) and Qorders in "auto" (must stay
   decoded) then forced "compressed"; then a second SF1 lineitem from
   the same arrays with BLOCK_DICT l_qty, where Qdict_filter (l_qty < 24
   and 60 < l_shipdate < 120, by l_suppkey, sum l_extprice) and
   Qdict_group (10 <= l_qty <= 20, by l_qty, count) run forced
   "compressed".  Each query runs cold and warm in its mode on a fresh
   cache of that budget with the packed payloads protected, then cold
   and warm in "decoded" on another: both against the oracle and each
   other (ints exact, floats rtol 1e-4), no decoded block of the scanned
   table cached, and warm ``bitunpack`` launches equal to its packed
   predicate columns (``[compressed]`` lines; ``[launches]
   path=compressed`` counts the compressed runs, each zeroed just before
   and read just after), then ``bitunpack_segments`` over the l_qty codes
   of all 12 containers in one launch, timed;
7. a trickle load of 10,000 rows into the WOS: Q3 and Q5 take the
   general path, and served through ``db.serve()`` with two corpus
   shapes (one shared scan, the WOS rows on its general path) equal
   their solo runs; then again after
   ``run_tuple_mover(force_moveout=True)``, all against the oracle;
8. the LM serving path (the database is freed first): the bf16 flash
   kernels' machine code must hold warpgroup MMAs (``[sass]`` lines:
   HGMMA and FFMA counted by ``cuobjdump`` per kernel, in the forward's
   library, whose 4 bf16 kernels -- head dims padded to 64 and 128, with
   and without the lse store -- must hold HGMMA, and the backward's, whose
   every bf16 kernel -- dq and dk/dv at the two paddings -- must hold
   HGMMA, and whose other kernels are the f32 ones); then qwen3-4b at
   its
   published width (36 layers, 4.02e9 parameters) built on the card in
   bf16 from seed 0, then, with the counters zeroed just before and read
   just after, ``serve.generate`` on 4 prompts of 512 tokens (ids from
   numpy, seed 0) plus 32 greedy tokens and on 1 prompt of 4096 plus 2:
   ``flash_attention`` must launch once per layer and prefill (72, and
   nothing else launches), each ``[lm]`` line shows prefill ms, decode
   ms per step, tokens/s and the peak memory of that generation.  Then
   a ``FlashCapture`` records every layer's kernel inputs in the same
   prefill run again (its first token must equal the generation's); the
   kernel is held against its plain version on each, on a ragged
   S = 500, on f32 (256, 128) inputs, and on bf16 cases for the tensor-core
   kernel's other paths (head dims 64 and 96, non-causal 128 x 384 at
   head dim 128): max |err| within the reference
   test's 2e-2 (bf16) or 2e-3 (f32), and every element within 2 ulps of
   the larger of its two values in the output's type plus 1e-5; decode
   from the prefill cache against a prefill of S + 1 tokens (max |logit
   gap| < 0.5, tests/test_models.py's tolerance) and the prefill through
   the plain attention instead of the kernel (< 0.5); then one profile
   of a prefill and of a decode step (device kernels only).  Then the
   int8 KV cache on the same weights (``kv_quant=True``): its path at 4
   x 512 (+32) with its own launch count (``arch=qwen3-4b-int8``: 36),
   decode ms a step beside the bf16 cache's, the cache's bytes, peak
   memory; its prefill cache must equal ``quantize_kv`` of the bf16
   prefill's bit for bit, and one decode step's written slot
   ``quantize_kv`` of the step's own k and v in every layer and of the
   bf16 step's slot in layer 0, every other slot unchanged, the logits
   finite (their gap to the bf16 step's printed beside the logit std);
   its profiles.  Then starcoder2-7b (32 layers, d 4608, gelu, 36 query
   heads over 4 kv heads: the kernel at G = 9) and olmoe-1b-7b (16
   layers, 64 experts, top 8, 16 query heads over 16 kv heads: G = 1),
   each freed before the next is built, each at 4 x 512 (+32) only:
   the counted path (``flash_attention`` once per layer, nothing else),
   the kernel against its plain version in every layer, a JSON row,
   decode against a prefill of S + 1 (for olmoe held only where neither
   prefill dropped a (token, k) pair: a dropped pair makes a token's
   output depend on the batch), the prefill through the plain attention
   (< 0.5), the profiles; olmoe also prints a ``[moe]`` line per
   prefill (capacity, dropped pairs per layer, largest and smallest
   expert load).  ``[lm] arch=... seconds=`` closes each model;
9. segmented execution (``segmented_phase``; it runs after phase 7 and
   before phase 8, and frees its databases first) on 4 logical shards of
   the card (``make_query_mesh(4)``): Q1-Q7 and Qorders on the main
   database (after the trickle) with a fresh block cache, cold then warm,
   each segmented with no exchange overflow and equal to the oracle and
   to its mesh-detached run (``[segmented]`` lines: route, exchange,
   cold/warm ms beside the single-node warm ms, stage ms, slab MB,
   launches); ``[launches] path=segmented`` zeroed just before and read
   just after (all three query kernels must launch, Q4's
   rle_grouped_agg once a run), and seg_preagg held against its plain
   version on the inputs of each segmented shape (JSON rows named
   ``seg-Q..``).  Then tests/test_segmented_exec.py's star layout at
   1500x (6,000,000 sales, 450,000 customer, 60,000 supplier, 3,000,000
   parts, 30 promo rows; 4 nodes, K=1): the four join templates must
   take "local", "local", "resegment", "broadcast" and match a numpy
   oracle and the mesh-detached run, loaded, with node 2 failed (its warm
   slabs evicted, buddies serving), after a 10,000-row trickle while it
   is down, and after ``rejoin_node`` and ``recover_node``
   (``[star]``, ``[fail]``, ``[recover]`` lines, ``[launches]
   path=segmented-star`` summing the segmented runs).  Last the Database
   Designer over two star queries, ``create_projection(populate=True)``
   of the first projection it proposes, and the query the planner routes
   to it against the oracle (``[design]``).  ``[step]`` lines give each
   step's seconds.
10. serving (``serving_phase``; it runs after phase 5 and before phase
   6) through ``db.serve()`` on the main database with a fresh 4 GiB
   block cache: tests/test_serving.py's corpus re-keyed onto lineitem
   plus Q1-Q7 and Qorders (two shared scans of 8), then Q1-Q7 and
   Qorders solo twice, then benchmarks/serving.py's closed loop (12
   clients x 12 ops of its re-keyed mix) and its interactive probe
   under a bounded batch flood.  The launch counters are zeroed before
   and read after (``[launches] path=serving``: all three query kernels
   must launch); every served ticket must equal its solo run (ints
   exact, floats rtol 1e-5) and its float64 numpy oracle (phase 4's, or
   ``corpus_oracle`` for the corpus shapes), leave no pin, and each
   drained flight cost one copy.  ``[serving]`` lines: latency
   percentiles, qps beside the same ops run serially, shared-scan hit
   rate, peak reservation, a profiled round's busy share, the flood
   ratio; ``[overlap]`` lines: how often ``_Flight.ready()`` found a
   flight unready and the synchronising calls inside dispatch under
   ``torch.cuda.set_sync_debug_mode("warn")``, by source line.
   seg_preagg is held as in phase 4 on the shared members' inputs (JSON
   rows named ``serve-..``).
11. training (``train_phase``, last; phase 8's model is freed first):
   a. the forward kernels' lse (``return_lse=True``, what training
   saves) against ``flash_attention_plain``'s in bf16 and f32, within
   ``LSE_TOL`` times max(1, max |lse|), the output bit for bit the one
   without lse; one traced ``flash_attention_bwd`` call on the model's
   views must hold exactly its two kernels (no copy, no elementwise
   kernel); then ``flash_attention_bwd`` (the port's own kernel: the
   gradient of the forward, which has no Pallas backward), given the
   forward's lse, against float64 autograd of ``flash_attention_plain``
   on the model's permuted views: bf16 and f32, head dims 64/96/128,
   causal and not, G = 1 and 4, S = 300, S != T both ways (130 x 200
   causal, 200 x 70 not), and the training shapes 4 x 512 and 1 x 4096;
   max |err| of dq, dk, dv within ``BWD_TOL`` times max(1, max |want|),
   the plain backward's gap printed beside it, and a second launch bit
   for bit the first;
   c. qwen3-4b at full width and depth with f32 master weights, bf16
   compute and remat "minimal", 4 x 512 tokens a step from a port
   ``TokenStore`` pinned at its data epoch: one step's loss and global
   grad norm through the kernels and again through the plain versions
   (within ``TRAIN_LOSS_TOL`` / ``TRAIN_GNORM_RTOL``), with the counters
   zeroed just before and read just after (``flash_attention`` 72 = 36
   layers x 2 with the recompute, ``flash_attention_bwd`` 72 = 36 calls
   x 2 launches, nothing else); then 5 AdamW steps, each with those
   launches and a finite loss (``[train]`` lines: step ms, tokens/s),
   the peak ``max_memory_allocated`` of the steps, and of one profiled
   step the device busy share, the kernel ms and the backward kernels'
   ms and share of them;
   b. two ``flash_attention_bwd`` JSON rows at phase 8's shapes (event
   and device ms, bound, plain ms, SDPA's backward alone with kv
   expanded as ``library_ms``, and the launches of one training step);
   d. ``python -m repro_torch.launch.train`` at d 512, 4 layers, vocab
   2048 (head dim 64), run twice in subprocesses, straight and with
   ``--fail-at-step 8`` (buddy restore from the last good epoch, then
   replay): the two final checkpoints equal bit for bit.

The last lines: the card's name and power limit, one JSON object with a
row per kernel and, for seg_preagg, per main-path shape, and for
bitunpack and rle_filter_agg their one-container shape and the whole
scan (``ms``,
``plain_ms``, ``library_ms``: CUDA-event time per call over 20 calls;
``kernel_device_ms``: the kernels of one call in a torch.profiler trace
(for seg_preagg and rle_grouped_agg the output-initialising kernel
included, and ``fold_device_ms`` without it; seg_preagg and phase 5's
rows also give the library call's ``library_device_ms`` from the same
padded traces);
``bound_ms``: the bytes each call must move on its inputs over the
H100's 3.35 TB/s, for ``flash_attention`` and ``flash_attention_bwd``
the larger of that and its flops over the 989 TFLOP/s bf16 rate, with
``bound_by`` and ``bound_share``, the bound over ``kernel_device_ms``
(a flash row whose device time reads below its bound fails);
``kernel_device_ms`` counts the kernel events it sums and fails unless
the trace holds every launch of its calls; ``launches``:
the run of the kernel's path -- the main path, phase 6 for the
whole-scan bitunpack row, phase 5 for the four kernels only ``ops``
reaches, phase 9's SF1 runs for the ``seg-`` seg_preagg rows, phase 10
for the ``serve-`` rows, phase 8's prefill shape of that model, or one
training
step for ``flash_attention_bwd``), and
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
repository beside it, the script fails and prints no result.
"""
from __future__ import annotations

import gc
import json
import os
import re
import subprocess
import sys
import time
import types

import numpy as np

HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3, NVIDIA's data sheet
MAIN_KERNELS = ("bitunpack", "seg_preagg", "rle_grouped_agg")
API_KERNELS = ("rle_filter_agg", "onehot_groupby", "semijoin_probe",
               "delta_decode")
PREPASS_BLOCK = 4096            # rows per onehot_groupby block row
BF16_FLOPS_PER_S = 989e12       # H100 SXM dense bf16 tensor rate
LM_ARCH = "qwen3-4b"
# phase 8's other models, served at LM_SERVE after qwen3-4b: the dense
# config with a gelu MLP and 9 query heads a kv head, the MoE family (16
# query heads over 16 kv heads), the SSM family (attention-free) and the
# hybrid family (25 query heads over 5 kv heads at head dim 64, windowed
# attention but in 3 global layers, an SSD branch in every layer)
LM_FAMILY = ("starcoder2-7b", "olmoe-1b-7b", "mamba2-130m", "hymba-1.5b")
# the LM path's two prefill shapes: (batch, prompt tokens, new tokens)
LM_SERVE = (4, 512, 32)
LM_LONG = (1, 4096, 2)
# the family models served at more shapes than LM_SERVE: at LM_LONG
# hymba's windowed layers mask, its ring cache keeps the last 1,024
# tokens and its decode wraps to slot 0
LM_FAMILY_SHAPES = {"hymba-1.5b": (LM_SERVE, LM_LONG)}
LM_STEPS = 4                    # decode steps held against a prefill
# the chunked SSD against its sequential oracle in f32: max |err| within
# SSD_TOL x max(1, max |want|)
SSD_TOL = 1e-3
FLASH_TOL = {"bfloat16": 2e-2, "float32": 2e-3}   # tests/test_kernels.py
# and per element: |err| <= FLASH_ULPS ulps of max(|got|, |want|) in the
# output's type, plus FLASH_FLOOR for f32 rounding next to zero
FLASH_ULPS, FLASH_FLOOR = 2, 1e-5
N_FACT, N_DIM = 6_000_000, 1_500_000
N_TRICKLE = 10_000
REPO = os.path.dirname(os.path.abspath(__file__))


def _say(phase: str, **kw) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()),
          flush=True)


def _time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds per call, from CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


# A torch.profiler trace loses some of its kernel records: none in a
# fresh process, later the first 4-5 of a session, or runs of them
# further on (PERF.md).  Each trace therefore opens and closes
# with this many spin kernels, which take the loss and are left out of
# every sum; a trace that kept none of its opening or of its closing
# spin kernels fails, since it may have lost measured ones too.
PROFILE_PAD_KERNELS = 1024
PAD_KERNEL = "spin_kernel"      # torch.cuda._sleep's kernel


def _pad_kernels() -> None:
    import torch
    torch.cuda.synchronize()
    for _ in range(PROFILE_PAD_KERNELS):
        torch.cuda._sleep(100)
    torch.cuda.synchronize()


def _traced(fn, reps: int):
    """A torch.profiler trace of ``reps`` calls of ``fn`` (after one
    untraced warm-up call), between two runs of ``PROFILE_PAD_KERNELS``
    spin kernels on an idle card."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _pad_kernels()
        for _ in range(reps):
            fn()
        _pad_kernels()
    return prof


class TraceLoss(AssertionError):
    """A profiler trace that may have lost measured kernel records."""


def _device_events(prof):
    """The trace's device kernel events less its spin kernels; raises
    ``TraceLoss`` unless some of the opening spin kernels come before the
    first of them and some of the closing ones after the last."""
    from torch.autograd import DeviceType
    dev = sorted((e for e in prof.events()
                  if e.device_type == DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    pads = [i for i, e in enumerate(dev) if PAD_KERNEL in e.name]
    calls = [i for i, e in enumerate(dev) if PAD_KERNEL not in e.name]
    first, last = (calls[0], calls[-1]) if calls else (len(dev), -1)
    if not (pads and pads[0] < first and pads[-1] > last):
        raise TraceLoss(f"profiler trace kept {len(pads)} of its "
                        f"{2 * PROFILE_PAD_KERNELS} spin kernels, not one "
                        f"on each side of the measured calls: it may have "
                        f"lost some of their kernels")
    return [dev[i] for i in calls]


def _profile(fn, reps: int = 1):
    """Device milliseconds per call of the device kernels in a
    torch.profiler trace of ``reps`` calls: the total and the share by
    kernel name.  Returns (None, {}) when the trace holds no kernel.  A
    trace that may have lost kernel records (``TraceLoss``) is printed as
    a ``[profile]`` line and taken again, up to ``PROFILE_ATTEMPTS``
    times, as ``_kernel_device_ms`` does; then the run fails."""
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        try:
            events = _device_events(_traced(fn, reps))
            break
        except TraceLoss as e:
            if attempt == PROFILE_ATTEMPTS:
                raise
            _say("profile", lost_kernels="trace", attempt=attempt,
                 why=str(e).replace(" ", "_")[:200])
    by_name = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) \
            + e.time_range.elapsed_us() / 1e3 / reps
    total = sum(by_name.values())
    return (total or None), by_name


def _kernel_events(fn, reps: int, kernel: str, exclude: str = None):
    """The device kernel events of a trace of ``reps`` calls whose names
    hold ``kernel`` (and not ``exclude``), as (start us, duration us), and
    the trace's count of all device kernel events of the calls."""
    dev = _device_events(_traced(fn, reps))
    hit = [(e.time_range.start, e.time_range.elapsed_us()) for e in dev
           if kernel in e.name and not (exclude and exclude in e.name)]
    return sorted(hit), len(dev)


PROFILE_REPS, PROFILE_ATTEMPTS = 20, 3


def _kernel_device_ms(fn, kernel: str, exclude: str = None,
                      per_call: int = None) -> float:
    """Device ms per call of the CUDA kernels whose names hold ``kernel``
    (and not ``exclude``), summed over the kernel events of a trace of
    ``PROFILE_REPS`` calls: without launch gaps and without the torch
    ops around them.  ``per_call`` is the number of such kernels one call launches;
    where that depends on the data (a launcher that initialises its
    output in a kernel of its own on one route only) it is counted in a
    trace of one call, and must be at least 1.  A trace of
    ``PROFILE_REPS`` calls must hold exactly ``PROFILE_REPS * per_call``
    of them, so no kernel's time can go missing unnoticed (a row whose
    device time reads below its bound): one that does not is printed as a
    ``[profile]`` line and traced again, up to ``PROFILE_ATTEMPTS`` times,
    then the run fails."""
    reps, why = PROFILE_REPS, ""
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        try:
            n = per_call
            if n is None:
                n = len(_kernel_events(fn, 1, kernel, exclude)[0])
                if n < 1:
                    raise TraceLoss("a trace of one call holds no such "
                                    "kernel")
            hit, n_dev = _kernel_events(fn, reps, kernel, exclude)
            if len(hit) == reps * n:
                return sum(d for _, d in hit) / 1e3 / reps
            t0 = hit[0][0] if hit else 0.0
            why = (f"the trace of {reps} calls holds {len(hit)} of the "
                   f"{reps * n} kernels they launch ({n_dev} device kernel "
                   f"events in all; matched events at "
                   f"{[(round(t - t0, 1), round(d, 1)) for t, d in hit][:6]}"
                   f" us)")
        except TraceLoss as e:
            why = str(e)
        _say("profile", lost_kernels=kernel.replace(" ", "_"),
             attempt=attempt, why=why.replace(" ", "_")[:200])
    raise AssertionError(f"device time of {kernel!r}: {why}")


def _fmt(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f}"


# ------------------------------------------------------------------ data --

def build_db(fact, dim, device, block_rows=4096, cache_budget=4 << 30,
             encodings=None):
    """The cstore_queries layout, built with the port; ``encodings`` adds
    lineitem column encodings to the RLE l_shipdate, and ``dim=None``
    leaves orders out."""
    from repro_torch.core import (ColumnDef, Encoding, SQLType, TableSchema,
                                  VerticaDB, super_projection)
    db = VerticaDB(n_nodes=4, k_safety=0, block_rows=block_rows,
                   cache_budget_bytes=cache_budget, device=device)
    schema = TableSchema("lineitem", (
        ColumnDef("l_orderkey"), ColumnDef("l_suppkey"),
        ColumnDef("l_shipdate"), ColumnDef("l_qty"),
        ColumnDef("l_extprice", SQLType.FLOAT)))
    db.catalog.add_table(schema)
    db.create_projection(super_projection(
        schema, ("l_shipdate", "l_suppkey"), ("l_orderkey",),
        encodings={"l_shipdate": Encoding.RLE, **(encodings or {})}))
    if dim is not None:
        db.create_table(TableSchema("orders", (
            ColumnDef("o_orderkey"), ColumnDef("o_custkey"),
            ColumnDef("o_orderdate"))), sort_order=("o_orderkey",),
            segment_by=())
    t = db.begin(direct_to_ros=True)
    db.insert(t, "lineitem", fact)
    if dim is not None:
        db.insert(t, "orders", dim)
    db.commit(t)
    return db


def make_queries(db):
    """Q1-Q7 of benchmarks/cstore_queries.py, plus a scan of orders."""
    from repro_torch.engine import col
    li = db.query("lineitem")
    return {
        "Q1": li.where(col("l_shipdate") == 180).agg(c=("*", "count")),
        "Q2": li.where(col("l_shipdate") == 180)
                .group_by("l_suppkey").agg(c=("*", "count")),
        "Q3": li.where((col("l_shipdate") > 60) & (col("l_shipdate") < 120))
                .group_by("l_suppkey").agg(s=("l_qty", "sum")),
        "Q4": li.group_by("l_shipdate").agg(c=("*", "count")),
        "Q5": li.join("orders", on=("l_orderkey", "o_orderkey"),
                      cols=("o_custkey",), where=col("o_orderdate") < 60)
                .group_by("o_custkey").agg(s=("l_extprice", "sum")),
        "Q6": li.where(col("l_shipdate") > 300)
                .group_by("l_suppkey").agg(a=("l_extprice", "avg")),
        "Q7": li.where(col("l_suppkey") < 10)
                .join("orders", on=("l_orderkey", "o_orderkey"),
                      cols=("o_custkey",))
                .group_by("o_custkey").agg(c=("*", "count")),
        "Qorders": db.query("orders").where(col("o_orderkey") < N_DIM // 2)
                     .group_by("o_orderdate")
                     .agg(n=("*", "count"), s=("o_custkey", "sum")),
    }


def oracle(name, fact, dim):
    """Independent float64 numpy answer: {group key: {agg: value}} as
    (keys, {agg: values}) sorted by key; scalar queries use key 0."""
    f, d = fact, dim
    sd = f["l_shipdate"]
    if name == "Q1":
        return np.zeros(1, np.int64), {"c": np.array([(sd == 180).sum()])}
    if name == "Qorders":
        m = d["o_orderkey"] < N_DIM // 2
        keys, inv = np.unique(d["o_orderdate"][m], return_inverse=True)
        return keys, {"n": np.bincount(inv),
                      "s": np.bincount(inv, d["o_custkey"][m]
                                       .astype(np.float64))}
    qty = f["l_qty"]
    if name == "Qdict_filter":
        m = (qty < 24) & (sd > 60) & (sd < 120)
        keys, inv = np.unique(f["l_suppkey"][m], return_inverse=True)
        return keys, {"s": np.bincount(inv, f["l_extprice"][m]
                                       .astype(np.float64))}
    if name == "Qdict_group":
        keys, inv = np.unique(qty[(qty >= 10) & (qty <= 20)],
                              return_inverse=True)
        return keys, {"c": np.bincount(inv)}
    cust = d["o_custkey"][f["l_orderkey"]]        # o_orderkey == position
    if name == "Q2":
        m, key, agg = sd == 180, f["l_suppkey"], ("c", None, "count")
    elif name == "Q3":
        m, key, agg = (sd > 60) & (sd < 120), f["l_suppkey"], \
            ("s", f["l_qty"], "sum")
    elif name == "Q4":
        m, key, agg = np.ones(sd.size, bool), sd, ("c", None, "count")
    elif name == "Q5":
        m = d["o_orderdate"][f["l_orderkey"]] < 60
        key, agg = cust, ("s", f["l_extprice"], "sum")
    elif name == "Q6":
        m, key, agg = sd > 300, f["l_suppkey"], ("a", f["l_extprice"], "avg")
    else:   # Q7
        m, key, agg = f["l_suppkey"] < 10, cust, ("c", None, "count")
    keys, inv = np.unique(key[m], return_inverse=True)
    cnt = np.bincount(inv)
    out, vals, kind = agg
    if kind == "count":
        return keys, {out: cnt}
    s = np.bincount(inv, vals[m].astype(np.float64))
    return keys, {out: s / cnt if kind == "avg" else s}


KEY_COL = {"Q1": None, "Q2": "l_suppkey", "Q3": "l_suppkey",
           "Q4": "l_shipdate", "Q5": "o_custkey", "Q6": "l_suppkey",
           "Q7": "o_custkey", "Qorders": "o_orderdate",
           "Qdict_filter": "l_suppkey", "Qdict_group": "l_qty"}


def check(name, res, fact, dim) -> None:
    keys, want = oracle(name, fact, dim)
    key_col = KEY_COL[name]
    got_keys = np.zeros(1, np.int64) if key_col is None \
        else np.asarray(res[key_col]).astype(np.int64)
    order = np.argsort(got_keys, kind="stable")
    if not np.array_equal(got_keys[order], keys):
        raise AssertionError(f"{name}: group keys differ from the oracle")
    for agg, w in want.items():
        g = np.asarray(res[agg])[order]
        if np.issubdtype(g.dtype, np.integer):
            if not np.array_equal(g.astype(np.int64),
                                  np.asarray(w).astype(np.int64)):
                raise AssertionError(f"{name}.{agg}: ints differ")
        elif not np.allclose(g.astype(np.float64), w, rtol=1e-4, atol=0):
            err = np.max(np.abs(g - w) / np.maximum(np.abs(w), 1e-30))
            raise AssertionError(f"{name}.{agg}: rel err {err:.3g}")


# -------------------------------------------------------------- kernels --

def decode_checks(db, device) -> None:
    """Every column of one lineitem and one orders container decoded on
    the card (``decode_torch``, bitunpack included) against the host
    ``EncodedColumn.decode_blocks()`` in the 32-bit lanes, bit for bit --
    FLOAT_SCALED's division included."""
    from repro_torch.core.encodings import decode_torch
    seen = {}
    for table in ("lineitem_super", "orders_super"):
        c = db.nodes[0].stores[table].containers[0]
        for name, col in c.columns.items():
            got = decode_torch(col, device).cpu().numpy()
            host = col.decode_blocks()
            host = host.astype(np.float32 if host.dtype.kind == "f"
                               else np.int32)
            if got.dtype != host.dtype or got.shape != host.shape or \
                    not np.array_equal(got.view(np.uint32),
                                       host.view(np.uint32)):
                raise AssertionError(f"{table}.{name} ({col.encoding}): "
                                     f"card decode differs from host")
            seen[name] = col.encoding.value
    _say("decode", bit_exact=True,
         columns=json.dumps(seen, separators=(",", ":")))


def segment_checks(device) -> None:
    """``bitunpack_segments`` (the compressed scan's one launch per
    predicate column) bit for bit against its plain version on the card:
    widths 1, 6, 21, 31 and 32 with and without a base of INT32_MAX (it
    wraps), segments with no kept block, 70 segments in one launch, word
    rows at an offset and a row stride that are not 16-byte aligned,
    block_rows 64 and 98 (output rows at an 8-byte offset, a ragged last
    quad), then the one-segment ``bitunpack`` on the unaligned rows."""
    import torch
    from repro_torch.core.encodings import to_device
    from repro_torch.kernels import ops
    rng = np.random.default_rng(17)
    i32_max = np.int32(2**31 - 1)

    def stream(nb, br, width, offset=0):
        ng = -(-br // 32)
        bits = rng.integers(0, 1 << 32, (nb, ng * width + offset),
                            dtype=np.uint64).astype(np.uint32)
        return to_device(bits, device)[:, offset:]

    def base(nb, kind):
        if kind is None:
            return None
        b = np.full(nb, i32_max) if kind == "max" else             rng.integers(-2**31, 2**31, nb, dtype=np.int64).astype(np.int32)
        return torch.as_tensor(b, device=device)

    def kept(nb, kind):
        return {"all": None, "none": np.zeros(0, np.int64),
                "some": np.sort(rng.choice(nb, max(1, nb // 3),
                                           replace=False)),
                "shuffled": rng.permutation(nb)}[kind]

    cases = []                                   # (what, block_rows, segs)
    for br in (4096, 64, 98):
        cases.append((f"widths br={br}", br, [
            ops.Segment(stream(7, br, w), w, base(7, b), kept(7, k))
            for w, b, k in ((1, None, "all"), (6, "max", "some"),
                            (21, "rand", "none"), (31, "max", "shuffled"),
                            (32, None, "some"), (32, "max", "all"))]))
        cases.append((f"unaligned rows br={br}", br, [
            ops.Segment(stream(5, br, w, offset=1), w, base(5, "max"),
                        kept(5, "shuffled")) for w in (1, 6, 21, 31, 32)]))
    cases.append(("70 segments", 64, [
        ops.Segment(stream(3, 64, int(w)), int(w), base(3, b), kept(3, k))
        for w, b, k in zip(rng.integers(1, 33, 70),
                           ["max", None, "rand"] * 24,
                           ["all", "none", "some", "shuffled"] * 18)]))
    cases.append(("only empty", 64, [
        ops.Segment(stream(3, 64, 6), 6, None, kept(3, "none"))] * 3))
    n_launch = ops.launch_counts()["bitunpack"]
    for what, br, segs in cases:
        got = ops.bitunpack_segments(segs, br)
        want = ops.bitunpack_segments_plain(segs, br)
        torch.cuda.synchronize()
        if got.shape != want.shape or not torch.equal(got, want):
            raise AssertionError(f"bitunpack_segments {what}: not "
                                 f"bit-exact against its plain version")
        if what.startswith("unaligned"):
            for sg in segs:
                one = ops.bitunpack(sg.words, sg.width, br, base=sg.base)
                if not torch.equal(one, ops.bitunpack_plain(
                        sg.words, sg.width, br, sg.base)):
                    raise AssertionError(f"bitunpack {what} "
                                         f"w={sg.width}: not bit-exact")
    launched = ops.launch_counts()["bitunpack"] - n_launch
    _say("kernel", name="bitunpack_segments", bit_exact=True,
         cases=len(cases), widths="1,6,21,31,32,random",
         block_rows="4096,64,98", segments_max=70, launches=launched)


def kernel_checks(db, device):
    """Phase 3: bitunpack and rle_grouped_agg against their plain versions
    on the card, on the payloads of a real lineitem container (seg_preagg
    is checked on the main path's own inputs: seg_preagg_rows)."""
    import torch
    from repro_torch.core.encodings import to_device
    from repro_torch.kernels import ops
    rows = []
    container = db.nodes[0].stores["lineitem_super"].containers[0]
    rng = np.random.default_rng(0)

    # --- bitunpack: every width at the container's block count, then the
    # container's packed l_orderkey stream
    col = container.columns["l_orderkey"]
    nb, br = col.n_blocks, col.block_rows
    worst = 0
    for width in range(1, 33):
        words = to_device(rng.integers(0, 1 << 32, (nb, br // 32 * width),
                                       dtype=np.uint64)
                          .astype(np.uint32), device)
        base = torch.as_tensor(rng.integers(-2**31, 2**31, nb,
                                            dtype=np.int64)
                               .astype(np.int32), device=device)
        for b in (None, base):
            got = ops.bitunpack(words, width, br, base=b)
            want = ops.bitunpack_plain(words, width, br, base=b)
            worst = max(worst, int((got.long() - want.long()).abs().max()))
            if not torch.equal(got, want):
                raise AssertionError(f"bitunpack width {width} base "
                                     f"{b is not None}: not bit-exact")
    if col.encoding.value != "delta_value":
        raise AssertionError(f"l_orderkey is {col.encoding}, expected a "
                             f"packed DELTA_VALUE stream")
    width = col.widths["deltas_packed"]
    words = to_device(col.arrays["deltas_packed"], device)
    base = to_device(col.arrays["base"], device)
    got = ops.bitunpack(words, width, br, base=base)
    want = ops.bitunpack_plain(words, width, br, base=base)
    host = col.decode_blocks()
    if not (torch.equal(got, want)
            and np.array_equal(got.cpu().numpy(), host.astype(np.int32))):
        raise AssertionError("bitunpack on l_orderkey: not bit-exact")
    nbytes = words.numel() * 4 + got.numel() * 4 + base.numel() * 4
    rows.append({
        "name": "bitunpack", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/bitunpack.cu",
        "replaces": "src/repro/kernels/bitunpack.py:120",
        "max_abs_err": float(worst),
        "ms": _time_ms(lambda: ops.bitunpack(words, width, br, base=base)),
        "plain_ms": _time_ms(lambda: ops.bitunpack_plain(
            words, width, br, base=base)),
        "bound_ms": _bound_ms(nbytes), "bound_by": "bytes",
        "library_ms": None,
        "kernel_device_ms": _kernel_device_ms(
            lambda: ops.bitunpack(words, width, br, base=base),
            "bitunpack_kernel"),
        "shape": f"words {tuple(words.shape)} w={width} + base"})
    _say("kernel", name="bitunpack", widths="1..32", base="with+without",
         bit_exact=True, real_width=width, ms=f"{rows[-1]['ms']:.4f}",
         kernel_device_ms=_fmt(rows[-1]["kernel_device_ms"]),
         plain_ms=f"{rows[-1]['plain_ms']:.4f}",
         bound_ms=f"{rows[-1]['bound_ms']:.4f}")

    # --- rle_grouped_agg: the container's RLE l_shipdate runs (Q4)
    col = container.columns["l_shipdate"]
    rv = to_device(col.arrays["run_values"], device)
    rl = to_device(col.arrays["run_lengths"], device)
    domain = 365
    got = ops.rle_grouped_agg(rv, rl, domain=domain)
    want = ops.rle_grouped_agg_plain(rv, rl, domain=domain)
    if not (torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
            and torch.equal(got[3], want[3])
            and torch.allclose(got[1], want[1], rtol=1e-5, atol=0)):
        raise AssertionError("rle_grouped_agg differs from its plain version")
    shipdate = col.decode()
    host = np.bincount(shipdate, minlength=domain)
    pad = col.n_blocks * br - col.n_rows        # tail padding repeats last
    host[shipdate[-1]] += pad
    if not np.array_equal(got[0].cpu().numpy(), host):
        raise AssertionError("rle_grouped_agg counts differ from numpy")
    err = float((got[1] - want[1]).abs().max())
    rows.append({
        "name": "rle_grouped_agg", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rle_grouped_agg.cu",
        "replaces": "src/repro/kernels/rle_scan_agg.py:131",
        "max_abs_err": err,
        "ms": _time_ms(lambda: ops.rle_grouped_agg(rv, rl, domain=domain)),
        "plain_ms": _time_ms(lambda: ops.rle_grouped_agg_plain(
            rv, rl, domain=domain)),
        "bound_ms": _bound_ms(rv.numel() * 8 + 4 * domain * 4),
        "bound_by": "bytes",
        "library_ms": _time_ms(lambda: torch.zeros(
            domain, dtype=torch.int32, device=device).index_add_(
                0, rv.reshape(-1).long(), rl.reshape(-1))),
        "kernel_device_ms": _kernel_device_ms(
            lambda: ops.rle_grouped_agg(rv, rl, domain=domain),
            "rle_grouped_agg"),
        "shape": f"runs {tuple(rv.shape)} domain={domain}"})
    _say("kernel", name="rle_grouped_agg", counts_exact=True,
         sum_max_abs_err=f"{err:.3g}", ms=f"{rows[-1]['ms']:.4f}",
         kernel_device_ms=_fmt(rows[-1]["kernel_device_ms"]),
         plain_ms=f"{rows[-1]['plain_ms']:.4f}",
         library_ms=f"{rows[-1]['library_ms']:.4f}",
         bound_ms=f"{rows[-1]['bound_ms']:.4f}")
    rows.append(rle_scan_row(db, device))
    return rows


def rle_scan_row(db, device) -> dict:
    """``rle_grouped_agg_many`` over the RLE l_shipdate runs of every
    lineitem container in one call (Q4's scan), against its plain version
    on the card and numpy's count of l_shipdate (the tail padding, which
    repeats each container's last value, subtracted).  The library
    yardstick is ``index_add_`` over the runs concatenated outside the
    timed call."""
    import torch
    from repro_torch.core.encodings import to_device
    from repro_torch.kernels import ops
    domain = 365
    li = _containers(db, "lineitem_super")
    segs, host, pads = [], np.zeros(domain, np.int64), 0
    for c in li:
        col = c.columns["l_shipdate"]
        segs.append((to_device(col.arrays["run_values"], device),
                     to_device(col.arrays["run_lengths"], device)))
        sd = col.decode()
        host += np.bincount(sd, minlength=domain)
        pad = col.n_blocks * col.block_rows - col.n_rows
        host[sd[-1]] += pad
        pads += pad
    got = ops.rle_grouped_agg_many(segs, domain=domain)
    want = ops.rle_grouped_agg_many_plain(segs, domain=domain)
    if not (torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
            and torch.equal(got[3], want[3])
            and torch.allclose(got[1], want[1], rtol=1e-5, atol=0)):
        raise AssertionError("rle_grouped_agg over the whole scan differs "
                             "from its plain version")
    if not np.array_equal(got[0].cpu().numpy(), host):
        raise AssertionError("rle_grouped_agg over the whole scan: counts "
                             "differ from numpy")
    keys = torch.cat([rv.reshape(-1) for rv, _ in segs]).long()
    lens = torch.cat([rl.reshape(-1) for _, rl in segs])
    n_runs = keys.numel()
    fn = lambda: ops.rle_grouped_agg_many(segs, domain=domain)
    row = {"name": "rle_grouped_agg", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/rle_grouped_agg.cu",
           "replaces": "src/repro/kernels/rle_scan_agg.py:131",
           "max_abs_err": float((got[1] - want[1]).abs().max()),
           "ms": _time_ms(fn),
           "plain_ms": _time_ms(lambda: ops.rle_grouped_agg_many_plain(
               segs, domain=domain)),
           "bound_ms": _bound_ms(n_runs * 8 + 4 * domain * 4),
           "bound_by": "bytes",
           "library_ms": _time_ms(lambda: torch.zeros(
               domain, dtype=torch.int32, device=device).index_add_(
                   0, keys, lens)),
           "kernel_device_ms": _kernel_device_ms(fn, "rle_grouped_agg"),
           "fold_device_ms": _kernel_device_ms(fn, "rle_grouped_agg",
                                               exclude="init"),
           "shape": f"whole scan: {len(segs)} containers, {n_runs} runs, "
                    f"domain={domain}"}
    _say("kernel", name="rle_grouped_agg", scan="whole", containers=len(segs),
         runs=n_runs, padding_rows=pads, counts_exact=True,
         ms=f"{row['ms']:.4f}", kernel_device_ms=_fmt(row["kernel_device_ms"]),
         fold_device_ms=_fmt(row["fold_device_ms"]),
         plain_ms=f"{row['plain_ms']:.4f}",
         library_ms=f"{row['library_ms']:.4f}",
         bound_ms=f"{row['bound_ms']:.6f}")
    return row


# the aggregates of the edge cases: count, and sum / min / max of an int32
# and of an f32 column
CASE_AGGS = (("n", "*", "count"), ("si", "i", "sum"), ("mni", "i", "min"),
             ("mxi", "i", "max"), ("sf", "f", "sum"), ("mnf", "f", "min"),
             ("mxf", "f", "max"))
# the same, with f32 min and max over a column "e" of signed zeros and
# infinities (whose sums would be NaN)
SIGNED_AGGS = CASE_AGGS[:5] + (("mne", "e", "min"), ("mxe", "e", "max"))


def _seg_equal(got, want, aggs, what) -> float:
    """Ints, counts, min and max exactly; f32 sums and avgs within rtol
    1e-5 (atomics reorder the sums).  Returns the largest f32 |err|."""
    import torch
    kinds = {name: kind for name, _, kind in aggs}
    err = 0.0
    for name, w in want.items():
        g = got[name]
        if g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(f"seg_preagg {what} {name}: {g.dtype} "
                                 f"{tuple(g.shape)} against {w.dtype} "
                                 f"{tuple(w.shape)}")
        if g.dtype == torch.int32 or kinds.get(name) in ("min", "max"):
            if not torch.equal(g, w):
                raise AssertionError(f"seg_preagg {what} {name}")
        else:
            if not torch.allclose(g, w, rtol=1e-5, atol=0):
                raise AssertionError(f"seg_preagg {what} {name}")
            err = max(err, float((g - w).abs().max()))
    return err


def _f32_minmax_bits(keys, valid, x, domain: int, kind: str) -> np.ndarray:
    """numpy reference of an f32 min or max lane as bit patterns, in
    float_atomics.cuh's total order (-0.0 below +0.0), which the plain
    version's scatter_reduce leaves to the order of its updates: each
    float's bits map to an int that orders like the float, the per-key
    min/max runs on those ints, and the winner maps back."""
    def flip(b):                            # an involution
        return np.where(b < 0, b ^ np.int32(0x7FFFFFFF), b)

    k = np.clip(np.asarray(keys, np.int64), 0, domain - 1)
    ok = np.asarray(valid, bool)
    ordered = flip(np.asarray(x, np.float32).view(np.int32))[ok]
    start = np.float32(np.inf if kind == "min" else -np.inf)
    acc = np.full(domain, flip(np.array([start]).view(np.int32))[0],
                  np.int32)
    (np.minimum if kind == "min" else np.maximum).at(acc, k[ok], ordered)
    return flip(acc)


def _f32_order_check(got, keys, valid, vals, domain, aggs, what) -> None:
    """Every f32 min/max lane of ``got`` bit for bit against
    ``_f32_minmax_bits``: the sign of a zero included."""
    import torch
    cpu = lambda a: a.cpu().numpy() if torch.is_tensor(a) else a
    for name, col, kind in aggs:
        if kind not in ("min", "max") or \
                not vals[col].dtype.is_floating_point:
            continue
        want = _f32_minmax_bits(cpu(keys), cpu(valid), cpu(vals[col]),
                                domain, kind)
        g = got[name].view(torch.int32).cpu().numpy()
        if not np.array_equal(g, want):
            bad = int(np.flatnonzero(g != want)[0])
            raise AssertionError(
                f"seg_preagg {what} {name}: key {bad} bits "
                f"{int(g[bad]) & 0xFFFFFFFF:#010x}, in -0.0 < +0.0 order "
                f"{int(want[bad]) & 0xFFFFFFFF:#010x}")


def seg_preagg_case_checks(device) -> None:
    """Phase 3: both ``seg_preagg`` routes against the plain version on the
    card, at the shared route's domain limit for CASE_AGGS and one key
    past it (the global route), and at domain 100, on: random keys with
    negatives and keys >= domain, sorted keys (the main path's layout),
    all rows invalid, int32 sums that wrap, f32 min/max over -0.0, +0.0
    and +-inf, keys/valid/values sliced at an odd element offset, slices
    whose pointers disagree on alignment, n not a multiple of 16 (every
    case: n = 1,000,003, and n = 5), and 32 aggregates at domain 100 and
    at their own limit and one past it; then ``global_cases`` and
    ``short_slice_cases`` on the global route at domain 150,000."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.seg_preagg import SMEM_BYTES, \
        seg_preagg_replicas
    rng = np.random.default_rng(3)
    limit = SMEM_BYTES // (4 * len(CASE_AGGS))      # 1 + 6 lanes
    if (ops.seg_preagg_route(limit, 6), ops.seg_preagg_route(limit + 1, 6)) \
            != ("shared", "global"):
        raise AssertionError(f"seg_preagg_route at {limit} / {limit + 1}")
    n = 1_000_003
    t = lambda a: torch.as_tensor(a, device=device)

    def case(name, keys, valid, i, f, domain, aggs=CASE_AGGS, extra=None):
        vals = {"i": t(i), "f": t(f), **(extra or {})}
        got = ops.seg_preagg(t(keys), t(valid), vals, domain, aggs)
        want = ops.seg_preagg_plain(t(keys), t(valid), vals, domain, aggs)
        err = _seg_equal(got, want, aggs, f"{name} domain={domain}")
        _f32_order_check(got, keys, valid, vals, domain, aggs,
                         f"{name} domain={domain}")
        m = sum(kind != "count" for _, _, kind in aggs)
        _say("check", kernel="seg_preagg", case=name, n=len(keys),
             domain=domain, aggs=m, route=ops.seg_preagg_route(domain, m),
             replicas=seg_preagg_replicas(domain, m), valid=int(valid.sum()),
             exact=True, f32_minmax_bitwise=True,
             f32_sum_max_abs_err=f"{err:.3g}")

    ivals = lambda k: rng.integers(-2**31, 2**31, k, dtype=np.int64) \
        .astype(np.int32)
    # small whole numbers: every f32 sum here is exact in any order
    fvals = lambda k: rng.integers(0, 16, k).astype(np.float32)
    for domain in (100, limit, limit + 1):
        keys = rng.integers(-3, domain + 3, n).astype(np.int32)
        valid = rng.random(n) < 0.9
        case("random", keys, valid, ivals(n), fvals(n), domain)
        case("sorted", np.sort(keys), rng.random(n) < 0.95, ivals(n),
             fvals(n), domain)
        case("all_invalid", keys, np.zeros(n, bool), ivals(n), fvals(n),
             domain)
        few = rng.integers(0, 3, n).astype(np.int32)   # 3 hot keys
        case("int_wrap", few, np.ones(n, bool),
             (2**30 + rng.integers(0, 1000, n)).astype(np.int32),
             fvals(n), domain)
        edges = np.array([-0.0, 0.0, np.inf, -np.inf, 1.5, -2.5],
                         np.float32)
        e = edges[rng.integers(0, edges.size, n)]
        case("f32_signed_zero_inf", keys % 7, valid, ivals(n), fvals(n),
             domain, SIGNED_AGGS, {"e": t(e)})
        zeros = np.where(rng.random(n) < 0.5, -0.0, 0.0).astype(np.float32)
        case("f32_zeros_only", keys % 5, valid, ivals(n), fvals(n), domain,
             SIGNED_AGGS, {"e": t(zeros)})
        # slices of longer tensors: one odd element offset for all, then
        # offsets that disagree (the scalar path)
        K, V = t(rng.integers(-3, domain + 3, n + 8).astype(np.int32)), \
            t(rng.random(n + 8) < 0.9)
        I, F = t(ivals(n + 8)), t(fvals(n + 8))
        for label, (ok, ov, oi, of) in (("odd_offset", (1, 1, 1, 1)),
                                        ("offsets_disagree", (1, 3, 2, 5))):
            got = ops.seg_preagg(K[ok:ok + n], V[ov:ov + n],
                                 {"i": I[oi:oi + n], "f": F[of:of + n]},
                                 domain, CASE_AGGS)
            want = ops.seg_preagg_plain(K[ok:ok + n], V[ov:ov + n],
                                        {"i": I[oi:oi + n],
                                         "f": F[of:of + n]},
                                        domain, CASE_AGGS)
            err = _seg_equal(got, want, CASE_AGGS, f"{label} {domain}")
            _f32_order_check(got, K[ok:ok + n], V[ov:ov + n],
                             {"i": I[oi:oi + n], "f": F[of:of + n]},
                             domain, CASE_AGGS, f"{label} {domain}")
            _say("check", kernel="seg_preagg", case=label, n=n,
                 domain=domain, route=ops.seg_preagg_route(domain, 6),
                 offsets=f"{ok},{ov},{oi},{of}", exact=True,
                 f32_minmax_bitwise=True,
                 f32_sum_max_abs_err=f"{err:.3g}")
        case("n=5", keys[:5], valid[:5], ivals(5), fvals(5), domain)
    # 32 aggregates: every kind on both lanes, round robin
    kinds = ("sum", "min", "max")
    aggs32 = (("n", "*", "count"),) + tuple(
        (f"a{j}", "if"[j % 2], kinds[j % 3]) for j in range(32))
    lim32 = SMEM_BYTES // (4 * 33)
    for domain in (100, lim32, lim32 + 1):
        keys = rng.integers(-3, domain + 3, n).astype(np.int32)
        case("32_aggs", keys, rng.random(n) < 0.9, ivals(n), fvals(n),
             domain, aggs32)
    # the global route's lane fold, warp merge and sector skipping
    for name, (keys, valid, vals, domain, aggs) in global_cases(n).items():
        if ops.seg_preagg_route(domain, 6) != "global":
            raise AssertionError(f"global case {name}: domain {domain} "
                                 f"takes the shared route")
        extra = {c: t(x) for c, x in vals.items() if c not in ("i", "f")}
        case(f"global_{name}", keys, valid, vals["i"], vals["f"], domain,
             aggs, extra)
    # calls shorter than the valid bytes' unaligned head, on slices: the
    # global route must take element loads (a vector load there faults)
    width = 16 + max(max(c[1:]) for c in short_slice_cases())
    V, I, F = t(rng.random(width) < 0.8), t(ivals(width)), t(fvals(width))
    for label, K in (("sorted", t(np.sort(rng.integers(0, 4, width))
                                  .astype(np.int32))),
                     ("random", t(rng.integers(-3, GLOBAL_DOMAIN + 3, width)
                                  .astype(np.int32)))):
        for n, ok, ov, oi in short_slice_cases():
            k, v = K[ok:ok + n], V[ov:ov + n]
            vals = {"i": I[oi:oi + n], "f": F[oi:oi + n]}
            what = f"global_short_slice {label} n={n} offsets={ok},{ov},{oi}"
            got = ops.seg_preagg(k, v, vals, GLOBAL_DOMAIN, CASE_AGGS)
            _seg_equal(got, ops.seg_preagg_plain(k, v, vals, GLOBAL_DOMAIN,
                                                 CASE_AGGS), CASE_AGGS, what)
            _f32_order_check(got, k, v, vals, GLOBAL_DOMAIN, CASE_AGGS, what)
    _say("check", kernel="seg_preagg", case="global_short_slices",
         calls=2 * len(short_slice_cases()), n="8-15", domain=GLOBAL_DOMAIN,
         route=ops.seg_preagg_route(GLOBAL_DOMAIN, 6), exact=True,
         f32_minmax_bitwise=True)


def rle_case_checks(device) -> None:
    """Phase 3: ``rle_grouped_agg_many`` against its plain version on the
    card over lists of segments with empty segments, runs of length 0,
    keys outside [lo, hi] and outside [0, domain), with and without
    values: one CTA, many CTAs, more segments than one call takes (70),
    and a domain whose table does not fit in shared memory."""
    import torch
    from repro_torch.kernels import ops
    rng = np.random.default_rng(4)

    def seg(n, domain, with_values):
        rv = torch.as_tensor(rng.integers(-4, domain + 4, n)
                             .astype(np.int32), device=device)
        rl = torch.as_tensor(rng.integers(0, 9, n).astype(np.int32),
                             device=device)
        # whole numbers: every f32 sum here is exact in any order
        v = torch.as_tensor(rng.integers(-100, 100, n).astype(np.float32),
                            device=device) if with_values else None
        return rv, rl, v

    for label, sizes, domain in (
            ("one_cta", (100, 0, 2000, 7), 365),
            ("many_ctas", (40_000, 0, 90_000, 3), 365),
            ("70_segments", tuple(rng.integers(0, 300, 70)), 365),
            ("wide_domain", (50_000, 0, 30_000), 20_000)):
        for with_values in (False, True):
            segs = [seg(int(k), domain, with_values) for k in sizes]
            for lo, hi in ((-3.0e38, 3.0e38), (5.0, domain - 10.0)):
                got = ops.rle_grouped_agg_many(segs, domain=domain, lo=lo,
                                               hi=hi)
                want = ops.rle_grouped_agg_many_plain(segs, domain=domain,
                                                      lo=lo, hi=hi)
                if not (torch.equal(got[0], want[0])
                        and torch.equal(got[1], want[1])
                        and torch.equal(got[2], want[2])
                        and torch.equal(got[3], want[3])):
                    raise AssertionError(f"rle_grouped_agg {label} values="
                                         f"{with_values} [{lo}, {hi}]")
        _say("check", kernel="rle_grouped_agg", case=label,
             segments=len(sizes), runs=int(sum(sizes)), domain=domain,
             exact=True)


class SegCapture:
    """Records the main path's ``seg_preagg`` calls by shape -- (query,
    rows, domain, aggregates) -- with the number of calls and the inputs
    of the last.  It wraps ``ops.seg_preagg``, the name the engine calls;
    the wrapper underneath still counts every launch."""

    def __init__(self):
        self.query = None
        self.shapes = {}          # shape -> [calls, (keys, valid, values)]
        self._inner = None

    def __enter__(self):
        from repro_torch.kernels import ops
        self._inner = inner = ops.seg_preagg

        def wrapped(keys, valid, values, domain, aggs):
            if keys.is_cuda and keys.numel():     # the calls that launch
                shape = (self.query, keys.numel(), int(domain), tuple(aggs))
                entry = self.shapes.setdefault(shape, [0, None])
                entry[0] += 1
                entry[1] = (keys, valid, dict(values))
            return inner(keys, valid, values, domain, aggs)
        ops.seg_preagg = wrapped
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        ops.seg_preagg = self._inner


def _seg_bound_bytes(valid, n_cols: int, domain: int, n_out: int) -> int:
    """Bytes ``seg_preagg`` must move on these inputs: the whole mask, the
    32-byte sectors (8 rows of int32 or f32) of the keys and of each value
    column that hold at least one valid row -- the kernel reads no other
    key or value -- and each ``(domain,)`` output once."""
    import torch
    pad = (-valid.numel()) % 8
    v = torch.cat([valid, valid.new_zeros(pad)]) if pad else valid
    sectors = int(v.view(-1, 8).any(1).sum())
    return valid.numel() + sectors * 32 * (1 + n_cols) + domain * 4 * n_out


def _f64_agg(keys, valid, x, domain: int, kind: str):
    """The exact (float64) per-key sum, or mean, of f32 values: what an
    f32 sum approximates, whatever order it adds in."""
    import torch
    k = keys.to(torch.int64).clamp(0, domain - 1)
    f64 = torch.float64
    s = torch.zeros(domain, dtype=f64, device=x.device).index_add_(
        0, k, torch.where(valid, x.to(torch.float32).to(f64), 0))
    if kind == "avg":
        n = torch.zeros(domain, dtype=f64, device=x.device).index_add_(
            0, k, valid.to(f64))
        s = s / n.clamp(min=1)
    return s


def _rel_gap(got, exact) -> float:
    """The largest relative gap of ``got`` to the float64 ``exact``
    (0 where both are 0)."""
    d = (got.double() - exact).abs()
    return float((d / exact.abs().clamp(min=1e-300)).max()) \
        if d.numel() else 0.0


def seg_preagg_rows(capture, launched: int, device):
    """``seg_preagg`` against its plain version on the card, once per shape
    the main path gave it and on the inputs it gave: the query's own
    aggregates plus count, sum, min and max of an int32 column (full range,
    so sums wrap) and an f32 column of the same rows.  Counts, int sums
    (and avgs of them) and min/max must equal the plain version's.  An
    f32 sum or avg is held within rtol 1e-5 of the exact (float64) sum,
    or mean, of the same f32 values: atomics reorder the kernel's sums,
    and the plain version's ``index_add_`` is no exact judge either -- it
    adds a key's rows one at a time, and over millions of rows a key (a
    served aggregate over the unpruned scan) it drifts further from the
    exact sum than the kernel does.  The row gives both sides' largest
    relative gap to the float64 sum (``f64_rel_err``,
    ``plain_f64_rel_err``).
    One JSON row per shape, timed on the query's own aggregates, with the
    launches of that shape in the main-path run; the library call
    (``index_add_`` of the first summed column, or of the count) carries
    its device ms from the same padded traces as the kernel's."""
    import torch
    from repro_torch.kernels import ops
    calls = sum(c for c, _ in capture.shapes.values())
    if calls != launched:
        raise AssertionError(f"seg_preagg: {calls} captured calls, "
                             f"{launched} launches")
    rng = np.random.default_rng(1)
    extra = (("xn", "*", "count"), ("xsi", "xi", "sum"),
             ("xmni", "xi", "min"), ("xmxi", "xi", "max"),
             ("xsf", "xf", "sum"), ("xmnf", "xf", "min"),
             ("xmxf", "xf", "max"))
    rows = []
    for (query, n, domain, aggs), (count, (keys, valid, values)) in \
            capture.shapes.items():
        valid = valid.to(torch.bool)
        vals = dict(values)
        vals["xi"] = torch.as_tensor(rng.integers(
            -2**31, 2**31, n, dtype=np.int64).astype(np.int32),
            device=device)
        vals["xf"] = torch.as_tensor(rng.uniform(0, 1e4, n)
                                     .astype(np.float32), device=device)
        every = tuple(aggs) + extra
        got = ops.seg_preagg(keys, valid, vals, domain, every)
        want = ops.seg_preagg_plain(keys, valid, vals, domain, every)
        kinds = {name: kind for name, _, kind in every}
        cols_of = {name: c for name, c, _ in every}
        err = gap = plain_gap = 0.0
        for name, w in want.items():
            g = got[name]
            kind = kinds.get(name)
            if kind not in ("sum", "avg") or \
                    not vals[cols_of[name]].is_floating_point():
                if not torch.equal(g, w):
                    raise AssertionError(f"seg_preagg {query} {name}")
                continue
            exact = _f64_agg(keys, valid, vals[cols_of[name]], domain, kind)
            if not torch.allclose(g.double(), exact, rtol=1e-5, atol=0):
                raise AssertionError(
                    f"seg_preagg {query} {name}: rel err "
                    f"{_rel_gap(g, exact):.3g} to the float64 sum")
            gap = max(gap, _rel_gap(g, exact))
            plain_gap = max(plain_gap, _rel_gap(w, exact))
            err = max(err, float((g - w).abs().max()))
        cols = {c for _, c, kind in aggs if kind != "count"}
        n_out = 1 + sum(kind != "count" for _, _, kind in aggs)
        kidx = keys.to(torch.int64).clamp(0, domain - 1)
        summed = [c for _, c, kind in aggs if kind in ("sum", "avg")]
        if summed:
            lib_in = torch.where(valid, vals[summed[0]], 0)
            lib_dtype = lib_in.dtype
        else:
            lib_in, lib_dtype = valid.to(torch.int32), torch.int32
        call = lambda: ops.seg_preagg(keys, valid, values, domain, aggs)
        library = lambda: torch.zeros(domain, dtype=lib_dtype,
                                      device=device).index_add_(
            0, kidx, lib_in)
        route = ops.seg_preagg_route(domain, n_out - 1)
        row = {
            "name": "seg_preagg", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/seg_preagg.cu",
            "replaces": "src/repro/kernels/seg_preagg.py:123",
            "launches": count, "max_abs_err": err,
            "ms": _time_ms(call),
            "plain_ms": _time_ms(lambda: ops.seg_preagg_plain(
                keys, valid, values, domain, aggs)),
            "bound_ms": _bound_ms(_seg_bound_bytes(valid, len(cols),
                                                   domain, n_out)),
            "bound_by": "bytes",
            "library_ms": _time_ms(library),
            "kernel_device_ms": _kernel_device_ms(call, "seg_preagg"),
            "library_device_ms": _kernel_device_ms(library, ""),
            "fold_device_ms": _kernel_device_ms(call, "seg_preagg",
                                                exclude="init"),
            "f64_rel_err": gap, "plain_f64_rel_err": plain_gap,
            "shape": f"{query}: n={n} domain={domain} valid="
                     f"{int(valid.sum())} aggs="
                     + "+".join(kind for _, _, kind in aggs)
                     + f" route={route}"}
        rows.append(row)
        _say("kernel", name="seg_preagg", query=query, n=n, domain=domain,
             valid=int(valid.sum()), route=route, launches=count,
             ints_exact=True, f32_sum_max_abs_err=f"{err:.3g}",
             f64_rel_err=f"{gap:.3g}", plain_f64_rel_err=f"{plain_gap:.3g}",
             ms=f"{row['ms']:.4f}",
             kernel_device_ms=_fmt(row["kernel_device_ms"]),
             fold_device_ms=_fmt(row["fold_device_ms"]),
             plain_ms=f"{row['plain_ms']:.4f}",
             library_ms=f"{row['library_ms']:.4f}",
             library_device_ms=_fmt(row["library_device_ms"]),
             bound_ms=f"{row['bound_ms']:.6f}")
    return rows


# ------------------------------------------------- the kernel entry point --

def _containers(db, table, nodes=None):
    nodes = range(len(db.nodes)) if nodes is None else nodes
    return [c for n in nodes for c in db.nodes[n].stores[table].containers]


HOST_CALLS = 1000       # calls per host enqueue timing


def _host_us(fn, calls: int = HOST_CALLS, repeats: int = 3) -> float:
    """Host microseconds per call to enqueue ``calls`` calls back to back,
    with no synchronise among them (after one synchronised warm-up), the
    least of ``repeats`` such runs, since other work on the host only adds
    to it: the wrapper's own cost, unless the card falls so far behind
    that the launch queue fills."""
    import torch
    fn()
    best = float("inf")
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        best = min(best, time.perf_counter() - t0)
    torch.cuda.synchronize()
    return best / calls * 1e6


def _api_row(name, source, replaces, fn, plain, library, kernel, nbytes,
             shape, **extra):
    """One JSON row of a phase-5 kernel, timed on one call's inputs.  The
    library call's device ms is every kernel of one call, from the same
    padded traces as the kernel's."""
    return {"name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}",
            "replaces": replaces,
            "ms": _time_ms(fn), "plain_ms": _time_ms(plain, reps=5),
            "bound_ms": _bound_ms(nbytes), "bound_by": "bytes",
            "library_ms": None if library is None else _time_ms(library),
            "kernel_device_ms": _kernel_device_ms(fn, kernel),
            "library_device_ms": None if library is None
            else _kernel_device_ms(library, ""),
            "host_us": _host_us(fn), "shape": shape, **extra}


def _say_row(row, **kw) -> None:
    if "host_us" in row:                # phase 5's rows
        kw.update(library_device_ms=_fmt(row["library_device_ms"]),
                  host_us=f"{row['host_us']:.2f}")
    _say("kernel", name=row["name"], launches=row["launches"], **kw,
         ms=f"{row['ms']:.4f}",
         kernel_device_ms=_fmt(row["kernel_device_ms"]),
         plain_ms=f"{row['plain_ms']:.4f}",
         library_ms=_fmt(row["library_ms"]),
         bound_ms=f"{row['bound_ms']:.6f}")


# ------------------ edge cases of semijoin_probe's and onehot_groupby's --
# The inputs that break a hash set or a run fold quietly, from numpy's
# seeds: phase 5 holds both kernels against their plain versions on them,
# and tests/test_torch_sip_prepass.py holds numpy models of the two
# algorithms against the reference's Pallas kernels on the same ones.

I32_MIN, I32_MAX = -2 ** 31, 2 ** 31 - 1
# probed in every probe case: -1 (the padding) and the hash set's empty
# marker (INT32_MIN) beside the other extremes
SENTINELS = (-1, I32_MIN, I32_MAX, 0, I32_MIN + 1, I32_MAX - 1)


def probe_cases():
    """name -> (probe keys (nb, B) int32, build keys (S,) int32)."""
    rng = np.random.default_rng(0)
    # like phase 5's: ascending orderkeys of 1,500,000 (phase 5 has 4,119
    # dated 0; here 4,110: chunks of 4,096 and 14) against uniform
    # l_orderkeys, a few hitting
    orders = np.sort(rng.choice(1_500_000, 4110, replace=False))
    lineitem = rng.integers(0, 1_500_000, (2, 4096))
    lineitem[0, 100:164] = orders[::64][:64]
    lineitem[1, :14] = orders[4096:]
    small = rng.integers(-300, 300, (1, 512))
    # one slot under key & (slots - 1), at the table's size and half of it
    mult = np.arange(4096, dtype=np.int64) * 8192
    mult16 = np.arange(4096, dtype=np.int64) * 16384
    cases = {
        "phase5_chunk_4096": (lineitem, orders[:4096]),
        "phase5_chunk_14": (lineitem, orders[4096:]),
        "int32_extremes_in_build": (small, [I32_MIN, I32_MAX, 0, -2, 17]),
        "int32_min_absent": (small, rng.integers(-300, 300, 128)),
        "minus_one_S100": (small, np.arange(100)),
        "minus_one_S128": (small, np.arange(128)),
        "minus_one_S4096": (small, np.arange(4096) * 3 + 1),
        "minus_one_in_build_S128": (small, np.r_[np.arange(127), -1]),
        "empty_build": (small, np.zeros(0, np.int64)),
        "duplicates_ragged": (rng.integers(-10, 310, (3, 130)),
                              rng.integers(0, 300, 4096)),
        "one_key_4096_times": (rng.integers(0, 16, (1, 512)),
                               np.full(4096, 7)),
        "multiples_of_8192": (np.r_[mult[::8], mult[::8] + 1,
                                    mult[:512] + 4096 * 8192]
                              .reshape(2, 768), mult),
        "multiples_of_16384": (np.r_[mult16[::8], mult16[::8] + 1,
                                     mult16[:512] + 4096 * 16384]
                               .reshape(2, 768), mult16),
    }
    out = {}
    for name, (keys, build) in cases.items():
        keys = np.array(keys, dtype=np.int64)
        keys.reshape(-1)[1:1 + len(SENTINELS)] = SENTINELS
        out[name] = (keys.astype(np.int32),
                     np.asarray(build, dtype=np.int64).astype(np.int32))
    return out


def fold_cases():
    """name -> (keys (nb, B) int32, values (nb, B) int32 or f32, domain)."""
    rng = np.random.default_rng(1)
    # Q3: l_suppkey sorted within a day, rows outside the dates keyed -1
    n = 3 * 4096
    day = np.sort(rng.integers(0, 4, n))
    supp = rng.integers(0, 100, n)
    q3 = supp[np.lexsort((supp, day))]
    q3[:300] = -1
    q3[-700:] = -1
    # Qorders: o_orderdate over 365 in o_orderkey order, the tail padded
    qo = rng.integers(0, 365, n)
    qo[-1000:] = -1
    # out-of-domain keys inside runs, at domain 100
    ood = np.tile([5, 5, -1, 5, 5, 100, 5, I32_MIN, 5, I32_MAX, 99, 99, -1,
                   99, 0, 0], 8)
    runs = np.repeat(rng.integers(0, 50, 60), rng.integers(1, 40, 60))[:1024]
    # values whose int sum wraps (f32 rounds each to 2^30: sums exact)
    big = np.full((1, 4096), 2 ** 30 - 1)
    cases = {
        "q3_sorted_within_day": (q3.reshape(3, 4096),
                                 rng.integers(1, 50, (3, 4096)), 100),
        "qorders_random": (qo.reshape(3, 4096),
                           rng.integers(0, 1000, (3, 4096)), 365),
        "out_of_domain_inside_runs": (ood.reshape(1, 128),
                                      rng.integers(1, 9, (1, 128)), 100),
        "one_run_across_every_chunk": (np.full((2, 4096), 3),
                                       rng.uniform(0, 1e3, (2, 4096))
                                       .astype(np.float32), 16),
        "float_runs": (runs.reshape(2, 512),
                       rng.uniform(0, 1e3, (2, 512)).astype(np.float32), 50),
        "ragged_rows_B130": (rng.integers(-2, 9, (3, 130)),
                             rng.uniform(0, 10, (3, 130))
                             .astype(np.float32), 7),
        "two_tiles_domain_1024": (np.sort(rng.integers(-5, 1030, (2, 4196)),
                                          axis=1),
                                  rng.integers(-50, 50, (2, 4196)), 1024),
        "domain_1": (rng.integers(-1, 2, (1, 256)),
                     rng.integers(0, 9, (1, 256)), 1),
        "no_key_in_domain": (np.where(rng.random((2, 256)) < 0.5, -1, 10),
                             rng.integers(0, 9, (2, 256)), 10),
        "int_values_near_2_30": (np.sort(rng.integers(0, 4, (1, 4096)),
                                         axis=1), big, 4),
    }
    out = {}
    for name, (keys, vals, domain) in cases.items():
        vals = np.asarray(vals)
        out[name] = (np.asarray(keys, dtype=np.int64).astype(np.int32),
                     vals if vals.dtype == np.float32
                     else vals.astype(np.int32), domain)
    return out


GLOBAL_DOMAIN = 150_000       # Q5 and Q7's packed domain: the global route


def global_cases(n: int, domain: int = GLOBAL_DOMAIN):
    """name -> (keys, valid, {column: values}, domain, aggregates) of
    ``n`` rows, int32 column "i" and f32 columns "f" (and "e"): the
    inputs that break ``seg_preagg``'s global route (lane fold, warp
    merge, sector skipping) quietly.  Phase 3 runs them on the card
    at n = 1,000,003 and domain 150,000; tests/test_torch_global_fold.py
    holds a numpy model of the route against the reference on them at a
    small n and a domain the Pallas kernel takes."""
    rng = np.random.default_rng(5)
    row = np.arange(n)
    ints = lambda: rng.integers(-2**31, 2**31, n, dtype=np.int64) \
        .astype(np.int32)
    # small whole numbers: every f32 sum here is exact in any order
    small = lambda: rng.integers(0, 16, n).astype(np.float32)
    # runs that end exactly at, and one row past, lane (8-row) and warp
    # (256-row) edges, and at the 16- and 512-row edges twice those
    brk = (row % 256 < 2) | ((row % 8 < 2) & (rng.random(n) < 0.25))
    edges = (np.cumsum(brk) - 1).astype(np.int32)
    sorted_keys = np.sort(rng.integers(0, domain, n)).astype(np.int32)
    # half the 32-byte sectors full, the other half one valid row each, at
    # every position of the sector in turn
    sector = row // 8
    half = (sector % 2 == 0) | (row % 8 == (sector // 2) % 8)
    # keys past both ends inside runs of 0 and of domain - 1: clipping
    # merges them into those runs
    ood = np.sort(np.r_[np.zeros(n // 4), np.full(n // 4, domain - 1),
                        rng.integers(0, domain, n - 2 * (n // 4))]
                  ).astype(np.int64)
    lo_run, hi_run = ood == 0, ood == domain - 1
    ood[lo_run & (rng.random(n) < 0.3)] = -1
    ood[lo_run & (rng.random(n) < 0.1)] = I32_MIN
    ood[hi_run & (rng.random(n) < 0.3)] = domain
    ood[hi_run & (rng.random(n) < 0.1)] = I32_MAX
    signed = np.array([-0.0, 0.0, np.inf, -np.inf, 1.5, -2.5], np.float32)
    cases = {
        "runs_at_lane_and_warp_edges": (edges, np.ones(n, bool), ints(),
                                        domain),
        "one_key_every_row": (np.full(n, domain // 2),
                              rng.random(n) < 0.9, ints(), domain),
        "distinct_key_every_row": (row % domain, rng.random(n) < 0.9,
                                   ints(), domain),
        "random_domain_150000": (rng.integers(-3, GLOBAL_DOMAIN + 3, n),
                                 rng.random(n) < 0.9, ints(), GLOBAL_DOMAIN),
        "all_invalid": (sorted_keys, np.zeros(n, bool), ints(), domain),
        "half_valid_sectors": (sorted_keys, half, ints(), domain),
        "out_of_range_inside_runs": (ood, rng.random(n) < 0.95, ints(),
                                     domain),
        "int_sums_wrap": (np.sort(rng.integers(0, 3, n)), np.ones(n, bool),
                          (2**30 + rng.integers(0, 1000, n)).astype(np.int32),
                          domain),
        "f32_signed_zero_inf": (np.sort(rng.integers(0, 7, n)),
                                rng.random(n) < 0.9, ints(), domain),
    }
    out = {}
    for name, (k, v, i, d) in cases.items():
        vals, aggs = {"i": i, "f": small()}, CASE_AGGS
        if name == "f32_signed_zero_inf":       # min / max over the signs
            vals["e"] = signed[rng.integers(0, signed.size, n)]
            aggs = SIGNED_AGGS
        out[name] = (np.asarray(k, np.int64).astype(np.int32), v, vals, d,
                     aggs)
    return out


def short_slice_cases():
    """(n, keys offset, valid offset, values offset), in elements, of
    short ``seg_preagg`` calls on slices: n = 8-15 rows with the valid
    bytes 1-7 bytes past a 16-byte boundary, so the head that would align
    them is as a rule longer than the call, and the keys and values at
    offsets 0-3, every alignment of 4-byte words.  Phase 3 runs them on
    the global route; tests/test_torch_global_fold.py's model checks that
    no vector load there is misaligned."""
    return [(n, ok, ov, ok) for n in range(8, 16) for ov in range(1, 8)
            for ok in range(4)]


def filter_cases():
    """name -> (segments [(run values, run lengths), ...], lo, hi) for
    ``rle_filter_agg_many``: rows of R = 0, 1, 4, 33 and 128 runs (one row
    spread over several lanes, several rows a warp, a warp striding over
    a row), segments of different R in one launch, empty segments, more
    segments than one launch takes (70), and int32 and f32 values and
    lengths.  Values are multiples of 0.25 and lengths at most 9, so every
    sum is exact in any order."""
    rng = np.random.default_rng(6)

    def seg(nb, R, v_float=False, l_float=False):
        v = rng.integers(-20, 280, (nb, R)) / (4.0 if v_float else 1.0)
        n = rng.integers(0, 10, (nb, R))
        return (v.astype(np.float32 if v_float else np.int32),
                n.astype(np.float32 if l_float else np.int32))

    return {
        "R1": ([seg(5, 1), seg(40, 1, True), seg(3, 1)], 2.0, 60.0),
        "R4_phase5": ([seg(123, 4) for _ in range(3)], 10.0, 40.0),
        "R33": ([seg(10, 33, True), seg(7, 33, False, True)], -3.0, 50.5),
        "R128": ([seg(4, 128, True, True), seg(6, 128)], 0.0, 70.0),
        "mixed_R_one_launch": ([seg(7, 3), seg(9, 17, True), seg(2, 40),
                                seg(33, 2, False, True)], 5.0, 30.0),
        "empty_segments": ([seg(3, 4), seg(0, 4), seg(5, 4), seg(0, 0),
                            seg(2, 0), seg(0, 40, True)], 2.0, 60.0),
        "70_segments": ([seg(int(rng.integers(0, 20)),
                             int(rng.choice([1, 2, 3, 4, 5, 8, 16, 31, 32,
                                             33, 64])),
                             bool(rng.integers(0, 2)),
                             bool(rng.integers(0, 2)))
                         for _ in range(70)], -5.0, 45.0),
    }


def _offset_copy(t):
    """``t`` as a contiguous tensor whose data starts 4 bytes past a
    16-byte boundary: the kernels' element-wise load path."""
    import torch
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = flat[1:].view(t.shape)
    view.copy_(t)
    return view


def api_case_checks(device) -> None:
    """Phase 5's edge cases: ``semijoin_probe`` bool for bool against its
    plain version and ``np.isin`` of the padded build side, and
    ``onehot_groupby`` against its plain version, counts exactly and sums
    within rtol 1e-5; each on aligned inputs and on a copy off 16-byte
    alignment; then ``rle_filter_agg_many`` on ``filter_cases`` against
    its plain version and the per-segment ``rle_filter_agg`` calls,
    exactly."""
    import torch
    from repro_torch.kernels import hash_groupby, ops, sip_probe
    n_probe = 0
    for name, (keys, build) in probe_cases().items():
        padded = np.r_[build, np.full((-len(build)) % 128, -1, np.int32)]
        want_host = np.isin(keys, padded)
        k = torch.as_tensor(keys, device=device)
        b = torch.as_tensor(build, device=device)
        want = sip_probe.semijoin_probe_plain(k, b)
        if not np.array_equal(want.cpu().numpy(), want_host):
            raise AssertionError(f"semijoin_probe case {name}: the plain "
                                 f"version differs from np.isin")
        for kk in (k, _offset_copy(k)):
            got = sip_probe.semijoin_probe(kk, b)
            n_probe += 1
            if not torch.equal(got, want):
                bad = int((got != want).sum())
                raise AssertionError(
                    f"semijoin_probe case {name} (offset="
                    f"{kk.data_ptr() % 16}): {bad} of {got.numel()} keys "
                    f"differ from the plain version")
    n_fold = 0
    worst = 0.0
    for name, (keys, vals, domain) in fold_cases().items():
        k = torch.as_tensor(keys, device=device)
        v = torch.as_tensor(vals, device=device)
        want = hash_groupby.onehot_groupby_plain(k, v, domain=domain)
        for kk, vv in ((k, v), (_offset_copy(k), _offset_copy(v))):
            got = hash_groupby.onehot_groupby(kk, vv, domain=domain)
            n_fold += 1
            where = (f"onehot_groupby case {name} "
                     f"(offset={kk.data_ptr() % 16})")
            if not torch.equal(got[..., 0], want[..., 0]):
                raise AssertionError(f"{where}: counts differ")
            if not torch.allclose(got[..., 1], want[..., 1], rtol=1e-5,
                                  atol=0):
                raise AssertionError(f"{where}: sums beyond rtol 1e-5 of "
                                     f"the plain version")
            worst = max(worst, float(
                ((got[..., 1] - want[..., 1]).abs()
                 / want[..., 1].abs().clamp_min(1e-30)).max()))
    n_filter = 0
    for name, (segs, lo, hi) in filter_cases().items():
        segs = [(torch.as_tensor(v, device=device),
                 torch.as_tensor(n, device=device)) for v, n in segs]
        got = ops.rle_filter_agg_many(segs, lo=lo, hi=hi)
        n_filter += 1
        want = ops.rle_filter_agg_many_plain(segs, lo=lo, hi=hi)
        each = torch.cat([ops.rle_filter_agg(v, n, lo=lo, hi=hi)
                          for v, n in segs])
        for label, other in (("plain version", want),
                             ("per-segment calls", each)):
            if not torch.equal(got, other):
                raise AssertionError(f"rle_filter_agg_many case {name}: "
                                     f"differs from the {label}")
    torch.cuda.synchronize()
    _say("check", kernel="rle_filter_agg", edge_cases=len(filter_cases()),
         list_calls=n_filter, plain="exact", per_segment_calls="exact")
    _say("check", kernel="semijoin_probe", edge_cases=len(probe_cases()),
         launches=n_probe, offsets="0,4", plain="match", np_isin="match")
    _say("check", kernel="onehot_groupby", edge_cases=len(fold_cases()),
         launches=n_fold, offsets="0,4", counts="exact",
         sum_max_rel_err=f"{worst:.3g}")


def _prepass_inputs(keys, valid, values, aggs):
    """A main-path ``seg_preagg`` call as ``onehot_groupby`` takes it:
    (nb, 4096) keys with invalid and tail rows keyed -1, and the values
    of the call's summed column (or ones for a count)."""
    import torch
    n = keys.numel()
    pad = (-n) % PREPASS_BLOCK
    k = torch.where(valid, keys.to(torch.int32), -1)
    summed = [c for _, c, kind in aggs if kind in ("sum", "avg")]
    v = values[summed[0]] if summed else torch.ones_like(k)
    k = torch.cat([k, k.new_full((pad,), -1)])
    v = torch.cat([v, v.new_zeros(pad)])
    return (k.reshape(-1, PREPASS_BLOCK), v.reshape(-1, PREPASS_BLOCK),
            summed[0] if summed else None)


def kernel_api_phase(db, fact, dim, capture, device):
    """Phase 5: the four kernels only ``kernels.ops`` reaches, driven at
    full size over the database's own containers and the main path's own
    ``seg_preagg`` inputs, each held against numpy and against its plain
    version on the card.  Returns their JSON rows."""
    import torch
    from repro_torch.core.encodings import decode_torch, to_device
    from repro_torch.kernels import ops
    li = _containers(db, "lineitem_super")
    orders = _containers(db, "orders_super", nodes=(0,))
    intervals = {"Q1": (180.0, 180.0), "Q3": (61.0, 119.0)}
    runs = [(to_device(c.columns["l_shipdate"].arrays["run_values"], device),
             to_device(c.columns["l_shipdate"].arrays["run_lengths"], device))
            for c in li]
    dr = []
    for c in orders:
        col = c.columns["o_orderkey"]
        if col.encoding.value != "delta_range" or \
                "deltas_packed" not in col.arrays:
            raise AssertionError(f"o_orderkey is {col.encoding}, expected "
                                 f"a packed DELTA_RANGE stream")
        a = {k: to_device(v, device) for k, v in col.arrays.items()}
        dr.append((col, a))
    prepass = {}
    for (q, _, domain, aggs), (_, (keys, valid, values)) in \
            capture.shapes.items():
        if q in ("Q3", "Qorders"):
            valid = valid.to(torch.bool)
            k2, v2, summed = _prepass_inputs(keys, valid, values, aggs)
            prepass[q] = {"domain": domain, "aggs": aggs, "keys": keys,
                          "valid": valid, "values": values, "k2": k2,
                          "v2": v2, "summed": summed}
    if set(prepass) != {"Q3", "Qorders"}:
        raise AssertionError(f"seg_preagg inputs of Q3 and Qorders not "
                             f"captured: {sorted(prepass)}")
    build_host = dim["o_orderkey"][dim["o_orderdate"] == 0].astype(np.int32)
    build_keys = torch.as_tensor(build_host, device=device)
    chunks = [build_keys[s:s + 4096]
              for s in range(0, build_keys.numel(), 4096)]
    probe = [decode_torch(c.columns["l_orderkey"], device) for c in li]
    torch.cuda.synchronize()

    # ---- the path: every launch below is counted
    ops.reset_launch_counts()
    filt = {q: ops.rle_filter_agg_many(runs, lo=lo, hi=hi)
            for q, (lo, hi) in intervals.items()}
    decoded = []
    for col, a in dr:
        deltas = ops.bitunpack(a["deltas_packed"], col.widths["deltas_packed"],
                               col.block_rows, base=a["delta_min"])
        decoded.append((deltas, ops.delta_decode(a["first"][:, None],
                                                 deltas)))
    parts, onehot_launches = {}, {}
    for q, p in prepass.items():
        before = ops.launch_counts()["onehot_groupby"]
        parts[q] = ops.onehot_groupby(p["k2"], p["v2"], domain=p["domain"])
        onehot_launches[q] = ops.launch_counts()["onehot_groupby"] - before
    members = []
    for keys in probe:
        hit = ops.semijoin_probe(keys, chunks[0])
        for ch in chunks[1:]:
            hit |= ops.semijoin_probe(keys, ch)
        members.append(hit)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    _say("launches", path="kernels.ops", bitunpack=launches["bitunpack"],
         **{k: launches[k] for k in API_KERNELS})
    missing = [k for k in API_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels.ops phase never launched: {missing}")
    if launches["rle_filter_agg"] != len(intervals):
        raise AssertionError(f"rle_filter_agg launched "
                             f"{launches['rle_filter_agg']} times, not once "
                             f"per interval over the whole scan")
    if sum(onehot_launches.values()) != launches["onehot_groupby"]:
        raise AssertionError(f"onehot_groupby launches by query "
                             f"{onehot_launches} do not add up to "
                             f"{launches['onehot_groupby']}")
    rows = []
    errs = {k: 0.0 for k in API_KERNELS}

    def worst(name, got, want):
        errs[name] = max(errs[name], float(
            (got.double() - want.double()).abs().max()))

    # ---- rle_filter_agg: the whole scan split by container equals the
    # per-container calls and the plain version, and numpy's count, sum
    # and max of l_shipdate (every partial sum stays below 2^24: exact)
    sd = fact["l_shipdate"]
    for q, (lo, hi) in intervals.items():
        whole = filt[q]
        if not torch.equal(whole, ops.rle_filter_agg_many_plain(
                runs, lo=lo, hi=hi)):
            raise AssertionError(f"rle_filter_agg_many {q} differs from its "
                                 f"plain version")
        cnt = tot = 0
        mx = -np.inf
        per_container = whole.split([rv.shape[0] for rv, _ in runs])
        for c, (rv, rl), got in zip(li, runs, per_container):
            want = ops.rle_filter_agg_plain(rv, rl, lo=lo, hi=hi)
            # -inf in the max of a block with no passing run on both sides
            worst("rle_filter_agg", torch.nan_to_num(got),
                  torch.nan_to_num(want))
            if not (torch.equal(got, want) and torch.equal(
                    got, ops.rle_filter_agg(rv, rl, lo=lo, hi=hi))):
                raise AssertionError(f"rle_filter_agg {q}: a container of "
                                     f"the whole scan differs from its own "
                                     f"call or the plain version")
            g = got.cpu().numpy().astype(np.float64)
            cnt += g[:, 0].sum()
            tot += g[:, 1].sum()
            mx = max(mx, g[:, 2].max())
            # the tail padding repeats the last run's value
            col = c.columns["l_shipdate"]
            pad = col.n_blocks * col.block_rows - c.n_rows
            host_rl = col.arrays["run_lengths"].reshape(-1)
            last = col.arrays["run_values"].reshape(-1)[
                np.flatnonzero(host_rl)[-1]]
            if pad and lo <= last <= hi:
                cnt -= pad
                tot -= pad * float(last)
        m = (sd >= lo) & (sd <= hi)
        if (cnt, tot, mx) != (m.sum(), sd[m].sum(), sd[m].max()):
            raise AssertionError(f"rle_filter_agg {q}: ({cnt}, {tot}, {mx})"
                                 f" against numpy ({m.sum()}, {sd[m].sum()},"
                                 f" {sd[m].max()})")
        _say("check", kernel="rle_filter_agg", query=q, lo=lo, hi=hi,
             rows=int(cnt), sum=int(tot), max=int(mx), numpy="match",
             plain="match", per_container_calls="match")
    rv, rl = runs[0]
    lo, hi = intervals["Q3"]
    note = "no single PyTorch call computes the masked count, sum and max " \
           "per block"
    row = _api_row(
        "rle_filter_agg", "rle_filter_agg.cu",
        "src/repro/kernels/rle_scan_agg.py:56",
        lambda: ops.rle_filter_agg(rv, rl, lo=lo, hi=hi),
        lambda: ops.rle_filter_agg_plain(rv, rl, lo=lo, hi=hi), None,
        "rle_filter_agg_kernel", rv.numel() * 8 + rv.shape[0] * 12,
        f"runs {tuple(rv.shape)} [61, 119], one container; launch-bound",
        launches=launches["rle_filter_agg"],
        max_abs_err=errs["rle_filter_agg"], library_note=note)
    rows.append(row)
    _say_row(row, containers=1, exact=True)
    n_runs = sum(v.numel() for v, _ in runs)
    n_rows = sum(v.shape[0] for v, _ in runs)
    row = _api_row(
        "rle_filter_agg", "rle_filter_agg.cu",
        "src/repro/kernels/rle_scan_agg.py:56",
        lambda: ops.rle_filter_agg_many(runs, lo=lo, hi=hi),
        lambda: ops.rle_filter_agg_many_plain(runs, lo=lo, hi=hi), None,
        "rle_filter_agg_kernel", n_runs * 8 + n_rows * 12,
        f"whole scan: {len(runs)} containers, {n_rows} blocks, {n_runs} "
        f"runs, [61, 119], one launch",
        launches=launches["rle_filter_agg"],
        max_abs_err=errs["rle_filter_agg"], library_note=note)
    rows.append(row)
    _say_row(row, containers=len(runs), exact=True)

    # ---- delta_decode: bit for bit the host decode of o_orderkey
    for (col, a), (deltas, got) in zip(dr, decoded):
        host = col.decode_blocks().astype(np.float32)
        want = ops.delta_decode_plain(a["first"][:, None], deltas)
        worst("delta_decode", got, want)
        if not (torch.equal(got, want)
                and np.array_equal(got.cpu().numpy().view(np.uint32),
                                   host.view(np.uint32))):
            raise AssertionError("delta_decode of o_orderkey: not bit-exact")
    rng = np.random.default_rng(2)
    nb, br = probe[0].shape             # one lineitem container's blocks
    ffirst = torch.as_tensor(rng.normal(0, 1e3, (nb, 1)).astype(np.float32),
                             device=device)
    fdeltas = torch.as_tensor(rng.normal(0, 1, (nb, br)).astype(np.float32),
                              device=device)
    got = ops.delta_decode(ffirst, fdeltas)
    want = ops.delta_decode_plain(ffirst, fdeltas)
    magnitude = ffirst.abs() + torch.cumsum(fdeltas.abs(), dim=1) \
        + fdeltas[:, :1].abs()
    ferr = float(((got - want).abs() / magnitude).max())
    if ferr > 1e-5:
        raise AssertionError(f"delta_decode float case: {ferr:.3g} of the "
                             f"running magnitude")
    _say("check", kernel="delta_decode", containers=len(dr),
         o_orderkey="bit_exact", float_case=f"({nb},{br})",
         float_err_of_magnitude=f"{ferr:.3g}")
    col, a = dr[0]
    deltas = decoded[0][0]
    first = a["first"][:, None]
    row = _api_row(
        "delta_decode", "delta_decode.cu",
        "src/repro/kernels/delta_decode.py:26",
        lambda: ops.delta_decode(first, deltas),
        lambda: ops.delta_decode_plain(first, deltas),
        lambda: torch.cumsum(deltas, dim=1, dtype=torch.float32),
        "delta_decode_kernel", deltas.numel() * 8 + first.numel() * 4,
        f"o_orderkey deltas {tuple(deltas.shape)} int32",
        launches=launches["delta_decode"], max_abs_err=errs["delta_decode"],
        float_case_err_of_magnitude=ferr)
    rows.append(row)
    _say_row(row, bit_exact=True)

    # ---- onehot_groupby: the partials add up to seg_preagg's answer
    for q, p in prepass.items():
        domain, aggs, k2, v2 = p["domain"], p["aggs"], p["k2"], p["v2"]
        got = parts[q]
        want = ops.onehot_groupby_plain(k2, v2, domain=domain)
        err = float((got - want).abs().max())
        if not (torch.equal(got[..., 0], want[..., 0]) and torch.allclose(
                got[..., 1], want[..., 1], rtol=1e-5, atol=0)):
            raise AssertionError(f"onehot_groupby {q} differs from its "
                                 f"plain version")
        seg = ops.seg_preagg(p["keys"], p["valid"], p["values"], domain,
                             aggs)
        cnt = got[..., 0].double().sum(0)
        if not torch.equal(cnt.to(torch.int64),
                           seg["group_count"].to(torch.int64)):
            raise AssertionError(f"onehot_groupby {q}: counts differ from "
                                 f"seg_preagg's")
        if p["summed"] is not None:
            name = next(n for n, c, _ in aggs if c == p["summed"])
            s = got[..., 1].double().sum(0)
            ref = seg[name].double()
            if not torch.allclose(s, ref, rtol=1e-5, atol=0):
                raise AssertionError(f"onehot_groupby {q}: sums differ from "
                                     f"seg_preagg's")
        nbk = k2.shape[0]
        ok = (k2 >= 0) & (k2 < domain)
        flat = (torch.arange(nbk, device=device)[:, None] * domain
                + torch.where(ok, k2, 0).long()).reshape(-1)
        w = torch.stack([ok.float(), torch.where(ok, v2.float(), 0.0)],
                        dim=-1).reshape(-1, 2)
        # the cross-block combine that seg_preagg's single table includes
        combine = got.sum
        combine_device_ms, _ = _profile(lambda: combine(0), reps=20)
        row = _api_row(
            "onehot_groupby", "onehot_groupby.cu",
            "src/repro/kernels/hash_groupby.py:39",
            lambda: ops.onehot_groupby(k2, v2, domain=domain),
            lambda: ops.onehot_groupby_plain(k2, v2, domain=domain),
            lambda: torch.zeros(nbk * domain, 2, device=device)
            .index_add_(0, flat, w),
            "onehot_groupby_kernel",
            k2.numel() * 8 + nbk * domain * 2 * 4,
            f"{q}: keys {tuple(k2.shape)} domain={domain} "
            f"valid={int(p['valid'].sum())}",
            launches=onehot_launches[q], max_abs_err=err, query=q,
            combine_ms=_time_ms(lambda: combine(0)),
            combine_device_ms=combine_device_ms)
        rows.append(row)
        _say_row(row, query=q, counts_equal_seg_preagg=True,
                 sum_max_abs_err=f"{err:.3g}")

    # ---- semijoin_probe: np.isin, exactly
    for c, keys, got in zip(li, probe, members):
        host = c.columns["l_orderkey"].decode_blocks()
        want = ops.semijoin_probe_plain(keys, chunks[0])
        for ch in chunks[1:]:
            want |= ops.semijoin_probe_plain(keys, ch)
        worst("semijoin_probe", got, want)
        if not (torch.equal(got, want) and np.array_equal(
                got.cpu().numpy(), np.isin(host, build_host))):
            raise AssertionError("semijoin_probe differs from np.isin")
    hits = sum(int(m.sum()) for m in members)
    _say("check", kernel="semijoin_probe", containers=len(li),
         build=build_keys.numel(), chunks=len(chunks), members=hits,
         np_isin="match", plain="match")
    keys = probe[0]
    ch = chunks[0]
    padded = torch.cat([ch, ch.new_full(((-ch.numel()) % 128,), -1)])
    row = _api_row(
        "semijoin_probe", "semijoin_probe.cu",
        "src/repro/kernels/sip_probe.py:38",
        lambda: ops.semijoin_probe(keys, ch),
        lambda: ops.semijoin_probe_plain(keys, ch),
        lambda: torch.isin(keys, padded),
        "semijoin_probe_kernel",
        keys.numel() * 5 + padded.numel() * 4,
        f"keys {tuple(keys.shape)} build {padded.numel()}",
        launches=launches["semijoin_probe"],
        max_abs_err=errs["semijoin_probe"],
        bound_note="bytes: membership needs no B x S compares (a sorted "
                   "or hashed build side answers in O(1)-O(log S) each)")
    rows.append(row)
    _say_row(row, exact=True)
    api_case_checks(device)
    return rows


# ------------------------------------------------------------ main path --

def _is_cuda(device) -> bool:
    import torch
    return torch.device(device).type == "cuda"


def _sync(device) -> None:
    import torch
    if _is_cuda(device):
        torch.cuda.synchronize()


def run_main_path(db, fact, dim, device, capture=None) -> dict:
    """Phase 4: Q1-Q7 and the orders query, cold then warm; returns the
    warm milliseconds by query.  Each line also shows the kernel launches
    of the cold and of the warm run.  ``capture`` (a SegCapture) is told
    which query runs."""
    from repro_torch.kernels import ops
    warm = {}
    queries = make_queries(db)
    for name, qb in queries.items():
        if capture is not None:
            capture.query = name
        ms, launched = [], []
        for _ in range(2):                # cold, then warm
            before = ops.launch_counts()
            _sync(device)
            t0 = time.perf_counter()
            res = qb.collect()
            _sync(device)
            ms.append((time.perf_counter() - t0) * 1e3)
            after = ops.launch_counts()
            launched.append("/".join(f"{after[k] - before[k]}"
                                     for k in MAIN_KERNELS))
            check(name, res, fact, dim)
            rle = after["rle_grouped_agg"] - before["rle_grouped_agg"]
            if name == "Q4" and _is_cuda(device) and rle != 1:
                raise AssertionError(f"Q4 launched rle_grouped_agg {rle} "
                                     f"times, expected once per run")
        st = qb.stats
        if db.epochs.n_pinned() != 0:
            raise AssertionError(f"{name} leaked an epoch pin")
        _say("query", name=name, cold_ms=f"{ms[0]:.3f}",
             warm_ms=f"{ms[1]:.3f}", route=st.groupby_algorithm,
             fused=st.fused, plan_cache=st.plan_cache,
             frontend_ms=f"{st.frontend_s * 1e3:.3f}",
             rows_scanned=st.rows_scanned, oracle="match",
             launches_cold=launched[0], launches_warm=launched[1])
        warm[name] = ms[1]
    return warm


def profile_queries(db, warm) -> None:
    """One more warm run of each query under torch.profiler: its device
    time, the share of the untraced warm wall time the device was busy,
    and the kernel that took most of the device time."""
    for name, qb in make_queries(db).items():
        dev_ms, by_name = _profile(qb.collect)
        if dev_ms is None:
            _say("profile", name=name, device_ms="not measured")
            continue
        top = max(by_name, key=by_name.get)
        _say("profile", name=name, device_ms=f"{dev_ms:.4f}",
             warm_ms=f"{warm[name]:.3f}",
             busy_share=f"{dev_ms / warm[name]:.4f}",
             top_kernel=top.replace(" ", "_")[:60],
             top_kernel_ms=f"{by_name[top]:.4f}")


def run_trickle(db, fact, dim, device) -> dict:
    """Phase 7: pending WOS rows force the general path (and, served
    through ``db.serve()``, the shared scan's general path), then the
    tuple mover drains them and the fused path returns.  Returns the
    lineitem rows the database holds after it."""
    from repro_torch.data import star_schema
    more, _ = star_schema(N_TRICKLE, N_DIM, seed=1)
    t = db.begin()
    db.insert(t, "lineitem", more)
    db.commit(t)
    both = {c: np.concatenate([fact[c], more[c]]) for c in fact}
    for stage in ("wos", "moved"):
        if stage == "moved":
            db.run_tuple_mover(force_moveout=True)
        queries = make_queries(db)
        solo = {}
        for name in ("Q3", "Q5"):
            res = solo[name] = queries[name].collect()
            check(name, res, both, dim)
            st = queries[name].stats
            if st.fused != (stage == "moved"):
                raise AssertionError(f"{name} after {stage}: fused="
                                     f"{st.fused}")
            _say("trickle", stage=stage, name=name, fused=st.fused,
                 route=st.groupby_algorithm, oracle="match")
        if stage == "wos":
            serve_wos_round(db, solo)
    return both


# ------------------------------------------------------------ serving path --

SERVE_CACHE = 4 << 30              # phase 10's fresh block cache
LOOP_CLIENTS, LOOP_OPS = 12, 12    # benchmarks/serving.py's closed loop
FLOOD_N, N_PROBE = 48, 24          # its batch flood and interactive probes
N_SUPP = 64                        # benchmarks/serving.py's N_CIDS


def serve_corpus(db):
    """tests/test_serving.py::corpus re-keyed onto lineitem: l_suppkey for
    cid, l_shipdate for day, l_qty for qty, l_extprice for price,
    l_orderkey for sale_id."""
    from repro_torch.engine import col
    li = lambda: db.query("lineitem")
    return {
        "c-by-supp": li().group_by("l_suppkey").agg(n=("*", "count")),
        "c-day180": li().where(col("l_shipdate") < 180)
                        .group_by("l_suppkey")
                        .agg(rev=("l_extprice", "sum"), n=("*", "count")),
        "c-supp-range": li().where((col("l_suppkey") >= 10)
                                   & (col("l_suppkey") < 40))
                            .group_by("l_shipdate")
                            .agg(mx=("l_extprice", "max")),
        "c-total": li().agg(total=("l_qty", "sum")),
        "c-qty5": li().where(col("l_qty") > 5)
                      .agg(n=("*", "count"), lo=("l_extprice", "min")),
        "c-composite": li().group_by("l_suppkey", "l_qty")
                           .agg(s=("l_extprice", "sum")),
        "c-having": li().where(col("l_shipdate") >= 300)
                        .group_by("l_suppkey")
                        .agg(avg_p=("l_extprice", "avg"))
                        .having(col("avg_p") > 40).order_by("-avg_p")
                        .limit(7),
        "c-derived": li().select(margin=col("l_extprice") * col("l_qty"))
                         .group_by("l_suppkey").agg(m=("margin", "sum")),
        "c-select": li().where(col("l_shipdate") == 33)
                        .select("l_orderkey", "l_suppkey", "l_extprice"),
        "c-supp7": li().where(col("l_suppkey") == 7).group_by("l_shipdate")
                       .agg(n=("*", "count")).order_by("l_shipdate"),
        "c-empty-group": li().where(col("l_shipdate") > 9000)
                             .group_by("l_suppkey")
                             .agg(s=("l_extprice", "sum")),
        "c-empty-min": li().where(col("l_shipdate") > 9000)
                           .agg(lo=("l_extprice", "min")),
    }


def corpus_oracle(name, fact):
    """Independent float64 numpy answer of a ``serve_corpus`` shape, over
    the values the database holds (prices as f32): ({column: values},
    key columns to sort both sides by, or () when the query's own ORDER
    BY fixes the order).  A pruned-to-empty scalar aggregate is one row
    of zeros, the engine's empty result."""
    f = fact
    sd, sk, qty = f["l_shipdate"], f["l_suppkey"], f["l_qty"]
    price = f["l_extprice"].astype(np.float32).astype(np.float64)

    def grouped(m, key, /, **aggs):
        keys, inv = np.unique(key[m], return_inverse=True)
        out = {}
        for col, (kind, v) in aggs.items():
            if kind == "count":
                out[col] = np.bincount(inv, minlength=keys.size)
            elif kind == "sum":
                out[col] = np.bincount(inv, v[m], minlength=keys.size)
            else:   # max
                mx = np.full(keys.size, -np.inf)
                np.maximum.at(mx, inv, v[m])
                out[col] = mx
        return keys, out

    if name == "c-by-supp":
        keys, out = grouped(np.ones(sd.size, bool), sk, n=("count", None))
        return {"l_suppkey": keys, **out}, ("l_suppkey",)
    if name == "c-day180":
        keys, out = grouped(sd < 180, sk, rev=("sum", price),
                            n=("count", None))
        return {"l_suppkey": keys, **out}, ("l_suppkey",)
    if name == "c-supp-range":
        keys, out = grouped((sk >= 10) & (sk < 40), sd, mx=("max", price))
        return {"l_shipdate": keys, **out}, ("l_shipdate",)
    if name == "c-total":
        return {"total": np.array([qty.sum()])}, ()
    if name == "c-qty5":
        m = qty > 5
        return {"n": np.array([m.sum()]),
                "lo": np.array([price[m].min()])}, ()
    if name == "c-composite":
        keys, out = grouped(np.ones(sd.size, bool), sk * 64 + qty,
                            s=("sum", price))
        return {"l_suppkey": keys // 64, "l_qty": keys % 64, **out}, \
            ("l_suppkey", "l_qty")
    if name == "c-having":
        keys, out = grouped(sd >= 300, sk, s=("sum", price),
                            n=("count", None))
        avg = out["s"] / out["n"]
        keep = avg > 40
        order = np.argsort(-avg[keep], kind="stable")
        return {"l_suppkey": keys[keep][order],
                "avg_p": avg[keep][order]}, ()
    if name == "c-derived":
        keys, out = grouped(np.ones(sd.size, bool), sk,
                            m=("sum", price * qty))
        return {"l_suppkey": keys, **out}, ("l_suppkey",)
    if name == "c-select":
        m = sd == 33
        return {"l_orderkey": f["l_orderkey"][m], "l_suppkey": sk[m],
                "l_extprice": price[m]}, \
            ("l_orderkey", "l_suppkey", "l_extprice")
    if name == "c-supp7":
        keys, out = grouped(sk == 7, sd, n=("count", None))
        return {"l_shipdate": keys, **out}, ()
    if name == "c-empty-group":
        keys, out = grouped(sd > 9000, sk, s=("sum", price))
        return {"l_suppkey": keys, **out}, ("l_suppkey",)
    if name == "c-empty-min":
        m = sd > 9000
        return {"lo": np.array([price[m].min() if m.any() else 0.0])}, ()
    raise KeyError(name)


def check_corpus(name, res, fact) -> None:
    """A ``serve_corpus`` result against ``corpus_oracle``: the same rows
    (sorted by the key columns, or in the query's order), ints exact,
    floats within rtol 1e-4.  c-having's ORDER BY avg LIMIT 7 is held up
    to near-ties: its keys' averages match the oracle's, run in
    descending order, and are the oracle's top 7 within rtol 1e-4."""
    want, keys = corpus_oracle(name, fact)
    got = {c: np.asarray(res[c]) for c in want}
    if name == "c-having":
        w = dict(zip(want["l_suppkey"].tolist(), want["avg_p"]))
        k, a = got["l_suppkey"].tolist(), got["avg_p"].astype(np.float64)
        top = want["avg_p"][:7]
        if len(k) != top.size or len(set(k)) != len(k) or \
                any(x not in w for x in k):
            raise AssertionError(f"{name}: keys {k} are not a top "
                                 f"{top.size} of the oracle's")
        ok = np.allclose(a, [w[x] for x in k], rtol=1e-4, atol=0) and \
            np.all(np.diff(a) <= 0) and \
            np.allclose(np.sort([w[x] for x in k])[::-1], top, rtol=1e-4,
                        atol=0)
        if not ok:
            raise AssertionError(f"{name}: top {top.size} differ from the "
                                 f"oracle's")
        return
    n = len(next(iter(want.values())))
    for c, g in got.items():
        if g.shape != (n,):
            raise AssertionError(f"{name}.{c}: {g.shape[0] if g.ndim else g}"
                                 f" rows, oracle {n}")
    if keys:
        og = np.lexsort([got[c].astype(np.float64) for c in keys[::-1]])
        ow = np.lexsort([want[c].astype(np.float64) for c in keys[::-1]])
        got = {c: v[og] for c, v in got.items()}
        want = {c: v[ow] for c, v in want.items()}
    for c, w in want.items():
        g = got[c]
        if g.dtype.kind in "iub" and w.dtype.kind in "iub":
            if not np.array_equal(g.astype(np.int64), w.astype(np.int64)):
                raise AssertionError(f"{name}.{c}: ints differ from the "
                                     f"oracle")
        elif not np.allclose(g.astype(np.float64), w, rtol=1e-4, atol=0):
            err = np.max(np.abs(g - w) / np.maximum(np.abs(w), 1e-30))
            raise AssertionError(f"{name}.{c}: rel err {err:.3g}")


def serve_mix(db):
    """benchmarks/serving.py::_mix re-keyed onto lineitem, as above."""
    from repro_torch.engine import col
    li = lambda: db.query("lineitem")
    return [
        li().group_by("l_suppkey").agg(n=("*", "count")),
        li().group_by("l_suppkey").agg(rev=("l_extprice", "sum")),
        li().where(col("l_qty") > 5).group_by("l_suppkey")
            .agg(s=("l_extprice", "sum"), n=("*", "count")),
        li().where(col("l_suppkey") < N_SUPP // 2).group_by("l_qty")
            .agg(avg_p=("l_extprice", "avg")),
        li().agg(total=("l_extprice", "sum"), n=("*", "count")),
        li().where(col("l_qty") == 3).agg(n=("*", "count")),
        li().group_by("l_qty").agg(mx=("l_extprice", "max"),
                                   mn=("l_extprice", "min")),
        li().select(margin=col("l_extprice") * col("l_qty"))
            .group_by("l_suppkey").agg(m=("margin", "sum"))
            .order_by("-m").limit(10),
    ]


def _served_equal(name, got, want) -> float:
    """A served result against the same query's solo run: the same
    columns and shapes, ints and counts equal, floats within rtol 1e-5
    (``seg_preagg``'s atomics order f32 sums differently from run to
    run).  One difference is the reference's own: a scalar query whose
    solo route is the RLE count (Q1) carries ``group_count`` too when it
    rides a shared scan (the fused shape keeps it), so that column may
    be extra.  Returns the largest relative float difference."""
    extra = set(got) - set(want)
    if set(want) - set(got) or extra - {"group_count"} or (
            extra and name != "Q1"):
        raise AssertionError(f"{name}: served {sorted(got)} != "
                             f"solo {sorted(want)}")
    worst = 0.0
    for c in want:
        a, b = np.asarray(got[c]), np.asarray(want[c])
        if a.shape != b.shape:
            raise AssertionError(f"{name}.{c}: shape {a.shape} != {b.shape}")
        if a.dtype.kind in "iub" and b.dtype.kind in "iub":
            if not np.array_equal(a.astype(np.int64), b.astype(np.int64)):
                raise AssertionError(f"{name}.{c}: ints differ")
            continue
        a, b = a.astype(np.float64), b.astype(np.float64)
        if not np.allclose(a, b, rtol=1e-5, atol=0):
            raise AssertionError(f"{name}.{c}: floats beyond rtol 1e-5")
        if a.size:
            worst = max(worst, float(np.max(np.abs(a - b) / np.maximum(
                np.abs(b), 1e-30))))
    return worst


class ServeProbe:
    """Instruments one serving run without touching the service: labels
    ``seg_preagg``'s captured calls with the query a fused closure serves
    (``serve-<name>`` for a shared member, ``solo-<name>`` for a solo
    unit), counts how often ``_Flight.ready()`` found a flight still
    computing, and counts the synchronising CUDA calls made inside
    ``QueryService._dispatch`` under ``torch.cuda.set_sync_debug_mode
    ("warn")``, by the source line that made them."""

    def __init__(self, capture, names):
        self.capture, self.names = capture, names
        self.ready_probes = self.unready = 0
        self.syncs = {}
        self._saved = []

    def __enter__(self):
        import traceback
        import warnings
        import torch
        from repro_torch.engine import executor, serving
        probe = self

        def label(kind, real):
            def wrapped(db, q, *args):
                probe.capture.query = f"{kind}-" + probe.names.get(
                    id(q), "other")
                return real(db, q, *args)
            return wrapped

        def ready(fl, real=serving._Flight.ready):
            r = real(fl)
            probe.ready_probes += 1
            probe.unready += not r
            return r

        src = os.path.join(REPO, "src") + os.sep

        def on_warning(message, category, filename, lineno, *rest):
            if "synchroniz" not in str(message):
                return
            # the innermost frame of the port: the line that asked for it
            site = next((f"{os.path.relpath(f.filename, REPO)}:{f.lineno}"
                         for f in reversed(traceback.extract_stack())
                         if f.filename.startswith(src)),
                        f"{filename}:{lineno}")
            probe.syncs[site] = probe.syncs.get(site, 0) + 1

        def dispatch(svc, unit, real=serving.QueryService._dispatch):
            with warnings.catch_warnings():
                warnings.simplefilter("always")
                warnings.showwarning = on_warning
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    return real(svc, unit)
                finally:
                    torch.cuda.set_sync_debug_mode(0)

        for owner, attr, new in (
                (executor, "execute_shared_fused_deferred",
                 label("serve", executor.execute_shared_fused_deferred)),
                (executor, "execute_fused_deferred",
                 label("solo", executor.execute_fused_deferred)),
                (serving._Flight, "ready", ready),
                (serving.QueryService, "_dispatch", dispatch)):
            self._saved.append((owner, attr, getattr(owner, attr)))
            setattr(owner, attr, new)
        return self

    def __exit__(self, *exc):
        for owner, attr, old in reversed(self._saved):
            setattr(owner, attr, old)
        self._saved = []

    def take(self):
        """(ready probes, unready answers, {sync site: calls}) since the
        last take, and start counting afresh."""
        out = (self.ready_probes, self.unready, self.syncs)
        self.ready_probes = self.unready = 0
        self.syncs = {}
        return out


def _serve_round(db, named, **kw):
    """Submit ``named`` ({name: query}) to one service and drain it;
    returns (service, {name: ticket})."""
    svc = db.serve(**kw)
    with svc.session("interactive") as s:
        tickets = {name: s.submit(q) for name, q in named.items()}
    svc.drain()
    return svc, tickets


def _check_round(db, label, svc, tickets, irs, fact, dim):
    """Every ticket of a drained round against its query's solo run and
    its float64 numpy oracle (phase 4's for the Q's, ``corpus_oracle``
    for the corpus shapes); the service's counters.
    Returns the worst float difference to the solo runs."""
    from repro_torch.engine import execute
    worst = 0.0
    for name, t in tickets.items():
        got = t.result()
        want, _ = execute(db, irs[name], as_of=t.stats.snapshot_epoch)
        worst = max(worst, _served_equal(name, got, want))
        if name in KEY_COL:
            check(name, got, fact, dim)
        else:
            check_corpus(name, got, fact)
    st = svc.stats
    if db.epochs.n_pinned() != 0:
        raise AssertionError(f"serving {label} left an epoch pinned")
    if st.device_transfers != st.drains:
        raise AssertionError(f"serving {label}: {st.device_transfers} "
                             f"copies for {st.drains} drains")
    groups = sorted({t.stats.dispatch_seq: t.stats.share_group
                     for t in tickets.values()}.items())
    _say("serving", round=label, queries=len(tickets), solo="match",
         oracle="match", max_float_rel_diff=f"{worst:.3g}",
         shared_scans=st.shared_scans, deduped=st.deduped,
         async_units=st.async_units, drains=st.drains,
         device_transfers=st.device_transfers,
         groups="+".join(str(g) for _, g in groups),
         pinned=db.epochs.n_pinned())
    return worst


def _closed_loop(db, scripts):
    """benchmarks/serving.py's closed loop: each client submits its next
    op once its previous one settled.  Returns (latencies ms, seconds,
    service).  A refused submit raises and fails the phase."""
    svc = db.serve(queue_depth=LOOP_CLIENTS + 2, max_concurrent=4,
                   max_coalesce=8, batch_boost_after=4)
    sessions = [svc.session("interactive" if ci % 3 else "batch")
                for ci in range(LOOP_CLIENTS)]
    next_op = [0] * LOOP_CLIENTS
    inflight, lat_ms = {}, []
    t0 = time.perf_counter()
    while True:
        for ci, sess in enumerate(sessions):
            if ci in inflight or next_op[ci] >= LOOP_OPS:
                continue
            inflight[ci] = sess.submit(scripts[ci][next_op[ci]])
            next_op[ci] += 1
        if not inflight:
            if all(n >= LOOP_OPS for n in next_op):
                break
            continue
        svc.step()
        for ci in [c for c, t in inflight.items() if t.done]:
            t = inflight.pop(ci)
            if t.state != "done":
                raise AssertionError(f"closed loop: {t.stats.rejected_reason}")
            lat_ms.append(t.stats.total_s * 1e3)
    seconds = time.perf_counter() - t0
    if svc.stats.completed != LOOP_CLIENTS * LOOP_OPS:
        raise AssertionError("closed loop: not every op completed")
    return lat_ms, seconds, svc


def _flood(db, mix, rng):
    """benchmarks/serving.py's interactive isolation: the p99 of a fixed
    interactive probe, unloaded, then between steps of a batch flood
    held to two flights by the batch bulkhead."""
    svc = db.serve(queue_depth=FLOOD_N + 8, max_concurrent=4,
                   max_coalesce=8,
                   max_in_flight={"interactive": 4, "batch": 2})
    inter = svc.session("interactive")
    probe = mix[0]

    def timed():
        t1 = time.perf_counter()
        inter.submit(probe).result()
        return (time.perf_counter() - t1) * 1e3

    unloaded = [timed() for _ in range(N_PROBE)]
    batch = svc.session("batch")
    flood = [batch.submit(mix[int(rng.integers(0, len(mix)))])
             for _ in range(FLOOD_N)]
    flooded = []
    for _ in range(N_PROBE):
        svc.step()
        svc.step()
        flooded.append(timed())
    svc.drain()
    if not all(t.state == "done" for t in flood):
        raise AssertionError("flood: a batch ticket did not complete")
    peak = svc.stats.peak_in_flight.get("batch", 0)
    if peak > 2:
        raise AssertionError(f"flood: {peak} batch tickets in flight")
    return (float(np.percentile(unloaded, 99)),
            float(np.percentile(flooded, 99)), peak)


def serving_phase(db, fact, dim, device):
    """Phase 10: ``db.serve()`` over the main SF1 database on a fresh
    block cache (the first union scans are cold).  (1) The differential
    round: tests/test_serving.py's corpus re-keyed onto lineitem plus
    Q1-Q7 and Qorders, served together at max_concurrent=2,
    max_coalesce=8; then Q1-Q7 and Qorders twice more with coalescing off
    (every unit solo: fused closures parked, the RLE routes synchronous;
    the second run warm).
    (2) benchmarks/serving.py's closed loop (12 clients x 12 ops of its
    mix) and its interactive probe under a bounded batch flood.  The
    launch counters are zeroed before (1) and read after (2); every
    served ticket is then held against its query's solo run (ints exact,
    floats rtol 1e-5) and its float64 numpy oracle, the closed
    loop's schedules run serially through ``execute``, seg_preagg is held
    against its plain version and the float64 sums on the shared
    members' inputs (``serve-`` rows), and one served round of the mix is
    profiled.  Returns the
    ``serve-`` JSON rows."""
    import torch
    from repro_torch.core.block_cache import BlockCache
    from repro_torch.engine import execute
    from repro_torch.kernels import ops
    t_step = time.perf_counter()
    saved = db.block_cache
    db.block_cache = BlockCache(SERVE_CACHE)
    try:
        corpus = {n: qb.to_ir() for n, qb in serve_corpus(db).items()}
        qs = {n: qb.to_ir() for n, qb in make_queries(db).items()}
        mix = [qb.to_ir() for qb in serve_mix(db)]
        names = {id(q): n for n, q in list(corpus.items()) + list(qs.items())}
        names.update({id(q): f"mix{i}" for i, q in enumerate(mix)})
        rng = np.random.default_rng(42)
        scripts = [[mix[i] for i in rng.integers(0, len(mix), LOOP_OPS)]
                   for _ in range(LOOP_CLIENTS)]
        with SegCapture() as capture, ServeProbe(capture, names) as probe:
            ops.reset_launch_counts()
            _sync(device)
            t0 = time.perf_counter()
            svc_a, tk_a = _serve_round(db, {**corpus, **qs},
                                       max_concurrent=2, max_coalesce=8,
                                       queue_depth=64)
            _sync(device)
            cold_ms = (time.perf_counter() - t0) * 1e3
            seen = {"mix": probe.take()}
            svc_b, tk_b = _serve_round(db, qs, max_concurrent=2,
                                       max_coalesce=1, queue_depth=64)
            seen["solo"] = probe.take()
            svc_w, tk_w = _serve_round(db, qs, max_concurrent=2,
                                       max_coalesce=1, queue_depth=64)
            seen["solo_warm"] = probe.take()
            # warm the shared closures outside the timed loop, as the
            # benchmark does
            _serve_round(db, {f"mix{i}": q for i, q in enumerate(mix)},
                         queue_depth=len(mix) + 1, max_coalesce=len(mix))
            probe.take()
            lat_ms, loop_s, svc_c = _closed_loop(db, scripts)
            seen["closed_loop"] = probe.take()
            p99_unloaded, p99_flood, flood_peak = _flood(db, mix, rng)
            seen["flood"] = probe.take()
            _sync(device)
            launches = ops.launch_counts()
        _say("launches", path="serving",
             **{k: launches[k] for k in MAIN_KERNELS})
        missing = [k for k in MAIN_KERNELS if launches[k] == 0]
        if missing:
            raise AssertionError(f"serving path never launched: {missing}")

        # ---- what the run served, held against solo runs and oracles ----
        irs = {**corpus, **qs}
        _check_round(db, "mix", svc_a, tk_a, irs, fact, dim)
        if svc_a.stats.shared_scans == 0:
            raise AssertionError("serving: no shared scan in the mix round")
        _check_round(db, "solo", svc_b, tk_b, irs, fact, dim)
        _check_round(db, "solo_warm", svc_w, tk_w, irs, fact, dim)
        _say("serving", round="mix", cold_ms=f"{cold_ms:.3f}")
        for label, (probes, unready, syncs) in seen.items():
            _say("overlap", round=label, ready_probes=probes,
                 unready=unready, dispatch_syncs=sum(syncs.values()),
                 sync_sites=json.dumps(syncs, separators=(",", ":")))

        # ---- the closed loop's schedules, one at a time ----
        for q in mix:
            execute(db, q)
        _sync(device)
        t0 = time.perf_counter()
        serial_ms = []
        for rnd in range(LOOP_OPS):
            for ci in range(LOOP_CLIENTS):
                t1 = time.perf_counter()
                execute(db, scripts[ci][rnd])
                serial_ms.append((time.perf_counter() - t1) * 1e3)
        serial_s = time.perf_counter() - t0
        st = svc_c.stats
        n_ok = len(lat_ms)
        p50, p95, p99 = (float(np.percentile(lat_ms, p))
                         for p in (50, 95, 99))

        # ---- one served round of the mix, profiled ----
        def mix_round():
            _serve_round(db, {f"mix{i}": q for i, q in enumerate(mix)},
                         queue_depth=len(mix) + 1, max_coalesce=len(mix))
        round_ms = _host_ms(mix_round, reps=5)
        dev_ms, by_name = _profile(mix_round)
        busy = "not measured" if dev_ms is None \
            else f"{dev_ms / round_ms:.4f}"
        _say("serving", round="closed_loop", clients=LOOP_CLIENTS,
             ops=LOOP_CLIENTS * LOOP_OPS, completed=n_ok,
             p50_ms=f"{p50:.3f}", p95_ms=f"{p95:.3f}", p99_ms=f"{p99:.3f}",
             qps=f"{n_ok / loop_s:.2f}",
             serial_qps=f"{len(serial_ms) / serial_s:.2f}",
             serial_p50_ms=f"{float(np.percentile(serial_ms, 50)):.3f}",
             serial_p99_ms=f"{float(np.percentile(serial_ms, 99)):.3f}",
             speedup_vs_serial=f"{serial_s / loop_s:.3f}",
             shared_scan_hit_rate=f"{st.shared_hit_rate():.3f}",
             shared_scans=st.shared_scans, coalesced_max=st.coalesced_max,
             deduped=st.deduped, async_units=st.async_units,
             drains=st.drains, device_transfers=st.device_transfers,
             peak_reserved_mb=f"{db.block_cache.stats.peak_reserved_bytes / 2**20:.1f}")
        _say("serving", round="profiled_mix", host_ms=f"{round_ms:.3f}",
             device_ms=_fmt(dev_ms), busy_share=busy,
             top_kernel=(max(by_name, key=by_name.get).replace(" ", "_")[:60]
                         if by_name else "none"))
        _say("serving", round="flood", probes=N_PROBE, flood=FLOOD_N,
             p99_unloaded_ms=f"{p99_unloaded:.3f}",
             p99_flood_ms=f"{p99_flood:.3f}",
             p99_flood_ratio=f"{p99_flood / p99_unloaded:.3f}",
             batch_peak_in_flight=flood_peak)
        if st.device_transfers != st.drains or db.epochs.n_pinned():
            raise AssertionError("closed loop: copies != drains or a pin "
                                 "left")
        if st.shared_scans == 0 or st.async_units == 0:
            raise AssertionError("closed loop: nothing shared or parked")

        # ---- seg_preagg on the shared members' inputs: one row per
        # (rows, domain, aggregates), named by the first query to give it
        served = {}
        for (label, n, domain, aggs), (count, inputs) in \
                capture.shapes.items():
            if not label.startswith("serve-"):
                continue
            key = next((k for k in served if k[1:] == (n, domain, aggs)),
                       (label, n, domain, aggs))
            entry = served.setdefault(key, [0, inputs])
            entry[0] += count
        rows = seg_preagg_rows(types.SimpleNamespace(shapes=served),
                               sum(c for c, _ in served.values()), device)
        if not rows:
            raise AssertionError("serving: no shared member launched "
                                 "seg_preagg")
    finally:
        db.block_cache = saved
    torch.cuda.synchronize()
    _say("step", path="serving", seconds=f"{time.perf_counter() - t_step:.1f}")
    return rows


def serve_wos_round(db, solo) -> None:
    """Phase 7's serving round while the trickled rows are still in the
    WOS: Q3, Q5 and two corpus shapes served together, each equal to its
    solo run (Q3 and the corpus shapes share one scan, the WOS rows on
    the general path; Q5, a join, runs solo)."""
    from repro_torch.engine import execute
    corpus = serve_corpus(db)
    qs = make_queries(db)
    named = {"Q3": qs["Q3"].to_ir(), "Q5": qs["Q5"].to_ir(),
             "c-day180": corpus["c-day180"].to_ir(),
             "c-composite": corpus["c-composite"].to_ir()}
    svc, tickets = _serve_round(db, named, max_concurrent=2,
                                max_coalesce=8, queue_depth=16)
    for name, t in tickets.items():
        got = t.result()
        want = solo[name] if name in solo else execute(
            db, named[name], as_of=t.stats.snapshot_epoch)[0]
        _served_equal(name, got, want)
        if t.stats.exec_stats is not None and t.stats.exec_stats.fused:
            raise AssertionError(f"{name}: fused with WOS rows pending")
    if db.epochs.n_pinned() or svc.stats.device_transfers != \
            svc.stats.drains or svc.stats.shared_scans == 0:
        raise AssertionError(f"serving with WOS: {svc.stats}")
    _say("trickle", stage="wos", served=",".join(tickets), solo="match",
         shared_scans=svc.stats.shared_scans,
         groups="+".join(str(t.stats.share_group)
                         for t in tickets.values()))


# ------------------------------------------------------- compressed path --

# benchmarks/cstore_queries.py's compression tier: the working set its
# budget is computed over, and its fused queries (COMP_NAMES less Q1,
# which runs on the host), plus Q7
COMP_NEED = ("l_shipdate", "l_suppkey", "l_qty", "l_extprice")
COMP_AUTO = ("Q2", "Q3", "Q6", "Q7")
PRED_COLS = {"Q2": ("l_shipdate",), "Q3": ("l_shipdate",),
             "Q6": ("l_shipdate",), "Q7": ("l_suppkey",),
             "Qorders": ("o_orderkey",),
             "Qdict_filter": ("l_qty", "l_shipdate"),
             "Qdict_group": ("l_qty",)}


def comp_budget(db):
    """cstore_queries.py's constrained budget, max(0.55 (packed +
    decoded), 2 packed + 1 MiB) over COMP_NEED of every lineitem
    container: it holds the packed working set, not the decoded one.
    Returns (packed, decoded, budget) bytes, by the port's device_bytes."""
    from repro_torch.core.encodings import device_bytes, upload_torch
    packed = decoded = 0
    for c in _containers(db, "lineitem_super"):
        for name in COMP_NEED:
            ec = c.columns[name]
            inner = ec.inner if ec.inner is not None else ec
            packed += device_bytes(upload_torch(inner, "cpu"))
            decoded += inner.n_blocks * inner.block_rows * 4
    return packed, decoded, max(int(0.55 * (packed + decoded)),
                                2 * packed + (1 << 20))


def _packed_preds(db, table, cols) -> int:
    """Predicate columns stored packed in some container (BLOCK_DICT
    codes, DELTA_VALUE or DELTA_RANGE deltas): the bitunpack launches a
    compressed query must make, one per column."""
    return sum(any(col.encoding.value in ("block_dict", "delta_value",
                                          "delta_range")
                   and any(k.endswith("_packed") for k in col.arrays)
                   for col in (c.columns[n]
                               for c in _containers(db, table)))
               for n in cols)


def _comp_runs(db, qb, mode, budget, protect, device):
    """``qb`` cold then warm in ``mode`` on a fresh BlockCache of
    ``budget`` bytes (cstore_queries.py's _bench_compression), the launch
    counters zeroed just before each run and read just after.  Returns
    [(ms, launches, result, stats)] and leaves the cache in place."""
    from repro_torch.core.block_cache import BlockCache
    from repro_torch.kernels import ops
    db.block_cache = BlockCache(budget, protect_packed=protect)
    db.exec_mode = mode
    runs = []
    for _ in range(2):
        ops.reset_launch_counts()
        _sync(device)
        t0 = time.perf_counter()
        res = qb.collect()
        _sync(device)
        ms = (time.perf_counter() - t0) * 1e3
        runs.append((ms, ops.launch_counts(), res, qb.stats))
    return runs


def _same_result(name, a, b) -> None:
    """Two runs of one query: the same groups, ints and counts equal,
    floats within rtol 1e-4 (f32 atomics reorder sums between runs)."""
    key = KEY_COL[name]
    if set(a) != set(b):
        raise AssertionError(f"{name}: columns {sorted(a)} != {sorted(b)}")
    ka = np.asarray(a[key]).astype(np.int64)
    kb = np.asarray(b[key]).astype(np.int64)
    oa, ob = np.argsort(ka, kind="stable"), np.argsort(kb, kind="stable")
    if not np.array_equal(ka[oa], kb[ob]):
        raise AssertionError(f"{name}: the two runs' groups differ")
    for c in a:
        x, y = np.asarray(a[c])[oa], np.asarray(b[c])[ob]
        same = np.array_equal(x, y) if x.dtype.kind in "iub" else \
            np.allclose(x, y, rtol=1e-4, atol=0)
        if not same:
            raise AssertionError(f"{name}.{c}: the two runs differ")


def _comp_query(db, name, qb, mode, budget, fact, dim, table, device,
                totals) -> None:
    """One query of the compressed phase: cold and warm in ``mode`` with
    the packed payloads protected, one more warm run under the profiler,
    then cold and warm in "decoded" at the same budget; both held against
    the oracle and each other, the compressed runs' launches added to
    ``totals``.  Fails unless every compressed run took the code-domain
    scan, cached no decoded block of the table and, warm, launched
    bitunpack once per packed predicate column."""
    from repro_torch.core.block_cache import KIND_DECODED
    comp = _comp_runs(db, qb, mode, budget, True, device)
    ids = {c.id for c in _containers(db, table)}
    n_dec = sum(1 for k in db.block_cache.keys()
                if k[2] == KIND_DECODED and k[0] in ids)
    in_use = db.block_cache.stats.bytes_in_use
    dev_ms, by_name = _profile(qb.collect)
    dec = _comp_runs(db, qb, "decoded", budget, False, device)
    for _, _, res, _ in comp + dec:
        check(name, res, fact, dim)
    for (_, _, res, _), (_, _, dres, _) in zip(comp, dec):
        _same_result(name, res, dres)
    expect = _packed_preds(db, table, PRED_COLS[name])
    st = comp[1][3]
    if not all(r[3].compressed_scan for r in comp) or any(
            r[3].compressed_scan for r in dec):
        raise AssertionError(f"{name}: {mode} did not take the compressed "
                             f"scan, or decoded did")
    if comp[1][1]["bitunpack"] != expect:
        raise AssertionError(f"{name}: warm bitunpack launches "
                             f"{comp[1][1]['bitunpack']}, expected {expect}")
    if n_dec:
        raise AssertionError(f"{name}: {n_dec} decoded blocks cached")
    for _, launched, _, _ in comp:
        for k in totals:
            totals[k] += launched[k]
    top = max(by_name, key=by_name.get) if by_name else None
    _say("compressed", name=name, mode=mode,
         cold_ms=f"{comp[0][0]:.3f}", warm_ms=f"{comp[1][0]:.3f}",
         decoded_cold_ms=f"{dec[0][0]:.3f}",
         decoded_warm_ms=f"{dec[1][0]:.3f}",
         compressed_scan=st.compressed_scan, rows_scanned=st.rows_scanned,
         rows_materialized=st.rows_materialized,
         bitunpack="/".join(str(r[1]["bitunpack"]) for r in comp),
         seg_preagg="/".join(str(r[1]["seg_preagg"]) for r in comp),
         packed_pred_cols=expect, cache_bytes=in_use,
         decoded_entries=n_dec, oracle="match", equals_decoded=True,
         device_ms=_fmt(dev_ms),
         busy_share=_fmt(dev_ms and dev_ms / comp[1][0]),
         top_kernel=(top or "none").replace(" ", "_")[:60])


def whole_scan_row(db, launches, device) -> dict:
    """``bitunpack_segments`` over the l_qty codes of every container in
    one launch, the shape Qdict_group's mask program gives it: bit for
    bit against its plain version and the host unpack, timed."""
    import torch
    from repro_torch.core.encodings import unpack_words, upload_torch
    from repro_torch.kernels import ops
    segs, host = [], []
    for c in _containers(db, "lineitem_super"):
        col = c.columns["l_qty"]
        w = col.widths["codes_packed"]
        segs.append(ops.Segment(upload_torch(col, device)["codes_packed"],
                                w, None, np.arange(col.n_blocks)))
        host.append(unpack_words(col.arrays["codes_packed"], w,
                                 col.block_rows))
    br = host[0].shape[1]
    got = ops.bitunpack_segments(segs, br)
    want = ops.bitunpack_segments_plain(segs, br)
    if not (got.shape == want.shape and torch.equal(got, want)
            and np.array_equal(
            got.cpu().numpy(), np.concatenate(host).astype(np.int32))):
        raise AssertionError("bitunpack_segments whole scan: not bit-exact")
    n_blk = got.shape[0]
    nbytes = sum(s.words.numel() * 4 for s in segs) + got.numel() * 4 \
        + n_blk * 8 + len(segs) * 64          # words, codes, kept, table
    widths = sorted({s.width for s in segs})
    fn = lambda: ops.bitunpack_segments(segs, br)      # noqa: E731
    row = {"name": "bitunpack", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/bitunpack.cu",
           "replaces": "src/repro/kernels/bitunpack.py:111",
           "launches": launches, "launches_path": "compressed",
           "max_abs_err": float((got.long() - want.long()).abs().max()),
           "ms": _time_ms(fn),
           "plain_ms": _time_ms(lambda: ops.bitunpack_segments_plain(
               segs, br), reps=5),
           "bound_ms": _bound_ms(nbytes), "bound_by": "bytes",
           "library_ms": None,
           "kernel_device_ms": _kernel_device_ms(fn, "bitunpack_kernel"),
           "shape": f"whole scan: l_qty codes of {len(segs)} containers, "
                    f"{n_blk} blocks x {br}, w={widths}, one launch"}
    _say_row(row, shape=row["shape"].replace(" ", "_"), bit_exact=True)
    return row


def compressed_phase(db, fact, dim, device):
    """Phase 6: compressed-domain execution on the card.  (a) The
    reference benchmark's constrained deployment on the main database:
    Q2, Q3, Q6 and Q7 in "auto" at cstore_queries.py's budget (each takes
    the compressed scan), Qorders in "auto" (stays decoded: its decoded
    working set fits) and then forced "compressed".  (b) A second SF1
    lineitem from the same arrays with BLOCK_DICT l_qty: a code-range
    filter mixed with the sort column, and a GROUP BY in the code space,
    forced "compressed".  Returns the whole-scan bitunpack JSON row."""
    from repro_torch.core import Encoding
    from repro_torch.engine import col
    saved = db.block_cache
    totals = {"bitunpack": 0, "seg_preagg": 0}
    try:
        packed, decoded, budget = comp_budget(db)
        _say("compressed", layout="cstore_queries", packed_mb=packed / 1e6,
             decoded_mb=decoded / 1e6, budget_mb=budget / 1e6)
        queries = make_queries(db)
        auto = _comp_runs(db, queries["Qorders"], "auto", budget, True,
                          device)
        if any(r[3].compressed_scan for r in auto):
            raise AssertionError("Qorders: auto left the decoded scan")
        _say("compressed", name="Qorders", mode="auto",
             compressed_scan=False, cold_ms=f"{auto[0][0]:.3f}",
             warm_ms=f"{auto[1][0]:.3f}")
        for name in COMP_AUTO + ("Qorders",):
            _comp_query(db, name, queries[name],
                        "compressed" if name == "Qorders" else "auto",
                        budget, fact, dim, "lineitem_super"
                        if name != "Qorders" else "orders_super",
                        device, totals)
    finally:
        db.block_cache, db.exec_mode = saved, "auto"

    t0 = time.perf_counter()
    db2 = build_db(fact, None, device,
                   encodings={"l_qty": Encoding.BLOCK_DICT})
    packed, decoded, budget = comp_budget(db2)
    _say("compressed", layout="dict_qty",
         seconds=f"{time.perf_counter() - t0:.1f}",
         l_qty=db2.nodes[0].stores["lineitem_super"].containers[0]
         .columns["l_qty"].encoding.value,
         packed_mb=packed / 1e6, decoded_mb=decoded / 1e6,
         budget_mb=budget / 1e6)
    li = db2.query("lineitem")
    dict_queries = {
        "Qdict_filter": li.where((col("l_qty") < 24)
                                 & (col("l_shipdate") > 60)
                                 & (col("l_shipdate") < 120))
                          .group_by("l_suppkey")
                          .agg(s=("l_extprice", "sum")),
        "Qdict_group": li.where((col("l_qty") >= 10) & (col("l_qty") <= 20))
                         .group_by("l_qty").agg(c=("*", "count")),
    }
    for name, qb in dict_queries.items():
        _comp_query(db2, name, qb, "compressed", budget, fact, None,
                    "lineitem_super", device, totals)
    _say("launches", path="compressed", **totals)
    if not all(totals.values()):
        raise AssertionError(f"compressed path never launched: {totals}")
    return [whole_scan_row(db2, totals["bitunpack"], device)]


# ------------------------------------------------------- segmented path --

SEG_SHARDS = 4
SEG_CACHE = 8 << 30               # block cache of the segmented runs
# tests/test_segmented_exec.py::make_db's star at STAR_SCALE times its
# rows (promo stays 30 rows: its keys are days); the join templates with
# the exchange the planner must pick at this scale (planner/cost.py:
# parts' broadcast 3,000,000 x 16 B x 4 nodes > the 6,000,000 x 16 B
# resegment)
STAR_SCALE = 1500
STAR_ROWS = {"sales": 4000, "customer": 300, "supplier": 40, "parts": 2000}
N_PROMO = 30
STAR_JOINS = {
    "customer": (("custkey", "c_custkey"), "c_nation", "local"),
    "supplier": (("suppkey", "s_suppkey"), "s_region", "local"),
    "parts": (("partkey", "p_partkey"), "p_cat", "resegment"),
    "promo": (("day", "pr_day"), "pr_kind", "broadcast"),
}
STAR_TRICKLE = 10_000
STAR_FAILED = 2


def _same_answer(name, a, b) -> None:
    if KEY_COL.get(name, "") is None:            # a scalar query
        for c in a:
            x, y = np.asarray(a[c]), np.asarray(b[c])
            if not (np.array_equal(x, y) if x.dtype.kind in "iub"
                    else np.allclose(x, y, rtol=1e-4, atol=0)):
                raise AssertionError(f"{name}.{c}: the runs differ")
        return
    _same_result(name, a, b)


def _seg_bytes(db) -> int:
    """Device bytes of the cached segmented slabs and WOS buffers."""
    from repro_torch.core.block_cache import KIND_SEG, KIND_WOS
    return sum(nb for key, (_, nb) in db.block_cache._entries.items()
               if key[2] in (KIND_SEG, KIND_WOS))


def _timed(fn, device):
    _sync(device)
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return out, (time.perf_counter() - t0) * 1e3


def _seg_runs(db, name, qb, device, want, label):
    """``qb`` cold then warm on the attached mesh: each run segmented on
    every shard with no exchange overflow and equal to ``want`` (the
    mesh-detached answer).  Returns (ms, launches, stats) per run."""
    from repro_torch.kernels import ops
    runs = []
    for _ in range(2):
        before = ops.launch_counts()
        res, ms = _timed(qb.collect, device)
        after = ops.launch_counts()
        st = qb.stats
        if not st.segmented or st.n_shards != SEG_SHARDS \
                or st.reseg_overflow != 0:
            raise AssertionError(
                f"{label} {name}: segmented={st.segmented} n_shards="
                f"{st.n_shards} reseg_overflow={st.reseg_overflow}")
        if db.epochs.n_pinned() != 0:
            raise AssertionError(f"{label} {name} leaked an epoch pin")
        want(res)
        runs.append((ms, {k: after[k] - before[k] for k in MAIN_KERNELS},
                     st))
    return runs


def _seg_profile(phase, name, qb, warm_ms) -> None:
    """One more warm run under torch.profiler: device kernels only, the
    share of the untraced warm wall time the card was busy, and the
    kernel that took most of the device time."""
    dev_ms, by_name = _profile(qb.collect)
    if dev_ms is None:
        _say("profile", path=phase, name=name, device_ms="not measured")
        return
    top = max(by_name, key=by_name.get)
    _say("profile", path=phase, name=name, device_ms=f"{dev_ms:.4f}",
         warm_ms=f"{warm_ms:.3f}", busy_share=f"{dev_ms / warm_ms:.4f}",
         top_kernel=top.replace(" ", "_")[:60],
         top_kernel_ms=f"{by_name[top]:.4f}")


def _say_seg(phase, name, runs, single_ms, db, **kw) -> None:
    (cold, lc, sc), (warm, lw, sw) = runs
    _say(phase, name=name, route=sw.groupby_algorithm.replace(" ", "_"),
         exchange=sw.exchange or "none", slab=f"{sc.seg_slab}/{sw.seg_slab}",
         cold_ms=f"{cold:.3f}", warm_ms=f"{warm:.3f}",
         single_warm_ms=f"{single_ms:.3f}",
         stage_ms_warm=json.dumps({k: round(v, 3) for k, v in
                                   sw.stage_ms.items()},
                                  separators=(",", ":")),
         slab_mb=f"{_seg_bytes(db) / 1e6:.1f}",
         launches_cold="/".join(str(lc[k]) for k in MAIN_KERNELS),
         launches_warm="/".join(str(lw[k]) for k in MAIN_KERNELS),
         plan_cache=sw.plan_cache, **kw)


def build_star(device, scale=None, seed=7):
    """tests/test_segmented_exec.py::make_db at ``scale`` times its rows:
    sales segmented by custkey; customer co-located, supplier
    replicated, parts segmented by its key (resegmented to), promo (30
    rows) segmented off the join key (broadcast); 4 nodes, K=1,
    block_rows 4096, loaded in one direct-to-ROS commit.  Returns the
    database and its rows (the dimensions keyed by position)."""
    from repro_torch.core import ColumnDef, SQLType, TableSchema, VerticaDB
    rng = np.random.default_rng(seed)
    scale = STAR_SCALE if scale is None else scale
    n = {t: r * scale for t, r in STAR_ROWS.items()}
    db = VerticaDB(n_nodes=4, k_safety=1, block_rows=4096,
                   cache_budget_bytes=SEG_CACHE, device=device)
    C = ColumnDef
    db.create_table(TableSchema("sales", (
        C("sale_id"), C("custkey"), C("suppkey"), C("partkey"), C("day"),
        C("qty"), C("delta"), C("price", SQLType.FLOAT))),
        sort_order=("day",), segment_by=("custkey",))
    db.create_table(TableSchema("customer", (C("c_custkey"),
                                             C("c_nation"))),
                    sort_order=("c_custkey",), segment_by=("c_custkey",))
    db.create_table(TableSchema("supplier", (C("s_suppkey"),
                                             C("s_region"))),
                    sort_order=("s_suppkey",), segment_by=())
    db.create_table(TableSchema("parts", (C("p_partkey"), C("p_cat"))),
                    sort_order=("p_partkey",), segment_by=("p_partkey",))
    db.create_table(TableSchema("promo", (C("pr_day"), C("pr_kind"))),
                    sort_order=("pr_day",), segment_by=("pr_day",))
    data = {"sales": _star_sales(rng, n["sales"], 0, n),
            "customer": {"c_custkey": np.arange(n["customer"]),
                         "c_nation": rng.integers(0, 12, n["customer"])},
            "supplier": {"s_suppkey": np.arange(n["supplier"]),
                         "s_region": rng.integers(0, 5, n["supplier"])},
            "parts": {"p_partkey": np.arange(n["parts"]),
                      "p_cat": rng.integers(0, 9, n["parts"])},
            "promo": {"pr_day": np.arange(N_PROMO) * 12,
                      "pr_kind": rng.integers(0, 4, N_PROMO)}}
    t = db.begin(direct_to_ros=True)
    for table, rows in data.items():
        db.insert(t, table, rows)
    db.commit(t)
    return db, data, n


def _star_sales(rng, n_rows, base, n):
    return {"sale_id": base + np.arange(n_rows, dtype=np.int64),
            "custkey": rng.integers(0, n["customer"], n_rows),
            "suppkey": rng.integers(0, n["supplier"], n_rows),
            "partkey": rng.integers(0, n["parts"], n_rows),
            "day": rng.integers(0, 365, n_rows),
            "qty": rng.integers(1, 50, n_rows),
            "delta": rng.integers(-40, 40, n_rows),
            "price": np.round(rng.normal(100, 10, n_rows), 2)}


def star_query(db, dim):
    on, carried, _ = STAR_JOINS[dim]
    return (db.query("sales").join(dim, on=on, cols=(carried,))
            .group_by(carried)
            .agg(n=("*", "count"), s=("qty", "sum"), mx=("price", "max")))


def star_oracle(dim, data):
    """numpy answer of ``star_query``: the dimensions are keyed by
    position (promo by day / 12 on the days divisible by 12)."""
    s = data["sales"]
    if dim == "promo":
        d = s["day"]
        m = (d % 12 == 0) & (d // 12 < N_PROMO)
        key = data["promo"]["pr_kind"][d[m] // 12]
    else:
        (fk, _), carried, _ = STAR_JOINS[dim]
        m = np.ones(s["day"].size, bool)
        key = data[dim][carried][s[fk]]
    keys, inv = np.unique(key, return_inverse=True)
    mx = np.full(keys.size, -np.inf)
    np.maximum.at(mx, inv.reshape(-1), s["price"][m])
    return keys, {"n": np.bincount(inv.reshape(-1)),
                  "s": np.bincount(inv.reshape(-1), s["qty"][m]),
                  "mx": mx}


def star_check(dim, res, data) -> None:
    keys, want = star_oracle(dim, data)
    carried = STAR_JOINS[dim][1]
    got = np.asarray(res[carried]).astype(np.int64)
    order = np.argsort(got, kind="stable")
    if not np.array_equal(got[order], keys):
        raise AssertionError(f"star {dim}: group keys differ")
    for agg in ("n", "s"):
        if not np.array_equal(np.asarray(res[agg])[order].astype(np.int64),
                              want[agg].astype(np.int64)):
            raise AssertionError(f"star {dim}.{agg}: ints differ")
    if not np.allclose(np.asarray(res["mx"])[order], want["mx"],
                       rtol=1e-4, atol=0):
        raise AssertionError(f"star {dim}.mx differs")


def _star_round(db, data, device, step, totals, profile=False):
    """The four join templates cold then warm on the mesh (first, so the
    cold run decodes), each equal to the oracle and to the warm
    mesh-detached run after it, each with the exchange the planner must
    pick; their launches add to ``totals``.  ``profile`` adds a profiled
    warm run of each."""
    mesh = db.mesh
    for dim in STAR_JOINS:
        got = []
        qb = star_query(db, dim)
        runs = _seg_runs(db, dim, qb, device,
                         lambda r, dim=dim: (star_check(dim, r, data),
                                             got.append(r)), "star")
        if profile:
            _seg_profile("star", dim, qb, runs[1][0])
        db.detach_mesh()
        single = star_query(db, dim)
        single.collect()
        res, single_ms = _timed(single.collect, device)   # warm
        db.attach_mesh(mesh)
        star_check(dim, res, data)
        for r in got:
            _same_star(dim, r, res)
        for _, launched, _ in runs:
            for k, v in launched.items():
                totals[k] += v
        exch = runs[1][2].exchange
        if exch != STAR_JOINS[dim][2]:
            raise AssertionError(f"star {dim}: exchange {exch}, expected "
                                 f"{STAR_JOINS[dim][2]}")
        _say_seg("star", dim, runs, single_ms, db, step=step,
                 oracle="match", single="match")


def _same_star(dim, a, b) -> None:
    carried = STAR_JOINS[dim][1]
    oa = np.argsort(np.asarray(a[carried]), kind="stable")
    ob = np.argsort(np.asarray(b[carried]), kind="stable")
    for c in a:
        x, y = np.asarray(a[c])[oa], np.asarray(b[c])[ob]
        if not (np.array_equal(x, y) if x.dtype.kind in "iub"
                else np.allclose(x, y, rtol=1e-4, atol=0)):
            raise AssertionError(f"star {dim}.{c}: segmented != single")


def segmented_phase(db, fact, dim, device):
    """Phase 9: segmented execution on SEG_SHARDS logical shards of the
    card.  (1) Q1-Q7 and Qorders on the main SF1 database, cold (a fresh
    block cache: decodes and slab builds) then warm, each equal to the
    oracle and to its mesh-detached run; seg_preagg's inputs captured and
    held against its plain version per shape.  (2) The star layout of
    tests/test_segmented_exec.py at STAR_SCALE x: the four join templates
    (local, local, resegment, broadcast) against a numpy oracle and the
    mesh-detached run; then a node fails (its slabs are evicted, buddies
    serve), a trickle lands while it is down, it rejoins and recovers, and
    every step is checked again.  (3) The Database Designer on the star:
    ``design`` over two star queries, ``create_projection(populate=True)``
    of the first projection it proposes, and a query the planner routes
    to it against the oracle.  Returns seg_preagg's JSON rows."""
    import torch
    from repro_torch.core.block_cache import BlockCache, KIND_SEG
    from repro_torch.core.recovery import recover_node
    from repro_torch.distributed import make_query_mesh
    from repro_torch.engine import col
    from repro_torch.kernels import ops
    from repro_torch.planner import design, plan_query

    # ---- (1) the main SF1 database on 4 shards ----
    t_step = time.perf_counter()
    queries = make_queries(db)
    single, single_ms = {}, {}
    for name, qb in queries.items():          # mesh detached, warm
        qb.collect()
        single[name], single_ms[name] = _timed(qb.collect, device)
        check(name, single[name], fact, dim)
    saved = db.block_cache
    db.block_cache = BlockCache(SEG_CACHE)    # cold runs decode and slab
    db.collect_stage_timing = True
    db.attach_mesh(make_query_mesh(SEG_SHARDS, device=device))
    try:
        warm = {}
        with SegCapture() as capture:
            ops.reset_launch_counts()
            for name, qb in queries.items():
                capture.query = f"seg-{name}"
                runs = _seg_runs(db, name, qb, device,
                                 lambda r, name=name: (
                                     check(name, r, fact, dim),
                                     _same_answer(name, r, single[name])),
                                 "sf1")
                if name == "Q4" and any(
                        r[1]["rle_grouped_agg"] != 1 for r in runs):
                    raise AssertionError("segmented Q4 did not launch "
                                         "rle_grouped_agg once a run")
                _say_seg("segmented", name, runs, single_ms[name], db,
                         oracle="match", single="match")
                warm[name] = runs[1][0]
            launches = ops.launch_counts()
        _say("launches", path="segmented",
             **{k: launches[k] for k in MAIN_KERNELS})
        missing = [k for k in MAIN_KERNELS if launches[k] == 0]
        if missing:
            raise AssertionError(f"segmented path never launched: {missing}")
        rows = seg_preagg_rows(capture, launches["seg_preagg"], device)
        for name, qb in queries.items():
            _seg_profile("segmented", name, qb, warm[name])
    finally:
        db.detach_mesh()
        db.block_cache = saved
        db.collect_stage_timing = False
    _say("step", path="segmented", name="sf1",
         seconds=f"{time.perf_counter() - t_step:.1f}")

    # ---- (2) the star layout: three exchanges, failure and recovery ----
    t_step = time.perf_counter()
    star, data, n = build_star(device)
    _say("step", path="segmented", name="star_load",
         rows=json.dumps(n, separators=(",", ":")),
         seconds=f"{time.perf_counter() - t_step:.1f}")
    star.collect_stage_timing = True
    star.attach_mesh(make_query_mesh(SEG_SHARDS, device=device))
    totals = {k: 0 for k in MAIN_KERNELS}    # the segmented runs' launches
    t_step = time.perf_counter()
    _star_round(star, data, device, "loaded", totals, profile=True)
    _say("step", path="segmented", name="loaded",
         seconds=f"{time.perf_counter() - t_step:.1f}")

    t_step = time.perf_counter()
    warm_slabs = sum(k[2] == KIND_SEG for k in star.block_cache.keys())
    star.fail_node(STAR_FAILED)
    left = sum(k[2] == KIND_SEG for k in star.block_cache.keys())
    if warm_slabs - left <= 0:
        raise AssertionError("fail_node evicted no warm slab")
    _say("fail", node=STAR_FAILED, slabs_warm=warm_slabs,
         slabs_evicted=warm_slabs - left)
    _star_round(star, data, device, "node_down", totals)
    more = _star_sales(np.random.default_rng(8), STAR_TRICKLE,
                       10 * n["sales"], n)
    t = star.begin()
    star.insert(t, "sales", more)
    star.commit(t)
    data["sales"] = {c: np.concatenate([data["sales"][c], more[c]])
                     for c in more}
    _star_round(star, data, device, "trickle_while_down", totals)
    e_join = star.rejoin_node(STAR_FAILED)
    replayed = recover_node(star, STAR_FAILED)
    rec = star.nodes[STAR_FAILED].last_recovery
    if rec.get("complete") is False or star.nodes[STAR_FAILED].recovering:
        raise AssertionError(f"recovery incomplete: {rec}")
    _say("recover", node=STAR_FAILED, rejoin_epoch=e_join,
         replayed=json.dumps(replayed, separators=(",", ":")),
         last_recovery=json.dumps(rec, separators=(",", ":"), default=str))
    _star_round(star, data, device, "recovered", totals)
    _say("launches", path="segmented-star", **totals)
    if totals["seg_preagg"] == 0:
        raise AssertionError("the star's segmented runs never launched "
                             "seg_preagg")
    _say("step", path="segmented", name="failure_cycle",
         seconds=f"{time.perf_counter() - t_step:.1f}")

    # ---- (3) the Database Designer ----
    t_step = time.perf_counter()
    star.detach_mesh()
    workload = [star.query("sales").group_by("suppkey")
                .agg(n=("*", "count")),
                star.query("sales").where(col("day") < 60)
                .agg(n=("*", "count"), s=("qty", "sum"))]
    report = design(star, workload)
    if not report.proposed:
        raise AssertionError("design proposed no projection")
    proj = report.proposed[0]
    t0 = time.perf_counter()
    star.create_projection(proj, populate=True)
    populate_s = time.perf_counter() - t0
    s = data["sales"]
    oracle_of = [
        (np.unique(s["suppkey"]), {"n": np.bincount(s["suppkey"])}),
        (None, {"n": int((s["day"] < 60).sum()),
                "s": int(s["qty"][s["day"] < 60].sum())})]
    routed = []
    for qi, qb in enumerate(workload):
        plan = plan_query(star, qb.to_ir())
        if plan.projection != proj.name:
            continue
        res = qb.collect()
        keys, want = oracle_of[qi]
        for agg, w in want.items():
            got = np.asarray(res[agg]).astype(np.int64)
            if keys is not None:
                got = got[np.argsort(np.asarray(res["suppkey"]))]
                w = w[keys]
            if not np.array_equal(got.reshape(-1), np.reshape(w, -1)):
                raise AssertionError(f"designed projection q{qi}.{agg}")
        routed.append(qi)
    if not routed:
        raise AssertionError(f"no workload query routed to {proj.name}")
    _say("design", proposed=",".join(p.name for p in report.proposed),
         populated=proj.name, sort_order=",".join(proj.sort_order),
         segmented_by=",".join(proj.segmentation.columns),
         populate_host_s=f"{populate_s:.2f}",
         routed=",".join(f"q{i}" for i in routed), oracle="match",
         seconds=f"{time.perf_counter() - t_step:.1f}")
    del star
    gc.collect()
    torch.cuda.empty_cache()
    return rows


# -------------------------------------------------------------- LM path --

class FlashCapture:
    """Records the LM's ``flash_attention`` calls by q shape, with the
    inputs of each.  It wraps ``ops.flash_attention``, the name the model
    calls; the wrapper underneath still counts every launch."""

    def __init__(self):
        self.calls = {}          # q shape -> [(q, k, v, causal), ...]
        self._inner = None

    def __enter__(self):
        from repro_torch.kernels import ops
        self._inner = inner = ops.flash_attention

        def wrapped(q, k, v, *, causal=True, **kw):
            self.calls.setdefault(tuple(q.shape), []).append(
                (q, k, v, causal))
            return inner(q, k, v, causal=causal, **kw)
        ops.flash_attention = wrapped
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        ops.flash_attention = self._inner


def _flash_check(got, want, dtype: str) -> dict:
    """Holds the kernel's output against the plain version's: max |err|
    within FLASH_TOL (the reference test's) and every element within
    FLASH_ULPS ulps of max(|got|, |want|) in the output's type plus
    FLASH_FLOOR.  The element limit follows the values, so a fault in rows
    whose outputs are small (late rows of a long prompt) shows too.
    Returns max |err|, the largest share of its limit an element uses
    (at most 1) and the median |want|."""
    import torch
    g, w = got.to(torch.float32), want.to(torch.float32)
    err = (g - w).abs()
    _, ex = torch.frexp(torch.maximum(g.abs(), w.abs()))
    ulp = torch.ldexp(torch.full_like(g, torch.finfo(got.dtype).eps / 2), ex)
    limit = FLASH_ULPS * ulp + FLASH_FLOOR
    over = err - limit
    out = {"max_abs_err": float(err.max()),
           "limit_share": float((err / limit).max()),
           "median_abs_want": float(w.abs().median())}
    if not torch.isfinite(g).all() or out["max_abs_err"] > FLASH_TOL[dtype] \
            or float(over.max()) > 0:
        at = int(over.argmax())
        raise AssertionError(
            f"flash_attention ({dtype}, shape {tuple(got.shape)}): max |err| "
            f"{out['max_abs_err']:.3g} (limit {FLASH_TOL[dtype]}); worst "
            f"element {at}: got {float(g.flatten()[at]):.6g} want "
            f"{float(w.flatten()[at]):.6g}, over its limit of {FLASH_ULPS} "
            f"ulps + {FLASH_FLOOR} by {float(over.max()):.3g}")
    return out


def _flash_work(q, k, causal: bool, tensors: int = 2,
                flops_per_d: int = 4):
    """Bytes and flops of one attention call on q ``(..., S, d)`` and k
    ``(..., T, d)`` (k unexpanded): ``tensors`` q-shaped and as many
    k-shaped tensors each read or written once, and ``flops_per_d`` d
    flops per unmasked (query, key) pair.  The forward: q, out; k, v;
    2 d for q.k and 2 d for P.V."""
    S, d = q.shape[-2:]
    T = k.shape[-2]
    pairs = sum(min(i + 1, T) for i in range(S)) if causal else S * T
    n_q = q.numel() // (S * d)
    nbytes = tensors * (q.numel() + k.numel()) * q.element_size()
    return nbytes, flops_per_d * d * pairs * n_q


def _sdpa_inputs(q, k, v):
    """q ``(B, K, G, S, d)`` and k, v ``(B, K, 1, T, d)`` as SDPA's (B,
    heads, rows, d), kv expanded to the q heads: the library yardstick's
    inputs, made once outside its timed call."""
    B, K, G, S, d = q.shape
    T = k.shape[-2]
    return (q.reshape(B, K * G, S, d).contiguous(),
            *(t.expand(B, K, G, T, d).reshape(B, K * G, T, d).contiguous()
              for t in (k, v)))


def _flash_row(q, k, v, causal, launches, stats, shape):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    nbytes, flops = _flash_work(q, k, causal)
    by_bytes = _bound_ms(nbytes)
    by_ops = flops / BF16_FLOPS_PER_S * 1e3
    lq, lk, lv = _sdpa_inputs(q, k, v)
    fn = lambda: ops.flash_attention(q, k, v, causal=causal)
    device_ms = _kernel_device_ms(fn, "flash_attention_kernel", per_call=1)
    bound_ms = max(by_bytes, by_ops)
    if device_ms < bound_ms:
        raise AssertionError(f"flash_attention {tuple(q.shape)}: device "
                             f"{device_ms} ms below its bound {bound_ms}")
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:73",
            "launches": launches, **stats,
            "ms": _time_ms(fn, reps=10),
            "kernel_device_ms": device_ms,
            "plain_ms": _time_ms(lambda: ops.flash_attention_plain(
                q, k, v, causal=causal), reps=5),
            "library_ms": _time_ms(lambda: F.scaled_dot_product_attention(
                lq, lk, lv, is_causal=causal), reps=10),
            "bound_ms": bound_ms,
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bound_share": bound_ms / device_ms,
            "bound_bytes": nbytes, "bound_flops": flops, "shape": shape}


def flash_sass() -> None:
    """The bf16 flash kernels' machine code holds tensor-core products:
    ``cuobjdump --dump-sass`` of the forward's and the backward's
    libraries, HGMMA (warpgroup MMA) and FFMA counted per kernel; raises
    unless every sm90 instantiation (the forward's at 2 head-dim
    paddings, with and without the lse store; the backward's dq and
    dk/dv at 2 paddings) holds HGMMA and the backward's library has no
    other kernel than its f32 ones."""
    from pathlib import Path
    from repro_torch.kernels import build
    tool = Path(build._nvcc()).parent / "cuobjdump"
    for lib, n_sm90 in (("flash_attention", 4), ("flash_attention_bwd", 4)):
        sass = subprocess.run([str(tool), "--dump-sass",
                               str(build._lib_path(lib))],
                              capture_output=True, text=True,
                              check=True).stdout
        funcs = {}
        for part in sass.split("Function : ")[1:]:
            name = part.split(None, 1)[0]
            funcs[name] = (part.count("HGMMA"), part.count("FFMA"))
        for name, (hgmma, ffma) in sorted(funcs.items()):
            _say("sass", library=lib, kernel=name, hgmma=hgmma, ffma=ffma)
        sm90 = {n: h for n, (h, _) in funcs.items() if "sm90" in n}
        others = [n for n in funcs if "sm90" not in n]
        if len(sm90) != n_sm90 or not all(sm90.values()) or (
                lib == "flash_attention_bwd"
                and not all("f32" in n for n in others)):
            raise AssertionError(f"{lib}: sm90 kernels {sm90} (expected "
                                 f"{n_sm90}, each with HGMMA), others "
                                 f"{others}")


class MoeCapture:
    """Records each MoE layer's dispatch while it is open: it wraps
    ``models.moe.dispatch_plan``, the name ``_moe_apply_scatter`` calls,
    and keeps per call the capacity, the (token, k) pairs dropped and each
    expert's load (pairs routed to it).  It reads counts back to the host
    in every layer, so it stays off the timed path."""

    def __init__(self):
        self.calls = []          # (capacity, dropped pairs, load per expert)
        self._inner = None

    def __enter__(self):
        import torch
        from repro_torch.models import moe
        self._inner = inner = moe.dispatch_plan

        def wrapped(experts, m, cap):
            pos, keep = inner(experts, m, cap)
            load = torch.bincount(experts.reshape(-1),
                                  minlength=m.num_experts)
            self.calls.append((cap, int((~keep).sum()), load.tolist()))
            return pos, keep
        moe.dispatch_plan = wrapped
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe.dispatch_plan = self._inner

    def dropped(self):
        return [c[1] for c in self.calls]


def _lm_model(arch, device, kv_quant=False):
    """The config of ``arch`` at its published width, its model on the
    card, and bf16 weights from seed 0; returns (cfg, model, params,
    seconds to build)."""
    import torch
    from repro_torch import configs
    from repro_torch.models import build_model
    cfg = configs.get(arch)
    t0 = time.perf_counter()
    model = build_model(cfg, tp=1, device=device, kv_quant=kv_quant)
    params = model.init_params(seed=0)              # bf16, from the seed
    torch.cuda.synchronize()
    return cfg, model, params, time.perf_counter() - t0


def _cache_bytes(cache) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(cache))


def _flash_layers(cfg) -> int:
    """The layers whose prefill attention is the flash kernel's: every
    full-attention (unwindowed) layer of a model with attention (hymba:
    its 3 global layers; mamba2: none)."""
    from repro_torch.models.transformer import segments
    if not cfg.n_heads:
        return 0
    return sum(seg.n_layers for seg in segments(cfg) if seg.window is None)


def lm_path(model, params, prompts, init_s, label):
    """The LM path of one model: ``serve.generate`` on each prompt with
    the counters zeroed just before and read just after, nothing
    captured, so each generation's peak memory is what serving holds.
    ``flash_attention`` must launch once per full-attention layer and
    prefill (``_flash_layers``; an attention-free model launches
    nothing), and nothing else.  Prints the ``[launches]`` and ``[lm]``
    lines; returns the generations and each one's flash launches."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    cfg = model.cfg
    first = next(iter(prompts.values()))
    serve.generate(model, params, first[:, :64], 2)          # warm-up
    gens, peaks, flash = {}, {}, {}
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    for shape, tokens in prompts.items():
        torch.cuda.reset_peak_memory_stats()
        before = ops.launch_counts()["flash_attention"]
        gens[shape] = serve.generate(model, params, tokens, shape[2])
        peaks[shape] = torch.cuda.max_memory_allocated()
        flash[shape] = ops.launch_counts()["flash_attention"] - before
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    _say("launches", path="lm", arch=label,
         **{k: v for k, v in launches.items()
            if v or k == "flash_attention"})
    others = {k: v for k, v in launches.items()
              if v and k != "flash_attention"}
    n_flash = _flash_layers(cfg)
    if any(n != n_flash for n in flash.values()) or others:
        raise AssertionError(f"LM path ({label}) launches {launches}: "
                             f"expected flash_attention once per "
                             f"full-attention layer ({n_flash}) and "
                             f"prefill")
    weights = sum(t.numel() * t.element_size() for t in _leaves(params))
    for (B, S, n_new), gen in gens.items():
        ids = gen.tokens
        if tuple(ids.shape) != (B, n_new) or int(ids.min()) < 0 or \
                int(ids.max()) >= cfg.vocab_size:
            raise AssertionError(f"generate {label} {B}x{S}: tokens "
                                 f"{ids.shape} out of [0, {cfg.vocab_size})")
        steps = max(gen.decode_steps, 1)
        kv_bytes = _cache_bytes(_decl_cache(model, B, S + n_new))
        _say("lm", arch=label, params=model.n_params, batch=B, prompt=S,
             new_tokens=n_new, init_s=f"{init_s:.2f}",
             prefill_ms=f"{gen.prefill_s * 1e3:.3f}",
             prefill_tok_per_s=f"{B * S / gen.prefill_s:.1f}",
             decode_ms_per_step=f"{gen.decode_s * 1e3 / steps:.3f}",
             decode_tok_per_s=f"{B * gen.decode_steps / gen.decode_s:.1f}"
             if gen.decode_steps else "none",
             weights_gb=f"{weights / 1e9:.3f}", kv_cache_bytes=kv_bytes,
             flash_launches=flash[(B, S, n_new)],
             max_memory_allocated_gib=f"{peaks[(B, S, n_new)] / 2**30:.3f}",
             first_tokens=json.dumps(ids[0, :8].tolist()))
    return gens, flash


def _decl_cache(model, batch, max_len):
    """The cache ``model.cache_decls`` declares, as meta tensors (shapes
    and dtypes, no memory)."""
    import torch

    def meta(tree):
        if isinstance(tree, dict):
            return {k: meta(v) for k, v in tree.items()}
        return torch.empty(tree[0], dtype=tree[2], device="meta")
    return meta(model.cache_decls(batch, max_len))


def lm_flash_rows(model, params, prompts, gens, flash, label, moe=None):
    """Each prefill again with every layer's kernel inputs captured (its
    first token must equal the generation's), the kernel against its
    plain version on each layer, and one flash JSON row per prompt shape;
    one shape at a time, so the captured tensors are freed in between.
    With ``moe`` (a list), each prefill's ``MoeCapture`` calls are added
    to it."""
    import torch
    from repro_torch.kernels import ops
    cfg = model.cfg
    n_flash = _flash_layers(cfg)
    rows = []
    for (B, S, n_new), gen in gens.items():
        with FlashCapture() as capture, MoeCapture() as mcap:
            logits, _ = model.prefill(params, {"tokens": prompts[
                (B, S, n_new)]}, max_len=S + n_new)
        if moe is not None:
            moe.append((f"prefill_{B}x{S}", mcap.calls))
        first = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        if not torch.equal(first, gen.tokens[:, 0]):
            raise AssertionError(f"prefill {label} {B}x{S}: the captured "
                                 f"run's first tokens differ from the "
                                 f"path's")
        if not n_flash:
            if capture.calls:
                raise AssertionError(f"prefill {label} {B}x{S}: flash "
                                     f"calls in an attention-free model")
            _say("check", lm="no_flash_layers", arch=label,
                 prefill=f"{B}x{S}", flash_calls=0)
            continue
        K, G, d = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, \
            cfg.resolved_head_dim
        calls = capture.calls.get((B, K, G, S, d), [])
        if len(calls) != n_flash or len(capture.calls) != 1:
            raise AssertionError(
                f"prefill {label} {B}x{S}: flash calls "
                f"{ {k: len(c) for k, c in capture.calls.items()} }, "
                f"expected {n_flash} of q {(B, K, G, S, d)}")
        per = [_flash_check(ops.flash_attention(q, k, v, causal=c),
                            ops.flash_attention_plain(q, k, v, causal=c),
                            "bfloat16") for q, k, v, c in calls]
        stats = {"max_abs_err": max(p["max_abs_err"] for p in per),
                 "limit_share": max(p["limit_share"] for p in per),
                 "median_abs_want": min(p["median_abs_want"] for p in per)}
        q, k, v, c = calls[0]
        row = _flash_row(q, k, v, c, flash[(B, S, n_new)], stats,
                         f"{label} prefill {B}x{S}: q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} bf16 causal")
        rows.append(row)
        _say_row(row, arch=label, layers=len(calls),
                 max_abs_err=f"{stats['max_abs_err']:.3g}",
                 limit_share=f"{stats['limit_share']:.3g}",
                 min_median_abs_want=f"{stats['median_abs_want']:.3g}",
                 bound_by=row["bound_by"],
                 bound_share=_fmt(row["bound_share"]))
        del capture, calls, per, q, k, v
    return rows


def flash_extra_cases(cfg, device) -> None:
    """The kernel against its plain version beyond the model's shapes:
    ragged S, f32, and the bf16 kernel's other code paths (head dims 64
    and 96, no causal mask with S != T)."""
    import torch
    from repro_torch.kernels import ops
    K, G, d = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, \
        cfg.resolved_head_dim
    g = torch.Generator(device=device).manual_seed(7)
    for name, qs, ks, dt, causal in (
            ("ragged S=500", (1, K, G, 500, d), (1, K, 1, 500, d),
             "bfloat16", True),
            ("f32 (256, 128)", (256, d), (256, d), "float32", True),
            ("d=64 (2, 4, 2, 384, 64)", (2, 4, 2, 384, 64),
             (2, 4, 1, 384, 64), "bfloat16", True),
            ("d=96 (1, 8, 4, 300, 96)", (1, 8, 4, 300, 96),
             (1, 8, 1, 300, 96), "bfloat16", True),
            ("non-causal (128, 384)", (K, 128, d), (K, 384, d), "bfloat16",
             False)):
        tdt = getattr(torch, dt)
        q, k, v = (torch.randn(sh, generator=g, device=device).to(tdt)
                   for sh in (qs, ks, ks))
        st = _flash_check(ops.flash_attention(q, k, v, causal=causal),
                          ops.flash_attention_plain(q, k, v, causal=causal),
                          dt)
        _say("check", kernel="flash_attention", case=name.replace(" ", "_"),
             max_abs_err=f"{st['max_abs_err']:.3g}", tol=FLASH_TOL[dt],
             limit_share=f"{st['limit_share']:.3g}",
             median_abs_want=f"{st['median_abs_want']:.3g}")


def lm_decode_checks(model, params, rng, label, moe=None):
    """Decode from a prefill cache against a prefill of S + 1 tokens
    (decode takes the plain ``attend_full``, the prefill the kernel; max
    |logit gap| < 0.5), then that prefill through the kernel against the
    plain attention (< 0.5), at ``LM_SERVE``.  An MoE model (``moe``, a
    list that receives both prefills' ``MoeCapture`` calls) holds the
    first only where neither prefill dropped a (token, k) pair: a drop
    makes a token's output depend on the rest of the batch.  Returns the
    prefill cache and the tokens, for a decode step's profile."""
    import torch
    from repro_torch.kernels import ops
    cfg = model.cfg
    B, S, _ = LM_SERVE
    tok = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S + 1)),
                          dtype=torch.int32, device=model.device)
    with MoeCapture() as short:
        _, cache = model.prefill(params, {"tokens": tok[:, :S]},
                                 max_len=S + 4)
    ld, _ = model.decode_step(params, cache, tok[:, S:], S)
    with MoeCapture() as full:
        lf, _ = model.prefill(params, {"tokens": tok})
    gap = float((ld - lf).abs().max())
    finite = bool(torch.isfinite(ld).all() and torch.isfinite(lf).all())
    dropped = sum(short.dropped()) + sum(full.dropped())
    if moe is not None:
        moe += [(f"prefill_{B}x{S}", short.calls),
                (f"prefill_{B}x{S + 1}", full.calls)]
    held = dropped == 0
    if not finite or (held and gap >= 0.5):
        raise AssertionError(f"{label} decode vs prefill of S + 1: {gap:.4g}"
                             f" (finite: {finite})")
    # ---- the prefill through the kernel against the plain version
    kernel_logits = lf
    inner = ops.flash_attention
    ops.flash_attention = lambda q, k, v, causal=True, **kw: \
        ops.flash_attention_plain(q, k, v, causal=causal)
    try:
        plain_logits, _ = model.prefill(params, {"tokens": tok})
    finally:
        ops.flash_attention = inner
    plain_gap = float((kernel_logits - plain_logits).abs().max())
    agree = int((kernel_logits[:, -1].argmax(-1)
                 == plain_logits[:, -1].argmax(-1)).sum())
    if plain_gap >= 0.5 or not torch.isfinite(plain_logits).all():
        raise AssertionError(f"{label} prefill logits, kernel vs plain "
                             f"attention: {plain_gap:.4g}")
    real = lf[..., :cfg.vocab_size].float()       # the padding is masked
    _say("check", lm="decode_vs_prefill", arch=label, batch=B, prompt=S,
         max_abs_logit_gap=f"{gap:.4g}",
         limit=0.5 if held else f"not_held_{dropped}_pairs_dropped",
         kernel_vs_plain_prefill_gap=f"{plain_gap:.4g}",
         max_abs_logit=f"{float(real.abs().max()):.4g}",
         logit_std=f"{float(real.std()):.4g}",
         argmax_agree=f"{agree}/{B}")
    return cache, tok


def lm_profiles(model, params, prompt, cache, tok, label) -> None:
    """Where a prefill's and a decode step's device time goes: ``prompt``
    (B, S) and one decode step from ``cache``, a prefill of ``tok[:,
    :S]`` (each call writes the same token at position S again)."""
    B, S = prompt.shape
    step = lambda: model.decode_step(params, cache, tok[:, S:S + 1], S)
    for what, fn in ((f"prefill {B}x{S}", lambda: model.prefill(
            params, {"tokens": prompt})), ("decode step", step)):
        host_ms = _host_ms(fn)
        _, kernels = _profile(fn)
        if not kernels:
            _say("profile", lm=what.replace(" ", "_"), arch=label,
                 device_ms="not measured")
            continue
        dev_ms = sum(kernels.values())
        flash = sum(v for k2, v in kernels.items()
                    if "flash_attention_kernel" in k2)
        top = sorted(kernels, key=kernels.get, reverse=True)[:6]
        _say("profile", lm=what.replace(" ", "_"), arch=label,
             batch=B, prompt=S, host_ms=f"{host_ms:.3f}",
             kernel_ms=f"{dev_ms:.4f}", busy_share=f"{dev_ms / host_ms:.4f}",
             flash_ms=f"{flash:.4f}", kernels=len(kernels),
             top=json.dumps({k2.replace(" ", "_")[:40]: round(kernels[k2], 4)
                             for k2 in top}, separators=(",", ":")))


def _prompts(cfg, shapes, device, seed=0):
    import torch
    rng = np.random.default_rng(seed)
    return rng, {shape: torch.as_tensor(
        rng.integers(0, cfg.vocab_size, shape[:2]), dtype=torch.int32,
        device=device) for shape in shapes}


def lm_phase(device):
    """Phase 8: qwen3-4b at full width on the card (bf16 cache at
    ``LM_SERVE`` and ``LM_LONG``, then the int8 cache at ``LM_SERVE``),
    then each of ``LM_FAMILY`` at ``LM_SERVE`` (hymba-1.5b also at
    ``LM_LONG``), each model freed before the next is built.  Returns the
    flash_attention JSON rows."""
    import torch
    flash_sass()
    rows = []
    for arch in (LM_ARCH,) + LM_FAMILY:
        t0 = time.perf_counter()
        rows += (lm_qwen(device) if arch == LM_ARCH
                 else lm_family(arch, device))
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.empty_cache()
        _say("lm", arch=arch, seconds=f"{time.perf_counter() - t0:.1f}")
    return rows


def lm_qwen(device):
    """qwen3-4b: the bf16 cache's path at both shapes, the flash kernel
    on every layer of both prefills and on its extra cases, decode against
    prefill, the profiles; then the int8 cache (``lm_int8``)."""
    cfg, model, params, init_s = _lm_model(LM_ARCH, device)
    rng, prompts = _prompts(cfg, (LM_SERVE, LM_LONG), device)
    gens, flash = lm_path(model, params, prompts, init_s, cfg.name)
    rows = lm_flash_rows(model, params, prompts, gens, flash, cfg.name)
    flash_extra_cases(cfg, device)
    cache, tok = lm_decode_checks(model, params, rng, cfg.name)
    lm_profiles(model, params, prompts[LM_SERVE], cache, tok, cfg.name)
    del cache
    lm_int8(model, params, prompts[LM_SERVE], gens[LM_SERVE], device)
    return rows


def lm_int8(model, params, prompt, bf16_gen, device) -> None:
    """qwen3-4b with the int8 KV cache, on the bf16 model's weights: its
    path at ``LM_SERVE`` (launches, decode ms a step, KV bytes, peak
    memory), then, bit for bit, its prefill cache against ``quantize_kv``
    of the bf16 model's, and one decode step's written slot against
    ``quantize_kv`` of the step's own k and v in every layer and of the
    bf16 path's slot in layer 0 (later layers' k and v depend on the
    cache they attended to); the step's other slots unchanged, its logits
    finite, and their gap to the bf16 step's beside the logit std."""
    import torch
    from repro_torch.models import attention as attn
    from repro_torch.models import build_model
    cfg = model.cfg
    label = f"{cfg.name}-int8"
    qmodel = build_model(cfg, tp=1, device=device, kv_quant=True)
    gens, _ = lm_path(qmodel, params, {LM_SERVE: prompt}, 0.0, label)
    B, S, n_new = LM_SERVE
    step_ms = [g.decode_s * 1e3 / max(g.decode_steps, 1)
               for g in (gens[LM_SERVE], bf16_gen)]
    _say("lm", arch=label, kv_cache="int8",
         decode_ms_per_step=f"{step_ms[0]:.3f}",
         bf16_decode_ms_per_step=f"{step_ms[1]:.3f}",
         kv_cache_bytes=_cache_bytes(_decl_cache(qmodel, B, S + n_new)),
         bf16_kv_cache_bytes=_cache_bytes(_decl_cache(model, B, S + n_new)),
         same_first_token=bool(torch.equal(gens[LM_SERVE].tokens[:, 0],
                                           bf16_gen.tokens[:, 0])))

    # ---- the prefill caches: int8 == quantize_kv(bf16), bit for bit
    _, cache = model.prefill(params, {"tokens": prompt}, max_len=S + n_new)
    _, qcache = qmodel.prefill(params, {"tokens": prompt},
                               max_len=S + n_new)
    got = _cache_bytes(qcache)
    if got != _cache_bytes(_decl_cache(qmodel, B, S + n_new)):
        raise AssertionError(f"int8 cache holds {got} bytes, not its "
                             f"declarations'")
    for name in ("k", "v"):
        want_q, want_s = attn.quantize_kv(cache["layers"]["attn"][name])
        leaf = qcache["layers"]["attn"][name]
        if not (torch.equal(leaf["q"], want_q)
                and torch.equal(leaf["s"], want_s)):
            raise AssertionError(f"int8 prefill cache {name}: not "
                                 f"quantize_kv of the bf16 prefill's")
    # ---- one decode step on each cache, the int8 step's k and v captured
    nxt = prompt[:, -1:]
    before = {n: {p: t.clone() for p, t in
                  qcache["layers"]["attn"][n].items()} for n in ("k", "v")}
    seen = []
    inner = attn.quantize_kv

    def quantize(x):
        seen.append(x)
        return inner(x)
    attn.quantize_kv = quantize
    try:
        lq, _ = qmodel.decode_step(params, qcache, nxt, S)
    finally:
        attn.quantize_kv = inner
    lb, _ = model.decode_step(params, cache, nxt, S)
    if len(seen) != 2 * cfg.n_layers:
        raise AssertionError(f"int8 decode step quantized {len(seen)} "
                             f"tensors, expected k and v of "
                             f"{cfg.n_layers} layers")
    for j, name in enumerate(("k", "v")):
        leaf = qcache["layers"]["attn"][name]
        for layer in range(cfg.n_layers):
            wq, ws = inner(seen[2 * layer + j])
            if not (torch.equal(leaf["q"][layer, :, S:S + 1], wq)
                    and torch.equal(leaf["s"][layer, :, S:S + 1], ws)):
                raise AssertionError(f"int8 decode slot {S} of layer "
                                     f"{layer} {name}: not quantize_kv of "
                                     f"the step's {name}")
        bq, bs = inner(cache["layers"]["attn"][name][0, :, S:S + 1])
        if not (torch.equal(leaf["q"][0, :, S:S + 1], bq)
                and torch.equal(leaf["s"][0, :, S:S + 1], bs)):
            raise AssertionError(f"int8 decode slot {S} of layer 0 {name}: "
                                 f"not quantize_kv of the bf16 path's slot")
        for part, t in leaf.items():
            rest = torch.ones(t.shape[2], dtype=torch.bool, device=t.device)
            rest[S] = False
            if not torch.equal(t[:, :, rest], before[name][part][:, :, rest]):
                raise AssertionError(f"int8 decode step changed slots "
                                     f"other than {S} ({name}/{part})")
    if not torch.isfinite(lq).all():
        raise AssertionError("int8 decode logits are not finite")
    real_q = lq[..., :cfg.vocab_size].float()
    real_b = lb[..., :cfg.vocab_size].float()
    gap = float((real_q - real_b).abs().max())
    agree = int((real_q.argmax(-1) == real_b.argmax(-1)).sum())
    _say("check", lm="int8_cache", arch=label, prefill_cache="bit_exact",
         decode_slot="bit_exact", layers=cfg.n_layers,
         int8_vs_bf16_decode_logit_gap=f"{gap:.4g}",
         logit_std=f"{float(real_b.std()):.4g}", argmax_agree=f"{agree}/{B}")
    lm_profiles(qmodel, params, prompt, qcache, torch.cat(
        [prompt, nxt], dim=1), label)


def lm_steps_check(model, params, rng, shape, label):
    """``LM_STEPS`` decode steps from a prefill of S tokens against a
    prefill of S + LM_STEPS (max |logit gap| < 0.5, as one step is held).
    Every step writes the cache in place (an SSM layer's state and conv
    rings; a windowed layer's ring, which at S = 4096 wraps to slot 0) and
    the decoder hands a stacked segment's cache back as it received it,
    so a write that missed the cache shows in the next step.  The
    prefill's cache holds the bytes its declarations do."""
    import torch
    cfg = model.cfg
    B, S, _ = shape
    tok = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                       (B, S + LM_STEPS)),
                          dtype=torch.int32, device=model.device)
    _, cache = model.prefill(params, {"tokens": tok[:, :S]},
                             max_len=S + LM_STEPS)
    got = _cache_bytes(cache)
    want = _cache_bytes(_decl_cache(model, B, S + LM_STEPS))
    if got != want:
        raise AssertionError(f"{label} {B}x{S}: the prefill cache holds "
                             f"{got} bytes, its declarations {want}")
    for i in range(LM_STEPS):
        ld, cache = model.decode_step(params, cache,
                                      tok[:, S + i:S + i + 1], S + i)
    lf, _ = model.prefill(params, {"tokens": tok})
    gap = float((ld - lf).abs().max())
    finite = bool(torch.isfinite(ld).all() and torch.isfinite(lf).all())
    if not finite or gap >= 0.5:
        raise AssertionError(f"{label} {B}x{S}: {LM_STEPS} decode steps vs "
                             f"a prefill of S + {LM_STEPS}: {gap:.4g} "
                             f"(finite: {finite})")
    _say("check", lm=f"decode_{LM_STEPS}_steps_vs_prefill", arch=label,
         batch=B, prompt=S, max_abs_logit_gap=f"{gap:.4g}", limit=0.5,
         ring_wraps=bool(cfg.window and S + LM_STEPS > cfg.window),
         cache_bytes=got)


def lm_ssd_check(model, params, prompt, label):
    """The chunked SSD against its sequential oracle on layer 0's input,
    captured from a prefill of ``prompt``: both in f32 (the layer's
    parameters and the input cast up), at the model's chunk; max |err|
    within ``SSD_TOL`` x max(1, max |want|)."""
    import torch
    from repro_torch.models import ssm
    seen = []
    inner = ssm.ssd_apply

    def capture(p, u, lo, chunk, **kw):
        if not seen:
            seen.append((p, u, lo, chunk))
        return inner(p, u, lo, chunk, **kw)
    ssm.ssd_apply = capture
    try:
        model.prefill(params, {"tokens": prompt})
    finally:
        ssm.ssd_apply = inner
    p, u, lo, chunk = seen[0]
    p32 = {k: t.to(torch.float32) for k, t in p.items()}
    u32 = u.to(torch.float32)
    t0 = time.perf_counter()
    got = inner(p32, u32, lo, chunk)
    want = ssm.ssd_reference(p32, u32, lo)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    top = float(want.abs().max())
    limit = SSD_TOL * max(1.0, top)
    if not (err <= limit and torch.isfinite(got).all()):
        raise AssertionError(f"{label} ssd_apply vs ssd_reference on "
                             f"{tuple(u.shape)}: max |err| {err:.4g} "
                             f"(limit {limit:.4g})")
    _say("check", lm="ssd_chunked_vs_sequential", arch=label,
         input=json.dumps(list(u.shape), separators=(",", ":")),
         chunk=chunk, heads=lo.n_heads, d_state=lo.d_state,
         max_abs_err=f"{err:.4g}", limit=f"{limit:.4g}",
         max_abs_want=f"{top:.4g}",
         seconds=f"{time.perf_counter() - t0:.2f}")


def lm_family(arch, device):
    """One of ``LM_FAMILY`` at ``LM_SERVE`` (and at ``LM_FAMILY_SHAPES``'
    others): its path, the flash kernel on every full-attention layer,
    decode against prefill, the profiles; an MoE model also prints a
    ``[moe]`` line per prefill (capacity, dropped (token, k) pairs per
    layer, the largest and smallest expert load); an SSM or hybrid model
    also holds ``LM_STEPS`` decode steps against a prefill and the chunked
    SSD against its sequential oracle at each shape, and profiles each."""
    import torch
    cfg, model, params, init_s = _lm_model(arch, device)
    shapes = LM_FAMILY_SHAPES.get(arch, (LM_SERVE,))
    rng, prompts = _prompts(cfg, shapes, device)
    gens, flash = lm_path(model, params, prompts, init_s, cfg.name)
    moe = [] if cfg.moe is not None else None
    rows = lm_flash_rows(model, params, prompts, gens, flash, cfg.name, moe)
    cache, tok = lm_decode_checks(model, params, rng, cfg.name, moe)
    for what, calls in moe or ():
        if len(calls) != cfg.n_layers:
            raise AssertionError(f"{what}: {len(calls)} MoE dispatches, "
                                 f"expected {cfg.n_layers}")
        loads = [n for _, _, load in calls for n in load]
        _say("moe", arch=cfg.name, prefill=what, experts=cfg.moe.num_experts,
             top_k=cfg.moe.top_k, capacity=calls[0][0],
             dropped_per_layer=json.dumps([c[1] for c in calls],
                                          separators=(",", ":")),
             max_expert_load=max(loads), min_expert_load=min(loads))
    lm_profiles(model, params, prompts[LM_SERVE], cache, tok, cfg.name)
    del cache
    if cfg.ssm is not None:
        for shape in shapes:
            lm_steps_check(model, params, rng, shape, cfg.name)
            lm_ssd_check(model, params, prompts[shape], cfg.name)
            if shape != LM_SERVE:
                B, S, _ = shape
                _, cache = model.prefill(params, {"tokens": prompts[shape]},
                                         max_len=S + 1)
                lm_profiles(model, params, prompts[shape], cache,
                            torch.cat([prompts[shape],
                                       prompts[shape][:, -1:]], 1),
                            cfg.name)
                del cache
    return rows



# -------------------------------------------------------- training path --

# phase 11a: the backward kernel against float64 autograd of the plain
# forward's formulas, max |err| within BWD_TOL times max(1, max |want|) of
# each gradient (bf16: a rounding of the inputs' type, 2^-8, with room for
# the f32 sums; f32: summation order over up to 4 x 300 rows); phase 11b
# holds it to the same bf16 limit against the plain backward at the
# training path's shapes
BWD_TOL = {"bfloat16": 1e-2, "float32": 2e-5}
# the forward kernels' lse against the plain version's, times max(1, max
# |lse|): f32 sums in another order and ex2.approx (relative 2^-22) on
# scores of a few units
LSE_TOL = 1e-4
# phase 11c: one step's loss (nats) and global grad norm (relative), the
# kernels' route against the plain versions': the two attentions differ
# by an f32 rounding, which bf16 activations carry through 36 layers.
# The global norm is mostly the logits' and the tied embedding's, so the
# wq, wk and wv gradients of the first and last layer are held too:
# ||kernels - plain|| within TRAIN_LEAF_RTOL of ||plain||, each leaf
# (on an H100 these gaps read 5.6e-3-1.4e-2; a backward that sums one of
# the G query heads into dk and dv reads 0.86-0.99 on wk and wv)
TRAIN_LOSS_TOL, TRAIN_GNORM_RTOL, TRAIN_LEAF_RTOL = 2e-2, 2e-2, 3e-2
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 512, 5
# phase 11d: the driver at a small config (head dim 64)
DRIVER_ARGS = ("--d-model", "512", "--layers", "4", "--vocab", "2048",
               "--steps", "12", "--batch", "8", "--seq", "128",
               "--ckpt-every", "5", "--n-docs", "64", "--doc-len", "257")
DRIVER_FAIL_AT = 8


def _model_views(B, S, K, G, d, dtype, gen, device):
    """q (B,K,G,S,d) and k, v (B,K,1,S,d) as the permuted views the
    model's train mode hands the kernels."""
    import torch
    q = torch.randn((B, S, K, G, d), generator=gen, device=device)
    k, v = (torch.randn((B, S, K, d), generator=gen, device=device)
            for _ in range(2))
    return (q.to(dtype).permute(0, 2, 3, 1, 4),
            k.to(dtype).permute(0, 2, 1, 3).unsqueeze(2),
            v.to(dtype).permute(0, 2, 1, 3).unsqueeze(2))


def _attention64(q, k, v, causal: bool):
    """``flash_attention_plain``'s formulas in float64 (it computes in
    f32): the reference the backward kernel's gradients are held to."""
    import torch
    from repro_torch.kernels.flash_attention import NEG_INF
    s = torch.matmul(q, k.transpose(-1, -2)) / q.shape[-1] ** 0.5
    if causal:
        S, T = s.shape[-2:]
        mask = (torch.arange(S, device=s.device)[:, None]
                >= torch.arange(T, device=s.device)[None, :])
        s = torch.where(mask, s, NEG_INF)
    return torch.matmul(torch.softmax(s, dim=-1), v)


def flash_lse_checks(device) -> None:
    """Phase 11a: the forward kernels' lse (bf16 tensor-core and f32
    scalar kernels) against the plain version's, on the model's views;
    the output with lse asked for is bit for bit the one without."""
    import torch
    from repro_torch import configs
    from repro_torch.kernels import ops
    cfg = configs.get(LM_ARCH)
    K, G, d = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, \
        cfg.resolved_head_dim
    g = torch.Generator(device=device).manual_seed(13)
    for name, (B, S, K_, G_, d_), T, dt, causal in (
            (f"bfloat16_train_{LM_SERVE[0]}x{LM_SERVE[1]}",
             (LM_SERVE[0], LM_SERVE[1], K, G, d), LM_SERVE[1], "bfloat16",
             True),
            ("bfloat16_d64_full_S300_T200", (2, 300, 2, 4, 64), 200,
             "bfloat16", False),
            ("bfloat16_d96_causal_S130", (1, 130, 2, 4, 96), 130,
             "bfloat16", True),
            ("float32_d128_causal_S300", (2, 300, 2, 4, 128), 300,
             "float32", True),
            ("float32_d64_full_S130_T200", (1, 130, 2, 4, 64), 200,
             "float32", False)):
        tdt = getattr(torch, dt)
        q, _, _ = _model_views(B, S, K_, G_, d_, tdt, g, device)
        _, k, v = _model_views(B, T, K_, 1, d_, tdt, g, device)
        out, lse = ops.flash_attention(q, k, v, causal=causal,
                                       return_lse=True)
        _, want = ops.flash_attention_plain(q, k, v, causal=causal,
                                            return_lse=True)
        same = torch.equal(out, ops.flash_attention(q, k, v, causal=causal))
        torch.cuda.synchronize()
        err = float((lse - want).abs().max())
        limit = LSE_TOL * max(1.0, float(want.abs().max()))
        _say("check", kernel="flash_attention", lse=name,
             max_abs_err=f"{err:.3g}", limit=f"{limit:.3g}",
             out_bit_identical=same)
        if not (same and torch.isfinite(lse).all() and err <= limit):
            raise AssertionError(f"flash_attention lse {name}: max |err| "
                                 f"{err} (limit {limit}), output "
                                 f"identical {same}")


def flash_bwd_trace(device) -> None:
    """Phase 11a: one traced ``flash_attention_bwd`` call on the model's
    views (4 x 512, bf16) holds exactly the backward's two kernels: the
    inputs go to them as they are, with no copy or elementwise kernel."""
    import torch
    from repro_torch import configs
    from repro_torch.kernels import ops
    cfg = configs.get(LM_ARCH)
    K, G, d = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, \
        cfg.resolved_head_dim
    g = torch.Generator(device=device).manual_seed(14)
    q, k, v = _model_views(*LM_SERVE[:2], K, G, d, torch.bfloat16, g, device)
    out, lse = ops.flash_attention(q, k, v, return_lse=True)
    dout = torch.randn(out.shape, generator=g, device=device).to(
        torch.bfloat16)
    names = [e.name for e in _device_events(_traced(
        lambda: ops.flash_attention_bwd(q, k, v, out, dout, lse), 1))]
    short = [(re.search(r"flash_attention_bwd_\w+<\d+>", n) or
              re.search(r"\S+", n)).group(0) for n in names]
    _say("check", kernel="flash_attention_bwd",
         traced_kernels=json.dumps(short, separators=(",", ":")))
    if len(names) != 2 or not all("flash_attention_bwd_" in n and "sm90" in n
                                  for n in names):
        raise AssertionError(f"one flash_attention_bwd call launched "
                             f"{names}, expected its two sm90 kernels")


def flash_bwd_checks(device) -> None:
    """Phase 11a: ``flash_attention_bwd`` on the card, given the
    forward's lse, against float64 autograd of the attention, with the
    plain backward's gap printed beside it, and bit for bit against its
    own second launch.  The last two cases are the training path's own
    (qwen3-4b: 8 kv heads of 4 q heads, d 128) at 4 x 512 and 1 x
    4096."""
    import torch
    from repro_torch import configs
    from repro_torch.kernels import ops
    flash_lse_checks(device)
    flash_bwd_trace(device)
    g = torch.Generator(device=device).manual_seed(11)
    cases = [(f"{dt}_d{d}_{'causal' if c else 'full'}_G{G}_S300",
              (2, 300, 2, G, d), 300, dt, c)
             for dt in ("bfloat16", "float32") for d in (64, 96, 128)
             for c in (True, False) for G in (1, 4)]
    cases += [("bfloat16_d128_causal_S130_T200", (1, 130, 2, 4, 128), 200,
               "bfloat16", True),
              ("bfloat16_d128_full_S200_T70", (1, 200, 2, 4, 128), 70,
               "bfloat16", False)]
    cfg = configs.get(LM_ARCH)
    K, G, d = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, \
        cfg.resolved_head_dim
    cases += [(f"bfloat16_train_{B}x{S}", (B, S, K, G, d), S, "bfloat16",
               True) for B, S in ((LM_SERVE[0], LM_SERVE[1]),
                                  (LM_LONG[0], LM_LONG[1]))]
    for name, (B, S, K, G, d), T, dt, causal in cases:
        tdt = getattr(torch, dt)
        q, _, _ = _model_views(B, S, K, G, d, tdt, g, device)
        _, k, v = _model_views(B, T, K, 1, d, tdt, g, device)
        out, lse = ops.flash_attention(q, k, v, causal=causal,
                                       return_lse=True)
        dout = torch.randn(out.shape, generator=g, device=device).to(tdt)
        got = ops.flash_attention_bwd(q, k, v, out, dout, lse, causal=causal)
        again = ops.flash_attention_bwd(q, k, v, out, dout, lse,
                                        causal=causal)
        plain = ops.flash_attention_bwd_plain(q, k, v, out, dout, lse,
                                              causal=causal)
        x64 = [t.detach().to(torch.float64).requires_grad_()
               for t in (q, k, v)]
        want = torch.autograd.grad(_attention64(*x64, causal), x64,
                                   dout.to(torch.float64))
        del x64
        torch.cuda.synchronize()
        errs, plain_errs, limits = [], [], []
        for a, p, w, x in zip(got, plain, want, (q, k, v)):
            if a.shape != x.shape or a.dtype != x.dtype \
                    or not torch.isfinite(a).all():
                raise AssertionError(f"flash_attention_bwd {name}: gradient "
                                     f"{tuple(a.shape)} {a.dtype} for "
                                     f"{tuple(x.shape)} {x.dtype}")
            errs.append(float((a.double() - w).abs().max()))
            plain_errs.append(float((p.double() - w).abs().max()))
            limits.append(BWD_TOL[dt] * max(1.0, float(w.abs().max())))
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        _say("check", kernel="flash_attention_bwd", case=name,
             max_abs_err_dq_dk_dv=json.dumps([float(f"{e:.3g}")
                                              for e in errs]),
             plain_max_abs_err=json.dumps([float(f"{e:.3g}")
                                           for e in plain_errs]),
             limits=json.dumps([float(f"{x:.3g}") for x in limits]),
             rerun_bit_identical=same)
        if not same or any(e > lim for e, lim in zip(errs, limits)):
            raise AssertionError(f"flash_attention_bwd {name}: errors {errs} "
                                 f"(limits {limits}), rerun identical "
                                 f"{same}")


def flash_bwd_row(shape, launches, device) -> dict:
    """Phase 11b: the ``flash_attention_bwd`` JSON row at one of phase 8's
    prefill shapes, on the model's views: event and device ms, bound,
    plain ms, and SDPA's backward alone (kv expanded) as the yardstick."""
    import torch
    import torch.nn.functional as F
    from repro_torch import configs
    from repro_torch.kernels import ops
    cfg = configs.get(LM_ARCH)
    B, S = shape
    K, G, d = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, \
        cfg.resolved_head_dim
    g = torch.Generator(device=device).manual_seed(12)
    q, k, v = _model_views(B, S, K, G, d, torch.bfloat16, g, device)
    out, lse = ops.flash_attention(q, k, v, return_lse=True)
    dout = torch.randn(out.shape, generator=g, device=device).to(
        torch.bfloat16)
    fn = lambda: ops.flash_attention_bwd(q, k, v, out, dout, lse)
    plain = lambda: ops.flash_attention_bwd_plain(q, k, v, out, dout, lse)
    # dq, dk, dv each within phase 11a's bf16 limit of the plain backward
    errs, limits = [], []
    for a, b in zip(fn(), plain()):
        errs.append(float((a.float() - b.float()).abs().max()))
        limits.append(BWD_TOL["bfloat16"] * max(1.0, float(
            b.float().abs().max())))
    err = max(errs)
    # q, out, dout, dq; k, v, dk, dv; lse; the gradient's five products
    nbytes, flops = _flash_work(q, k, True, tensors=4, flops_per_d=10)
    nbytes += lse.numel() * lse.element_size()
    by_bytes = _bound_ms(nbytes)
    by_ops = flops / BF16_FLOPS_PER_S * 1e3
    bound_ms = max(by_bytes, by_ops)
    lq, lk, lv = (t.requires_grad_() for t in _sdpa_inputs(q, k, v))
    lo = F.scaled_dot_product_attention(lq, lk, lv, is_causal=True)
    ldo = dout.reshape(B, K * G, S, d)
    library = lambda: torch.autograd.grad(lo, (lq, lk, lv), ldo,
                                          retain_graph=True)
    device_ms = _kernel_device_ms(fn, "flash_attention_bwd", per_call=2)
    row = {"name": "flash_attention_bwd", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
           "replaces": "none: the port's own kernel, the gradient of "
                       "src/repro/kernels/flash_attention.py:73's "
                       "function, which has no Pallas backward",
           "launches": launches, "launches_path": "training step",
           "max_abs_err": err, "ms": _time_ms(fn, reps=5),
           "kernel_device_ms": device_ms,
           "plain_ms": _time_ms(plain, reps=3),
           "library_ms": _time_ms(library, reps=5),
           "bound_ms": bound_ms,
           "bound_by": "bytes" if by_bytes >= by_ops else "operations",
           "bound_share": bound_ms / device_ms,
           "bound_bytes": nbytes, "bound_flops": flops,
           "shape": f"train {B}x{S}: q {tuple(q.shape)} k {tuple(k.shape)} "
                    f"bf16 causal"}
    _say_row(row, bound_by=row["bound_by"],
             bound_share=_fmt(row["bound_share"]),
             max_abs_err=f"{err:.3g}", shape=f"{B}x{S}",
             max_abs_err_dq_dk_dv=json.dumps([float(f"{e:.3g}")
                                              for e in errs]),
             limits=json.dumps([float(f"{x:.3g}") for x in limits]))
    if any(e > lim for e, lim in zip(errs, limits)):
        raise AssertionError(f"flash_attention_bwd {B}x{S}: errors {errs} "
                             f"against the plain backward (limits "
                             f"{limits})")
    if device_ms < bound_ms:
        raise AssertionError(f"flash_attention_bwd {B}x{S}: device "
                             f"{device_ms} ms below its bound {bound_ms}")
    return row


def _plain_attention():
    """Swaps the plain forward and backward in for the kernels inside
    ``flash_attention_train`` (its autograd function looks both up in
    the module at call time); returns the undo."""
    from repro_torch.kernels import flash_attention as fa
    saved = fa.flash_attention, fa.flash_attention_bwd
    fa.flash_attention = lambda q, k, v, causal=True, return_lse=False, \
        **kw: fa.flash_attention_plain(q, k, v, causal=causal,
                                       return_lse=return_lse)
    fa.flash_attention_bwd = fa.flash_attention_bwd_plain

    def undo():
        fa.flash_attention, fa.flash_attention_bwd = saved
    return undo


def _attn_grad_leaves(model, params, grads) -> dict:
    """Copies of the wq, wk and wv gradients of the first and last layer,
    by name, from ``loss_and_grads``' per-layer gradients."""
    from repro_torch.models.transformer import segments
    from repro_torch.train.train_step import split_layers
    from repro_torch.train.tree import tree_flatten, tree_unflatten
    _, treedef = tree_flatten(split_layers(model, params))
    layers = next(tree_unflatten(treedef, grads)[seg.name]
                  for seg in segments(model.cfg) if seg.scanned)
    return {f"layer{i}.{w}": layers[i]["attn"][w].detach().clone()
            for i in (0, len(layers) - 1) for w in ("wq", "wk", "wv")}


def _leaf_gaps(got: dict, want: dict) -> dict:
    """||got - want|| / ||want||, leaf by leaf."""
    return {n: float((got[n] - want[n]).norm() / want[n].norm())
            for n in want}


def train_full_width(device) -> dict:
    """Phase 11c: qwen3-4b at full width and depth, f32 master weights,
    bf16 compute, remat "minimal", 4 x 512 tokens a step from a token
    store pinned at its data epoch.  Returns the launches of one step."""
    import torch
    from repro_torch import configs
    from repro_torch.configs.base import RunConfig
    from repro_torch.data import TokenStore, token_corpus
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.train.optim import global_norm
    from repro_torch.train.train_step import (init_train_state,
                                              loss_and_grads,
                                              make_train_step)
    cfg = configs.get(LM_ARCH)
    model = build_model(cfg, tp=1, remat="minimal", device=device)
    t0 = time.perf_counter()
    state = init_train_state(model, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    store = TokenStore.create(n_nodes=4, device=device)
    epoch = store.ingest(token_corpus(32, TRAIN_SEQ + 1, cfg.vocab_size,
                                      seed=0))
    stream = store.batches(TRAIN_BATCH, TRAIN_SEQ, as_of=epoch, seed=0)
    batches = [{k: torch.as_tensor(x, device=device)
                for k, x in next(stream).items()}
               for _ in range(TRAIN_STEPS + 2)]
    st = store.storage_stats()
    _say("train", arch=cfg.name, params=model.n_params, remat=model.remat,
         batch=TRAIN_BATCH, seq=TRAIN_SEQ, init_s=f"{init_s:.2f}",
         corpus_tokens=st["rows"], data_epoch=epoch,
         compression=f"{st['ratio']:.2f}")

    # ---- one step's loss and grad norm, kernels then plain versions
    ops.reset_launch_counts()
    loss_k, grads = loss_and_grads(model, state["params"], batches[0])
    gnorm_k = float(global_norm(grads))
    leaves_k = _attn_grad_leaves(model, state["params"], grads)
    torch.cuda.synchronize()
    per_step = ops.launch_counts()
    del grads
    undo = _plain_attention()
    try:
        loss_p, grads = loss_and_grads(model, state["params"], batches[0])
        gnorm_p = float(global_norm(grads))
        leaves_p = _attn_grad_leaves(model, state["params"], grads)
    finally:
        undo()
    del grads
    loss_k, loss_p = float(loss_k), float(loss_p)
    gaps = _leaf_gaps(leaves_k, leaves_p)
    del leaves_k, leaves_p
    _say("check", train="kernels_vs_plain", loss_kernels=f"{loss_k:.6f}",
         loss_plain=f"{loss_p:.6f}", loss_tol=TRAIN_LOSS_TOL,
         grad_norm_kernels=f"{gnorm_k:.6f}",
         grad_norm_plain=f"{gnorm_p:.6f}", grad_norm_rtol=TRAIN_GNORM_RTOL,
         leaf_rel_gaps=json.dumps({n: float(f"{x:.3g}")
                                   for n, x in gaps.items()},
                                  separators=(",", ":")),
         leaf_rtol=TRAIN_LEAF_RTOL)
    if not (np.isfinite([loss_k, loss_p, gnorm_k, gnorm_p,
                         *gaps.values()]).all()
            and abs(loss_k - loss_p) <= TRAIN_LOSS_TOL
            and abs(gnorm_k - gnorm_p) <= TRAIN_GNORM_RTOL * gnorm_p
            and max(gaps.values()) <= TRAIN_LEAF_RTOL):
        raise AssertionError(f"training step, kernels vs plain: loss "
                             f"{loss_k} / {loss_p}, grad norm {gnorm_k} / "
                             f"{gnorm_p}, leaf gaps {gaps}")
    # remat "minimal": each layer's forward runs twice (the pass and the
    # recompute in the backward), its backward once (two launches)
    want = {"flash_attention": 2 * cfg.n_layers,
            "flash_attention_bwd": 2 * cfg.n_layers}
    got = {k: n for k, n in per_step.items() if n}
    if got != want:
        raise AssertionError(f"launches of one training step {got}, "
                             f"expected {want}")

    # ---- AdamW steps
    rc = RunConfig(total_steps=100, warmup_steps=2)
    step = make_train_step(model, rc)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(TRAIN_STEPS):
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        state, met = step(state, batches[i])
        loss = float(met["loss"])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        got = {k: n for k, n in ops.launch_counts().items() if n}
        _say("train", step=i + 1, loss=f"{loss:.6f}",
             grad_norm=f"{float(met['grad_norm']):.6f}",
             lr=f"{float(met['lr']):.3e}", step_ms=f"{times[-1] * 1e3:.3f}",
             tok_per_s=f"{TRAIN_BATCH * TRAIN_SEQ / times[-1]:.1f}",
             launches=json.dumps(got, separators=(",", ":")))
        if not np.isfinite(loss) or got != want:
            raise AssertionError(f"training step {i + 1}: loss {loss}, "
                                 f"launches {got} (expected {want})")
    peak = torch.cuda.max_memory_allocated()
    # ---- one profiled step (after an untraced one): its device kernels
    # against the steady steps' host time
    it = iter(batches[TRAIN_STEPS:])

    def one():
        nonlocal state
        state, _ = step(state, next(it))
    kern = {}
    for e in _device_events(_traced(one, 1)):
        kern[e.name] = kern.get(e.name, 0.0) + e.time_range.elapsed_us()
    dev_ms = sum(kern.values()) / 1e3
    host_ms = float(np.median(times[1:])) * 1e3
    flash_ms = sum(v for k, v in kern.items()
                   if "flash_attention" in k) / 1e3
    bwd_ms = sum(v for k, v in kern.items()
                 if "flash_attention_bwd" in k) / 1e3
    top = sorted(kern, key=kern.get, reverse=True)[:6]
    _say("train", summary=cfg.name, steps=TRAIN_STEPS,
         step_ms_median=f"{host_ms:.3f}",
         step_ms_all=json.dumps([round(t * 1e3, 3) for t in times]),
         tok_per_s=f"{TRAIN_BATCH * TRAIN_SEQ / host_ms * 1e3:.1f}",
         max_memory_allocated_gib=f"{peak / 2**30:.3f}",
         profiled_kernel_ms=f"{dev_ms:.3f}",
         busy_share=f"{dev_ms / host_ms:.4f}",
         flash_kernel_ms=f"{flash_ms:.3f}",
         flash_bwd_kernel_ms=f"{bwd_ms:.3f}",
         flash_bwd_share=f"{bwd_ms / dev_ms:.4f}", kernels=len(kern),
         top=json.dumps({k.replace(" ", "_")[:72]: round(kern[k] / 1e3, 3)
                         for k in top}, separators=(",", ":")))
    _say("launches", path="train", **want)
    return want


def driver_replay(device) -> None:
    """Phase 11d: ``python -m repro_torch.launch.train`` on the card at a
    small config, straight through and with ``--fail-at-step`` (node 1
    lost: buddy restore from the last good epoch, then replay); the two
    final checkpoints must hold the same state bit for bit."""
    import shutil
    import tempfile
    root = os.path.join(REPO, "results")
    os.makedirs(root, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="train_replay_", dir=root)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               CUBLAS_WORKSPACE_CONFIG=":4096:8")
    finals = {}
    try:
        for label, extra in (("straight", ()), ("failed", (
                "--fail-at-step", str(DRIVER_FAIL_AT)))):
            ck = os.path.join(tmp, label)
            t0 = time.perf_counter()
            out = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.train",
                 *DRIVER_ARGS, "--device", str(device), "--ckpt-dir", ck,
                 *extra], cwd=REPO, env=env, capture_output=True, text=True,
                timeout=600)
            if out.returncode != 0:
                raise AssertionError(f"driver ({label}) exit "
                                     f"{out.returncode}:\n{out.stdout}\n"
                                     f"{out.stderr[-4000:]}")
            lines = [ln for ln in out.stdout.splitlines()
                     if ln.startswith("[train]")]
            for ln in lines:
                print(f"[driver] {label}: {ln[8:]}", flush=True)
            if _is_cuda(device) and "flash_attention_bwd" not in lines[-1]:
                raise AssertionError(f"driver ({label}) launched no "
                                     f"backward kernel: {lines[-1]}")
            (cfg_dir,) = os.listdir(ck)
            steps = int(DRIVER_ARGS[DRIVER_ARGS.index("--steps") + 1])
            epoch = os.path.join(ck, cfg_dir, f"epoch_{steps:08d}")
            finals[label] = {s: dict(np.load(os.path.join(
                epoch, f"node_{s}", f"primary_shard_{s}", "state.npz")))
                for s in range(4)}
            _say("driver", run=label,
                 seconds=f"{time.perf_counter() - t0:.1f}")
        a, b = finals["straight"], finals["failed"]
        n = 0
        for s in a:
            if sorted(a[s]) != sorted(b[s]):
                raise AssertionError(f"shard {s}: leaves differ")
            for key in a[s]:
                n += 1
                if not np.array_equal(a[s][key], b[s][key]):
                    raise AssertionError(
                        f"replayed run differs from the straight run: "
                        f"shard {s} {key}")
        _say("check", driver="fail_at_step_replay", fail_at=DRIVER_FAIL_AT,
             leaves_compared=n, bit_identical=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def train_phase(device):
    """Phase 11: training.  Returns the flash_attention_bwd JSON rows."""
    import torch
    flash_bwd_checks(device)
    per_step = train_full_width(device)
    gc.collect()
    torch.cuda.empty_cache()
    rows = [flash_bwd_row(shape, per_step["flash_attention_bwd"], device)
            for shape in ((LM_SERVE[0], LM_SERVE[1]),
                          (LM_LONG[0], LM_LONG[1]))]
    gc.collect()
    torch.cuda.empty_cache()
    driver_replay(device)
    return rows


def _host_ms(fn, reps: int = 3) -> float:
    """Host milliseconds per call, synchronised, after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


# ----------------------------------------------------------------- main --

def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(REPO, "src"))
    from repro_torch.data import star_schema
    from repro_torch.kernels import build, ops

    device = "cuda"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    _say("card", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    secs = build.build_all()
    _say("build", kernels=",".join(build.SOURCES), seconds=f"{secs:.2f}",
         arch="sm_90a")

    t0 = time.perf_counter()
    fact, dim = star_schema(N_FACT, N_DIM, seed=0)
    db = build_db(fact, dim, device)
    encs = {c: db.nodes[0].stores["lineitem_super"].containers[0]
            .columns[c].encoding.value
            for c in ("l_orderkey", "l_suppkey", "l_shipdate", "l_qty",
                      "l_extprice")}
    oenc = {c: db.nodes[0].stores["orders_super"].containers[0]
            .columns[c].encoding.value
            for c in ("o_orderkey", "o_custkey", "o_orderdate")}
    _say("load", lineitem=N_FACT, orders=N_DIM,
         seconds=f"{time.perf_counter() - t0:.1f}",
         lineitem_encodings=json.dumps(encs, separators=(",", ":")),
         orders_encodings=json.dumps(oenc, separators=(",", ":")))

    decode_checks(db, device)
    segment_checks(device)
    rows = kernel_checks(db, device)
    seg_preagg_case_checks(device)
    rle_case_checks(device)

    with SegCapture() as capture:
        ops.reset_launch_counts()
        warm = run_main_path(db, fact, dim, device, capture)
        launches = ops.launch_counts()
    _say("launches", path="main", **{k: launches[k] for k in MAIN_KERNELS})
    missing = [k for k in MAIN_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"main path never launched: {missing}")
    for row in rows:
        row["launches"] = launches[row["name"]]
    rows[1:1] = seg_preagg_rows(capture, launches["seg_preagg"], device)
    profile_queries(db, warm)

    api_rows = kernel_api_phase(db, fact, dim, capture, device)
    for row in api_rows:
        if row["name"] == "onehot_groupby":
            seg = next(r for r in rows if r["name"] == "seg_preagg"
                       and r["shape"].startswith(row["query"] + ":"))
            # count and sum partials plus their combine, against
            # seg_preagg's one table of count, sum, min and max
            dev = (None if None in (row["kernel_device_ms"],
                                    row["combine_device_ms"])
                   else row["kernel_device_ms"] + row["combine_device_ms"])
            _say("compare", query=row["query"],
                 onehot_plus_combine_device_ms=_fmt(dev),
                 seg_preagg_device_ms=_fmt(seg["kernel_device_ms"]),
                 onehot_plus_combine_ms=f"{row['ms'] + row['combine_ms']:.4f}",
                 seg_preagg_ms=f"{seg['ms']:.4f}",
                 index_add_ms=f"{seg['library_ms']:.4f}")
    rows += api_rows

    rows += serving_phase(db, fact, dim, device)
    rows += compressed_phase(db, fact, dim, device)
    fact = run_trickle(db, fact, dim, device)
    rows += segmented_phase(db, fact, dim, device)
    torch.cuda.synchronize()
    del db, capture                      # the LM phase needs the memory
    gc.collect()
    torch.cuda.empty_cache()
    rows += lm_phase(device)
    torch.cuda.synchronize()
    gc.collect()                         # phase 8's bf16 model goes first
    torch.cuda.empty_cache()
    rows += train_phase(device)
    torch.cuda.synchronize()

    print(smi, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
