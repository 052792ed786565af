#!/usr/bin/env python3
"""Time one tree's ``seg_preagg`` and ``rle_grouped_agg`` wrappers on fixed
inputs shaped like the main path's.

    python3 scripts/torch_groupby_ab.py [--root TREE] [--tag NAME]

``--root`` is the checkout whose ``src/repro_torch`` runs (this one by
default), so two versions compare on one card by running the script
against each in turn, in the order A B B A.  Inputs come from numpy's
seed 0: ``seg_preagg`` at the row counts, domains, valid shares and
aggregates of chip_smoke's Q2, Q3, Q6, Qorders, Q5 and Q7 calls (keys
sorted where the main path's are: l_suppkey within a day), and
``rle_grouped_agg`` over 12 segments of (123, 4) runs at domain 365, one
segment alone and all twelve (one call where the tree has the list form,
else one call per segment).  Prints one JSON line: per shape, the event
ms per call over 50 calls, the device ms of the kernels whose names hold
the wrapper's name, and the device ms of every kernel of the call (the
output fills or the init kernel included), both from torch.profiler; and
``index_add_``'s event ms at domain 365 as the host's yardstick.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(os.path.abspath(args.root), "src"))
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import build, ops

    def event_ms(fn, reps=50, warmup=5):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps

    def device_ms(fn, name=None, reps=20):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        return sum(getattr(e, "self_device_time_total", 0)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and (name is None or name in e.key)) / 1e3 / reps

    def measure(fn, name):
        return [round(event_ms(fn), 5), round(device_ms(fn, name), 5),
                round(device_ms(fn), 5)]

    build.build_all(("seg_preagg", "rle_grouped_agg"))
    rng = np.random.default_rng(0)
    dev = "cuda"
    out = {"tag": args.tag, "card": torch.cuda.get_device_name(0),
           "columns": ["event_ms", "kernel_device_ms", "call_device_ms"]}
    for name, n, domain, is_sorted, p_valid, aggs in (
            ("Q2", 49_152, 100, True, 0.33, (("c", "*", "count"),)),
            ("Q3", 1_036_288, 100, True, 0.94, (("s", "v", "sum"),)),
            ("Q6", 1_118_208, 100, True, 0.94, (("a", "f", "avg"),)),
            ("Qorders", 753_664, 365, False, 0.995,
             (("n", "*", "count"), ("s", "v", "sum"))),
            ("Q5", 6_033_408, 150_000, False, 0.16, (("s", "f", "sum"),)),
            ("Q7", 6_000_640, 150_000, False, 0.1, (("c", "*", "count"),))):
        keys = rng.integers(0, domain, n).astype(np.int32)
        if is_sorted:
            keys = np.sort(keys)
        valid = torch.as_tensor(rng.random(n) < p_valid, device=dev)
        keys = torch.as_tensor(keys, device=dev)
        vals = {"v": torch.as_tensor(rng.integers(0, 50, n)
                                     .astype(np.int32), device=dev),
                "f": torch.as_tensor(rng.uniform(0, 1e3, n)
                                     .astype(np.float32), device=dev)}
        out[name] = measure(lambda: ops.seg_preagg(keys, valid, vals, domain,
                                                   aggs), "seg_preagg")
    segs = []
    for _ in range(12):
        rv = np.sort(rng.integers(0, 365, 492)).astype(np.int32)
        rl = rng.integers(1, 400, 492).astype(np.int32)
        segs.append((torch.as_tensor(rv.reshape(123, 4), device=dev),
                     torch.as_tensor(rl.reshape(123, 4), device=dev)))
    out["rle_one"] = measure(lambda: ops.rle_grouped_agg(*segs[0],
                                                         domain=365),
                             "rle_grouped_agg")
    if hasattr(ops, "rle_grouped_agg_many"):
        whole = lambda: ops.rle_grouped_agg_many(segs, domain=365)
    else:
        whole = lambda: [ops.rle_grouped_agg(*s, domain=365) for s in segs]
    out["rle_whole"] = measure(whole, "rle_grouped_agg")
    k = torch.zeros(365, dtype=torch.long, device=dev)
    v = torch.ones(365, dtype=torch.int32, device=dev)
    out["index_add_365_event_ms"] = round(event_ms(lambda: torch.zeros(
        365, dtype=torch.int32, device=dev).index_add_(0, k, v)), 5)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
