#!/usr/bin/env python3
"""Time one tree's group-by and probe wrappers on fixed inputs shaped like
the main path's and phase 5's.

    python3 scripts/torch_groupby_ab.py [--root TREE] [--tag NAME]
        [--kernels seg_preagg,rle,filter,onehot,semijoin]

``--root`` is the checkout whose ``src/repro_torch`` runs (this one by
default), so two versions compare on one card by running the script
against each in turn, in the order A B B A.  Inputs come from numpy's
seed 0:

* ``seg_preagg`` at the row counts, domains, valid shares and aggregates
  of chip_smoke's Q2, Q3, Q6, Qorders, Q5 and Q7 calls (keys sorted where
  the main path's are: l_suppkey within a day; Q7 with random valid rows,
  and "Q7-clustered" with the main path's: l_suppkey < 10 in containers
  sorted on (l_shipdate, l_suppkey)), and of phase 10's shared
  Q4 (the unpruned scan: l_shipdate sorted within each of 12 containers,
  every row valid, domain 65,536, the global route), and of phase 9's
  segmented Q7 ("seg-Q7": 4 shards' rows in one call, keys
  ``shard * 150,000 + o_custkey``, about 20 % of the rows valid in runs
  as Q7-clustered's, an approximation of the pruned slabs);
* ``rle_grouped_agg`` over 12 segments of (123, 4) runs at domain 365, one
  segment alone and all twelve (one call where the tree has the list
  form, else one call per segment), and ``rle_filter_agg`` over the same
  runs in [61, 119] the same two ways;
* ``onehot_groupby`` at phase 5's Q3 (253 x 4096, domain 100, 12
  containers' l_suppkey each sorted within a day, rows outside the dates
  keyed -1, int values) and
  Qorders (184 x 4096, domain 365, random o_orderdate, the tail keyed -1,
  int values), beside ``index_add_`` of the same partials;
* ``semijoin_probe`` of 123 x 4096 uniform l_orderkeys against 4,119
  ascending orderkeys of 1,500,000 (phase 5's build side: the orders
  dated 0), as phase 5 cuts them: a chunk of 4,096 and one of 23, beside
  ``torch.isin`` on the padded chunk.

Prints one JSON line: per shape, the event
ms per call over 50 calls, the device ms of the kernels whose names hold
the wrapper's kernel name and of every kernel of the call (from
chip_smoke's padded torch.profiler traces, which fail unless they hold
every launched kernel), and the host us per call to enqueue 1,000 calls
without a synchronise (the least of three runs); the library call's
event and device ms beside.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUPS = ("seg_preagg", "rle", "filter", "onehot", "semijoin")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--tag", default="")
    ap.add_argument("--kernels", default=",".join(GROUPS))
    args = ap.parse_args()
    groups = args.kernels.split(",")
    sys.path.insert(0, os.path.join(os.path.abspath(args.root), "src"))
    sys.path.insert(1, REPO)
    import numpy as np
    import torch

    import chip_smoke as cs          # this checkout's timing helpers
    from repro_torch.kernels import build, ops

    def measure(fn, kernel):
        return {"event_ms": cs._time_ms(fn, reps=50, warmup=5),
                "kernel_device_ms": cs._kernel_device_ms(fn, kernel),
                "call_device_ms": cs._kernel_device_ms(fn, ""),
                "host_us": cs._host_us(fn)}

    def library(fn):
        return {"library_event_ms": cs._time_ms(fn, reps=50, warmup=5),
                "library_device_ms": cs._kernel_device_ms(fn, "")}

    build.build_all(("seg_preagg", "rle_grouped_agg", "rle_filter_agg",
                     "onehot_groupby", "semijoin_probe"))
    rng = np.random.default_rng(0)
    dev = "cuda"
    out = {"tag": args.tag, "root": os.path.abspath(args.root),
           "card": torch.cuda.get_device_name(0)}
    for name, n, domain, is_sorted, p_valid, aggs in (
            ("Q2", 49_152, 100, True, 0.33, (("c", "*", "count"),)),
            ("Q3", 1_036_288, 100, True, 0.94, (("s", "v", "sum"),)),
            ("Q6", 1_118_208, 100, True, 0.94, (("a", "f", "avg"),)),
            ("Qorders", 753_664, 365, False, 0.995,
             (("n", "*", "count"), ("s", "v", "sum"))),
            ("Q5", 6_033_408, 150_000, False, 0.16, (("s", "f", "sum"),)),
            ("Q7", 6_000_640, 150_000, False, 0.1, (("c", "*", "count"),)),
            ("Q7-clustered", 6_000_640, 150_000, False, "suppkey",
             (("c", "*", "count"),)),
            ("serve-Q4", 6_033_408, 65_536, "containers", 1.0,
             (("c", "*", "count"),)),
            ("seg-Q7", 2_920_448, 600_000, "shards", "suppkey-20",
             (("c", "*", "count"),))):
        keys = rng.integers(0, domain, n).astype(np.int32)
        if is_sorted == "shards":         # shard * 150,000 + o_custkey
            keys = (np.arange(n) // (n // 4) * (domain // 4)
                    + rng.integers(0, domain // 4, n)).astype(np.int32)
        elif is_sorted == "containers":   # l_shipdate, sorted in each of
            keys = np.concatenate([np.sort(p) for p in np.array_split(
                rng.integers(0, 365, n), 12)]).astype(np.int32)
        elif is_sorted:
            keys = np.sort(keys)
        if str(p_valid).startswith("suppkey"):  # Q7's l_suppkey < 10
            below = int(p_valid[8:] or 10)        # (or < 20), in 12
            ok = []                       # containers sorted on
            for part in np.array_split(np.arange(n), 12):  # (day, supp)
                day = rng.integers(0, 365, len(part))
                supp = rng.integers(0, 100, len(part))
                ok.append(supp[np.lexsort((supp, day))] < below)
            valid = torch.as_tensor(np.concatenate(ok), device=dev)
        else:
            valid = torch.as_tensor(rng.random(n) < p_valid, device=dev)
        keys = torch.as_tensor(keys, device=dev)
        vals = {"v": torch.as_tensor(rng.integers(0, 50, n)
                                     .astype(np.int32), device=dev),
                "f": torch.as_tensor(rng.uniform(0, 1e3, n)
                                     .astype(np.float32), device=dev)}
        if "seg_preagg" in groups:
            out[name] = measure(lambda: ops.seg_preagg(
                keys, valid, vals, domain, aggs), "seg_preagg")
    segs = []
    for _ in range(12):
        rv = np.sort(rng.integers(0, 365, 492)).astype(np.int32)
        rl = rng.integers(1, 400, 492).astype(np.int32)
        segs.append((torch.as_tensor(rv.reshape(123, 4), device=dev),
                     torch.as_tensor(rl.reshape(123, 4), device=dev)))
    if "rle" in groups:
        out["rle_one"] = measure(
            lambda: ops.rle_grouped_agg(*segs[0], domain=365),
            "rle_grouped_agg")
        if hasattr(ops, "rle_grouped_agg_many"):
            whole = lambda: ops.rle_grouped_agg_many(segs, domain=365)
        else:
            whole = lambda: [ops.rle_grouped_agg(*s, domain=365)
                             for s in segs]
        out["rle_whole"] = measure(whole, "rle_grouped_agg")
        k = torch.zeros(365, dtype=torch.long, device=dev)
        v = torch.ones(365, dtype=torch.int32, device=dev)
        out["index_add_365_event_ms"] = cs._time_ms(lambda: torch.zeros(
            365, dtype=torch.int32, device=dev).index_add_(0, k, v),
            reps=50, warmup=5)
    if "filter" in groups:
        out["filter_one"] = measure(
            lambda: ops.rle_filter_agg(*segs[0], lo=61.0, hi=119.0),
            "rle_filter_agg")
        if hasattr(ops, "rle_filter_agg_many"):
            whole = lambda: ops.rle_filter_agg_many(segs, lo=61.0, hi=119.0)
        else:
            whole = lambda: [ops.rle_filter_agg(*s, lo=61.0, hi=119.0)
                             for s in segs]
        out["filter_whole"] = measure(whole, "rle_filter_agg")

    # ---- onehot_groupby at phase 5's shapes
    # Q3: the scan of 12 containers, each sorted on (l_shipdate,
    # l_suppkey), so runs of a key within a day are ~14 rows long
    parts = []
    for part in np.array_split(np.arange(253 * 4096), 12):
        day = np.sort(rng.integers(0, 63, len(part)))
        supp = rng.integers(0, 100, len(part))
        keys = supp[np.lexsort((supp, day))]
        keys[(day < 2) | (day > 60)] = -1     # outside Q3's dates
        parts.append(keys)
    q3 = np.concatenate(parts)
    qo = np.full(184 * 4096, -1)
    qo[:750_000] = rng.integers(0, 365, 750_000)
    prepass = {"Q3": (q3.reshape(253, 4096), 100,
                      rng.integers(1, 50, (253, 4096))),
               "Qorders": (qo.reshape(184, 4096), 365,
                           rng.integers(0, 150_000, (184, 4096)))}
    for q, (keys, domain, vals) in prepass.items():
        if "onehot" not in groups:
            break
        k2 = torch.as_tensor(keys.astype(np.int32), device=dev)
        v2 = torch.as_tensor(vals.astype(np.int32), device=dev)
        nb = k2.shape[0]
        ok = (k2 >= 0) & (k2 < domain)
        flat = (torch.arange(nb, device=dev)[:, None] * domain
                + torch.where(ok, k2, 0).long()).reshape(-1)
        w = torch.stack([ok.float(), torch.where(ok, v2.float(), 0.0)],
                        dim=-1).reshape(-1, 2)
        row = measure(lambda: ops.onehot_groupby(k2, v2, domain=domain),
                      "onehot_groupby_kernel")
        row.update(library(lambda: torch.zeros(nb * domain, 2, device=dev)
                           .index_add_(0, flat, w)))
        out[f"onehot_{q}"] = row

    # ---- semijoin_probe at phase 5's shape
    if "semijoin" in groups:
        # the 4,119 orderkeys of phase 5's build side (o_orderdate 0)
        orderkeys = np.sort(rng.choice(1_500_000, 4119, replace=False))
        probe = torch.as_tensor(rng.integers(0, 1_500_000, (123, 4096))
                                .astype(np.int32), device=dev)
        for label, chunk in (("4096", orderkeys[:4096]),
                             ("rest", orderkeys[4096:])):
            ch = torch.as_tensor(chunk.astype(np.int32), device=dev)
            padded = torch.cat([ch, ch.new_full(((-ch.numel()) % 128,), -1)])
            row = measure(lambda: ops.semijoin_probe(probe, ch),
                          "semijoin_probe")
            row["build"] = int(ch.numel())
            row.update(library(lambda: torch.isin(probe, padded)))
            out[f"semijoin_{label}"] = row
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
