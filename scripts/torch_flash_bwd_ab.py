#!/usr/bin/env python3
"""Device times of the flash kernels, forward and backward, on the card.

    python3 scripts/torch_flash_bwd_ab.py [--root TREE] [--tag NAME]

``--root`` is the checkout whose ``src/repro_torch`` runs (this one by
default), so two versions compare on one card by running the script
against each in turn, in the order A B B A.  On qwen3-4b's training
views (8 kv heads of 4 query heads, head dim 128, bf16, causal, inputs
from a seeded generator) at 4 x 512 and 1 x 4096 it prints one JSON line:
per shape the forward's device ms without lse (the prefill's call), the
backward's device ms in all and per kernel name, and its CUDA-event ms.
Device ms are the kernels' summed durations in a torch.profiler trace of
20 calls, over 20 (chip_smoke.py's ``_device_events``, whose padding
keeps a trace from losing kernel records).  A tree whose backward takes
no lse (before the forward saved it) is called without one.
"""
from __future__ import annotations

import argparse
import inspect
import json
import os
import re
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = ((4, 512), (1, 4096))
REPS = 20


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(os.path.abspath(args.root), "src"))
    sys.path.insert(1, REPO)
    import torch
    if not torch.cuda.is_available():
        print("torch_flash_bwd_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.kernels import ops

    def device_ms(fn):
        by_name = {}
        for e in chip_smoke._device_events(chip_smoke._traced(fn, REPS)):
            m = re.search(r"flash_attention\w*(<\d+>)?", e.name)
            name = m.group(0) if m else \
                e.name.replace("void ", "").split("(")[0][:60]
            by_name[name] = by_name.get(name, 0.0) \
                + e.time_range.elapsed_us() / 1e3 / REPS
        return by_name

    takes_lse = "lse" in inspect.signature(ops.flash_attention_bwd).parameters
    out = {"tag": args.tag, "root": args.root,
           "card": torch.cuda.get_device_name(0)}
    g = torch.Generator(device="cuda").manual_seed(12)
    for B, S in SHAPES:
        q, k, v = chip_smoke._model_views(B, S, 8, 4, 128, torch.bfloat16, g,
                                          "cuda")
        if takes_lse:
            o, lse = ops.flash_attention(q, k, v, return_lse=True)
            extra = (lse,)
        else:
            o, extra = ops.flash_attention(q, k, v), ()
        dout = torch.randn(o.shape, generator=g, device="cuda").to(
            torch.bfloat16)
        fwd = device_ms(lambda: ops.flash_attention(q, k, v))
        bwd_fn = lambda: ops.flash_attention_bwd(q, k, v, o, dout, *extra)
        bwd = device_ms(bwd_fn)
        out[f"{B}x{S}"] = {
            "fwd_device_ms": sum(fwd.values()),
            "bwd_device_ms": sum(bwd.values()),
            "bwd_by_kernel": bwd,
            "bwd_event_ms": chip_smoke._time_ms(bwd_fn, reps=REPS)}
        del q, k, v, o, dout, extra
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
