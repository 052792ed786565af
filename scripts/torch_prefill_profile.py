#!/usr/bin/env python3
"""Time and profile a qwen3-4b prefill of 4 x 512 tokens on the card.

    python3 scripts/torch_prefill_profile.py [--root TREE] [--tag NAME]

``--root`` is the checkout whose ``src/repro_torch`` runs (this one by
default), so two versions compare on one card by running the script
against each in turn, in the order A B B A.  The model is built at full
width in bf16 from seed 0 (as chip_smoke's LM phase builds it), the
prompt ids come from numpy's seed 0, and after 3 warm-up prefills it
prints one JSON line: the mean of 10 prefills by CUDA events and by the
host clock, then, from one prefill under torch.profiler, the device
kernels' total ms, the ``flash_attention`` kernel's ms, the elementwise
and copy kernels' ms, and the number of kernel launches.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

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

    from repro_torch import configs
    from repro_torch.models import build_model

    if not torch.cuda.is_available():
        print("torch_prefill_profile: no CUDA device", file=sys.stderr)
        return 2
    cfg = configs.get("qwen3-4b")
    model = build_model(cfg, tp=1, device="cuda")
    params = model.init_params(seed=0)
    B, S = 4, 512
    tok = torch.as_tensor(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S)),
        dtype=torch.int32, device="cuda")

    def prefill():
        return model.prefill(params, {"tokens": tok}, max_len=S + 32)

    for _ in range(3):
        prefill()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(10):
        prefill()
    stop.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / 10
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prefill()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total]
    ms = {e.key: e.self_device_time_total / 1e3 for e in kernels}
    print(json.dumps({
        "tag": args.tag, "root": args.root,
        "card": torch.cuda.get_device_name(0),
        "prefill_event_ms": start.elapsed_time(stop) / 10,
        "prefill_host_ms": host_ms,
        "kernel_ms": sum(ms.values()),
        "flash_ms": sum(v for k, v in ms.items()
                        if "flash_attention_kernel" in k),
        "elementwise_copy_ms": sum(v for k, v in ms.items()
                                   if "elementwise" in k or "opy" in k),
        "kernel_launches": sum(e.count for e in kernels)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
