#!/usr/bin/env python3
"""Planted faults in the flash_attention kernel against chip_smoke's check.

    python3 scripts/torch_flash_faults.py        # from anywhere, one GPU

For each case of ``FAULTS``, ``src/repro_torch`` and ``chip_smoke.py`` are
copied into a temporary directory, the fault is written into the copy's
``kernels/csrc/flash_attention.cu`` (into the bf16 tensor-core kernel,
``flash_attention_kernel_sm90``), and a child process run in the copy
builds qwen3-4b at full width from seed 0, captures every layer's kernel
inputs in a prefill at each of chip_smoke's two shapes (4 x 512 and
1 x 4096), and counts the layers whose kernel output fails
``chip_smoke._flash_check`` (the check chip_smoke holds every layer to)
and those that fail tests/test_kernels.py's allclose (atol = rtol = 2e-2).
One ``[fault]`` line per case and shape.  The first case plants nothing.
The repository itself is never written.  Exits 1 unless the clean kernel
passes the check on every layer and each fault fails it on some layer.
"""
from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EDGE = "const bool edge = "
MASK = "(!a.causal || key <= row)"
# name -> [(text in csrc/flash_attention.cu, its replacement), ...]
FAULTS = {
    "none": [],
    # keys 256..287 never reach any row: only rows from 288 on lose keys
    "drop_keys_256_287": [(EDGE, EDGE + "k0 == 256 || "),
                          (MASK, MASK + " && (key < 256 || key >= 288)")],
    # rows from 256 on also see the key after them
    "late_diag_offby1": [(MASK, "(!a.causal || key <= row + (row >= 256))")],
    # P.V from a single bf16 P: P_lo dropped
    "drop_p_lo": [("lo[f] = __byte_perm(", "lo[f] = 0u * __byte_perm(")],
}


def child(name: str) -> int:
    """In the copy: prefill both shapes, check every captured layer."""
    here = os.getcwd()
    sys.path[:0] = [here, os.path.join(here, "src")]
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models import build_model

    cfg = configs.get(cs.LM_ARCH)
    model = build_model(cfg, tp=1, device="cuda")
    params = model.init_params(seed=0)
    rng = np.random.default_rng(0)
    caught = 0
    for B, S, n_new in (cs.LM_SERVE, cs.LM_LONG):
        tok = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                              dtype=torch.int32, device="cuda")
        with cs.FlashCapture() as cap:
            model.prefill(params, {"tokens": tok}, max_len=S + n_new)
        calls = [c for per in cap.calls.values() for c in per]
        fails = allclose_fails = 0
        worst = 0.0
        for q, k, v, causal in calls:
            got = ops.flash_attention(q, k, v, causal=causal)
            want = ops.flash_attention_plain(q, k, v, causal=causal)
            g, w = got.float(), want.float()
            err = (g - w).abs()
            worst = max(worst, float(err.max()))
            allclose_fails += bool((err > 2e-2 + 2e-2 * w.abs()).any())
            try:
                cs._flash_check(got, want, "bfloat16")
            except AssertionError:
                fails += 1
        caught += fails
        print(f"[fault] case={name} prefill={B}x{S} layers={len(calls)} "
              f"check_fails={fails} allclose_fails={allclose_fails} "
              f"max_abs_err={worst:.4g}", flush=True)
        del cap, calls
    return int((caught > 0) != (name != "none"))


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--child":
        return child(sys.argv[2])
    bad = 0
    for name, edit in FAULTS.items():
        tmp = tempfile.mkdtemp(prefix="flash_fault_")
        try:
            shutil.copytree(os.path.join(REPO, "src", "repro_torch"),
                            os.path.join(tmp, "src", "repro_torch"),
                            ignore=shutil.ignore_patterns("build",
                                                          "__pycache__"))
            shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp)
            cu = os.path.join(tmp, "src", "repro_torch", "kernels", "csrc",
                              "flash_attention.cu")
            with open(cu) as f:
                src = f.read()
            for anchor, planted in edit:
                if src.count(anchor) != 1:
                    raise RuntimeError(f"{name}: the kernel source changed; "
                                       f"the fault's anchor is gone")
                src = src.replace(anchor, planted)
            with open(cu, "w") as f:
                f.write(src)
            rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                                 "--child", name], cwd=tmp).returncode
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        if rc:
            print(f"[fault] case={name} verdict="
                  f"{'flagged' if name == 'none' else 'missed'}", flush=True)
            bad += 1
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
