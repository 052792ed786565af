#!/usr/bin/env python3
"""Planted faults in the group-by and probe kernels against chip_smoke's
checks.

    python3 scripts/torch_groupby_faults.py [CASE ...]   # one GPU

For each case of ``FAULTS`` (all of them, or those named), ``src/repro_torch``
and ``chip_smoke.py`` are copied into a temporary directory, the fault is
written into the copy's ``kernels/csrc/<source>``, and a child process run
in the copy builds the kernels and runs chip_smoke's checks of them, on a
database of a quarter of SF1 (1,500,000 lineitem and 375,000 orders rows):
phase 3's ``kernel_checks`` (the one-container and the whole-scan
``rle_grouped_agg`` rows), ``seg_preagg_case_checks`` and
``rle_case_checks``; phase 4's main path (every query against its numpy
oracle) followed by ``seg_preagg_rows`` (the kernel against its plain
version on every main-path input); phase 5's ``kernel_api_phase`` over
that main path's inputs (``np.isin``, the plain versions, ``seg_preagg``'s
counts and sums), which ends with ``api_case_checks`` (the edge cases of
``semijoin_probe`` and ``onehot_groupby``).  One ``[fault]`` line per case
and check.  The first case plants nothing.  The repository itself is
never written.  Exits 1 unless the clean kernels pass every check and
each fault fails at least one.
"""
from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLUSH = "  // fold the replicas; flush the keys this CTA touched"
# name -> (source in kernels/csrc, [(text, its replacement), ...])
FAULTS = {
    "none": ("seg_preagg.cu", []),
    # the second CTA of the shared route never flushes its table
    "drop_cta_flush": ("seg_preagg.cu",
                       [(FLUSH, "  if (blockIdx.x == 1) return;\n" + FLUSH)]),
    # the last replica of each shared table is left out of the fold
    "skip_replica_fold": ("seg_preagg.cu",
                          [("for (int r = 1; r < R; ++r) acc",
                            "for (int r = 1; r < R - 1; ++r) acc")]),
    # min starts from 0 instead of its sentinel (+inf, int32 max)
    "min_init_zero": ("seg_preagg.cu",
                      [("kind == AGG_MIN ? 0x7f800000", "kind == AGG_MIN ? 0"),
                       ("kind == AGG_MIN ? INT_MAX", "kind == AGG_MIN ? 0")]),
    # each call leaves its last run segment out
    "drop_last_segment": ("rle_grouped_agg.cu",
                          [("const long long total = segs.start[n_segs];",
                            "const long long total = "
                            "segs.start[n_segs > 1 ? n_segs - 1 : n_segs];")]),
    # the probe gives up when the next slot is empty, before it has
    # compared the current one: a key at the end of its chain is missed
    "probe_stops_one_slot_early": (
        "semijoin_probe.cu",
        [("    if (v == key) return true;\n    if (v == kEmpty) return false;",
          "    if (t.slots[(s + 1) & kMask] == kEmpty) return false;\n"
          "    if (v == key) return true;")]),
    # a build key equal to the empty marker never sets the flag
    "drop_empty_marker_flag": ("semijoin_probe.cu",
                               [("    t.has_empty = 1;\n", "")]),
    # each chunk's last run is never added to the table
    "fold_loses_last_run": ("onehot_groupby.cu",
                            [("    if (run_n > 0) {", "    if (false) {")]),
    # the count is read from the sum's table at write-out
    "count_from_sum_table": ("onehot_groupby.cu",
                             [("make_float2((float)cnt[j], sum[j])",
                               "make_float2(sum[j], sum[j])")]),
}
N_FACT, N_DIM = 1_500_000, 375_000


def child(name: str) -> int:
    """In the copy: run each check, count the ones that fail."""
    here = os.getcwd()
    sys.path[:0] = [here, os.path.join(here, "src")]
    import chip_smoke as cs
    from repro_torch.data import star_schema
    from repro_torch.kernels import build, ops

    build.build_all(("seg_preagg", "rle_grouped_agg", "bitunpack",
                     "rle_filter_agg", "delta_decode", "onehot_groupby",
                     "semijoin_probe"))
    cs.N_FACT, cs.N_DIM = N_FACT, N_DIM
    fact, dim = star_schema(N_FACT, N_DIM, seed=0)
    db = cs.build_db(fact, dim, "cuda")

    captured = []

    def main_path():
        with cs.SegCapture() as capture:
            ops.reset_launch_counts()
            cs.run_main_path(db, fact, dim, "cuda", capture)
            launched = ops.launch_counts()["seg_preagg"]
        captured.append(capture)
        cs.seg_preagg_rows(capture, launched, "cuda")

    def api_phase():
        if not captured:        # phase 5 takes the main path's inputs
            with cs.SegCapture() as capture:
                cs.run_main_path(db, fact, dim, "cuda", capture)
            captured.append(capture)
        cs.kernel_api_phase(db, fact, dim, captured[0], "cuda")

    checks = (("kernel_checks", lambda: cs.kernel_checks(db, "cuda")),
              ("seg_preagg_case_checks",
               lambda: cs.seg_preagg_case_checks("cuda")),
              ("rle_case_checks", lambda: cs.rle_case_checks("cuda")),
              ("main_path+seg_preagg_rows", main_path),
              ("kernel_api_phase+api_case_checks", api_phase))
    failed = 0
    for check, fn in checks:
        try:
            fn()
            verdict = "pass"
        except Exception as e:          # a wrong answer or a failed launch
            failed += 1
            verdict = "fail: " + str(e).splitlines()[0][:120]
        print(f"[fault] case={name} check={check} {verdict}", flush=True)
    return int((failed > 0) != (name != "none"))


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--child":
        return child(sys.argv[2])
    names = sys.argv[1:] or list(FAULTS)
    unknown = [n for n in names if n not in FAULTS]
    if unknown:
        raise SystemExit(f"unknown cases {unknown}; cases: {list(FAULTS)}")
    bad = 0
    for name in names:
        source, edit = FAULTS[name]
        tmp = tempfile.mkdtemp(prefix="groupby_fault_")
        try:
            shutil.copytree(os.path.join(REPO, "src", "repro_torch"),
                            os.path.join(tmp, "src", "repro_torch"),
                            ignore=shutil.ignore_patterns("build",
                                                          "__pycache__"))
            shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp)
            cu = os.path.join(tmp, "src", "repro_torch", "kernels", "csrc",
                              source)
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
        print(f"[fault] case={name} verdict="
              f"{'as expected' if rc == 0 else 'WRONG'}", flush=True)
        bad += rc != 0
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
