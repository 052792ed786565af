"""The port stands alone: importing any module of ``repro_torch`` pulls in
neither jax nor the reference package ``repro``, and a database asked to
run on CUDA refuses to run on the CPU instead."""
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import repro_torch

SRC = os.path.dirname(os.path.dirname(os.path.abspath(repro_torch.__file__)))


def test_importing_every_module_leaves_out_jax_and_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'repro'))\n"
        "print(len(names), bad)\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.strip().split(" ", 1)
    assert bad == "[]", bad
    expected = {m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch.")}
    assert int(n) == len(expected) >= 68
    for name in ("repro_torch.distributed", "repro_torch.distributed.mesh",
                 "repro_torch.engine.segmented",
                 "repro_torch.engine.exchange",
                 "repro_torch.engine.executor",
                 "repro_torch.engine.serving",
                 "repro_torch.core.recovery",
                 "repro_torch.planner.designer"):
        assert name in expected, name


def test_chip_smoke_imports_nothing_of_jax_or_repro():
    path = os.path.join(os.path.dirname(SRC), "chip_smoke.py")
    src = open(path).read()
    for bad in ("import jax", "from jax", "import repro\n", "from repro ",
                "from repro.", "import repro."):
        assert bad not in src, bad


def test_cuda_database_without_a_gpu_raises():
    from repro_torch.core import VerticaDB
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal needs none")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VerticaDB()                                  # the default device
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VerticaDB(device="cuda")
    assert VerticaDB(device="cpu").device.type == "cpu"


def test_kernel_wrappers_count_only_their_launches():
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    words = torch.zeros((1, 3), dtype=torch.int32)
    ops.bitunpack(words, 3, 32)                   # CPU: the plain version
    ops.seg_preagg(torch.zeros(4, dtype=torch.int32),
                   torch.ones(4, dtype=torch.bool), {}, 2, ())
    runs = torch.ones((1, 2), dtype=torch.int32)
    ops.rle_grouped_agg(torch.zeros((1, 2), dtype=torch.int32), runs,
                        domain=2)
    ops.rle_filter_agg(runs, runs, lo=0, hi=1)
    ops.onehot_groupby(runs, runs, domain=2)
    ops.semijoin_probe(runs, torch.ones(3, dtype=torch.int32))
    ops.delta_decode(torch.zeros((1, 1), dtype=torch.int32), runs)
    q = torch.zeros((1, 2, 5, 64))
    ops.flash_attention(q, q[:, :1], q[:, :1])
    assert ops.launch_counts() == {
        "bitunpack": 0, "seg_preagg": 0, "rle_grouped_agg": 0,
        "rle_filter_agg": 0, "onehot_groupby": 0, "semijoin_probe": 0,
        "delta_decode": 0, "flash_attention": 0}


def test_lm_entry_points_without_a_gpu_raise_and_run_on_the_cpu():
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import build_model, init_params
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal needs none")
    cfg = configs.get("qwen3-4b").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg)                             # the default device
    model = build_model(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(model.decls, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main([])
    params = model.init_params(seed=0)
    assert params["embedding"].device.type == "cpu"
    assert params["embedding"].dtype == torch.bfloat16
    gen = serve.main(["--device", "cpu", "--batch", "2", "--prompt-len",
                      "8", "--tokens", "3"])
    assert gen.tokens.shape == (2, 3) and gen.decode_steps == 2
