"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface (``extern "C"`` entry
points that take device pointers, sizes and a stream, launch, and return
``cudaGetLastError()``), so it compiles in seconds without PyTorch's
headers.  Libraries go to ``kernels/build/`` (ignored by git), named by a
hash of their source and the shared ``*.cuh`` headers, so an edited
kernel is rebuilt; every source is compiled by its own ``nvcc`` process,
all started together.

Nothing here runs at import: the first launch builds what it needs, or a
caller builds everything up front with :func:`build_all`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
SOURCES = ("bitunpack", "seg_preagg", "rle_grouped_agg", "rle_filter_agg",
           "onehot_groupby", "semijoin_probe", "delta_decode",
           "flash_attention", "flash_attention_bwd")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cand = Path(CUDA_HOME) / "bin" / "nvcc" if CUDA_HOME else None
    if cand is not None and cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.read_bytes())         # a shared header edit rebuilds
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all(names: Iterable[str] = SOURCES) -> float:
    """Compile every missing library in parallel (one ``nvcc`` per
    source); returns the wall seconds spent.  Raises with the compiler's
    output when a source fails to build."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    errors = []
    for name, out, tmp, p in procs:
        log, _ = p.communicate()
        if p.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log.decode()}")
            continue
        os.replace(tmp, out)       # atomic: a concurrent loader never
        #                            sees a half-written library
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build_all((name,))
        lib = ctypes.CDLL(str(path))
        _LIBS[name] = lib
    return lib


def entry(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """Entry point ``symbol`` of ``csrc/<name>.cu`` with its C signature
    declared: ``c_void_p`` for every pointer and the stream, so ctypes
    never cuts a 64-bit address to an int; it returns a cudaError_t."""
    fn = getattr(load(name), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by an entry point: a
    refused launch never runs, and a later synchronize would not say so."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def stream_ptr(device) -> int:
    """PyTorch's current stream on ``device``, as the pointer the entry
    points take."""
    import torch

    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


def require_cuda(name: str, *tensors, dtypes: Optional[tuple] = None,
                 contiguous: bool = True) -> None:
    """Wrapper-side checks shared by every kernel: each tensor lies on one
    CUDA device and, unless the kernel reads strides, is contiguous (and,
    when given, of the listed dtype)."""
    dev = tensors[0].device
    for i, t in enumerate(tensors):
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if contiguous and not t.is_contiguous():
            raise ValueError(f"{name}: argument {i} is not contiguous")
        if dtypes is not None and t.dtype != dtypes[i]:
            raise TypeError(f"{name}: argument {i} is {t.dtype}, "
                            f"expected {dtypes[i]}")


def int32_or_f32(t):
    """``t`` as a kernel that reads int32 or f32 lanes takes it: those two
    dtypes pass unchanged, any other is cast to f32, as the reference casts
    before it computes.  Returns (tensor, 1 if f32 else 0)."""
    import torch

    if t.dtype not in (torch.int32, torch.float32):
        t = t.to(torch.float32)
    return t.contiguous(), int(t.dtype == torch.float32)
