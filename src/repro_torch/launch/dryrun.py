"""Dry-run: count every (arch x shape) cell's step on meta tensors.

Mirrors ``src/repro/launch/dryrun.py`` (``run_cell``, ``_save``, the CLI).
The reference lowers and compiles each cell for its 256- and 512-chip
meshes and reads the compiled step's memory and HLO costs.  The port has
no SPMD partitioner, so its default is the one card a step of the port
runs on:

* **One card** (the default).  The model is built on ``device="meta"``
  and one step of the cell's kind -- a train step (loss, backward, AdamW
  on f32 master weights), a prefill or a decode step on bf16 weights --
  runs on ``model.input_specs(shape)`` under ``op_cost.count``, which
  allocates nothing.  The record holds the counted flops and bytes, the
  peak of live temporaries and the argument bytes (parameters, optimizer
  state, cache, inputs), ``model_flops`` and the roofline terms with
  H100 constants (``roofline_math``), ``fits_80gb`` (arguments plus the
  peak of temporaries against the card's 80 GiB) and
  ``bytes_floor_s``: the argument bytes less an untied embedding table
  over the HBM rate, a floor no run of the step can beat (every other
  weight, and a train step's optimizer state, is read at least once;
  an embedding lookup reads only its rows).
* **The reference's meshes** (``multi_pod=True`` or a ``mesh`` from
  ``launch/mesh.py``).  Only what resolves without a partitioner: each
  device's bytes of parameters, train state and cache under
  ``rules_for`` / ``resolve_spec`` (each dim divided by the product of
  its mesh axes' sizes, rounded up) and ``model_flops`` per chip.  No
  flops or bytes are counted there.

A decode step runs at ``pos = seq_len - 1`` (the port's decode takes
``pos`` as an int, where the reference traces it; the cost is the same).
Results go to ``results/dryrun/<arch>--<shape>--<mesh>--<tag>.json``.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k
  python -m repro_torch.launch.dryrun --sweep            # 40 one-card cells
  python -m repro_torch.launch.dryrun --sweep --multi-pod  # 2x16x16 shares
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import pathlib
import time
import traceback
from typing import Any, Dict, Optional, Union

import torch

from .. import configs
from ..configs.base import SHAPES_BY_NAME, RunConfig, ShapeConfig
from ..distributed.sharding import (long_context_overrides, resolve_spec,
                                    rules_for)
from ..models.model import build_model, cache_partition_axes
from ..models.params import abstract_params, logical_axes
from ..train.train_step import (abstract_train_state, make_train_step,
                                train_state_axes)
from . import op_cost
from .mesh import MeshShape, make_production_mesh
from .roofline_math import HBM_BW, analyze, model_flops

RESULTS_DIR = pathlib.Path(__file__).resolve().parents[3] / "results" / \
    "dryrun"
CARD_BYTES = 80 * 2**30           # one H100's HBM
SHAPE_NAMES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def _step(model, shape: ShapeConfig, rc: RunConfig, memory_len):
    """(fn, args) of one step of ``shape``'s kind on meta tensors."""
    inputs = model.input_specs(shape, memory_len=memory_len)
    if shape.kind == "train":
        return make_train_step(model, rc), \
            (abstract_train_state(model), inputs["batch"])
    params = abstract_params(model.decls, torch.bfloat16)
    if shape.kind == "prefill":
        return model.prefill, (params, inputs["batch"])
    pos = shape.seq_len - 1
    return (lambda p, c, t: model.decode_step(p, c, t, pos),
            (params, inputs["cache"], inputs["tokens"]))


def _embed_bytes(model, dtype) -> int:
    """Bytes of an untied embedding table in ``dtype`` (0 when tied: the
    table is the unembedding too, which the logits read whole)."""
    if model.cfg.tie_embeddings:
        return 0
    return math.prod(model.decls["embedding"].shape) * dtype.itemsize


def _one_card(model, shape: ShapeConfig, rc: RunConfig, memory_len):
    fn, args = _step(model, shape, rc, memory_len)
    t0 = time.perf_counter()
    out, costs = op_cost.count(fn, *args)
    count_s = time.perf_counter() - t0
    params = args[0]["params"] if shape.kind == "train" else args[0]
    dtype = torch.float32 if shape.kind == "train" else torch.bfloat16
    cache = {"decode": lambda: args[1], "prefill": lambda: out[1]}.get(
        shape.kind, lambda: None)()
    mflops = model_flops(model.cfg, shape)
    roof = analyze(costs, mflops, 1)
    floor_bytes = costs.arg_bytes - _embed_bytes(model, dtype)
    return dict(
        n_chips=1, count_s=round(count_s, 2), ops=costs.n_ops,
        flops=costs.flops, bytes=costs.bytes, peak_bytes=costs.peak_bytes,
        arg_bytes=costs.arg_bytes,
        params_bytes=op_cost.tree_bytes(params),
        state_bytes=(op_cost.tree_bytes(args[0])
                     if shape.kind == "train" else None),
        cache_bytes=None if cache is None else op_cost.tree_bytes(cache),
        embed_bytes=_embed_bytes(model, dtype),
        model_flops=mflops, compute_s=roof.compute_s,
        memory_s=roof.memory_s, collective_s=roof.collective_s,
        dominant=roof.dominant, bound_s=roof.bound_s,
        bytes_floor_s=floor_bytes / HBM_BW,
        useful_flops_ratio=round(roof.useful_ratio, 4),
        roofline_fraction=round(roof.roofline_fraction, 4),
        fits_80gb=costs.arg_bytes + costs.peak_bytes <= CARD_BYTES)


def _share(shape, spec, mesh: MeshShape) -> int:
    """Elements of one device's block of a ``shape`` tensor under
    ``spec``: each dim over the product of its mesh axes, rounded up."""
    sizes = mesh.shape
    n = 1
    for i, dim in enumerate(shape):
        entry = spec[i] if i < len(spec) else None
        names = () if entry is None else \
            ((entry,) if isinstance(entry, str) else entry)
        n *= -(-dim // math.prod(sizes[a] for a in names))
    return n


def _tree_share(tensors, axes, rules, mesh: MeshShape) -> int:
    """Bytes of one device's blocks of a tree of meta tensors, given the
    tree of their logical axes."""
    if isinstance(tensors, torch.Tensor):
        spec = resolve_spec(axes, rules, mesh.axis_names)
        return _share(tensors.shape, spec, mesh) * tensors.element_size()
    if isinstance(tensors, dict):
        return sum(_tree_share(tensors[k], axes[k], rules, mesh)
                   for k in tensors)
    return sum(_tree_share(t, a, rules, mesh)
               for t, a in zip(tensors, axes))


def _on_mesh(model, shape: ShapeConfig, mesh: MeshShape, rules):
    B, S = shape.global_batch, shape.seq_len
    rec: Dict[str, Any] = dict(
        n_chips=mesh.size,
        model_flops=model_flops(model.cfg, shape),
        model_flops_per_chip=model_flops(model.cfg, shape) / mesh.size,
        counted="none: the port has no SPMD partitioner, so only the "
                "per-device bytes of the state resolve on a mesh")
    if shape.kind == "train":
        state = abstract_train_state(model)
        rec["state_bytes_per_device"] = _tree_share(
            state, train_state_axes(model), rules, mesh)
        return rec
    params = abstract_params(model.decls, torch.bfloat16)
    rec["params_bytes_per_device"] = _tree_share(
        params, logical_axes(model.decls), rules, mesh)
    if shape.kind == "decode":
        rec["cache_bytes_per_device"] = _tree_share(
            model.input_specs(shape)["cache"],
            cache_partition_axes(model, B, S), rules, mesh)
    return rec


def run_cell(arch: str, shape_name: Union[str, ShapeConfig], *,
             multi_pod: bool = False, mesh: Optional[MeshShape] = None,
             rc: Optional[RunConfig] = None,
             moe_dispatch: Optional[str] = None, kv_quant: bool = False,
             save: bool = True, tag: str = "baseline",
             memory_len: Optional[int] = None) -> Dict[str, Any]:
    """The record of one cell: one card unless ``multi_pod`` or a
    ``mesh`` asks for the reference's.  ``shape_name`` may be a
    ``ShapeConfig`` of its own (``chip_smoke.py`` counts its measured
    shapes); ``memory_len`` is an enc-dec model's frames' length, where
    it differs from the shape's."""
    cfg = configs.get(arch)
    if moe_dispatch and cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, dispatch=moe_dispatch))
    shape = shape_name if isinstance(shape_name, ShapeConfig) \
        else SHAPES_BY_NAME[shape_name]
    if multi_pod and mesh is None:
        mesh = make_production_mesh(multi_pod=True)
    rc = rc or RunConfig()
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape.name, "batch": shape.global_batch,
        "seq_len": shape.seq_len, "kind": shape.kind, "tag": tag,
        "mesh": mesh.tag if mesh else "card", "remat": rc.remat_policy,
        "kv_quant": kv_quant, "moe_dispatch": moe_dispatch,
        "time": time.strftime("%F %T")}
    ok, reason = cfg.supports_shape(shape)
    if not ok:
        rec.update(status="skipped", reason=reason)
        _save(rec, save)
        return rec
    try:
        tp = mesh.shape["model"] if mesh else 1
        model = build_model(cfg, tp=tp, remat=rc.remat_policy,
                            kv_quant=kv_quant, device="meta")
        if mesh is None:
            rec.update(status="ok", **_one_card(model, shape, rc,
                                                memory_len))
            print(f"[dryrun] {arch} x {shape.name} (card): "
                  f"dominant={rec['dominant']} "
                  f"bound_ms={rec['bound_s'] * 1e3:.3f} "
                  f"fits_80gb={rec['fits_80gb']} "
                  f"count_s={rec['count_s']}", flush=True)
        else:
            rules = rules_for(cfg, shape.kind)
            if shape.name == "long_500k":
                rules.update(long_context_overrides())
            rec.update(status="ok", **_on_mesh(model, shape, mesh, rules))
            print(f"[dryrun] {arch} x {shape.name} ({mesh.tag}): "
                  f"model_flops_per_chip={rec['model_flops_per_chip']:.4g}",
                  flush=True)
    except Exception as e:  # noqa: BLE001 -- record the failure, keep sweeping
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
        print(f"[dryrun] {arch} x {shape.name} FAILED: {e}", flush=True)
    _save(rec, save)
    return rec


def _path(arch: str, shape: str, mesh_tag: str, tag: str) -> pathlib.Path:
    return RESULTS_DIR / f"{arch}--{shape}--{mesh_tag}--{tag}.json"


def _save(rec: Dict[str, Any], save: bool):
    if not save:
        return
    RESULTS_DIR.mkdir(parents=True, exist_ok=True)
    _path(rec["arch"], rec["shape"], rec["mesh"], rec["tag"]).write_text(
        json.dumps(rec, indent=1))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the reference's (pod=2, data=16, model=16) mesh")
    ap.add_argument("--pod", action="store_true",
                    help="the reference's (data=16, model=16) mesh")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--moe-dispatch", default=None)
    ap.add_argument("--remat", default=None, choices=("minimal", "dots",
                                                      "none"))
    ap.add_argument("--kv-quant", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args()

    mesh = make_production_mesh(multi_pod=True) if args.multi_pod else \
        make_production_mesh() if args.pod else None
    rc = RunConfig(remat_policy=args.remat) if args.remat else None
    kw = dict(mesh=mesh, rc=rc, tag=args.tag, moe_dispatch=args.moe_dispatch,
              kv_quant=args.kv_quant)
    if not args.sweep:
        run_cell(args.arch, args.shape, **kw)
        return
    for arch in configs.ARCH_NAMES:
        for shape in SHAPE_NAMES:
            f = _path(arch, shape, mesh.tag if mesh else "card", args.tag)
            if args.skip_existing and f.exists() and json.loads(
                    f.read_text()).get("status") in ("ok", "skipped"):
                continue
            run_cell(arch, shape, **kw)


if __name__ == "__main__":
    main()
