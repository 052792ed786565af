"""The port's dry-run stack (``launch/roofline_math``, ``launch/op_cost``,
``launch/mesh``, ``launch/dryrun``, ``distributed/sharding``, the abstract
parameters, train state, axes trees and ``input_specs``, and
``data/synth.meter_data``) against the reference's, on the CPU.

Exact throughout: ``model_flops`` is arithmetic on the configs, specs and
axes are trees of names, abstract bytes are products of shapes, and the
meter data is the same seeded draws.  ``op_cost`` is held to the flops of
a matmul counted by hand (2 m n k) and to ``flash_work``, the formula the
flash kernel's meta route and ``chip_smoke.py``'s bounds share.
"""
import dataclasses
import math

import jax
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.configs.base import SHAPES_BY_NAME as REF_SHAPES
from repro.data import meter_data as ref_meter_data
from repro.distributed import sharding as ref_sharding
from repro.launch.roofline_math import model_flops as ref_model_flops
from repro.models import build_model as ref_build_model
from repro.models import model as ref_model_module
from repro.models import params as ref_params_module
from repro.train import train_step as ref_train_step
from repro_torch import configs
from repro_torch.configs.base import SHAPES_BY_NAME, ShapeConfig
from repro_torch.data import meter_data
from repro_torch.distributed import sharding
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_work
from repro_torch.launch import dryrun, op_cost, roofline_math
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import build_model, model as model_module, params
from repro_torch.train import train_step

ARCHS = configs.ARCH_NAMES
KINDS = ("train", "prefill", "decode")
MESH_AXES = (("data", "model"), ("pod", "data", "model"))
FAMILIES = {"dense": "qwen3-4b", "moe": "olmoe-1b-7b", "ssm": "mamba2-130m",
            "hybrid": "hymba-1.5b", "audio": "seamless-m4t-medium",
            "vlm": "llama-3.2-vision-11b"}


def _plain(tree):
    """A tree with named tuples (``OptState``) as plain tuples and jax's
    ``PartitionSpec`` as its entries, for comparison across packages."""
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return ("namedtuple",) + tuple(_plain(v) for v in tree)
    if isinstance(tree, jax.sharding.PartitionSpec):
        return tuple(tree)
    return tree


def _shapes(tree):
    """Leaf shapes and byte sizes of a tree of jax ``ShapeDtypeStruct``s
    or torch tensors, in sorted-key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _shapes(tree[k])]
    if hasattr(tree, "_fields"):
        return [x for v in tree for x in _shapes(v)]
    itemsize = tree.element_size() if isinstance(tree, torch.Tensor) \
        else tree.dtype.itemsize
    return [(tuple(tree.shape), math.prod(tree.shape) * itemsize)]


def _models(arch, full=False, tp=1):
    cfg, ref_cfg = configs.get(arch), ref_configs.get(arch)
    if not full:
        cfg, ref_cfg = cfg.reduced(), ref_cfg.reduced()
    return (build_model(cfg, tp=tp, device="meta"),
            ref_build_model(ref_cfg, tp=tp))


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_and_shapes_match_the_reference(arch):
    """Every shape of every arch: the published-architecture flops of one
    step, and whether the cell runs, exactly the reference's."""
    for name, shape in SHAPES_BY_NAME.items():
        ref_cfg, ref_shape = ref_configs.get(arch), REF_SHAPES[name]
        assert roofline_math.model_flops(configs.get(arch), shape) == \
            ref_model_flops(ref_cfg, ref_shape), name
        assert configs.get(arch).supports_shape(shape) == \
            ref_cfg.supports_shape(ref_shape)


def test_resolve_spec_and_meshes():
    """``tests/test_rooflinemath.py``'s spec cases as tuples, and the
    reference's mesh shapes."""
    rules, names = sharding.BASE_RULES, ("data", "model")
    assert sharding.resolve_spec(("batch", "seq"), rules, names) == \
        ("data",)
    assert sharding.resolve_spec(("embed", "mlp"), rules, names) == \
        ("data", "model")
    assert sharding.resolve_spec(("batch",), rules,
                                 ("pod", "data", "model")) == \
        (("pod", "data"),)
    assert sharding.resolve_spec(("batch", "seq"), dict(rules, seq="data"),
                                 names) == ("data",)
    assert sharding.BASE_RULES == ref_sharding.BASE_RULES
    assert sharding.long_context_overrides() == \
        ref_sharding.long_context_overrides()
    one, two = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert (one.axis_names, one.sizes, one.size) == \
        (("data", "model"), (16, 16), 256)
    assert (two.shape, two.size) == ({"pod": 2, "data": 16, "model": 16},
                                     512)
    assert make_host_mesh(2, 1).shape == {"data": 2, "model": 1}


@pytest.mark.parametrize("arch", ARCHS)
def test_axes_and_partition_specs_match_the_reference(arch):
    """The reduced config's declarations, logical axes, train-state axes
    and cache axes are the reference's trees, and every leaf's partition
    spec under ``rules_for`` of each kind (and the long-context
    overrides) on both mesh axis sets is the reference's."""
    model, ref_model = _models(arch)
    assert params.logical_axes(model.decls) == \
        ref_params_module.logical_axes(ref_model.decls)
    assert _plain(train_step.train_state_axes(model)) == \
        _plain(ref_train_step.train_state_axes(ref_model))
    assert model_module.cache_partition_axes(model, 2, 16) == \
        ref_model_module.cache_partition_axes(ref_model, 2, 16)
    for kind in KINDS:
        for overrides in (None, sharding.long_context_overrides()):
            rules = sharding.rules_for(model.cfg, kind, overrides=overrides)
            assert rules == ref_sharding.rules_for(ref_model.cfg, kind,
                                                   overrides=overrides)
            for names in MESH_AXES:
                assert params.partition_specs(model.decls, rules, names) \
                    == _plain(ref_params_module.partition_specs(
                        ref_model.decls, rules, names)), (kind, names)


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_state_and_inputs_match_the_reference(arch):
    """At the published width: the meta parameters (bf16), which a model
    built on meta loads, and train state (f32 parameters and moments,
    int32 step) leaf for leaf in shape and bytes, and one input spec of
    each kind in shape and dtype."""
    model, ref_model = _models(arch, full=True)
    meta = params.abstract_params(model.decls, torch.bfloat16)
    assert model.load_params(meta) is meta      # a meta model's own device
    got = _shapes(meta)
    want = _shapes(ref_params_module.abstract_params(ref_model.decls,
                                                     jax.numpy.bfloat16))
    assert got == want
    assert _shapes(train_step.abstract_train_state(model)) == \
        _shapes(ref_train_step.abstract_train_state(ref_model))
    assert all(t.is_meta for t in jax.tree.leaves(
        train_step.abstract_train_state(model)))
    for name in ("train_4k", "prefill_32k", "decode_32k"):
        got = model.input_specs(SHAPES_BY_NAME[name])
        want = ref_model.input_specs(REF_SHAPES[name])
        assert sorted(got) == sorted(want)
        assert _shapes(got) == _shapes(want), name
        g = [(str(t.dtype), t.is_meta) for t in jax.tree.leaves(got)]
        w = [(f"torch.{x.dtype}", True) for x in jax.tree.leaves(want)]
        assert sorted(g) == sorted(w), name


def test_op_cost_counts_matmuls_loops_and_the_flash_meta_route():
    """One matmul is 2 m n k flops, seven of them in a loop seven times
    that; the flash kernel's meta route counts ``flash_work``'s flops and
    bytes (q, k, v read, out written; the backward's five inputs and lse
    read, dq, dk, dv written) and launches nothing, causal and not."""
    a = torch.empty(96, 128, device="meta")
    b = torch.empty(128, 80, device="meta")
    _, one = op_cost.count(torch.matmul, a, b)
    assert one.flops == 2 * 96 * 128 * 80 and one.coll_total == 0
    assert one.bytes == (96 * 128 + 128 * 80 + 96 * 80) * 4
    assert one.arg_bytes == (96 * 128 + 128 * 80) * 4
    assert one.peak_bytes == 96 * 80 * 4

    def loop(x):
        for _ in range(7):
            x = x @ x
        return x
    sq = torch.empty(64, 64, device="meta")
    _, seven = op_cost.count(loop, sq)
    assert seven.flops == 7 * 2 * 64 ** 3
    assert seven.peak_bytes == 2 * 64 * 64 * 4   # the product and its input
    ops.reset_launch_counts()
    for causal, S, T in ((True, 200, 200), (False, 100, 70)):
        q = torch.empty(2, 4, 3, S, 64, device="meta", dtype=torch.bfloat16)
        k = torch.empty(2, 4, 1, T, 64, device="meta", dtype=torch.bfloat16)
        (out, lse), fwd = op_cost.count(
            lambda q, k, v: ops.flash_attention(q, k, v, causal=causal,
                                                return_lse=True), q, k, k)
        assert out.shape == q.shape and lse.shape == q.shape[:-1]
        nbytes, flops = flash_work(q.shape, k.shape, causal, 2)
        assert (fwd.flops, fwd.bytes) == (flops, nbytes + lse.numel() * 4)
        pairs = S * (S + 1) // 2 if causal else S * T
        assert flops == 4 * 64 * pairs * 24
        grads, bwd = op_cost.count(
            lambda *t: ops.flash_attention_bwd(*t, causal=causal),
            q, k, k, out, out, lse)
        assert [g.shape for g in grads] == [q.shape, k.shape, k.shape]
        nbytes, flops = flash_work(q.shape, k.shape, causal, 2, tensors=4,
                                   flops_per_d=10)
        assert (bwd.flops, bwd.bytes) == (flops, nbytes + lse.numel() * 4)
    assert ops.launch_counts()["flash_attention"] == 0
    assert ops.launch_counts()["flash_attention_bwd"] == 0


@pytest.mark.parametrize("family", list(FAMILIES))
def test_run_cell_counts_each_kind_of_a_reduced_family(family, monkeypatch):
    """A reduced config of each family at each of the four shapes (cut to
    2 x 256 tokens: ``supports_shape`` reads the name, not the size):
    "ok" where the reference's ``supports_shape`` runs the cell, "skipped"
    where it does not; an ok cell counts its step on meta (its parameters'
    bytes in the step's dtype, a prefill's output cache and a decode's
    input cache as their declarations), and the 2 x 16 x 16 mesh gives
    per-device bytes of the state and ``model_flops`` per chip."""
    arch = FAMILIES[family]
    get = configs.get
    monkeypatch.setattr(configs, "get", lambda name: get(name).reduced())
    small = {n: dataclasses.replace(s, seq_len=256, global_batch=2)
             for n, s in SHAPES_BY_NAME.items()}
    monkeypatch.setattr(dryrun, "SHAPES_BY_NAME", small)
    for name, shape in small.items():
        rec = dryrun.run_cell(arch, name, save=False)
        ok, _ = ref_configs.get(arch).reduced().supports_shape(
            REF_SHAPES[name])
        assert rec["status"] == ("ok" if ok else "skipped"), rec
        if not ok:
            continue
        model = build_model(configs.get(arch), device="meta")
        assert rec["flops"] > 0 and rec["bytes"] > 0
        assert rec["params_bytes"] == sum(
            b for _, b in _shapes(params.abstract_params(
                model.decls, torch.float32 if shape.kind == "train"
                else torch.bfloat16)))
        B, S = shape.global_batch, shape.seq_len
        if shape.kind != "train":
            decls = model.cache_decls(B, S)
            want = sum(math.prod(s) * d.itemsize for s, _, d in
                       _cache_leaves(decls))
            assert rec["cache_bytes"] == want
        mesh = dryrun.run_cell(arch, name, multi_pod=True, save=False)
        key = "state_bytes_per_device" if shape.kind == "train" \
            else "params_bytes_per_device"
        assert 0 < mesh[key] and mesh["n_chips"] == 512
        assert mesh["model_flops_per_chip"] == rec["model_flops"] / 512


def _cache_leaves(decls):
    if isinstance(decls, tuple):
        return [decls]
    return [x for v in decls.values() for x in _cache_leaves(v)]


def test_run_cell_one_card_fit_and_memory_length():
    """seamless-m4t-medium at 4 x 512 on one card: its f32 state's bytes
    (parameters and two moments; the gradients are temporaries), the
    bytes floor less its untied embedding table, and a decode cache
    declared at the frames' length; qwen3-4b's decode_32k, whose bf16
    cache alone (618.5 GB) no card holds."""
    shape = ShapeConfig("train_4x512", 512, 4, "train")
    rec = dryrun.run_cell("seamless-m4t-medium", shape, save=False)
    n = 878_245_900
    assert rec["status"] == "ok" and rec["state_bytes"] == 12 * n + 4
    assert rec["arg_bytes"] == 12 * n + 4 + 2 * 4 * 512 * 4 \
        + 4 * 512 * 1024 * 2
    assert rec["fits_80gb"] and rec["compute_s"] > 0
    assert rec["bytes_floor_s"] == (rec["arg_bytes"] - 256_256 * 1024 * 4) \
        / roofline_math.HBM_BW
    dec = dryrun.run_cell("seamless-m4t-medium",
                          ShapeConfig("decode_4x516", 516, 4, "decode"),
                          memory_len=512, save=False)
    model = build_model(configs.get("seamless-m4t-medium"), device="meta")
    assert dec["cache_bytes"] == op_cost.tree_bytes(model_module.meta_cache(
        model.cache_decls(4, 516, enc_len=512)))
    big = dryrun.run_cell("qwen3-4b", "decode_32k", save=False)
    assert big["status"] == "ok" and not big["fits_80gb"]
    assert big["cache_bytes"] == 36 * 2 * 128 * 32768 * 8 * 128 * 2


def test_meter_data_matches_the_reference():
    for n_rows, kw in ((5_000, dict(n_metrics=7, n_meters=11)),
                       (1_234, {})):
        got, want = meter_data(n_rows, 3, **kw), ref_meter_data(n_rows, 3,
                                                                **kw)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
            assert got[k].dtype == want[k].dtype
