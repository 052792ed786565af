"""Logical-axis -> mesh-axis sharding rules (the framework's GSPMD policy).

Mirrors ``src/repro/distributed/sharding.py``: ``BASE_RULES``,
``rules_for``, ``long_context_overrides`` and ``resolve_spec`` are
verbatim, except that ``resolve_spec`` returns the entries of the
reference's ``PartitionSpec`` as a plain tuple (the port has no SPMD
partitioner to hand one to).  The dry-run (launch/dryrun.py) resolves
parameter, train-state and cache axes through them to size each device's
share on the reference's meshes.  ``activation_hints`` and ``shard_hint``
are left out: on one card they are identities, and the port's model code
never calls them.

The paper's segmentation insight maps directly: a *deterministic value->node
assignment* (here: batch element -> ('pod','data') chip row; attention-head /
expert / vocab shard -> 'model' chip column) is what makes operations local
and keeps the interconnect off the roofline's critical path.

Rule tables are plain dicts so a cell can swap them per (arch x shape)
without touching model code.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

# ---------------------------------------------------------------------------
# Baseline rules (paper-faithful segmentation analogue).
# Params store their embed/vocab-ish dims sharded over 'data' (ZeRO-3/FSDP
# storage; all-gathered per layer by GSPMD) and their head/mlp/expert dims
# over 'model' (Megatron TP / expert parallelism).
# ---------------------------------------------------------------------------

BASE_RULES: Dict[str, Any] = {
    # --- activations ---
    "batch": ("pod", "data"),
    "seq": None,
    "kv_seq": None,          # decode long-context override shards this
    "embed_act": None,
    "vocab_act": "model",
    # --- params ---
    "embed": "data",         # param storage sharding (FSDP-style)
    "vocab": "model",
    "heads": "model",        # q/o in (kv_eff, group) layout: kv_eff dim
    "kv_heads": None,        # raw kv weights stay replicated on model;
                             # the in-graph repeat produces kv_eff sharded
    "kv_heads_eff": "model",
    "q_group": None,
    "head_dim": None,
    "mlp": "model",
    "experts": "model",
    "expert_cap": None,
    "expert_in": "data",     # within-expert storage sharding
    "ssm_heads": "model",
    "ssm_state": None,
    "layers": None,          # scanned-layer leading dim
    "conv": None,
    "frontend_seq": None,
}


def rules_for(arch, shape_kind: str, *, overrides: Optional[Dict[str, Any]]
              = None) -> Dict[str, Any]:
    """Resolve the rule table for an (arch x shape) cell.

    decode with global_batch < dp_size gets its KV-cache sequence dim
    sharded over 'data' instead (long_500k: batch=1), so the data axis
    contributes memory+compute instead of idling.
    """
    rules = dict(BASE_RULES)
    if shape_kind == "decode":
        rules["kv_seq"] = None  # default: batch carries 'data'
    if overrides:
        rules.update(overrides)
    return rules


def long_context_overrides() -> Dict[str, Any]:
    """batch=1 decode: shard the KV/state sequence dim over 'data'."""
    return {"batch": None, "kv_seq": "data"}


# ---------------------------------------------------------------------------
# Logical partition specs
# ---------------------------------------------------------------------------

def resolve_spec(axes: Tuple[Optional[str], ...], rules: Dict[str, Any],
                 mesh_axis_names: Tuple[str, ...]):
    """Map logical axis names to a partition spec under ``rules``: the
    entries of the reference's ``PartitionSpec`` as a plain tuple (a mesh
    axis name, a tuple of them, or None per dim; trailing Nones dropped).

    Mesh axes absent from the current mesh are dropped; a mesh axis may
    appear at most once per spec (first dim wins)."""
    used = set()
    out = []
    for ax in axes:
        entry = rules.get(ax) if ax is not None else None
        if entry is None:
            out.append(None)
            continue
        names = (entry,) if isinstance(entry, str) else tuple(entry)
        names = [n for n in names if n in mesh_axis_names and n not in used]
        used.update(names)
        if not names:
            out.append(None)
        elif len(names) == 1:
            out.append(names[0])
        else:
            out.append(tuple(names))
    while out and out[-1] is None:
        out.pop()
    return tuple(out)
