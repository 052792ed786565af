"""build_model(cfg, tp, device=...): the entry point of the training and
serving paths.

A Model bundles, for the decoder-only dense, MoE, SSM and hybrid
families:
  decls          -- parameter declarations (shapes + logical axes)
  loss           -- (params, batch) -> scalar   [train]
  prefill        -- (params, batch, max_len) -> (last_logits, cache)
  decode_step    -- (params, cache, tokens, pos) -> (logits, cache)
  cache_decls    -- (batch, max_len) -> tree of (shape, axes, dtype)

Mirrors ``src/repro/models/model.py`` (``Model``, ``_attn_cache``,
``_ssm_cache``, ``_block_cache``, ``_stack_cache``, ``_positions`` and
``_build_decoder_only``).  ``Model`` is a ``torch.nn.Module`` on one
explicit device: ``init_params`` draws a parameter tree there and
``load_params`` checks one against the declarations and the device; the
caller keeps the tree, and ``prefill`` and ``decode_step`` take it as an
argument, as the reference's functions do.  ``loss`` takes f32 master
weights (bf16 compute), runs the decoder in train mode under the model's
remat policy and adds the MoE blocks' load-balance loss, as the
reference's does.  ``kv_quant=True`` gives the int8 KV cache: each
layer's entry is ``{"k": {"q": int8, "s": f32}, "v": {...}}``, the
reference's layout, so a reference cache carries across
(``carry.cache_from_numpy``).  An SSM or hybrid block's cache entry
``ssm`` holds the f32 state and the bf16 conv rings (``_ssm_cache``),
whose size does not grow with the sequence; a hybrid block holds it beside
its attention cache, a ring of ``window`` slots on its windowed layers.
The audio and VLM families raise ``NotImplementedError`` until their
slices; the dry-run's ``input_specs`` waits for its.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..configs.base import ArchConfig
from . import attention as attn
from . import ssm as ssm_mod
from .layers import embed_lookup, logits_fn, rmsnorm, softmax_xent
from .params import Decls, count_params, init_params, resolve_device
from .transformer import CACHE_DTYPE, decoder_decls, run_decoder, segments

PORTED_FAMILIES = ("dense", "moe", "ssm", "hybrid")


# ---------------------------------------------------------------------------
# Cache declaration mirrors (must match block_apply cache structure exactly)
# ---------------------------------------------------------------------------

def _attn_cache(cfg, tp, batch, max_len, window, kv_quant=False):
    layout = attn.resolve_head_layout(cfg.n_heads, cfg.n_kv_heads,
                                      cfg.resolved_head_dim, tp)
    shape, axes = attn.cache_decl_shapes(batch, max_len, layout, window)
    if kv_quant:
        sshape = shape[:-1] + (1,)
        entry = {"q": (shape, axes, torch.int8),
                 "s": (sshape, axes, torch.float32)}
        return {"k": entry, "v": dict(entry)}
    return {"k": (shape, axes, CACHE_DTYPE), "v": (shape, axes, CACHE_DTYPE)}


def _ssm_cache(cfg, tp, batch):
    lo = ssm_mod.resolve_ssm_layout(cfg.d_model, cfg.ssm, tp)
    shapes = ssm_mod.ssm_cache_shapes(batch, lo)
    out = {}
    for k, (shape, axes) in shapes.items():
        dt = torch.float32 if k == "state" else CACHE_DTYPE
        out[k] = (shape, axes, dt)
    return out


def _block_cache(cfg, tp, batch, max_len, window, *, kv_quant=False):
    entry: Dict[str, Any] = {}
    if cfg.n_heads:
        entry["attn"] = _attn_cache(cfg, tp, batch, max_len, window,
                                    kv_quant)
    if cfg.ssm is not None:
        entry["ssm"] = _ssm_cache(cfg, tp, batch)
    return entry


def _is_cache_leaf(x):
    return (isinstance(x, tuple) and len(x) == 3 and isinstance(x[0], tuple))


def _stack_cache(entry, n):
    if _is_cache_leaf(entry):
        shape, axes, dt = entry
        return ((n,) + shape, ("layers",) + axes, dt)
    return {k: _stack_cache(v, n) for k, v in entry.items()}


def _positions(B, S, device):
    return torch.arange(S, dtype=torch.int32, device=device).expand(B, S)


# ---------------------------------------------------------------------------
# Decoder-only family
# ---------------------------------------------------------------------------

class Model(torch.nn.Module):
    """The decoder-only LM on ``device``: its declarations, and the
    functions that run a parameter tree held on that device."""

    def __init__(self, cfg: ArchConfig, tp: int, device,
                 remat: str = "minimal", kv_quant: bool = False):
        super().__init__()
        self.cfg = cfg
        self.tp = tp
        self.device = device
        self.remat = remat
        self.kv_quant = kv_quant
        self.decls: Decls = decoder_decls(cfg, tp)

    @property
    def n_params(self) -> int:
        return count_params(self.decls)

    def init_params(self, seed: int = 0, dtype=torch.bfloat16):
        """Random weights from ``seed`` on the model's device (bf16, the
        serving type, unless asked otherwise)."""
        return self.load_params(init_params(self.decls, seed, dtype,
                                            self.device))

    def load_params(self, tree: Dict[str, Any]) -> Dict[str, Any]:
        """``tree``, after checking it against the declarations: every leaf
        of the declared shape, on the model's device."""
        def check(decls, sub, path):
            if set(decls) != set(sub):
                raise ValueError(f"params{path}: keys {sorted(sub)}, "
                                 f"declared {sorted(decls)}")
            for k, d in decls.items():
                if isinstance(d, dict):
                    check(d, sub[k], f"{path}/{k}")
                elif tuple(sub[k].shape) != d.shape or \
                        sub[k].device != self.device:
                    raise ValueError(
                        f"params{path}/{k}: {tuple(sub[k].shape)} on "
                        f"{sub[k].device}, declared {d.shape} on "
                        f"{self.device}")
        check(self.decls, tree, "")
        return tree

    def loss(self, params, batch):
        """Mean next-token cross entropy of ``batch`` (tokens, labels).  A
        stacked segment of ``params`` may be a list of per-layer trees
        (transformer.run_decoder)."""
        cfg = self.cfg
        tokens, labels = batch["tokens"], batch["labels"]
        B, S = tokens.shape
        x = embed_lookup(params, tokens, CACHE_DTYPE)
        x, _, aux = run_decoder(cfg, self.tp, params, x, mode="train",
                                positions=_positions(B, S, x.device),
                                remat_policy=self.remat)
        x = rmsnorm(params["ln_f"], x)
        logits = logits_fn(params, x, cfg.vocab_size, cfg.tie_embeddings)
        return softmax_xent(logits, labels) + aux

    def prefill(self, params, batch, max_len: Optional[int] = None):
        cfg = self.cfg
        tokens = batch["tokens"]
        B, S = tokens.shape
        x = embed_lookup(params, tokens, CACHE_DTYPE)
        x, caches, _ = run_decoder(cfg, self.tp, params, x, mode="prefill",
                                   positions=_positions(B, S, x.device),
                                   max_len=max_len, kv_quant=self.kv_quant)
        x = rmsnorm(params["ln_f"], x[:, -1:])
        logits = logits_fn(params, x, cfg.vocab_size, cfg.tie_embeddings)
        return logits, caches

    def decode_step(self, params, cache, tokens, pos: int):
        """One token per sequence at absolute position ``pos``; the cache
        is written in place and returned."""
        cfg = self.cfg
        B = tokens.shape[0]
        pos = int(pos)
        x = embed_lookup(params, tokens, CACHE_DTYPE)
        positions = torch.full((B, 1), pos, dtype=torch.int32,
                               device=x.device)
        x, caches, _ = run_decoder(cfg, self.tp, params, x, mode="decode",
                                   positions=positions, caches=cache,
                                   pos=pos, kv_quant=self.kv_quant)
        x = rmsnorm(params["ln_f"], x)
        logits = logits_fn(params, x, cfg.vocab_size, cfg.tie_embeddings)
        return logits, caches

    def cache_decls(self, batch, max_len):
        out = {}
        for seg in segments(self.cfg):
            entry = _block_cache(self.cfg, self.tp, batch, max_len,
                                 seg.window, kv_quant=self.kv_quant)
            out[seg.name] = _stack_cache(entry, seg.n_layers) \
                if seg.scanned else entry
        return out


def build_model(cfg: ArchConfig, tp: int = 1, remat: str = "minimal",
                kv_quant: bool = False, *, device="cuda") -> Model:
    """The model of ``cfg`` on ``device`` (CUDA unless the caller asks for
    the CPU; CUDA without a GPU raises); ``remat`` is the training
    path's recompute policy (minimal, dots or none); ``kv_quant`` gives
    the int8 KV cache (decode is cache-bandwidth bound)."""
    dev = resolve_device(device, "build_model")
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(f"{cfg.name}: the {cfg.family} family is "
                                  f"not ported yet")
    # serving runs bf16 matmuls; state (for f32 callers) that f32 products
    # stay full f32, never TF32 (the H100's default, set explicitly)
    torch.backends.cuda.matmul.allow_tf32 = False
    if remat not in ("minimal", "dots", "none"):
        raise ValueError(f"remat {remat!r}: minimal, dots or none")
    return Model(cfg, tp, dev, remat, kv_quant)
