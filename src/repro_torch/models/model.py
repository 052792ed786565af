"""build_model(cfg, tp, device=...): the entry point of the training and
serving paths.

A Model bundles, for every family:
  decls          -- parameter declarations (shapes + logical axes)
  loss           -- (params, batch) -> scalar   [train]
  prefill        -- (params, batch, max_len) -> (last_logits, cache)
  decode_step    -- (params, cache, tokens, pos) -> (logits, cache)
  cache_decls    -- (batch, max_len) -> tree of (shape, axes, dtype)
                    (enc-dec: (batch, max_len, enc_len=None))
  input_specs    -- ShapeConfig -> kwargs tree of meta tensors
                    (the dry-run stand-ins; no allocation)

Mirrors ``src/repro/models/model.py`` (``Model``, ``_attn_cache``,
``_ssm_cache``, ``_block_cache``, ``_stack_cache``, ``_positions``,
``_build_decoder_only``, ``_build_encdec``, ``_build_vlm`` and
``cache_partition_axes``).
``Model`` is a ``torch.nn.Module`` on one explicit device: ``init_params``
draws a parameter tree there and ``load_params`` checks one against the
declarations and the device; the caller keeps the tree, and ``prefill``
and ``decode_step`` take it as an argument, as the reference's functions
do.  The reference's three builders are one class per family group:
``Model`` (decoder-only: dense, MoE, SSM, hybrid) and its subclasses
``EncDecModel`` (audio: seamless) and ``VLMModel`` (vlm:
llama-3.2-vision), which override its hooks: ``_decls``, ``_memory``
(the cross-attention memory a batch carries: the encoder's output of
``batch["frames"]``, or ``batch["image_embeds"]`` as given),
``_memory_shape`` (its shape, for ``input_specs``), ``_run`` (the
decoder stack), ``stacked`` (which parameter entries are stacked layers)
and ``cache_decls``.  ``loss`` takes f32 master weights (bf16 compute),
runs the decoder (and an enc-dec model's encoder) in train mode under the
model's remat policy and adds the MoE blocks' load-balance loss, as the
reference's does.  ``kv_quant=True`` gives the int8 KV cache
(decoder-only families): each layer's entry is ``{"k": {"q": int8, "s":
f32}, "v": {...}}``, the reference's layout, so a reference cache
carries across (``carry.cache_from_numpy``).  An SSM or hybrid block's
cache entry ``ssm`` holds the f32 state and the bf16 conv rings
(``_ssm_cache``), whose size does not grow with the sequence; a hybrid
block holds it beside its attention cache, a ring of ``window`` slots on
its windowed layers.  A cross layer's entry ``cross`` holds the memory's
bf16 k and v, as long as the memory (seamless: the frames, declared at
``enc_len`` or, as in the reference, ``max_len``; the VLM:
``n_frontend_tokens``); decode reads it and never writes it.  The VLM
stacks its self layers twice, (groups, self layers per group, ...), in
its parameters and its cache, and its cross layers once; a cross layer
has no ``ln1`` / ``attn``, so it runs no self-attention.  A model built
on ``device="meta"`` allocates nothing: the dry-run runs it on
``input_specs`` and ``params.abstract_params`` to count its work.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Dict, Optional

import torch

from ..configs.base import ArchConfig, ShapeConfig
from . import attention as attn
from . import ssm as ssm_mod
from .layers import (embed_lookup, logits_fn, rmsnorm, rmsnorm_decl,
                     softmax_xent)
from .params import (Decls, ParamDecl, count_params, init_params,
                     resolve_device)
from .transformer import (CACHE_DTYPE, _layer, _remat, _stack,
                          _stack_decls, block_apply, block_decls,
                          decoder_decls, run_decoder, segments)

PORTED_FAMILIES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm")


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


def _block_cache(cfg, tp, batch, max_len, window, *, cross_len=None,
                 kv_quant=False):
    entry: Dict[str, Any] = {}
    if cfg.n_heads:
        entry["attn"] = _attn_cache(cfg, tp, batch, max_len, window,
                                    kv_quant)
    if cfg.ssm is not None:
        entry["ssm"] = _ssm_cache(cfg, tp, batch)
    if cross_len is not None:
        layout = attn.resolve_head_layout(cfg.n_heads, cfg.n_kv_heads,
                                          cfg.resolved_head_dim, tp)
        shape = (batch, cross_len, layout.kv_eff, layout.head_dim)
        axes = ("batch", "frontend_seq", "kv_heads_eff", "head_dim")
        entry["cross"] = {"k": (shape, axes, CACHE_DTYPE),
                          "v": (shape, axes, CACHE_DTYPE)}
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


def meta_cache(decls):
    """A cache declaration tree (``cache_decls``) as meta tensors of its
    shapes and dtypes: no memory."""
    if _is_cache_leaf(decls):
        return torch.empty(decls[0], dtype=decls[2], device="meta")
    return {k: meta_cache(v) for k, v in decls.items()}


# ---------------------------------------------------------------------------
# Decoder-only family
# ---------------------------------------------------------------------------

class Model(torch.nn.Module):
    """The decoder-only LM on ``device``: its declarations, and the
    functions that run a parameter tree held on that device.  The enc-dec
    and VLM subclasses override ``_decls``, ``_memory``,
    ``_memory_shape``, ``_run``, ``stacked`` and ``cache_decls``."""

    memory_key: Optional[str] = None   # the batch entry of the memory

    def __init__(self, cfg: ArchConfig, tp: int, device,
                 remat: str = "minimal", kv_quant: bool = False):
        super().__init__()
        self.cfg = cfg
        self.tp = tp
        self.device = device
        self.remat = remat
        self.kv_quant = kv_quant
        self.decls: Decls = self._decls()

    def _decls(self) -> Decls:
        return decoder_decls(self.cfg, self.tp)

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

    def stacked(self) -> Dict[str, int]:
        """The parameter entries that stack layers, each with its number
        of stacked levels (the VLM's self layers have two)."""
        return {seg.name: 1 for seg in segments(self.cfg) if seg.scanned}

    def loss(self, params, batch):
        """Mean next-token cross entropy of ``batch`` (tokens, labels, and
        the memory of a model with cross layers).  A stacked entry of
        ``params`` (``stacked``) may be a list of per-layer trees."""
        cfg = self.cfg
        tokens, labels = batch["tokens"], batch["labels"]
        B, S = tokens.shape
        memory = self._memory(params, batch, mode="train")
        x = embed_lookup(params, tokens, CACHE_DTYPE)
        x, _, aux = self._run(params, x, mode="train",
                              positions=_positions(B, S, x.device),
                              memory=memory)
        x = rmsnorm(params["ln_f"], x)
        logits = logits_fn(params, x, cfg.vocab_size, cfg.tie_embeddings)
        return softmax_xent(logits, labels) + aux

    def _memory(self, params, batch, mode: str) -> Optional[torch.Tensor]:
        """The cross-attention memory of ``batch`` for a pass in ``mode``:
        its ``memory_key`` entry (None for a decoder-only model)."""
        if self.memory_key is None:
            return None
        if self.memory_key not in batch:
            raise ValueError(f"{self.cfg.name}: {mode} needs "
                             f"batch[{self.memory_key!r}]")
        return batch[self.memory_key]

    def _memory_shape(self, batch: int, seq: int, memory_len=None):
        """The shape of the memory a batch of ``batch`` x ``seq`` tokens
        carries (None for a decoder-only model)."""
        return None

    def _run(self, params, x, **kw):
        """The decoder stack; returns (x, caches, aux)."""
        return run_decoder(self.cfg, self.tp, params, x,
                           kv_quant=self.kv_quant, remat_policy=self.remat,
                           **kw)

    def input_specs(self, shape: ShapeConfig,
                    memory_len: Optional[int] = None) -> Dict[str, Any]:
        """Meta tensors of one step's inputs at ``shape``, the reference's
        shapes and types: int32 tokens (and labels), a model's bf16
        memory; for decode a meta cache of ``seq_len`` slots, (B, 1)
        tokens and a 0-d int32 ``pos``.  ``memory_len``: an enc-dec
        model's frames' length (its cross cache's; the reference's is
        ``seq_len``)."""
        B, S = shape.global_batch, shape.seq_len
        meta = partial(torch.empty, device="meta")
        tok = meta((B, S), dtype=torch.int32)
        mem = self._memory_shape(B, S, memory_len)
        extra = {} if mem is None else \
            {self.memory_key: meta(mem, dtype=torch.bfloat16)}
        if shape.kind == "train":
            return {"batch": {"tokens": tok, "labels": meta(
                (B, S), dtype=torch.int32), **extra}}
        if shape.kind == "prefill":
            return {"batch": {"tokens": tok, **extra}}
        kw = {} if memory_len is None else {"enc_len": memory_len}
        return {"cache": meta_cache(self.cache_decls(B, S, **kw)),
                "tokens": meta((B, 1), dtype=torch.int32),
                "pos": meta((), dtype=torch.int32)}

    def prefill(self, params, batch, max_len: Optional[int] = None):
        cfg = self.cfg
        tokens = batch["tokens"]
        B, S = tokens.shape
        memory = self._memory(params, batch, mode="prefill")
        x = embed_lookup(params, tokens, CACHE_DTYPE)
        x, caches, _ = self._run(params, x, mode="prefill",
                                 positions=_positions(B, S, x.device),
                                 memory=memory, max_len=max_len)
        x = rmsnorm(params["ln_f"], x[:, -1:])
        logits = logits_fn(params, x, cfg.vocab_size, cfg.tie_embeddings)
        return logits, caches

    def decode_step(self, params, cache, tokens, pos: int):
        """One token per sequence at absolute position ``pos``; the cache
        is written in place and returned (a cross layer's entry is read
        only)."""
        cfg = self.cfg
        B = tokens.shape[0]
        pos = int(pos)
        x = embed_lookup(params, tokens, CACHE_DTYPE)
        positions = torch.full((B, 1), pos, dtype=torch.int32,
                               device=x.device)
        x, caches, _ = self._run(params, x, mode="decode",
                                 positions=positions, caches=cache, pos=pos)
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


# ---------------------------------------------------------------------------
# Enc-dec family (seamless: audio frontend stub -> encoder -> decoder)
# ---------------------------------------------------------------------------

class EncDecModel(Model):
    """The enc-dec LM: ``frontend_proj`` and a stack of bidirectional
    encoder blocks turn ``batch["frames"]`` (B, T, d) into the memory
    every decoder block's cross branch attends to."""

    memory_key = "frames"

    def _decls(self) -> Decls:
        cfg, tp, d = self.cfg, self.tp, self.cfg.d_model
        decls: Decls = dict(decoder_decls(cfg, tp))   # embed, layers, ln_f
        decls["layers"] = _stack_decls(block_decls(cfg, tp, cross=True),
                                       cfg.n_layers)
        decls["frontend_proj"] = ParamDecl((d, d), ("embed", None))
        decls["encoder"] = _stack_decls(block_decls(cfg, tp),
                                        cfg.n_encoder_layers)
        decls["ln_enc"] = rmsnorm_decl(d)
        return decls

    def stacked(self) -> Dict[str, int]:
        return {**super().stacked(), "encoder": 1}

    def encode(self, params, frames, mode: str = "prefill"):
        """frames (B, T, d) -> the encoder's output (B, T, d), bf16: the
        encoder blocks' bidirectional self-attention through the flash
        kernel with ``causal=False``.  In train mode (the loss) each block
        runs under the model's remat policy, as the reference's
        ``jax.checkpoint(body)``, and its attention takes the autograd
        route (``flash_train``); in prefill mode (serving; the reference
        runs train mode there too) a block runs without ``max_len``,
        whose cache is its k and v themselves (no copy, dropped), so it
        launches the forward kernel alone."""
        B, T, _ = frames.shape
        x = frames.to(CACHE_DTYPE) @ params["frontend_proj"].to(CACHE_DTYPE)
        fn = partial(block_apply, self.cfg, self.tp, mode=mode, window=None,
                     positions=_positions(B, T, x.device), causal=False)
        body = lambda p, h: fn(p, h)[0]
        if mode == "train":
            body = _remat(body, self.remat)
        for i in range(self.cfg.n_encoder_layers):
            x = body(_layer(params["encoder"], i), x)
        return rmsnorm(params["ln_enc"], x)

    def _memory(self, params, batch, mode):
        return self.encode(params, super()._memory(params, batch, mode),
                           mode)

    def _memory_shape(self, batch, seq, memory_len=None):
        return (batch, memory_len or seq, self.cfg.d_model)

    def cache_decls(self, batch, max_len, enc_len=None):
        """``enc_len``: the frames' length, which the cross cache holds
        (the reference's default, ``max_len``, where it is not given)."""
        entry = _block_cache(self.cfg, self.tp, batch, max_len, None,
                             cross_len=enc_len or max_len)
        return {"layers": _stack_cache(entry, self.cfg.n_layers)}


# ---------------------------------------------------------------------------
# VLM family (groups of self layers + one gated cross-attn layer)
# ---------------------------------------------------------------------------

class VLMModel(Model):
    """The VLM: ``n_layers / cross_attn_every`` groups, each of
    ``cross_attn_every - 1`` self layers and one gated cross layer that
    attends to ``batch["image_embeds"]`` (B, n_frontend_tokens, d) and
    replaces self-attention (Llama-3.2's image layers)."""

    memory_key = "image_embeds"

    @property
    def n_groups(self) -> int:
        return self.cfg.n_layers // self.cfg.cross_attn_every

    @property
    def n_self(self) -> int:
        return self.cfg.cross_attn_every - 1

    def _decls(self) -> Decls:
        cfg, tp = self.cfg, self.tp
        cross_block = {k: v for k, v in
                       block_decls(cfg, tp, cross=True).items()
                       if k not in ("ln1", "attn")}
        decls: Decls = dict(decoder_decls(cfg, tp))
        del decls["layers"]
        decls["groups_self"] = _stack_decls(
            _stack_decls(block_decls(cfg, tp), self.n_self), self.n_groups)
        decls["groups_cross"] = _stack_decls(cross_block, self.n_groups)
        return decls

    def stacked(self) -> Dict[str, int]:
        return {"groups_self": 2, "groups_cross": 1}

    def _memory_shape(self, batch, seq, memory_len=None):
        return (batch, self.cfg.n_frontend_tokens, self.cfg.d_model)

    def _run(self, params, x, *, mode, positions, caches=None, pos=None,
             memory=None, max_len=None):
        """Group by group: its self layers (a view of level 2 of the
        doubly stacked trees), then its cross layer.  Decode writes the
        self caches in place and hands ``caches`` back; train runs each
        group under the model's remat policy, as the reference checkpoints
        its group body, and returns no caches."""
        if mode == "train":
            return self._train_groups(params, x, positions, memory), \
                None, 0.0
        caches = caches or {}
        c_self, c_cross = caches.get("groups_self"), \
            caches.get("groups_cross")
        kw = dict(mode=mode, window=None, positions=positions, pos=pos,
                  max_len=max_len)
        self_out, cross_out = [], []
        for g in range(self.n_groups):
            p_self = _layer(params["groups_self"], g)
            outs = []
            for i in range(self.n_self):
                c_l = None if c_self is None else _layer(c_self, g)
                x, c_out, _ = block_apply(
                    self.cfg, self.tp, _layer(p_self, i), x,
                    cache=None if c_l is None else _layer(c_l, i), **kw)
                outs.append(c_out)
            x, c_out, _ = block_apply(
                self.cfg, self.tp, _layer(params["groups_cross"], g), x,
                cache=None if c_cross is None else _layer(c_cross, g),
                memory=memory, **kw)
            self_out.append(outs)
            cross_out.append(c_out)
        if mode == "decode":
            return x, caches, 0.0
        return x, {"groups_self": _stack([_stack(o) for o in self_out]),
                   "groups_cross": _stack(cross_out)}, 0.0

    def _train_groups(self, params, x, positions, memory):
        kw = dict(mode="train", window=None, positions=positions)

        def group(p_self, p_cross, h):
            for i in range(self.n_self):
                h = block_apply(self.cfg, self.tp, _layer(p_self, i), h,
                                **kw)[0]
            return block_apply(self.cfg, self.tp, p_cross, h,
                               memory=memory, **kw)[0]
        body = _remat(group, self.remat)
        for g in range(self.n_groups):
            x = body(_layer(params["groups_self"], g),
                     _layer(params["groups_cross"], g), x)
        return x

    def cache_decls(self, batch, max_len):
        cfg = self.cfg
        self_entry = _block_cache(cfg, self.tp, batch, max_len, None)
        cross_entry = _block_cache(
            dataclasses.replace(cfg, ssm=None), self.tp, batch, max_len,
            None, cross_len=cfg.n_frontend_tokens)
        return {
            "groups_self": _stack_cache(_stack_cache(self_entry,
                                                     self.n_self),
                                        self.n_groups),
            "groups_cross": _stack_cache({"cross": cross_entry["cross"]},
                                         self.n_groups),
        }


_FAMILY_MODELS = {"audio": EncDecModel, "vlm": VLMModel}


def build_model(cfg: ArchConfig, tp: int = 1, remat: str = "minimal",
                kv_quant: bool = False, *, device="cuda") -> Model:
    """The model of ``cfg`` on ``device`` (CUDA unless the caller asks for
    the CPU; CUDA without a GPU raises); ``remat`` is the training
    path's recompute policy (minimal, dots or none); ``kv_quant`` gives
    the int8 KV cache (decode is cache-bandwidth bound), for the
    decoder-only families as in the reference."""
    dev = resolve_device(device, "build_model")
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(f"{cfg.name}: the {cfg.family} family is "
                                  f"not ported yet")
    if kv_quant and cfg.family in _FAMILY_MODELS:
        raise NotImplementedError(f"{cfg.name}: the int8 KV cache is the "
                                  f"decoder-only families'")
    # serving runs bf16 matmuls; state (for f32 callers) that f32 products
    # stay full f32, never TF32 (the H100's default, set explicitly)
    torch.backends.cuda.matmul.allow_tf32 = False
    if remat not in ("minimal", "dots", "none"):
        raise ValueError(f"remat {remat!r}: minimal, dots or none")
    return _FAMILY_MODELS.get(cfg.family, Model)(cfg, tp, dev, remat,
                                                 kv_quant)


def cache_partition_axes(model: Model, batch: int, max_len: int):
    """Logical axes tree for the cache (the dry-run's per-device shares)."""
    def axes(tree):
        if _is_cache_leaf(tree):
            return tree[1]
        return {k: axes(v) for k, v in tree.items()}
    return axes(model.cache_decls(batch, max_len))
