"""LM assembly: the decoder-only dense, MoE, SSM (mamba2) and hybrid
(hymba) families share one generic block, which the enc-dec (seamless)
and VLM (llama-3.2-vision) families extend with a gated cross-attention
branch (models/model.py assembles those two).

Layer segmentation: archs with heterogeneous layers (hymba's 3 global-
attention layers among sliding-window layers) are split into *segments* --
unstacked singles and stacked runs -- so every stacked run is homogeneous.

Modes:
  train   -- full sequence, no cache, each block under the remat policy,
             MoE aux losses accumulated
  prefill -- full sequence, last-position logits + KV/SSM/cross cache out
  decode  -- one token against the cache

Mirrors ``src/repro/models/transformer.py``: the reference's ``lax.scan``
over a segment's stacked layer dimension is a Python loop over it, and
parameters and caches keep the reference's stacked layout (a leading
layers dimension).  One routing decision is the port's own: every train
or prefill attention over full (unwindowed) context goes to the Hopper
flash kernel that replaces the reference's Pallas ``flash_attention``,
where the reference computes the same function with ``attend`` (self)
or ``attend_full`` / ``attend_chunked`` (cross): the causal
self-attention, and with ``causal=False`` the enc-dec encoder's
self-attention and every cross-attention layer (q against the memory's
k and v, T keys).  Prefill launches the forward kernel
(``kernels.ops.flash_attention``, ``flash_prefill``); training sends the
same views through ``kernels.ops.flash_attention_train`` (the forward
kernel, and the port's backward kernel for its gradient).  Windowed
layers and decode take ``attend`` / ``attend_full`` as in the reference,
the cross layers' decode step too (S = 1 against the cached memory).
The kernel keeps P.V in f32 where ``attend_full`` casts the
probabilities to bf16 first: the two differ by about one bf16 ulp of the
context.  The reference's remat policies (``_remat``) become
``torch.utils.checkpoint`` (non-reentrant, one block at a time):
"minimal" saves only each block's input, "dots" saves the matmul outputs
too, "none" recomputes nothing.  A stacked segment may also arrive as a
list of per-layer trees: the training path hands the model per-layer
leaves, since the gradient of a layer's view of a stacked leaf would
allocate a zero tensor of the whole leaf for every layer.  With
``kv_quant`` the cache holds int8 codes and f32 scales
(``attention.quantize_kv``): prefill attends on the unquantized k/v and
quantizes its cache; decode writes the new step's codes and scales in
place, then dequantizes the whole cache and attends, as the reference
does.  An SSM block (``models/ssm.py``) runs the chunked SSD in train and
prefill, whose cache is the final state and the last ``d_conv`` pre-conv
projections, and the recurrent step in decode, which writes the state and
the conv rings in place; a hybrid block runs attention and the SSD side by
side on the same normed input and fuses them as ``0.5 * (a * attn_scale +
s * ssm_scale)``.  Hymba's hybrid blocks declare ``ln_ssm``, as the
reference's do, and never read it (its gradient is zero).  A block
declared with ``cross=True`` adds ``ln_cross`` and ``cross`` (q, k, v, o
weights and a zero-initialised gate): ``_cross_branch`` projects the
memory's k and v in prefill, caches them, reads them back in decode, and
adds ``tanh(gate) * o(ctx)`` to the residual after the self-attention
(or SSM) branch, before the FFN.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Dict, List, Optional

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..configs.base import ArchConfig
from ..kernels import ops
from . import attention as attn
from . import ssm as ssm_mod
from .layers import (embed_decls, mlp_apply, mlp_decls, rmsnorm,
                     rmsnorm_decl)
from .moe import moe_apply, moe_decls
from .params import Decls, ParamDecl

CACHE_DTYPE = torch.bfloat16


# ---------------------------------------------------------------------------
# Segments
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Segment:
    name: str
    n_layers: int          # 1 for singles
    scanned: bool
    window: Optional[int]  # None = full attention


def segments(cfg: ArchConfig) -> List[Segment]:
    if not cfg.global_layers or cfg.window is None:
        return [Segment("layers", cfg.n_layers, cfg.n_layers > 1, cfg.window)]
    segs: List[Segment] = []
    prev = 0
    for i, g in enumerate(sorted(cfg.global_layers)):
        if g > prev:
            segs.append(Segment(f"swa_{i}", g - prev, g - prev > 1,
                                cfg.window))
        segs.append(Segment(f"global_{i}", 1, False, None))
        prev = g + 1
    if prev < cfg.n_layers:
        segs.append(Segment(f"swa_tail", cfg.n_layers - prev,
                            cfg.n_layers - prev > 1, cfg.window))
    assert sum(s.n_layers for s in segs) == cfg.n_layers
    return segs


def _stack_decls(decls: Decls, n: int) -> Decls:
    """Prepend a scanned 'layers' dim to every leaf."""
    out = {}
    for k, v in decls.items():
        if isinstance(v, ParamDecl):
            out[k] = ParamDecl((n,) + v.shape, ("layers",) + v.axes,
                               v.init, v.scale)
        else:
            out[k] = _stack_decls(v, n)
    return out


# ---------------------------------------------------------------------------
# Generic block
# ---------------------------------------------------------------------------

def block_decls(cfg: ArchConfig, tp: int, *, cross: bool = False) -> Decls:
    d = cfg.d_model
    decls: Decls = {}
    if cfg.n_heads:
        layout = attn.resolve_head_layout(cfg.n_heads, cfg.n_kv_heads,
                                          cfg.resolved_head_dim, tp)
        decls["ln1"] = rmsnorm_decl(d)
        decls["attn"] = attn.attention_decls(d, layout, cfg.qk_norm)
    if cfg.ssm is not None:
        lo = ssm_mod.resolve_ssm_layout(d, cfg.ssm, tp)
        # declared for every SSM block, as in the reference; only the pure
        # SSM branch reads it (the hybrid normalises with ln1)
        decls["ln_ssm"] = rmsnorm_decl(d)
        decls["ssm"] = ssm_mod.ssm_decls(d, lo)
        if cfg.family == "hybrid":
            # per-branch learned output scales (Hymba's branch fusion)
            decls["attn_scale"] = ParamDecl((d,), (None,), init="ones")
            decls["ssm_scale"] = ParamDecl((d,), (None,), init="ones")
    if cross:
        layout = attn.resolve_head_layout(cfg.n_heads, cfg.n_kv_heads,
                                          cfg.resolved_head_dim, tp)
        decls["ln_cross"] = rmsnorm_decl(d)
        decls["cross"] = attn.attention_decls(d, layout, False, cross=True)
    if cfg.moe is not None:
        decls["ln2"] = rmsnorm_decl(d)
        decls["moe"] = moe_decls(d, cfg.moe)
    elif cfg.d_ff:
        decls["ln2"] = rmsnorm_decl(d)
        decls["mlp"] = mlp_decls(d, cfg.d_ff, cfg.mlp)
    return decls


def flash_prefill(q, k, v, causal: bool = True):
    """Attention of a prefill through the flash kernel: q (B,S,K,G,H) goes
    in as the view (B,K,G,S,H) and k, v (B,T,K,H) as views (B,K,1,T,H).
    The kernel reads them through their strides, each kv head once for its
    G query heads, and writes its output in q's (B,S,K,G,H) order, so no
    side makes a copy.  ``causal`` masks key t > query s by index (self-
    attention, where both are positions 0..S-1); without it every query
    sees all T keys (the encoder, cross-attention)."""
    out = ops.flash_attention(q.permute(0, 2, 3, 1, 4),
                              k.permute(0, 2, 1, 3).unsqueeze(2),
                              v.permute(0, 2, 1, 3).unsqueeze(2),
                              causal=causal)
    return out.permute(0, 3, 1, 2, 4)


def flash_train(q, k, v, causal: bool = True):
    """``flash_prefill`` with a gradient: the same views through
    ``ops.flash_attention_train``, whose backward hands back gradients of
    the views' shapes."""
    out = ops.flash_attention_train(q.permute(0, 2, 3, 1, 4),
                                    k.permute(0, 2, 1, 3).unsqueeze(2),
                                    v.permute(0, 2, 1, 3).unsqueeze(2),
                                    causal=causal)
    return out.permute(0, 3, 1, 2, 4)


def _attn_branch(cfg, layout, p, h, *, mode, window, positions, cache, pos,
                 causal: bool = True, max_len: Optional[int] = None,
                 kv_quant: bool = False):
    """Self-attention on pre-normed h; returns (out, cache_out)."""
    q, k, v = attn.project_qkv(p, h, layout, positions=positions,
                               rope_theta=cfg.rope_theta, qk_norm=cfg.qk_norm)
    if mode == "decode":
        if kv_quant:
            kq, ks = attn.quantize_kv(k)
            vq, vs = attn.quantize_kv(v)
            attn.cache_update(cache["k"]["q"], cache["v"]["q"], kq, vq, pos,
                              window)
            attn.cache_update(cache["k"]["s"], cache["v"]["s"], ks, vs, pos,
                              window)
            ck = attn.dequantize_kv(cache["k"]["q"], cache["k"]["s"],
                                    q.dtype)
            cv = attn.dequantize_kv(cache["v"]["q"], cache["v"]["s"],
                                    q.dtype)
            return attn.attend_decode(q, ck, cv, pos, window), cache
        ck, cv = attn.cache_update(cache["k"], cache["v"], k, v, pos, window)
        ctx = attn.attend_decode(q, ck, cv, pos, window)
        return ctx, {"k": ck, "v": cv}
    if window is None:
        # q and k share the sequence's positions, arange(S) (model.py), so
        # the kernel's causal mask by index is the mask by position
        ctx = (flash_train if mode == "train" else flash_prefill)(
            q, k, v, causal=causal)
    else:
        pos1d = positions[0]
        ctx = attn.attend(q, k, v, pos1d, pos1d, causal=causal,
                          window=window)
    if mode == "train":
        return ctx, None
    S = k.shape[1]
    cap = max_len or S
    if window:
        # ring buffer of T slots, the declared cache (cache_decl_shapes:
        # min(cap, window)); token p lives at slot p % T.  The reference
        # pads a prompt shorter than the window to ``window`` slots
        # (repro/models/transformer.py:144-152), more than it declares;
        # slots past the prompt are masked in decode either way.
        T = min(cap, window)
        W = min(S, T)
        kw, vw = k[:, S - W:], v[:, S - W:]
        if W < T:
            kw = torch.nn.functional.pad(kw, (0, 0, 0, 0, 0, T - W))
            vw = torch.nn.functional.pad(vw, (0, 0, 0, 0, 0, T - W))
        kc = torch.roll(kw, (S - W) % T, dims=1)
        vc = torch.roll(vw, (S - W) % T, dims=1)
    else:
        pad = cap - S
        kc = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad)) if pad else k
        vc = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad)) if pad else v
    if kv_quant:
        kq, ks = attn.quantize_kv(kc)
        vq, vs = attn.quantize_kv(vc)
        return ctx, {"k": {"q": kq, "s": ks}, "v": {"q": vq, "s": vs}}
    return ctx, {"k": kc.to(CACHE_DTYPE), "v": vc.to(CACHE_DTYPE)}


def _cross_branch(cfg, tp, p, x, *, mode, memory, cache):
    """Cross-attention to a (B,T,d) memory (encoder output / image
    embeddings): q from the normed residual, no RoPE and no qk-norm; K/V
    projected per layer from the memory (train/prefill, and cached by
    prefill) or read from the cache (decode, which hands the cache back
    unchanged).  Gated (tanh, zero-init) like Llama-3.2's image layers.
    Returns (out, cache_out)."""
    layout = attn.resolve_head_layout(cfg.n_heads, cfg.n_kv_heads,
                                      cfg.resolved_head_dim, tp)
    h = rmsnorm(p["ln_cross"], x)
    q = torch.einsum("bsd,dkgh->bskgh", h, p["cross"]["wq"].to(h.dtype))
    if mode == "decode":
        # one query against every cached key: no mask
        T = cache["k"].shape[1]
        ctx = attn.attend_full(
            q, cache["k"].to(h.dtype), cache["v"].to(h.dtype),
            torch.zeros(1, dtype=torch.int32, device=h.device),
            torch.zeros(T, dtype=torch.int32, device=h.device),
            causal=False, window=None)
        cache_out = cache
    else:
        mem = memory.to(h.dtype)
        ik = torch.einsum("btd,dkh->btkh", mem, attn._expand_kv_weight(
            p["cross"]["wk"].to(h.dtype), layout))
        iv = torch.einsum("btd,dkh->btkh", mem, attn._expand_kv_weight(
            p["cross"]["wv"].to(h.dtype), layout))
        ctx = (flash_train if mode == "train" else flash_prefill)(
            q, ik, iv, causal=False)
        cache_out = None if mode == "train" else \
            {"k": ik.to(CACHE_DTYPE), "v": iv.to(CACHE_DTYPE)}
    gate = torch.tanh(p["cross"]["gate"].to(h.dtype))
    return gate * attn.output_proj(p["cross"], ctx, layout), cache_out


def block_apply(cfg: ArchConfig, tp: int, p: Dict[str, Any],
                x: torch.Tensor, *, mode: str, window: Optional[int],
                positions: Optional[torch.Tensor],
                cache: Optional[Dict[str, Any]] = None,
                pos: Optional[int] = None,
                memory: Optional[torch.Tensor] = None, causal: bool = True,
                max_len: Optional[int] = None, kv_quant: bool = False):
    """One decoder block. Returns (x, cache_out, aux_loss): the MoE
    FFN's load-balance loss in train mode, else 0.0 (a Python float, so a
    dense block launches nothing for it).  A block with ``cross`` params
    runs its cross branch when given a ``memory`` (train, prefill) or a
    cache holding ``cross`` (decode)."""
    aux = 0.0
    cache = cache or {}
    cache_out: Dict[str, Any] = {}
    if cfg.n_heads and "attn" in p:
        layout = attn.resolve_head_layout(cfg.n_heads, cfg.n_kv_heads,
                                          cfg.resolved_head_dim, tp)
        h = rmsnorm(p["ln1"], x)
        ctx, c_attn = _attn_branch(cfg, layout, p["attn"], h, mode=mode,
                                   window=window, positions=positions,
                                   cache=cache.get("attn"), pos=pos,
                                   causal=causal, max_len=max_len,
                                   kv_quant=kv_quant)
        a_out = attn.output_proj(p["attn"], ctx, layout)
        if mode != "train":
            cache_out["attn"] = c_attn
        if cfg.family == "hybrid":
            # parallel attention + SSM branches on the same input (Hymba)
            s_out, c_ssm = _ssm_branch(cfg, tp, p, h, mode=mode,
                                       cache=cache.get("ssm"))
            x = x + 0.5 * (a_out * p["attn_scale"].to(a_out.dtype)
                           + s_out * p["ssm_scale"].to(s_out.dtype))
            if mode != "train":
                cache_out["ssm"] = c_ssm
        else:
            x = x + a_out
    elif cfg.ssm is not None:
        # pure SSM family (mamba2): norm -> SSD -> residual
        h = rmsnorm(p["ln_ssm"], x)
        s_out, c_ssm = _ssm_branch(cfg, tp, p, h, mode=mode,
                                   cache=cache.get("ssm"))
        x = x + s_out
        if mode != "train":
            cache_out["ssm"] = c_ssm
    if "cross" in p and (memory is not None or "cross" in cache):
        c_out, c_cache = _cross_branch(cfg, tp, p, x, mode=mode,
                                       memory=memory,
                                       cache=cache.get("cross"))
        x = x + c_out
        if mode != "train":
            cache_out["cross"] = c_cache
    if cfg.moe is not None:
        h = rmsnorm(p["ln2"], x)
        mo, moe_aux = moe_apply(p["moe"], h, cfg.moe)
        x = x + mo
        if mode == "train":
            aux = moe_aux
    elif cfg.d_ff:
        h = rmsnorm(p["ln2"], x)
        x = x + mlp_apply(p["mlp"], h, cfg.mlp)
    return x, (cache_out or None), aux


def _ssm_branch(cfg, tp, p, h, *, mode, cache):
    """The SSD mixer on pre-normed h; returns (out, cache_out): decode
    steps the recurrence and writes ``cache`` in place, prefill runs the
    chunked form and builds the cache, train builds none."""
    lo = ssm_mod.resolve_ssm_layout(cfg.d_model, cfg.ssm, tp)
    if mode == "decode":
        return ssm_mod.ssm_decode_step(p["ssm"], cache, h, lo)
    if mode == "prefill":
        s_out, s_state = ssm_mod.ssd_apply(p["ssm"], h, lo, cfg.ssm.chunk,
                                           return_state=True)
        return s_out, _ssm_prefill_cache(p, h, lo, s_state)
    return ssm_mod.ssd_apply(p["ssm"], h, lo, cfg.ssm.chunk), None


def _ssm_prefill_cache(p, h, lo, s_state):
    """Conv tail (last d_conv inputs of each conv stream) + final state.
    Only the last d_conv positions are projected (cheap)."""
    K = lo.d_conv
    tail = h[:, -K:]
    _, xs, Bm, Cm, _ = ssm_mod._project(p["ssm"], tail, lo)
    return {"state": s_state,
            "conv_x": xs.to(CACHE_DTYPE),
            "conv_B": Bm.to(CACHE_DTYPE),
            "conv_C": Cm.to(CACHE_DTYPE)}


# ---------------------------------------------------------------------------
# Whole-model decls / apply
# ---------------------------------------------------------------------------

def decoder_decls(cfg: ArchConfig, tp: int) -> Decls:
    decls: Decls = dict(embed_decls(cfg.vocab_size, cfg.d_model,
                                    cfg.tie_embeddings))
    for seg in segments(cfg):
        b = block_decls(cfg, tp)
        decls[seg.name] = _stack_decls(b, seg.n_layers) if seg.scanned else b
    decls["ln_f"] = rmsnorm_decl(cfg.d_model)
    return decls


def _layer(tree, i: int):
    """Layer ``i`` of a stacked tree (views, so in-place cache writes reach
    the stacked tensors), or entry ``i`` of a list of per-layer trees."""
    if isinstance(tree, list):
        return tree[i]
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """jax's ``checkpoint_dots``: keep every matmul output, recompute the
    rest."""
    return CheckpointPolicy.MUST_SAVE if op in _DOTS \
        else CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, policy: str):
    if policy == "none":
        return fn
    if policy == "dots":
        return partial(checkpoint, fn, use_reentrant=False,
                       context_fn=partial(
                           create_selective_checkpoint_contexts, _save_dots))
    if policy != "minimal":
        raise ValueError(f"remat policy {policy!r}: minimal, dots or none")
    return partial(checkpoint, fn, use_reentrant=False)  # block boundaries


def run_decoder(cfg: ArchConfig, tp: int, params: Dict[str, Any],
                x: torch.Tensor, *, mode: str,
                positions: Optional[torch.Tensor] = None,
                caches: Optional[Dict[str, Any]] = None,
                pos: Optional[int] = None,
                memory: Optional[torch.Tensor] = None, causal: bool = True,
                max_len: Optional[int] = None, kv_quant: bool = False,
                remat_policy: str = "minimal"):
    """Run all segments. Returns (x, caches_out, aux): aux sums the
    blocks' load-balance losses in train mode (0.0 where there are none).
    ``memory`` feeds the blocks' cross branches (an enc-dec decoder).  In
    decode the caches are written in place and returned; train returns
    no caches."""
    if mode not in ("train", "prefill", "decode"):
        raise NotImplementedError(f"mode={mode!r}: the port runs train, "
                                  f"prefill and decode")
    aux_total = 0.0
    if mode == "train":
        for seg in segments(cfg):
            fn = partial(block_apply, cfg, tp, mode="train",
                         window=seg.window, positions=positions,
                         memory=memory, causal=causal)
            body = _remat(lambda p, h, _fn=fn: _fn(p, h)[::2], remat_policy)
            p_seg = params[seg.name]
            for i in range(seg.n_layers if seg.scanned else 1):
                x, aux = body(_layer(p_seg, i) if seg.scanned else p_seg, x)
                aux_total = aux_total + aux
        return x, None, aux_total
    caches = caches or {}
    caches_out: Dict[str, Any] = {}
    for seg in segments(cfg):
        p_seg = params[seg.name]
        c_seg = caches.get(seg.name)
        kw = dict(mode=mode, window=seg.window, positions=positions,
                  pos=pos, memory=memory, causal=causal, max_len=max_len,
                  kv_quant=kv_quant)
        if not seg.scanned:
            x, caches_out[seg.name], _ = block_apply(cfg, tp, p_seg, x,
                                                     cache=c_seg, **kw)
            continue
        outs = []
        for i in range(seg.n_layers):
            c_l = None if c_seg is None else _layer(c_seg, i)
            x, c_out, _ = block_apply(cfg, tp, _layer(p_seg, i), x,
                                      cache=c_l, **kw)
            outs.append(c_out)
        caches_out[seg.name] = c_seg if mode == "decode" else _stack(outs)
    return x, caches_out, aux_total
