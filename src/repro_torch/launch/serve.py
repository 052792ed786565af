"""Batched serving: prefill a batch of prompts, then decode with the
cache (KV, and an SSM layer's state and conv rings).

Usage:
  python -m repro_torch.launch.serve --arch qwen3-4b --tokens 32
  python -m repro_torch.launch.serve --device cpu      # without a GPU

Mirrors ``src/repro/launch/serve.py``, with its flags and its seeded
random weights and prompts, plus ``--device`` (``cuda`` unless the caller
asks for the CPU).  As in the reference, ``--reduced`` is a store_true
flag whose default is already True, so the command line always runs the
reduced config; ``generate`` takes any model, full width included.
Sampling is greedy: the reference parses ``--temperature`` and does not
use it.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from .. import configs
from ..models import build_model


@dataclasses.dataclass
class Generation:
    tokens: torch.Tensor     # (B, n_new) int32: the prefill's argmax, then
    #                          one token per decode step
    prefill_s: float         # host seconds of the prefill, synchronised
    decode_s: float          # host seconds of the n_new - 1 decode steps
    decode_steps: int


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def generate(model, params: Dict[str, Any], tokens: torch.Tensor,
             n_new: int) -> Generation:
    """Greedy generation: prefill ``tokens`` (B, S) into a cache of
    S + n_new slots (a windowed layer's ring holds at most its window; an
    SSM layer's state does not grow), take the argmax, then ``n_new - 1``
    decode steps."""
    B, S = tokens.shape
    _sync(tokens.device)
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, {"tokens": tokens},
                                  max_len=S + n_new)
    nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
    _sync(tokens.device)
    t_prefill = time.perf_counter() - t0
    outs = [nxt]
    t0 = time.perf_counter()
    for i in range(n_new - 1):
        logits, cache = model.decode_step(params, cache, nxt, S + i)
        nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        outs.append(nxt)
    _sync(tokens.device)
    return Generation(torch.cat(outs, dim=1), t_prefill,
                      time.perf_counter() - t0, n_new - 1)


def main(argv: Optional[Sequence[str]] = None) -> Generation:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg, tp=1, device=args.device)
    params = model.init_params(seed=0)
    print(f"[serve] arch={cfg.name} params={model.n_params:,} "
          f"device={model.device}")

    rng = np.random.default_rng(0)
    B, S = args.batch, args.prompt_len
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                             dtype=torch.int32, device=model.device)
    gen = generate(model, params, tokens, args.tokens)
    print(f"[serve] prefill {B}x{S} in {gen.prefill_s:.2f}s "
          f"({B*S/gen.prefill_s:,.0f} tok/s)")
    print(f"[serve] decoded {gen.decode_steps} steps x {B} seqs in "
          f"{gen.decode_s:.2f}s "
          f"({gen.decode_steps*B/max(gen.decode_s,1e-9):,.0f} tok/s)")
    print(f"[serve] sample generations (token ids):")
    ids = gen.tokens.cpu().numpy()
    for b in range(min(B, 2)):
        print(f"  seq{b}: {ids[b][:16].tolist()}")
    return gen


if __name__ == "__main__":
    main()
