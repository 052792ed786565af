"""End-to-end training driver (the same structure a pod job would run).

Pipeline: columnar token store (Vertica projection, data epoch pinned)
-> batches -> train_step -> epoch-based K-safe checkpoints.  Failure
injection (--fail-at-step) exercises buddy restore + deterministic
replay mid-run.

Usage:
  python -m repro_torch.launch.train --arch qwen3-4b --reduced --steps 100
  python -m repro_torch.launch.train --d-model 512 --layers 8 --steps 200
  python -m repro_torch.launch.train --device cpu      # without a GPU

Mirrors ``src/repro/launch/train.py``, with its flags, its loop, its
checkpoints and its replay, plus ``--device`` (``cuda`` unless the caller
asks for the CPU).  On CUDA the run is deterministic, so a replay after a
failure ends in the same state bit for bit: ``main`` sets
``CUBLAS_WORKSPACE_CONFIG`` (when the caller has not) before the first
CUDA call and turns on ``torch.use_deterministic_algorithms``
(the embedding gather's backward accumulates in a fixed order then);
the attention backward kernel uses no atomics.  Returns the losses.
"""
from __future__ import annotations

import argparse
import os
import pathlib
import time
from typing import List, Optional, Sequence

import torch

from .. import configs
from ..configs.base import ArchConfig, RunConfig
from ..data import TokenStore, token_corpus
from ..kernels import ops
from ..models import build_model
from ..models.params import resolve_device
from ..train.checkpoint import CheckpointStore, shard_state, unshard_state
from ..train.train_step import (init_train_state, make_train_step,
                                train_state_from_numpy, train_state_to_numpy)


def build_cfg(args) -> ArchConfig:
    if args.arch:
        cfg = configs.get(args.arch)
        return cfg.reduced() if args.reduced else cfg
    return ArchConfig(
        name=f"custom-{args.layers}L-{args.d_model}d",
        family="dense", n_layers=args.layers, d_model=args.d_model,
        n_heads=args.d_model // 64, n_kv_heads=args.d_model // 64,
        d_ff=args.d_model * 4, vocab_size=args.vocab, head_dim=64)


def main(argv: Optional[Sequence[str]] = None) -> List[float]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--vocab", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--ckpt-dir", default="results/ckpt")
    ap.add_argument("--fail-at-step", type=int, default=None)
    ap.add_argument("--n-docs", type=int, default=256)
    ap.add_argument("--doc-len", type=int, default=512)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device, "train")     # no GPU: raises
    if device.type == "cuda":
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True)
    cfg = build_cfg(args)
    rc = RunConfig(learning_rate=args.lr, total_steps=args.steps,
                   warmup_steps=max(1, args.steps // 10))
    model = build_model(cfg, tp=1, device=device)
    print(f"[train] arch={cfg.name} params={model.n_params:,}", flush=True)

    # --- corpus through the columnar store (bulk ingest -> tuple mover) ---
    store = TokenStore.create(n_nodes=4, device=device)
    corpus = token_corpus(args.n_docs, args.doc_len, cfg.vocab_size)
    data_epoch = store.ingest(corpus)
    st = store.storage_stats()
    print(f"[train] corpus: {st['rows']:,} tokens in {st['containers']} "
          f"containers, compression {st['ratio']:.2f}x, "
          f"data epoch {data_epoch}", flush=True)

    state = init_train_state(model, 0)
    step_fn = make_train_step(model, rc)
    ckpt = CheckpointStore(pathlib.Path(args.ckpt_dir) / cfg.name,
                           n_shards=4)

    def stream():
        while True:
            yield from store.batches(args.batch, args.seq,
                                     as_of=data_epoch, seed=0)

    batches = stream()
    t0 = time.time()
    losses = []
    step = 0
    while step < args.steps:
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in next(batches).items()}
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
        step += 1
        if step % 10 == 0 or step == 1:
            dt = time.time() - t0
            tok_s = step * args.batch * args.seq / dt
            print(f"[train] step {step:4d} loss {losses[-1]:.4f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"gnorm {float(metrics['grad_norm']):.2f} "
                  f"{tok_s:,.0f} tok/s", flush=True)
        if step % args.ckpt_every == 0 or step == args.steps:
            np_state = train_state_to_numpy(state)
            for shard in range(4):
                ckpt.save_shard(step, shard, shard_state(np_state, shard, 4))
            ckpt.commit_epoch(step, {"loss": losses[-1]})
            print(f"[train] checkpoint @ step {step} (K-safe x2)",
                  flush=True)
        if args.fail_at_step and step == args.fail_at_step:
            print(f"[train] !!! injecting node-1 failure at step {step}",
                  flush=True)
            lge = ckpt.last_good_epoch()
            np_state = train_state_to_numpy(state)
            shards = [ckpt.restore_shard(lge, s, shard_state(np_state, s, 4),
                                         lost_nodes=(1,)) for s in range(4)]
            full = unshard_state(shards, np_state)
            del state
            state = train_state_from_numpy(full, device)
            # deterministic replay: rewind the stream to the LGE
            batches = stream()
            for _ in range(lge):
                next(batches)
            step = lge
            args.fail_at_step = None
            print(f"[train] recovered from LGE {lge}, replaying", flush=True)
    print(f"[train] done: loss {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"in {time.time()-t0:.1f}s", flush=True)
    counts = {k: n for k, n in ops.launch_counts().items() if n}
    print(f"[train] kernel launches: {counts}", flush=True)
    return losses


if __name__ == "__main__":
    main()
