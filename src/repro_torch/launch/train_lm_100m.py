"""LM pretraining end to end: a ~100M-parameter llama-family model for a
few hundred steps on the synthetic repeat-copy stream, with the training
substrate in full: step-indexed data, AdamW (optionally BFP8 first
moments), clipping, async checkpoints, the watchdog, and a crash in the
middle of the run followed by a bit-exact resume.

    python -m repro_torch.launch.train_lm_100m --steps 200 --crash-at 120

Passes when the mean loss of the last 10 steps is more than 0.5 below
that of the first 10, and prints ``train_lm_100m OK``.

One departure from the JAX package's example makes that condition
reachable: the batch is 32 sequences, not 8.  The reference's own run
(batch 8, its init) ends 8.782 -> 8.789 and fails it; the port's init
(``LMModel.init_params``: attention projections at their true fan-in)
at batch 8 reaches only the uniform loss in 200 steps (8.800 -> 8.345),
and at batch 32 passes.  On the init as drawn no batch learns (batch 32:
8.781 -> 8.814): its softmaxes are near one-hot and its gradients grow
with depth.
"""
from __future__ import annotations

import argparse
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import ArchConfig
from repro_torch.core import tree as tree_lib
from repro_torch.data import TokenDataset
from repro_torch.launch.train import make_step
from repro_torch.models.lm import LMModel
from repro_torch.optim import adamw, cosine_with_warmup
from repro_torch.runtime.fault_tolerance import TrainRunner, Watchdog

# ~100M params: 12 layers x 768 (GPT-2-small class), llama-style blocks
CFG_100M = ArchConfig(
    name="llama-100m", family="dense", n_layers=12, d_model=768,
    n_heads=12, n_kv_heads=4, d_ff=2048, vocab=4096,
    param_dtype="float32", compute_dtype="float32", remat=False,
)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="Train a ~100M-parameter LM "
                                 "with a crash and resume in the middle.")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--moment-dtype", default="float32")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_lm100m"))
    ap.add_argument("--crash-at", type=int, default=0,
                    help="inject a crash at this step to show the resume")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    model = LMModel(CFG_100M, args.device)
    dev = model.device
    params = model.init_params(torch.Generator(dev).manual_seed(0))
    n_params = sum(t.numel() for t in tree_lib.leaves(params))
    print(f"[lm100m] {n_params / 1e6:.1f}M params")

    ds = TokenDataset(CFG_100M.vocab, args.seq, args.batch, seed=0)
    opt_init, opt_update = adamw(
        cosine_with_warmup(args.lr, 20, args.steps),
        moment_dtype=args.moment_dtype, weight_decay=0.01)

    step_fn = make_step(model, opt_update)

    def batch_fn(i):
        return {k: torch.from_numpy(v).to(dev)
                for k, v in ds.batch(i).items()}

    state = (params, opt_init(params), torch.zeros((), device=dev))
    shutil.rmtree(args.ckpt_dir, ignore_errors=True)
    runner = TrainRunner(step_fn, batch_fn,
                         CheckpointManager(args.ckpt_dir, keep=2),
                         ckpt_every=50, watchdog=Watchdog())
    t0 = time.time()
    try:
        step, state, status = runner.run(state, 0, args.steps,
                                         fail_at=args.crash_at or None)
    except RuntimeError as e:
        print(f"[lm100m] {e}: resuming from the latest checkpoint")
        resumed = TrainRunner(step_fn, batch_fn,
                              CheckpointManager(args.ckpt_dir, keep=2),
                              ckpt_every=50)
        start, state = resumed.resume_or_init(state)
        step, state, status = resumed.run(state, start, args.steps - start)
        runner.metrics_log += resumed.metrics_log

    logs = runner.metrics_log
    first = float(np.mean([m["loss"] for m in logs[:10]]))
    last = float(np.mean([m["loss"] for m in logs[-10:]]))
    for m in logs[::max(len(logs) // 10, 1)]:
        print(f"[lm100m] step {int(m['step']):4d} loss {m['loss']:.4f}")
    print(f"[lm100m] loss {first:.3f} -> {last:.3f} in "
          f"{time.time() - t0:.0f}s ({status})")
    if not last < first - 0.5:
        raise RuntimeError(f"the model must learn the repeat-copy "
                           f"structure: loss {first:.3f} -> {last:.3f}")
    print("train_lm_100m OK")
    return {"first": first, "last": last, "steps": len(logs),
            "status": status}


if __name__ == "__main__":
    main()
