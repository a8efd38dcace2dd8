"""End-to-end LM training driver.

Builds the model from a config, sets up AdamW with a warmup-cosine
schedule, the deterministic token stream, checkpoints, the step-time
watchdog and the preemption guard, then drives ``TrainRunner``; a run
whose checkpoint directory holds a checkpoint resumes from it.

    python -m repro_torch.launch.train --arch tinyllama-1.1b --smoke \\
        --steps 50 --ckpt-dir ckpt
    python -m repro_torch.launch.train --device cpu --smoke --arch zamba2-2.7b

``main`` returns the per-step metrics log.  Weights are drawn from a
seeded ``torch.Generator``; :func:`run` starts from a given parameter
tree instead.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Any, Dict, List

import torch


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="Train an LM on the "
                                 "synthetic repeat-copy stream.")
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--moment-dtype", default="float32")
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def make_loss(model):
    """``loss(params, batch)``: the mean cross-entropy of a train-mode
    forward; a frontend arch gets zero prefix frames."""
    from repro_torch.models.lm import cross_entropy
    from repro_torch.models.lm.params import as_dtype

    cfg = model.cfg

    def loss_fn(params, batch):
        kw = {}
        if cfg.frontend != "none":
            toks = batch["tokens"]
            kw["prefix_embed"] = torch.zeros(
                (toks.shape[0], cfg.frontend_len, cfg.d_model),
                dtype=as_dtype(cfg.compute_dtype), device=toks.device)
        logits = model.forward(params, batch["tokens"], mode="train", **kw)
        return cross_entropy(logits, batch["labels"])

    return loss_fn


def make_step(model, opt_update, *, n_micro: int = 1,
              grad_compression: bool = False):
    """``step((params, opt_state, residual), batch) -> (state, {"loss",
    "grad_norm"})``: the gradient of :func:`make_loss` (over ``n_micro``
    microbatches), optional BFP compression with error feedback,
    clipping at 1.0 and one optimizer update."""
    from repro_torch.optim import clip_by_global_norm
    from repro_torch.optim.grad_utils import (GradAccumulator,
                                              error_feedback_compress)

    loss_fn = make_loss(model)
    accum = GradAccumulator(n_micro)

    def step(state, batch):
        params, opt_state, residual = state
        loss, grads = accum(loss_fn, params, batch)
        if grad_compression:
            grads, residual = error_feedback_compress(grads, residual)
        grads, gnorm = clip_by_global_norm(grads, 1.0)
        params, opt_state = opt_update(grads, opt_state, params)
        return (params, opt_state, residual), {"loss": loss,
                                               "grad_norm": gnorm}

    return step


def run(args: argparse.Namespace, params=None) -> List[Dict[str, Any]]:
    """Train from ``params`` (a tree on any device; None draws one from
    ``torch.Generator().manual_seed(0)``) and return the metrics log."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core import tree as tree_lib
    from repro_torch.data import TokenDataset
    from repro_torch.models.lm import LMModel
    from repro_torch.optim import adamw, cosine_with_warmup
    from repro_torch.optim.grad_utils import init_residual
    from repro_torch.runtime.fault_tolerance import (PreemptionGuard,
                                                     TrainRunner, Watchdog)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = LMModel(cfg, args.device)
    dev = model.device
    ds = TokenDataset(cfg.vocab, args.seq, args.batch, seed=0)
    opt_init, opt_update = adamw(
        cosine_with_warmup(args.lr, 20, max(args.steps, 21)),
        moment_dtype=args.moment_dtype, weight_decay=0.01)
    step = make_step(model, opt_update, n_micro=args.n_micro,
                     grad_compression=args.grad_compression)
    if params is None:
        params = model.init_params(torch.Generator(dev).manual_seed(0))
    params = tree_lib.tree_map(lambda t: t.to(dev), params)
    residual = init_residual(params) if args.grad_compression \
        else torch.zeros((), device=dev)
    state = (params, opt_init(params), residual)

    ckpt_dir = args.ckpt_dir or os.path.join(tempfile.gettempdir(),
                                             f"repro_{args.arch}")

    def batch_fn(i):
        return {k: torch.from_numpy(v).to(dev)
                for k, v in ds.batch(i).items()}

    guard = PreemptionGuard(install=True)
    runner = TrainRunner(step, batch_fn,
                         CheckpointManager(ckpt_dir, keep=3),
                         ckpt_every=args.ckpt_every, watchdog=Watchdog(),
                         guard=guard)
    try:
        start, state = runner.resume_or_init(state)
        if start:
            print(f"[train] resumed from step {start}")
        t0 = time.time()
        last, state, status = runner.run(state, start, args.steps - start,
                                         fail_at=args.fail_at)
    finally:
        guard.uninstall()
    dt = time.time() - t0
    logs = runner.metrics_log
    for m in logs[::max(args.log_every, 1)]:
        print(f"[train] step {int(m['step']):5d} loss {m['loss']:.4f} "
              f"dt {m['dt'] * 1e3:.0f}ms")
    if logs:
        print(f"[train] {status} at step {last}; final loss "
              f"{logs[-1]['loss']:.4f}; {dt:.1f}s total; straggler "
              f"incidents: {len(runner.watchdog.incidents)}")
    return logs


def main(argv=None) -> List[Dict[str, Any]]:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
