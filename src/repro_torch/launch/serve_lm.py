"""LM serving: prefill with a KV/SSM cache, then batched greedy decode,
optionally with BFP-stored weights (paper C2 as a serving-bandwidth
feature).

Prefill runs attention through K4 (``use_flash``) and the Mamba2 scan
through K5 (``use_kernel``); decode is torch ops.  While a profile is
active (``runtime/telemetry.SPANS``) each prefill is an ``lm.prefill``
span counting ``tokens``, ``batch`` and the K4 and K5 launches it made
(``k4.launches``, ``k5.launches``); a stack with explicit hybrid sites
adds ``lm.shared`` and ``lm.mamba`` beneath it.  On the CPU (smoke):

    PYTHONPATH=src python -m repro_torch.launch.serve_lm --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve_lm --device cpu \
        --arch whisper-tiny

``--device`` defaults to ``cuda``; ``--arch`` takes any id of
``repro_torch.configs`` and serves its smoke configuration with seeded
random weights.  A frontend arch (``audio``, ``vlm``) gets seeded
``prefix_embed`` frames at 0.1 scale in ``input_specs``' shape, standing
in for its frontend stub.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import (SHAPES, ArchConfig, get_smoke_config,
                                 input_specs)
from repro_torch.core.device import resolve_device
from repro_torch.kernels.flash_attention.ops import flash_attention_padded
from repro_torch.kernels.ssd_scan.ops import ssd_chunk
from repro_torch.models.lm import LMModel
from repro_torch.models.lm import params as params_lib
from repro_torch.runtime.telemetry import SPANS

PREFILL_CTX = {"use_flash": True, "use_kernel": True}
PREFIX_SCALE = 0.1      # the stub frames' scale, as the reference's tests draw


def decode_start(cfg: ArchConfig, prompt_len: int) -> int:
    """The cache position of the first decode step after a prefill of
    ``prompt_len`` tokens: a ``vlm`` prefix takes the first frontend_len
    positions."""
    return prompt_len + (cfg.frontend_len if cfg.family == "vlm" else 0)


def prefix_embed_for(cfg: ArchConfig, batch: int, generator: torch.Generator):
    """Seeded stand-in frames of the frontend stub (``input_specs``'
    ``prefix_embed``: (batch, frontend_len, d_model) in the compute type)
    on the generator's device, or None for an arch without a frontend."""
    spec = input_specs(cfg, SHAPES["prefill_32k"], batch=batch).get(
        "prefix_embed")
    if spec is None:
        return None
    return (torch.randn(spec.shape, generator=generator,
                        device=generator.device) * PREFIX_SCALE
            ).to(spec.dtype)


@torch.no_grad()
def prefill(model: LMModel, params, prompts: torch.Tensor, max_len: int,
            prefix_embed=None):
    """prompts (B, L) -> (first greedy token (B,) int32, logits (B, L, V)
    f32, cache sized for ``max_len`` positions).  ``prefix_embed`` is the
    frontend stub's output for ``audio`` and ``vlm``; decode continues at
    ``decode_start(model.cfg, L)``."""
    k4, k5 = flash_attention_padded.launches, ssd_chunk.launches
    span = SPANS.begin("lm.prefill")
    try:
        logits, cache = model.forward(params, prompts,
                                      prefix_embed=prefix_embed,
                                      mode="serve", cache_out=True,
                                      max_len=max_len, ctx_extra=PREFILL_CTX)
        tok = logits[:, -1, :].argmax(-1).to(torch.int32)
    finally:
        SPANS.end(span, counts={
            "tokens": prompts.numel(), "batch": prompts.shape[0],
            "k4.launches": flash_attention_padded.launches - k4,
            "k5.launches": ssd_chunk.launches - k5})
    return tok, logits, cache


@torch.no_grad()
def decode(model: LMModel, params, tok: torch.Tensor, cache, pos: int,
           steps: int):
    """``steps`` greedy decode steps from ``tok`` (B,) at position
    ``pos`` -> (the tokens they chose (B, steps) int32, their logits
    (B, steps, V) f32, the cache)."""
    toks, logits = [], []
    for _ in range(steps):
        lg, cache = model.decode_step(params, tok[:, None], cache, pos)
        tok = lg[:, -1, :].argmax(-1).to(torch.int32)
        pos += 1
        toks.append(tok)
        logits.append(lg[:, -1, :])
    if not toks:
        return (torch.zeros((tok.shape[0], 0), dtype=torch.int32,
                            device=tok.device), None, cache)
    return torch.stack(toks, 1), torch.stack(logits, 1), cache


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=24)
    ap.add_argument("--bfp-weights", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch)
    model = LMModel(cfg, dev)
    params = model.init_params(torch.Generator(device=dev).manual_seed(0))
    if args.bfp_weights:
        # smoke weights are tiny: quantize every matmul weight
        params = params_lib.quantize_weights(params, model.param_meta(),
                                             min_size=1)
        print("[serve_lm] weights quantized to int8 BFP mantissa streams")

    start = decode_start(cfg, args.prompt_len)
    max_len = start + args.tokens
    prompts = torch.randint(
        0, cfg.vocab, (args.batch, args.prompt_len), device=dev,
        generator=torch.Generator(device=dev).manual_seed(1))
    prefix = prefix_embed_for(cfg, args.batch,
                              torch.Generator(device=dev).manual_seed(9))

    t0 = time.perf_counter()
    tok, _, cache = prefill(model, params, prompts, max_len, prefix)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t_pre = time.perf_counter() - t0

    t0 = time.perf_counter()
    rest, _, cache = decode(model, params, tok, cache, start,
                            args.tokens - 1)
    gen = torch.cat([tok[:, None], rest], dim=1)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t_dec = time.perf_counter() - t0
    tps = args.batch * (args.tokens - 1) / max(t_dec, 1e-9)
    print(f"[serve_lm] {args.arch} on {dev.type}: prefill({args.prompt_len}) "
          f"{t_pre * 1e3:.0f}ms; decode {args.tokens - 1} steps, "
          f"{tps:.0f} tok/s; sample: {gen[0, :8].tolist()}")
    if not bool(((gen >= 0) & (gen < cfg.vocab)).all()):
        raise RuntimeError("a generated token is outside the vocabulary")
    print("serve_lm OK")
    return gen


if __name__ == "__main__":
    main()
