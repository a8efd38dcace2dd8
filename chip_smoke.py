#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``src/repro_torch/csrc`` (into
``build/kernels/``), then runs the phases below; any failure exits
non-zero before the result line is printed.

1. Kernels against their plain torch versions at the main paths' shapes.
   K1 at each distinct shape of the 17 3x3 convs the engine's program
   sends it (read from ``FCNEngine.k1_shapes``; 512x512, batch 2,
   conv1_2 first), K2 at each of the seven 1x1-conv matmuls (read from
   ``FCNEngine.k2_shapes``) in 10 mantissa bits and at merge1_c1 also in
   15 (the hi + lo instances; the row's second shape), K3 at (2, 128,
   128) on the synthetic
   maps, on a serpentine in every tile and on links that are not
   symmetric and dirty labels (``data/cc_cases``; the first two timed,
   with the Jacobi rounds of the reference's loop printed beside).  K1's
   plain version runs on CPU copies of the inputs at conv1_1 (Cin 3),
   conv1_2 and conv5_1 and on the card tensors elsewhere, K2's and K3's
   on CPU copies, at the CPU tests' tolerances (K1 atol/rtol 2e-3, K2
   1e-4, K3 labels exact).  K4 at Zamba2-2.7B's prefill (B 4, H 32,
   L 512, D 80, causal) in bf16 and f32, at TinyLlama's GQA heads with a
   ragged length (1, Hq 32, Hkv 4, L 1000, D 64) in bf16 and f32 and at
   Mistral-NeMo's (1, Hq 32, Hkv 8, L 1024, D 128) in bf16, at
   Kimi-K2's prefill (4, Hq 64, Hkv 8, L 512, D 112) in bf16 and f32,
   at InternVL2-76B's (4, Hq 64, Hkv 8, L 768: 256 patches and 512
   tokens, D 128), Grok-1's (4, Hq 48, Hkv 8, L 512, D 128) and Whisper's
   decoder's (4, H 6, L 64, D 64) in bf16, and at phase 8's InternLM2
   microbatch (2, Hq 16, Hkv 8, L 512, D 128) in f32 (``K4_CASES``; in f32 q and k
   are scaled by 2 and v by 32, where one TF32 term would miss the
   tolerance); K5 at
   Zamba2's prefill (BC 16, G 1, HPG 80, Lc 128, N 64, P 64) on the
   strided views ``ssd_scan`` hands it; both against the plain
   version on the same card tensors (K4 atol/rtol 2e-3 in f32, 1.6e-2 in
   bf16, two bf16 ulps; K5 3e-3).
   Then the paths of ResNet-50 PixelLink and of the EAST and DB heads
   (``phase_zoo_kernels``): K1 at each of the 7 distinct shapes of
   ResNet-50's 17 3x3 convs and at DB's db_c3 (Cout 16), K2 at each of
   the 19 distinct shapes of ResNet-50's 40 1x1 convs (split from one
   image's rows) and at the heads' own 1x1 convs (DB's db_r1, K 16, and
   head_logits, N 1; EAST's head_logits, N 5), against the plain versions
   on the same card tensors (K1 2e-3, K2 1e-4); the deepest ResNet-50
   shape of each (s4b2_c2, s4b*_c1) is timed.
   Times are CUDA-event medians of 20 calls after 3 warm-up calls, each
   call bracketed on an idle card, so that a call shorter than its
   host launch path counts that path (``ms``, ``plain_ms``,
   ``library_ms``), for the kernel, the plain version on the card and,
   where one PyTorch call computes the same function, that call (a
   yardstick the port never calls: ``F.conv2d``, ``torch.matmul``,
   ``F.scaled_dot_product_attention``; TF32 off).  The kernel and the
   library call are timed again with all 20 calls queued while the card
   sleeps, which leaves device time only (``device_ms``,
   ``library_device_ms``).  K1's times are also summed over the 17
   launches of a forward pass.  The
   bound counts the operations of K1, K2, K5 and K4's f32 at the TF32
   tensor-core peak (K1, K5, K4 f32 and K2 above 10 bits three times:
   they split each operand into two TF32 terms; K2's 10-bit operands are
   exact in TF32) and K4's
   bf16 at the bf16 peak; K3's counts one compare-and-max per pixel and
   link, the work of a work-efficient spread, so bytes bound it.  Before
   phase 1,
   ``cuobjdump -sass`` of the built library must show tensor-core
   instructions (HGMMA) in the bf16 flash kernel and (HMMA) in every
   instance of K1, K2, K5 and the f32 flash kernel; the counts are
   printed.
2. The published configuration (``configs/pixellink_std.VGG16``: width
   1.0, 512x512, merge (128, 64, 32), optimized, BFP, FP16 storage) with
   seeded random weights through ``EngineFactory``'s single-device engine
   on a batch of 2.  Launch counters are zeroed just before that run and
   read just after: K1 must run 17 times, K2 7 times and K3 once.  The
   maps of image 0 are held against the port's CPU run of the same
   weights and image (probabilities within 2e-2, mean within 2e-3, as in
   tests/test_torch_engine.py), and the CC labels from the card (K3)
   must equal the CPU labelling of the card's maps bit for bit.
   The same for the paper's deployed configuration,
   ``configs/pixellink_std.RESNET50`` (ResNet-50 v1.5, BFP 32/10, FP16
   storage, merge (128, 64, 32)): K1 17, K2 40 and K3 1 launches, its 7
   strided convs through cuDNN one image at a time; its maps are held
   within 2.5e-3 L (max) and 2.5e-4 L (mean) of the CPU run, L the largest
   CPU logit, the tolerance tests/test_torch_engine.py derives for it.
3. Serving: ``STDService(width=1.0, precision="bfp", buckets=(128, 256,
   512), merge_ch=(128, 64, 32), device="cuda")`` answers 6 requests of
   ``RequestStream(6, seed=0, hw_range=((256, 512), (256, 512)))`` one by
   one with boxes from the host (boxes per request and the median latency
   printed).  A second service with the same weights,
   ``postprocess="device", max_batch=4, max_wait_ms=5, inflight=1``,
   must: (a) give the same boxes on those 6 one by one; (b) run one
   ``boxes_fn`` call under ``torch.cuda.set_sync_debug_mode("error")``
   (no host sync), its rows bit-equal to its CPU run; (c) give the same
   boxes from ``serve_pipelined``; (d) give from ``serve_batched`` on
   ``RequestStream(24, seed=1, ...)`` the boxes of sequential serving of
   the same 24, with a mean batch above 1; (e) with ``boxes_capacity=1``
   fall back to the label map on a multi-component request, boxes equal,
   ``pp_overflow`` counting it; (f) measure one 512x512 batch-4 engine's
   peak memory beside the planned one.  Every route's launches are
   counted from 0: K1 17, K2 7 and K3 1 per batch.  Sequential,
   pipelined and batched images/s, p50/p99 latency from
   ``metrics_snapshot()`` and the ``metrics_prometheus()`` line count are
   printed.
   Then the EAST and DB heads (``phase_zoo_serving``): ``STDService(
   width=1.0, precision="bfp", merge_ch=(128, 64, 32), model=...)`` on 6
   requests of 256-512 px, one by one and micro-batched (boxes equal,
   launches per batch EAST 17 / 7 / 0, DB 18 / 8 / 1), and for DB the
   device box tail too (boxes equal to the host tail's).
3b. Execution plans (``phase_plans``), every mesh slot on cuda:0: on
   VGG-16 and ResNet-50 at 512x512 bfp, batch 2, RowBand(2), RowBand(4),
   DataParallel(2) and GridPlan(2x2), and RowBand(4) of a 256x512 plane
   (two rows a band at stride 32, where a band's offset is not a
   multiple of K1's 4-row tile), each held to SingleDevice's maps by the
   map gate, with CC labels and boxes equal and one call's launches
   counted from 0 (K1 17 and K2 7 or 40 per band and shard, K3 once, per
   shard for DataParallel).  During one call of RowBand(4), of GridPlan
   and of the 256-row RowBand(4) every K1 and K2 launch is also run
   through its plain version on the same card tensors (K1 2e-3, K2
   1e-4): the band-extended shapes only these plans make.  A word walk
   names the first word whose band outputs are not bit-equal to the full
   plane's.  An STDService with a 4-band tall plan and one with a Planner
   serve a 2048x512 and a 512x2048 request, boxes equal to SingleDevice's
   on the same padded plane.  Step times are host-clock medians of 3 with
   all slots on one card, not multi-GPU speeds.
4. LM serving at full width (``phase_lm_serving``), one model of
   ``LM_FAMILIES`` at a time, each freed before the next:
   ``zamba2-2.7b`` (all 54 Mamba2 layers, one shared attention block at
   9 sites), ``grok-1-314b`` (2 of 64 layers), ``kimi-k2-1t-a32b`` (1 of
   61), ``internvl2-76b`` (8 of 80; a 256-patch ``prefix_embed`` before
   the prompt) and ``whisper-tiny`` (full: 4 encoder and 4 decoder layers
   over 1500 stub frames).  Seeded bf16 weights drawn on the card, the
   frontend stubs' frames seeded at 0.1 scale in ``input_specs``' shape,
   batch 4, 512-token prompts (whisper 64), then 31 greedy decode steps
   through ``launch/serve_lm``'s ``prefill`` and ``decode`` from
   ``decode_start``.  The counters are zeroed before the prefill: K4 must
   run 9 times and K5 54 times for Zamba2, K4 once per decoder layer for
   the others (Whisper's encoder runs dense, as in the reference), no
   other kernel; decode must add none.  Logits finite and tokens inside
   the vocabulary; prefill ms (median of 3 after the first), decode
   tokens/s, peak device memory and, for the MoE models, the share of
   (token, slot) pairs dropped at prefill are printed.  A forward pass of
   the same weights and prompts with the plain version at every
   attention site holds K4 against it on each site's own q, k, v (bf16,
   atol/rtol 1.6e-2), and the prefill's logits are compared with that
   plain route's and with the dense route's (``_sdpa_full``, P also
   rounded to bf16): the differences, and the top-two gap wherever the
   argmax differs, are printed.
5. LM parity on the card: Zamba2 at full width with 6 layers (one shared
   attention site) in f32, batch 1.  The card's prefill logits of a
   120-token prompt are held against the port's CPU run of the same
   weights (max abs 1e-2), and 8 decode steps against the one-shot
   forward over all 128 tokens at the same positions (max abs 5e-3, the
   reference's own decode-vs-forward tolerance).
5b. Parity of the moe, audio and vlm families on the card
   (``phase_lm_family_parity``): ``whisper-tiny`` (full) and
   ``internvl2-76b`` (4 layers, CPU runs of about 20 s) at full width in
   f32, batch 1 (``init_params`` takes the attention projections at
   their true fan-in, ``params.scale_attention_to_fan_in``; phase 4
   and phase 7 draw so too): the whole prefill against the
   port's CPU run of the same call (max abs 1e-2), every layer of it
   against the CPU run of that layer on the card's input to it (2e-3 of
   the output's largest value), the head (1e-2), and 8 decode steps
   against the one-shot forward (max abs 5e-3; vlm at cache_len =
   frontend_len + t).  MoE at
   full width, card only (a MoE decode step routes other tokens together
   than the one-shot forward, so the two differ by capacity, in the
   reference too): kimi's router on 64 tokens (its f32 gates routed on
   the card and on the CPU: expert ids, ranks and keep mask equal);
   grok's routed block on 64 tokens at capacity factor 16 within 1e-2 of
   the per-expert dense mixture; grok's and kimi's ``moe`` with d_ff cut
   to 1024 and 128, in f32 on the card against the CPU run on the same
   inputs (1e-4).

6. The serving fleet and STD training.
   6a: a ``Router`` over 3 ``ServiceReplica``s, each an STDService on
   cuda:0 with phase 3's device-route settings and weights (r0 routing
   through a ``Planner`` over a (1, 1) mesh), under ``round_robin``,
   ``least_loaded`` and ``p99`` on phase 3's 24 requests (every third in
   class "batch"), after one untimed pass that builds every engine:
   boxes equal phase 3's sequential boxes, launches K1 17 / K2 7 / K3 1
   per replica batch, the fleet's Prometheus text names each replica
   once a line, ``refit_now()`` fits r0's CostParams; images/s, p50/p99
   and requests per replica printed.
   6b: full-width VGG-16 PixelLink trained in the reference datapath
   (512x512, batch 4, ``SyntheticSTDData(seed=0)``, AdamW with weight
   decay 1e-4 and ``cosine_with_warmup(3e-3, 5, 20)``) through
   ``TrainRunner`` and a ``CheckpointManager`` (every 5 steps) under
   deterministic algorithms (``CUBLAS_WORKSPACE_CONFIG`` set before CUDA
   starts): 20 steps crash after step 13, the resume starts at 10, and
   its params and optimizer state are bit-equal to 20 uninterrupted
   steps; every loss finite, the mean of the last 5 below the first;
   step ms (host clock, median), images/s, peak memory and the blocking
   part of an async save printed.
   6c: ``launch/train_std.main(["--steps", "150"])`` on the card (width
   0.25, 64x64): the held-out f-measure improves.
   6d: 6b's params folded by ``normalize_weights`` through the optimized
   f32 datapath with the kernels (K1 17, K3 1 launches): maps within
   phase 2's VGG-16 gate of the reference-mode forward of the same
   params.

7. LM training on the card (the reference trains without its Pallas
   kernels, and K4 and K5 have no backward).
   7a: K4 and K5 raise "no backward" under autograd, through their
   wrappers and through a ``use_flash`` / ``use_kernel`` train-mode
   forward; under ``no_grad`` the same calls launch (counters move).
   7b: one ``launch/step_fns.build_train_step`` on a one-slot mesh,
   card against CPU from one seeded state: TinyLlama-1.1B at published
   widths with 2 layers and Zamba2-2.7B with 6 (one shared-attention
   site) in f32, batch 2 x 128, remat on: loss within 1e-5 relative,
   each gradient leaf within 1e-3 of its largest |g|, the AdamW update
   within 2·lr of the CPU's and within lr/2 of it on 99.9% of the
   entries the CPU moved by over 3/4·lr (at least half of all); then
   TinyLlama in bf16 (the card's ``low_precision_matmul`` backward
   rounds each f32 cotangent to bf16): loss within 2^-8 relative, each
   gradient leaf within 2^-5 of its largest |g|.
   7c: TinyLlama-1.1B as published (22 layers, bf16, remat on), batch 4
   x 512 from ``TokenDataset`` through ``Prefetcher()`` (the card), 12
   steps of ``launch/train.make_step`` (AdamW, f32 moments): loss and
   gradient norm finite at every step, no kernel launched; median step
   ms, tokens/s, peak memory and the share of the bf16 bound (8·N per
   token with remat's extra forward, at 989 TFLOP/s); then 2 steps with
   remat off from the same state: peak memory against remat on (the
   step's, and the forward and backward's alone), losses within 1e-2
   relative (bit-equality printed); then one step from the same draw
   without ``init_params``' fan-in rescale (the reference's init): its
   gradient norm against the first step's.
   7d: ``launch/train.py --smoke --fail-at 5`` then a resume, on the
   card: the final checkpoint's bytes equal an uninterrupted run's.
   7e: ``launch/train_lm_100m.main(["--steps", "200", "--crash-at",
   "120"])`` on the card prints ``train_lm_100m OK``.
8. Pipeline parallelism (``phase_pipeline``): InternLM2-1.8B at
   published widths and full depth (24 layers, f32), its stacked layer
   params through ``runtime.pipeline.split_stages(., 4)`` on a (4, 2)
   ("stage", "mdl") host mesh of cuda:0, ``LMModel.layer_fn()`` (one
   train-mode decoder layer) as the layer, the embedding of seeded
   tokens as ``microbatch(., 4)`` of batch 8 x 512.  The forward must
   match the sequential per-microbatch loop over the 24 layers within
   1e-5 of its largest |y|, the gradients of sum(y^2) w.r.t. the staged
   params (restaged) the loop's within 1e-4 of each leaf's largest |g|,
   and remat on and off the same loss within 1e-6 relative (bit-equality
   printed); forward+backward ms of both (host clock, median of 3), peak
   memory with remat on and off, and the dry run's account of the same
   call on meta (FLOPs, bytes saved for the backward) are printed.  Then
   under ``no_grad`` with ``use_flash`` the pipelined forward must launch
   K4 (f32) 24 x 4 = 96 times and nothing else, equal the same loop
   with ``use_flash`` within K4's f32 tolerance (atol/rtol 2e-3), and
   equal the plain-attention pipeline within 2e-3 of its largest |y|
   (phase 1 holds K4 against its plain version at this D 128 f32 shape).
9. The dry run against the card (``phase_dryrun``):
   ``launch/dryrun.run_cell`` on the meta device for 7c's cell
   (TinyLlama-1.1B as published, bf16, batch 4 x 512, a 1x1 mesh), remat
   on and off.  Its argument bytes must equal exactly the summed nbytes
   of the params, AdamW state and batch 7c placed on the card; remat off
   must predict more saved bytes than remat on; and the remat-off saved
   bytes must fall within 0.5-2x of 7c's forward-and-backward peak above
   the state.  Both sides leave out the resident params, optimizer state
   and batch; the card's peak also holds the backward's transients
   (gradients as they arrive, the loss's f32 logits and their gradient),
   so the bytes the card's forward leaves for the backward (allocated
   after the forward, graph alive, above the same base) are printed
   beside it as the same buffers the dry run counts.  The remat-on
   ratios and the counted FLOPs against 7c's 8·N·T are printed.

The last lines are a ``{"kernels": [...]}`` JSON line (``launches``: the
VGG-16 PixelLink forward's and the Zamba2 prefill's counts;
``launches_by_path``: ResNet-50's forward, one EAST and DB serving
batch, the plans, one fleet replica batch, the deploy check, each
phase-4 model's prefill and phase 8's pipelined forward), the
card's name and power limit from nvidia-smi, and ``{"ok": true,
"device": {...}}``.

``python3 chip_smoke.py --profile`` also runs torch.profiler over ten
calls of K1 (conv1_2, conv5_1, ResNet-50's s4b2_c2), K2 (merge1_c1,
head_logits, ResNet-50's s4b*_c1), K4 (every shape), K5 and their
library calls in phase 1, over one engine step of each configuration in
phase 2, over one serving step (device box tail and copy to the host
included) at batch 1 and 4 in phase 3, over one prefill and one
decode step of each model of phase 4 and over one training step of
phase 7c, and prints the
device time by kernel and the device's busy share of each.
"""
import contextlib
import dataclasses
import gc
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

F32_PEAK = 67e12        # H100 SXM f32 FLOP/s outside the tensor cores
BF16_PEAK = 989e12      # H100 SXM dense bf16 FLOP/s on the tensor cores
TF32_PEAK = 495e12      # H100 SXM dense TF32 FLOP/s on the tensor cores
HBM_BYTES_S = 3.35e12   # H100 SXM device-memory rate
SLEEP_CYCLES = 100_000_000   # ~50 ms of SM clock: the host queues meanwhile
BATCH = 2
HW = (512, 512)
# K1 at conv1_2 on one band of RowBand(4): 128 rows and a 4-row halo each side
BAND4_CONV1_2 = (BATCH, HW[0] // 4 + 8, HW[1], 64, 64)
LM_BATCH, LM_PROMPT, LM_TOKENS = 4, 512, 32
FCN_KERNELS = ("winograd_tiles", "bfp_matmul_quantized",
               "local_spread_converge")
# K1, K2, K3 per forward pass (one batch) of each STD path
VGG_LAUNCHES = dict(winograd_tiles=17, bfp_matmul_quantized=7,
                    local_spread_converge=1)
RESNET_LAUNCHES = dict(winograd_tiles=17, bfp_matmul_quantized=40,
                       local_spread_converge=1)
ZOO_LAUNCHES = {"east": dict(winograd_tiles=17, bfp_matmul_quantized=7,
                             local_spread_converge=0),
                "db": dict(winograd_tiles=18, bfp_matmul_quantized=8,
                           local_spread_converge=1)}
LM_KERNELS = ("flash_attention_padded", "ssd_chunk")
PORT_KERNELS = ("winograd_fused_kernel", "bfp_matmul_kernel",
                "cc_local_kernel", "flash_tf32_kernel", "flash_wgmma_kernel",
                "ssd_chunk_kernel")     # names of the kernels in csrc/
# K4 in phase 1: name, (B, Hq, Hkv, L, D), dtype
K4_CASES = (
    ("zamba2 prefill bf16", (LM_BATCH, 32, 32, LM_PROMPT, 80), "bfloat16"),
    ("zamba2 prefill f32", (LM_BATCH, 32, 32, LM_PROMPT, 80), "float32"),
    ("tinyllama GQA ragged bf16", (1, 32, 4, 1000, 64), "bfloat16"),
    ("tinyllama GQA ragged f32", (1, 32, 4, 1000, 64), "float32"),
    ("mistral-nemo GQA bf16 D 128", (1, 32, 8, 1024, 128), "bfloat16"),
    ("kimi-k2 prefill bf16 D 112", (LM_BATCH, 64, 8, LM_PROMPT, 112),
     "bfloat16"),
    ("kimi-k2 prefill f32 D 112", (LM_BATCH, 64, 8, LM_PROMPT, 112),
     "float32"),
    ("internvl2 prefill bf16", (LM_BATCH, 64, 8, 256 + LM_PROMPT, 128),
     "bfloat16"),
    ("internlm2 pipeline f32 D 128", (2, 16, 8, 512, 128), "float32"),
    ("grok-1 prefill bf16 GQA 6", (LM_BATCH, 48, 8, LM_PROMPT, 128),
     "bfloat16"),
    ("whisper decoder prefill bf16", (LM_BATCH, 6, 6, 64, 64), "bfloat16"))
# phase 4: arch, decoder layers kept (None: all), prompt length, K4 and K5
# launches per prefill (Zamba2: 9 shared-attention sites and 54 Mamba2
# layers; the others: K4 once per decoder layer, Whisper's encoder dense)
LM_FAMILIES = (("zamba2-2.7b", None, LM_PROMPT, 9, 54),
               ("grok-1-314b", 2, LM_PROMPT, 2, 0),
               ("kimi-k2-1t-a32b", 1, LM_PROMPT, 1, 0),
               ("internvl2-76b", 8, LM_PROMPT, 8, 0),
               ("whisper-tiny", None, 64, 4, 0))


def card_name_and_power() -> str:
    """The first card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def cuda_ms(torch, fn, warmup: int = 3, iters: int = 20,
            queued: bool = False) -> float:
    """Median time of one call of ``fn`` by CUDA events around each of
    ``iters`` calls.  On an idle card a pair brackets the host's launch
    path too where that is longer than the call's device time; with
    ``queued`` the calls are queued while the card sleeps and the pairs
    bracket device time only (a call that synchronises with the host
    makes its own pair an outlier, which the median drops)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    if queued:
        torch.cuda._sleep(SLEEP_CYCLES)
    events = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def time_row(torch, kernel, plain, library=None, plain_warmup: int = 3,
             plain_iters: int = 20):
    """``cuda_ms`` of the kernel, its plain version and the library call,
    and of the kernel and the library call queued (device time)."""
    t = dict(ms=cuda_ms(torch, kernel),
             device_ms=cuda_ms(torch, kernel, queued=True),
             plain_ms=cuda_ms(torch, plain, warmup=plain_warmup,
                              iters=plain_iters),
             library_ms=None, library_device_ms=None)
    if library is not None:
        t["library_ms"] = cuda_ms(torch, library)
        t["library_device_ms"] = cuda_ms(torch, library, queued=True)
    return t


def bound(nbytes: float, flops: float, peak: float = F32_PEAK):
    """The least time in ms for the work: bytes over the memory rate or
    operations over the peak rate for the inputs' type, the larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fmt_times(t: dict, library: str = "") -> str:
    out = (f"kernel {t['ms']:.4f} ms (device {t['device_ms']:.4f}) "
           f"plain {t['plain_ms']:.4f} ms")
    if library:
        out += (f" {library} {t['library_ms']:.4f} ms (device "
                f"{t['library_device_ms']:.4f})")
    return out


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def sass_tensor_ops(library) -> dict:
    """Mangled kernel name -> counts of HGMMA and HMMA instructions in
    the SASS of the built library."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    res = subprocess.run([tool, "-sass", str(library)], capture_output=True,
                         text=True)
    if res.returncode != 0:
        fail(f"cuobjdump -sass failed: {res.stderr.strip()[:400]}")
    counts, name = {}, None
    for line in res.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = {"HGMMA": 0, "HMMA": 0}
        elif name:
            for op in ("HGMMA", "HMMA"):
                if re.search(rf"\b{op}\b", line):
                    counts[name][op] += 1
    return counts


def check_tensor_cores(library) -> dict:
    """The bf16 flash kernel must issue HGMMA, and every instance of K1,
    K2, K5 and the f32 flash kernel HMMA; returns their counts by
    kernel."""
    counts = sass_tensor_ops(library)
    found = {}
    for kernel, key, op in (("winograd_tiles", "winograd_fused_kernel",
                             "HMMA"),
                            ("flash_attention_padded", "flash_wgmma_kernel",
                             "HGMMA"),
                            ("flash_attention_padded", "flash_tf32_kernel",
                             "HMMA"),
                            ("bfp_matmul_quantized", "bfp_matmul_kernel",
                             "HMMA"),
                            ("ssd_chunk", "ssd_chunk_kernel", "HMMA")):
        names = [n for n in counts if key in n]
        if not names:
            fail(f"no {key} in the SASS of {library}")
        for n in names:
            log(f"sass: {op} x{counts[n][op]} (HGMMA {counts[n]['HGMMA']}, "
                f"HMMA {counts[n]['HMMA']}) in {n}")
            if counts[n][op] == 0:
                fail(f"{n} issues no {op}: not on the tensor cores")
        found.setdefault(kernel, {}).update({n: counts[n] for n in names})
    return found


# ---------------------------------------------------------------------------
# phase 1: kernels against their plain versions
# ---------------------------------------------------------------------------

def k3_inputs(torch, cc_cases):
    """K3's phase-1 batches at (2, 128, 128), as CPU int32 (labels, pos,
    lnk): the ground-truth maps of synthetic 512x512 text, then the cases
    of ``cc_cases`` (links that are not symmetric, dirty labels, a
    serpentine in every 32x32 tile)."""
    from repro_torch.data.images import SyntheticSTDData
    from repro_torch.models.fcn import postprocess as pp

    data = SyntheticSTDData(HW, seed=0).sample(0, BATCH)
    pos = torch.from_numpy(data["score"]) > 0.5
    lnk = pp.link_symmetrize(torch.from_numpy(data["links"])) > 0.5
    cases = {"synthetic": [t.to(torch.int32).contiguous()
                           for t in (pp.cc_init_labels(pos), pos, lnk)]}
    n, h, w = cases["synthetic"][0].shape
    for name in cc_cases.CASES:
        cases[name] = [torch.from_numpy(a) for a in cc_cases.make_case(
            name, 0, n, h, w, 32, 32)]
    return cases


def k4_inputs(torch, dims, dt, gen):
    """q, k, v on the card and the call's keywords for a ``K4_CASES`` row.
    In f32, q and k are scaled by 2 and v by 32, as in the on-card tests:
    a nearly one-hot softmax over large values, where a kernel with one
    TF32 term misses 2e-3 (at unit scale it passes;
    tests/test_torch_kernels.py::TestTF32Premise)."""
    B, Hq, Hkv, L, D = dims
    dev = torch.device("cuda")
    sq, sv = (2.0, 32.0) if dt == torch.float32 else (1.0, 1.0)
    q = (torch.randn((B, Hq, L, D), generator=gen, device=dev) * sq).to(dt)
    k = (torch.randn((B, Hkv, L, D), generator=gen, device=dev) * sq).to(dt)
    v = (torch.randn((B, Hkv, L, D), generator=gen, device=dev) * sv).to(dt)
    return q, k, v, dict(sm_scale=D ** -0.5, causal=True, kv_len=L)


def profile_calls(torch, calls, n: int = 10) -> None:
    """torch.profiler over ``n`` back-to-back calls of each (name, fn):
    the device time by kernel and the card's busy share of the wall
    time, which shows where a call's host time exceeds its device time."""
    for what, fn in calls:
        fn()
        profile_step(torch, lambda: [fn() for _ in range(n)],
                     what=f"{what} x{n}")


def k1_row(torch, gen, key, names, *, label="", plain_on_cpu=False,
           timed=True, profile=False) -> dict:
    """K1 at one (n, h, w, Cin, Cout) shape against its plain version (on
    CPU copies or on the card tensors) at atol/rtol 2e-3; with ``timed``
    the kernel, the plain version and ``F.conv2d`` are timed and the
    bound is added.  Returns the shape's row of the kernels line."""
    import torch.nn.functional as F

    from repro_torch.core import winograd as wg
    from repro_torch.kernels.winograd_conv import (
        winograd_tiles, winograd_tiles_plain)

    dev = torch.device("cuda")
    n, hh, ww, cin, cout = key
    x = torch.randn((n, hh, ww, cin), generator=gen).to(dev)
    w = (torch.randn((3, 3, cin, cout), generator=gen)
         * (2.0 / (9 * cin)) ** 0.5).to(dev)
    b = torch.randn((cout,), generator=gen).to(dev)
    u = wg.transform_weights(w).reshape(36, cin, cout).contiguous()
    geo = dict(padding="SAME", relu=True)
    got = winograd_tiles(x, u, b, **geo)
    torch.cuda.synchronize()
    want = (winograd_tiles_plain(x.cpu(), u.cpu(), b.cpu(), **geo)
            if plain_on_cpu else winograd_tiles_plain(x, u, b, **geo).cpu())
    err = float((got.cpu() - want).abs().max())
    what = f"K1 {label}{'/'.join(names)}"
    if not torch.allclose(got.cpu(), want, atol=2e-3, rtol=2e-3):
        fail(f"{what}: kernel differs from plain (max abs {err})")
    where = "cpu" if plain_on_cpu else "card"
    row = dict(shape=f"{label}{'/'.join(names)} x{tuple(x.shape)} "
                     f"w{tuple(w.shape)}",
               launches_per_forward=len(names), max_abs_err=err,
               checked_on=where)
    msg = (f"{what} {tuple(x.shape)} -> {cout}: max_abs_err={err:.3g} "
           f"({where.upper() if plain_on_cpu else where} plain)")
    if timed:
        x_nchw = x.permute(0, 3, 1, 2).contiguous()
        w_oihw = w.permute(3, 2, 0, 1).contiguous()
        t = time_row(torch, lambda: winograd_tiles(x, u, b, **geo),
                     lambda: winograd_tiles_plain(x, u, b, **geo),
                     lambda: F.conv2d(x_nchw, w_oihw, b, padding=1))
        # the 36 products per tile, three TF32 products each (3xTF32);
        # bytes: x, U and b read once, y written once
        tiles = n * -(-hh // 4) * -(-ww // 4)
        bms, by = bound(nbytes(x, u, b, got),
                        3 * 2.0 * tiles * 36 * cin * cout, TF32_PEAK)
        row.update(**t, bound_ms=bms, bound_by=by)
        msg += f" {fmt_times(t, 'conv2d')} bound {bms:.4f} ms ({by})"
        if profile:
            profile_calls(torch, [
                (f"K1 {label}{names[0]}",
                 lambda: winograd_tiles(x, u, b, **geo)),
                (f"F.conv2d {label}{names[0]}",
                 lambda: F.conv2d(x_nchw, w_oihw, b, padding=1))])
    log(msg)
    return row


def k2_rows(torch, gen, key, names, *, label="", bits=(10,),
            plain_on_cpu=True, split_rows=0, timed=True,
            profile=False) -> list:
    """K2 at one (M, K, N) shape in each of ``bits`` against its plain
    version (on CPU copies or on the card tensors) at atol/rtol 1e-4;
    with ``timed`` the kernel, the plain version and ``torch.matmul`` on
    the dequantized operands are timed and the bound is added.  Returns
    one row of the kernels line per width."""
    from repro_torch.kernels.bfp_matmul import (
        bfp_matmul_quantized, bfp_matmul_quantized_plain, quantize_operands)
    from repro_torch.kernels.bfp_matmul.ops import _dequantize

    dev = torch.device("cuda")
    M, K, N = key
    a = torch.relu(torch.randn((M, K), generator=gen)).to(dev)
    bm = (torch.randn((K, N), generator=gen) * (2.0 / K) ** 0.5).to(dev)
    out = []
    for nbits in bits:
        geo = dict(block_size=32, mantissa_bits=nbits)
        ops = quantize_operands(a, bm, **geo)
        got = bfp_matmul_quantized(*ops, **geo, split_rows=split_rows)
        torch.cuda.synchronize()
        want = (bfp_matmul_quantized_plain(*(t.cpu() for t in ops), **geo)
                if plain_on_cpu
                else bfp_matmul_quantized_plain(*ops, **geo).cpu())
        err = float((got.cpu() - want).abs().max())
        what = f"K2 {label}{'/'.join(names)} {nbits} bits"
        if not torch.allclose(got.cpu(), want, atol=1e-4, rtol=1e-4):
            fail(f"{what}: kernel differs from plain (max abs {err})")
        row = dict(shape=f"{label}{'/'.join(names)} M={M} K={K} N={N} "
                         f"mantissa_bits={nbits}",
                   launches_per_forward=len(names), max_abs_err=err)
        msg = f"{what}: M={M} K={K} N={N} max_abs_err={err:.3g}"
        if timed:
            a_deq = _dequantize(ops[0], ops[1], 32, nbits)
            b_deq = _dequantize(ops[2].t(), ops[3], 32, nbits).t() \
                .contiguous()

            def kernel():
                return bfp_matmul_quantized(*ops, **geo,
                                            split_rows=split_rows)

            t = time_row(torch, kernel,
                         lambda: bfp_matmul_quantized_plain(*ops, **geo),
                         lambda: torch.matmul(a_deq, b_deq))
            # above 10 bits each product is three TF32 products (hi + lo)
            terms = 3 if nbits > 10 else 1
            bms, by = bound(nbytes(*ops, got), terms * 2.0 * M * K * N,
                            TF32_PEAK)
            row.update(**t, bound_ms=bms, bound_by=by)
            msg += f" {fmt_times(t, 'matmul')} bound {bms:.4f} ms ({by})"
            if profile:
                profile_calls(torch, [
                    (f"K2 {label}{names[0]} {nbits} bits", kernel),
                    (f"torch.matmul {label}{names[0]}",
                     lambda: torch.matmul(a_deq, b_deq))])
        log(msg)
        out.append(row)
    return out


def phase_kernels(torch, np, profile=False):
    from repro_torch.configs.pixellink_std import VGG16
    from repro_torch.data import cc_cases
    from repro_torch.kernels.cc_label import (
        local_spread_converge, local_spread_converge_plain,
        local_spread_jacobi)
    from repro_torch.models.fcn import DetectionModel, build_head

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    rows = {}

    # K1 at every distinct 3x3 conv of the program (conv1_2 first: it
    # leads the kernel's row); the plain version on CPU copies at conv1_1
    # (Cin 3), conv1_2 and conv5_1, on the card tensors elsewhere
    engine = DetectionModel(dataclasses.replace(VGG16, image_size=HW),
                            build_head("pixellink"), "cuda").engine
    k1 = engine.k1_shapes(BATCH)
    if len(k1) != 17:
        fail(f"expected the 17 3x3 convs of VGG-16 PixelLink, got {k1}")
    distinct = _distinct(k1)
    order = sorted(distinct, key=lambda k: "conv1_2" not in distinct[k])
    shapes, by_shape = [], {}
    for key in order:
        names = distinct[key]
        by_shape[key] = k1_row(
            torch, gen, key, names,
            plain_on_cpu=bool({"conv1_1", "conv1_2", "conv5_1"} & set(names)),
            profile=profile and names[0] in ("conv1_2", "conv5_1"))
        shapes.append(by_shape[key])
    total = {k: sum(by_shape[tuple(word[1:])][k] for word in k1)
             for k in ("ms", "device_ms", "library_ms", "library_device_ms")}
    log(f"K1 summed over the 17 launches of a forward pass: kernel "
        f"{total['ms']:.4f} ms (device {total['device_ms']:.4f}), conv2d "
        f"{total['library_ms']:.4f} ms (device "
        f"{total['library_device_ms']:.4f})")
    shapes[0]["sum_over_forward"] = total
    # conv1_2 on one band of a 4-band RowBand plan: 128 rows extended by
    # a 4-row halo on each side; its launches per forward are counted in
    # phase_plans' RowBand(4) call (main fills them in)
    shapes.append(k1_row(torch, gen, BAND4_CONV1_2, ["conv1_2"],
                         label="4-band "))
    shapes[-1]["launches_per_forward"] = None
    rows["winograd_tiles"] = shapes

    # K2 at every 1x1 conv of the program (merge1_c1, K = 128 + 512
    # concatenated, first: it leads the kernel's row), in the paper's 10
    # mantissa bits; merge1_c1 also in 15 (the hi + lo instances), second
    k2 = sorted(engine.k2_shapes(BATCH), key=lambda s: s[0] != "merge1_c1")
    if len(k2) != 7:
        fail(f"expected the 7 1x1 convs of VGG-16 PixelLink, got {k2}")
    shapes = []
    for name, *key in k2:
        shapes += k2_rows(
            torch, gen, tuple(key), [name],
            bits=(10, 15) if name == "merge1_c1" else (10,),
            profile=profile and name in ("merge1_c1", "head_logits"))
    rows["bfp_matmul_quantized"] = shapes

    # K3 at (2, 128, 128), 32x32 tiles, on k3_inputs' batches; the
    # synthetic maps (which lead the row) and the serpentine timed.  The
    # reference's Jacobi rounds come from the plain loop on the CPU and are
    # printed beside the time
    cases = k3_inputs(torch, cc_cases)
    shapes = []
    for name, args in cases.items():
        dargs = [t.to(dev) for t in args]
        got = local_spread_converge(*dargs)
        torch.cuda.synchronize()
        want, rounds = local_spread_jacobi(*args, th=32, tw=32)
        if not torch.equal(got.cpu(), want):
            fail(f"K3 {name}: kernel labels differ from the plain version")
        jacobi = (f"Jacobi rounds {int(rounds.sum())} over {rounds.numel()} "
                  f"tiles ({int(rounds.min())}..{int(rounds.max())})")
        if name not in ("synthetic", "serpentine"):
            log(f"K3 {name} {tuple(got.shape)}: exact, {jacobi}")
            continue
        t = time_row(torch, lambda: local_spread_converge(*dargs),
                     lambda: local_spread_converge_plain(*dargs, th=32,
                                                         tw=32),
                     plain_warmup=1, plain_iters=10)
        # a work-efficient spread: one compare-and-max per pixel and link
        bms, by = bound(nbytes(*dargs, got), 2.0 * 8 * got.numel())
        shapes.append(dict(
            shape=f"{name} labels{tuple(got.shape)}",
            jacobi_rounds=int(rounds.sum()), max_abs_err=0.0, **t,
            bound_ms=bms, bound_by=by))
        log(f"K3 {name} {tuple(got.shape)}: exact, {jacobi}, "
            f"{fmt_times(t)} bound {bms:.5f} ms ({by})")
    rows["local_spread_converge"] = shapes
    return rows


def _distinct(shapes):
    """{shape key: [bindings]} of ``k1_shapes`` / ``k2_shapes`` rows."""
    out = {}
    for name, *key in shapes:
        out.setdefault(tuple(key), []).append(name)
    return out


def phase_zoo_kernels(torch, np, profile=False):
    """Phase 1 at the shapes of ResNet-50 PixelLink and of the EAST and DB
    heads (512x512, batch 2): K1 at each distinct shape of ResNet-50's 17
    3x3 convs and at DB's db_c3 (Cout 16); K2 at each distinct shape of
    ResNet-50's 40 1x1 convs (split from one image's rows, as the engine
    runs it) and at the heads' own 1x1 convs (DB's db_r1, K 16 in one
    zero-padded block, and head_logits, N 1; EAST's head_logits, N 5).
    Each against its plain version on the same card tensors (K1 2e-3, K2
    1e-4).  The deepest ResNet-50 shape of each is timed beside
    ``F.conv2d`` / ``torch.matmul`` (TF32 off)."""
    from repro_torch.configs.pixellink_std import RESNET50, VGG16
    from repro_torch.models.fcn import DetectionModel, build_head

    gen = torch.Generator().manual_seed(2)

    def engine(cfg, head):
        return DetectionModel(dataclasses.replace(cfg, image_size=HW),
                              build_head(head), "cuda").engine

    resnet = engine(RESNET50, "pixellink")
    db, east = engine(VGG16, "db"), engine(VGG16, "east")
    k1, k2 = resnet.k1_shapes(BATCH), resnet.k2_shapes(BATCH)
    k1_res, k2_res = _distinct(k1), _distinct(k2)
    if (len(k1), len(k1_res), len(k2), len(k2_res)) != (17, 7, 40, 19):
        fail(f"ResNet-50 PixelLink: {len(k1)} K1 convs of {len(k1_res)} "
             f"shapes and {len(k2)} K2 of {len(k2_res)}, expected 17 of 7 "
             f"and 40 of 19")
    k1_heads = _distinct(s for s in db.k1_shapes(BATCH)
                         if s[0].startswith("db_"))
    k2_heads = _distinct([s for s in db.k2_shapes(BATCH)
                          if s[0] in ("db_r1", "head_logits")]
                         + [s for s in east.k2_shapes(BATCH)
                            if s[0] == "head_logits"])
    if (len(k1_heads), len(k2_heads)) != (1, 3):
        fail(f"head shapes: K1 {k1_heads}, K2 {k2_heads}")
    rows = {"winograd_tiles": [], "bfp_matmul_quantized": []}
    # the deepest shape of each is timed: K1's widest Cin, K2's longest K
    timed1 = max(k1_res, key=lambda k: (k[3], k))
    timed2 = max(k2_res, key=lambda k: (k[1], k))
    for label, shapes in (("resnet50 ", k1_res), ("head ", k1_heads)):
        for key, names in shapes.items():
            timed = key == timed1 and label == "resnet50 "
            rows["winograd_tiles"].append(k1_row(
                torch, gen, key, names, label=label, timed=timed,
                profile=profile and timed))
    for label, shapes in (("resnet50 ", k2_res), ("head ", k2_heads)):
        for key, names in shapes.items():
            timed = key == timed2 and label == "resnet50 "
            rows["bfp_matmul_quantized"] += k2_rows(
                torch, gen, key, names, label=label, plain_on_cpu=False,
                split_rows=key[0] // BATCH, timed=timed,
                profile=profile and timed)
    return rows


def phase_lm_kernels(torch, profile=False):
    """Phase 1, K4 and K5 at the LM prefill shapes, each against its plain
    version on the same card tensors."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (flash_attention_padded,
                                                     flash_attention_plain)
    from repro_torch.kernels.ssd_scan import ssd_chunk, ssd_chunk_plain

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    rows = {}
    shapes = []
    for name, (B, Hq, Hkv, L, D), dt in K4_CASES:
        dt = getattr(torch, dt)
        q, k, v, geo = k4_inputs(torch, (B, Hq, Hkv, L, D), dt, gen)
        got = flash_attention_padded(q, k, v, **geo)
        torch.cuda.synchronize()
        want = flash_attention_plain(q, k, v, **geo)
        tol = 2e-3 if dt == torch.float32 else 1.6e-2
        err = float((got.float() - want.float()).abs().max())
        if not torch.allclose(got.float(), want.float(), atol=tol, rtol=tol):
            fail(f"K4 {name}: kernel differs from plain (max abs {err})")
        t = time_row(torch, lambda: flash_attention_padded(q, k, v, **geo),
                     lambda: flash_attention_plain(q, k, v, **geo),
                     lambda: F.scaled_dot_product_attention(
                         q, k, v, is_causal=True, enable_gqa=Hq != Hkv))
        # causal: half of the 4 B H L^2 D of QK^T and PV; in f32 three
        # TF32 products each (3xTF32), beside the bound of the same work
        # as f32 FMAs on the CUDA cores (the first version's)
        flops = 2.0 * B * Hq * L * L * D
        extra = {}
        if dt == torch.float32:
            bms, by = bound(nbytes(q, k, v, got), 3 * flops, TF32_PEAK)
            extra["cuda_core_bound_ms"] = bound(nbytes(q, k, v, got),
                                                flops)[0]
        else:
            bms, by = bound(nbytes(q, k, v, got), flops, BF16_PEAK)
        shapes.append(dict(shape=f"{name} q{tuple(q.shape)} kv{tuple(k.shape)}",
                           max_abs_err=err, **t, bound_ms=bms, bound_by=by,
                           **extra))
        log(f"K4 {name}: max_abs_err={err:.3g} {fmt_times(t, 'sdpa')} "
            f"bound {bms:.4f} ms ({by})" + "".join(
                f", {k} {x:.4f}" for k, x in extra.items()))
        if profile:
            profile_calls(torch, [
                (f"K4 {name}", lambda: flash_attention_padded(q, k, v, **geo)),
                (f"sdpa {name}", lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=Hq != Hkv))])
        del q, k, v, got, want
    rows["flash_attention_padded"] = shapes

    # K5 at Zamba2's prefill, on the views ssd_scan hands it
    # (kernels/ssd_scan/ops.py): operands in (B, nc, Lc, H | G, ...) memory
    Bz, nc, G, H, Lc, N, P = LM_BATCH, LM_PROMPT // 128, 1, 80, 128, 64, 64
    BC, HPG = Bz * nc, H // G
    cm = torch.randn((Bz, nc, Lc, G, N), generator=gen, device=dev) * 0.5
    bm = torch.randn((Bz, nc, Lc, G, N), generator=gen, device=dev) * 0.5
    xm = torch.randn((Bz, nc, Lc, H, P), generator=gen, device=dev) * 0.5
    la = -torch.rand((Bz, nc, Lc, H), generator=gen, device=dev)
    c = cm.permute(0, 1, 3, 2, 4).reshape(BC, G, Lc, N)
    b = bm.permute(0, 1, 3, 2, 4).reshape(BC, G, Lc, N)
    xdt = xm.permute(0, 1, 3, 2, 4).reshape(BC, G, HPG, Lc, P)
    scum = torch.cumsum(la, dim=2).permute(0, 1, 3, 2).reshape(
        BC, G, HPG, Lc, 1)
    y, st = ssd_chunk(c, b, xdt, scum)
    torch.cuda.synchronize()
    wy, wst = ssd_chunk_plain(c, b, xdt, scum)
    err = max(float((y - wy).abs().max()), float((st - wst).abs().max()))
    if not (torch.allclose(y, wy, atol=3e-3, rtol=3e-3)
            and torch.allclose(st, wst, atol=3e-3, rtol=3e-3)):
        fail(f"K5: kernel differs from plain (max abs {err})")
    t = time_row(torch, lambda: ssd_chunk(c, b, xdt, scum),
                 lambda: ssd_chunk_plain(c, b, xdt, scum))
    # cb once per (chunk, group), then y and the chunk-end state per head;
    # cb and W = cb * decay are lower-triangular, so cb and y count the
    # Lc (Lc + 1) / 2 entries t >= s, at 2 operations each; three TF32
    # products each (3xTF32)
    flops = 1.0 * BC * G * Lc * (Lc + 1) * N + 1.0 * BC * G * HPG * (
        Lc * (Lc + 1) * P + 2 * P * N * Lc)
    bms, by = bound(nbytes(c, b, xdt, scum, y, st), 3 * flops, TF32_PEAK)
    rows["ssd_chunk"] = [dict(
        shape=f"zamba2 prefill BC={BC} G={G} HPG={HPG} Lc={Lc} N={N} P={P}",
        max_abs_err=err, **t, bound_ms=bms, bound_by=by)]
    log(f"K5 ssd_chunk: max_abs_err={err:.3g} {fmt_times(t)} "
        f"bound {bms:.4f} ms ({by})")
    if profile:
        profile_calls(torch, [("K5", lambda: ssd_chunk(c, b, xdt, scum))])
    return rows


# ---------------------------------------------------------------------------
# phase 2: the published configuration through the engine factory
# ---------------------------------------------------------------------------

def profile_step(torch, fn, *args, what="step") -> None:
    """torch.profiler over one call of ``fn``: device time by kernel and
    the device's busy share of the call's wall time."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn(*args)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # device-side events only (kernels, memcpy, memset): the CPU ops that
    # launched them report the same time again
    device = torch.autograd.DeviceType.CUDA
    events = sorted((e for e in prof.key_averages()
                     if getattr(e, "device_type", None) == device),
                    key=dev_us, reverse=True)
    busy = sum(dev_us(e) for e in events)
    log(f"profile: {what} wall {wall_us / 1e3:.2f} ms, device busy "
        f"{busy / 1e3:.2f} ms ({100 * busy / wall_us:.1f}%), "
        f"{sum(e.count for e in events)} device kernels")
    # the 20 longest, then the port's own kernels among the rest
    rest = [e for e in events[20:] if any(k in e.key for k in PORT_KERNELS)]
    for e in events[:20] + rest:
        log(f"profile: {dev_us(e) / 1e3:9.3f} ms {e.count:5d}x "
            f"{e.key[:90]}")


def map_gate(backbone: str, cpu_logits):
    """(max, mean) tolerance on image 0's probability maps against the
    port's CPU run: VGG-16's as tests/test_torch_engine.py states them;
    ResNet-50's in units of L = max |CPU logits| (2.5e-3 L and 2.5e-4 L,
    the same test's argument: each FP16/BFP step the sum order moves is one
    mantissa LSB relative to its block, so the end-of-net delta scales
    with the logits)."""
    if backbone == "resnet50":
        scale = float(cpu_logits.abs().max())
        return 2.5e-3 * scale, 2.5e-4 * scale
    return 2e-2, 2e-3


def phase_model(torch, np, cfg, want_launches: dict, profile=False):
    """One published configuration (``cfg``, at HW) through
    ``EngineFactory``'s single-device engine on a batch of 2: the launch
    counts of one batch, CC convergence, card labels against the CPU
    labelling of the card maps, image 0's maps against the port's CPU
    run (``map_gate``), and the median step of 3."""
    from repro_torch import kernels
    from repro_torch.data.images import SyntheticSTDData
    from repro_torch.models.fcn import DetectionModel, build_head
    from repro_torch.models.fcn import postprocess as pp
    from repro_torch.runtime.executor import EngineFactory, SingleDevice

    def make_model(hw, precision, model, device="cuda"):
        return DetectionModel(dataclasses.replace(cfg, image_size=hw),
                              build_head(model), device)

    tag = cfg.name
    factory = EngineFactory(make_model, device="cuda")
    fn = factory.plan_fn(HW, BATCH, SingleDevice(), "bfp")
    params = factory.params(HW, "bfp")
    images = SyntheticSTDData(HW, seed=0).sample(0, BATCH)["images"]
    x = torch.from_numpy(images).cuda()
    vq = torch.full((BATCH, 2), HW[0] // 4, dtype=torch.int32, device="cuda")
    torch.cuda.synchronize()

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    labels, converged = fn(params, x, vq)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    want = dict.fromkeys(launches, 0)
    want.update(want_launches)
    log(f"{tag}: main path launches {launches} (first call {first_s:.3f} s)")
    if launches != want:
        fail(f"{tag}: launch counts {launches} != {want} for one batch")
    if not bool(converged.all()):
        fail(f"{tag}: CC labelling did not converge")

    steps = []
    for _ in range(3):
        t0 = time.perf_counter()
        fn(params, x, vq)
        torch.cuda.synchronize()
        steps.append(time.perf_counter() - t0)
    log(f"{tag}: batch of {BATCH} at {HW}: median step "
        f"{statistics.median(steps) * 1e3:.2f} ms over 3")
    if profile:
        profile_step(torch, fn, params, x, vq, what=f"{tag} engine step")

    model = factory.model(HW, "bfp")
    maps = model.apply(params, x)
    labels2, _ = factory.label_tail(maps["score"], maps["links"], vq)
    cpu_labels = pp.cc_label_batched(maps["score"].cpu(), maps["links"].cpu())
    if not torch.equal(labels2.cpu(), cpu_labels):
        fail(f"{tag}: card CC labels differ from the CPU labelling of the "
             f"card maps")
    if not torch.equal(labels2, labels):
        fail(f"{tag}: two runs of the engine on the same batch gave other "
             f"labels")
    for k in ("score", "links", "logits"):
        if not bool(torch.isfinite(maps[k]).all()):
            fail(f"{tag}: non-finite values in {k}")

    cpu_model = make_model(HW, "bfp", "pixellink", device="cpu")
    cpu_params = {n: {k: v.cpu() for k, v in leaves.items()}
                  for n, leaves in params.items()}
    t0 = time.perf_counter()
    cpu_maps = cpu_model.apply(cpu_params, x[:1].cpu())
    log(f"{tag}: CPU run of image 0: {time.perf_counter() - t0:.1f} s")
    deltas = {}
    for k in ("score", "links", "logits"):
        d = (maps[k][:1].cpu() - cpu_maps[k]).abs()
        deltas[k] = (float(d.max()), float(d.mean()))
    gate = map_gate(cfg.backbone, cpu_maps["logits"])
    log(f"{tag}: card vs CPU map deltas (max, mean): {deltas}; max |CPU "
        f"logits| {float(cpu_maps['logits'].abs().max()):.4g}; gate on the "
        f"maps {gate[0]:.4g} / {gate[1]:.4g}")
    for k in ("score", "links"):
        if deltas[k][0] > gate[0] or deltas[k][1] > gate[1]:
            fail(f"{tag}: {k} maps differ from the CPU run beyond "
                 f"{gate[0]:.4g} / {gate[1]:.4g}")
    n_boxes = [len(pp.boxes_from_labels(labels[i].cpu().numpy()))
               for i in range(BATCH)]
    log(f"{tag}: components per image: {n_boxes}")
    return launches


# ---------------------------------------------------------------------------
# phase 3: serving
# ---------------------------------------------------------------------------

def _box_keys(out):
    return [[(b["label"], b["box"], b["area"]) for b in r] for r in out]


def _checked_launches(kernels, n_batches: int, what: str,
                      per_batch: dict = VGG_LAUNCHES) -> dict:
    """The counts since the last reset must be one engine forward per
    batch: ``per_batch`` (VGG-16 PixelLink: K1 17, K2 7 and K3 1) each
    time."""
    launches = kernels.launch_counts()
    want = dict.fromkeys(launches, 0)
    want.update({k: v * n_batches for k, v in per_batch.items()})
    if launches != want:
        fail(f"{what}: launches {launches} != {want} for {n_batches} "
             f"batches")
    return launches


def phase_serving(torch, np, profile=False) -> dict:
    from repro_torch import kernels
    from repro_torch.data.images import RequestStream
    from repro_torch.launch.serve import STDService

    geo = dict(width=1.0, precision="bfp", buckets=(128, 256, 512),
               merge_ch=(128, 64, 32), device="cuda")
    svc = STDService(**geo)
    stream = list(RequestStream(6, seed=0,
                                hw_range=((256, 512), (256, 512))))
    images = [req["image"] for req in stream]
    kernels.reset_launch_counts()
    host = []
    for i, req in enumerate(stream):
        boxes = svc(req["image"])
        h, w = req["hw"]
        for b in boxes:
            x0, y0, x1, y1 = b["box"]
            if not (0 <= x0 <= x1 < w // 4 and 0 <= y0 <= y1 < h // 4):
                fail(f"request {i}: box {b['box']} outside {req['hw']}")
        host.append(boxes)
        log(f"request {i} {req['hw']}: {len(boxes)} boxes, "
            f"{svc.stats['latency_s'][-1] * 1e3:.2f} ms")
    _checked_launches(kernels, len(stream), "host route, 6 requests")
    lat = svc.stats["latency_s"]
    log(f"serving (host route): 6 requests, median latency "
        f"{statistics.median(lat) * 1e3:.2f} ms")

    # the device box tail, pipelined and micro-batched serving, with the
    # same seeded weights
    dev = STDService(**geo, postprocess="device", max_batch=4,
                     max_wait_ms=5, inflight=1,
                     params=svc.factory.params(HW, "f32"))
    kernels.reset_launch_counts()
    got = [dev(img) for img in images]
    _checked_launches(kernels, len(images), "device route, 6 requests")
    if _box_keys(got) != _box_keys(host):
        fail("(a) device-route boxes differ from the host route's")
    log("(a) device route, 6 requests one by one: boxes equal the host "
        "route's")

    x, valid, _ = dev.preprocess(images[3])
    labels = dev.dispatch_labels(x[None], [valid])[0]
    torch.cuda.synchronize()
    fn = dev.factory.boxes_fn(x.shape[:2], 1, dev.boxes_capacity)
    torch.cuda.set_sync_debug_mode("error")
    rows, counts = fn(labels)
    torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    cpu_rows, cpu_counts = fn(labels.cpu())
    if not (torch.equal(rows.cpu(), cpu_rows)
            and torch.equal(counts.cpu(), cpu_counts)):
        fail("(b) boxes_fn rows on the card differ from its CPU run")
    log(f"(b) boxes_fn on the card under sync debug mode 'error': no sync, "
        f"rows {tuple(rows.shape)} bit-equal to the CPU run, "
        f"{int(cpu_counts[0])} components")

    if _box_keys(dev.serve_pipelined(images)) != _box_keys(host):
        fail("(c) pipelined boxes differ from the host route's")
    log("(c) serve_pipelined, 6 requests: boxes equal")

    many = RequestStream(24, seed=1,
                         hw_range=((256, 512), (256, 512))).images()
    t0 = time.perf_counter()
    seq = [dev(img) for img in many]
    seq_ips = len(many) / (time.perf_counter() - t0)
    pipe = dev.serve_pipelined(many)
    if _box_keys(pipe) != _box_keys(seq):
        fail("pipelined boxes of the 24 requests differ from sequential")
    kernels.reset_launch_counts()
    batched = dev.serve_batched(many)
    batches = dev.stats["batching"]["batches"]
    launches = _checked_launches(kernels, len(batches),
                                 "serve_batched, 24 requests")
    sizes = [b["n"] for b in batches]
    mean_batch = sum(sizes) / len(sizes)
    if _box_keys(batched) != _box_keys(seq):
        fail("(d) batched boxes differ from sequential serving")
    if mean_batch <= 1:
        fail(f"(d) no batching happened: batch sizes {sizes}")
    log(f"(d) serve_batched, 24 requests: boxes equal sequential, "
        f"{len(batches)} batches of {sizes} (mean {mean_batch:.2f}), "
        f"launches {launches}")
    batched_first = dev.stats["batched_tps"]
    dev.serve_batched(many)             # every engine built: warm
    if profile:
        # one engine step with the device box tail and the copy to the
        # host, at batch 1 and at batch 4, in the 512x512 bucket
        pads = [dev.preprocess(img)[:2] for img in many]
        pads = [p for p in pads if p[0].shape[:2] == (512, 512)][:4]
        for b in (1, 4):
            stack = np.stack([p[0] for p in pads[:b]])
            valids = [p[1] for p in pads[:b]]
            profile_step(torch, lambda: dev._finalize(
                dev._dispatch(stack, valids)),
                what=f"serving step, device route, batch {b} at 512x512")
    warm = dev.stats["batched_latency_s"]
    snap = dev.metrics_snapshot()
    log(f"STD serving at width 1.0, bfp, device route, 24 requests of "
        f"256-512 px: sequential {seq_ips:.2f} images/s, pipelined "
        f"{dev.stats['pipelined_tps']:.2f} images/s, batched "
        f"{dev.stats['batched_tps']:.2f} images/s (first run, engines "
        f"built on the way: {batched_first:.2f}), max_batch 4, "
        f"max_wait_ms 5, inflight 1, mean batch {mean_batch:.2f}")
    log(f"request latency p50/p99 from metrics_snapshot() (sequential "
        f"requests): {snap['std_request_latency_p50_ms']:.2f} / "
        f"{snap['std_request_latency_p99_ms']:.2f} ms; batched (warm run, "
        f"submit to result): {np.percentile(warm, 50) * 1e3:.2f} / "
        f"{np.percentile(warm, 99) * 1e3:.2f} ms; metrics_prometheus() "
        f"{len(dev.metrics_prometheus().splitlines())} lines")

    # (e) a capacity of 1 overflows on a multi-component request
    i = max(range(len(host)), key=lambda k: len(host[k]))
    if len(host[i]) < 2:
        fail("(e) no multi-component request to overflow")
    capacity, dev.boxes_capacity = dev.boxes_capacity, 1
    before = dev.stats["pp_overflow"]
    fell_back = dev(images[i])
    dev.boxes_capacity = capacity
    n_over = dev.stats["pp_overflow"] - before
    if _box_keys([fell_back]) != _box_keys([host[i]]) or n_over != 1 \
            or dev.book.counter("pp_overflow") != dev.stats["pp_overflow"]:
        fail(f"(e) overflow fallback: {n_over} counted, boxes equal "
             f"{_box_keys([fell_back]) == _box_keys([host[i]])}")
    log(f"(e) boxes_capacity=1 on request {i} ({len(host[i])} boxes): "
        f"fell back to the label map, boxes equal, pp_overflow +1")

    mem = dev.measure_engine_memory((512, 512), 4)
    log(f"(f) engine memory at 512x512, batch 4: measured peak "
        f"{mem['peak_bytes'] / 2**20:.1f} MiB (arguments "
        f"{mem['argument_bytes'] / 2**20:.1f} MiB, temp "
        f"{mem['temp_bytes'] / 2**20:.1f} MiB) against the planned "
        f"activation peak {mem['planned_peak_bytes'] / 2**20:.1f} MiB")
    # the fleet (phase 6a) serves the same 24 requests with these weights
    return {"images": many, "boxes": seq,
            "params": dev.factory.params(HW, "f32")}


def phase_zoo_serving(torch, np) -> dict:
    """The EAST and DB heads served at width 1.0 in bfp: 6 requests of
    256-512 px one by one and micro-batched, the batched boxes equal to
    the sequential ones and the launches per batch EAST 17 / 7 / 0 and DB
    18 / 8 / 1; for DB also the device box tail, its boxes equal to the
    host tail's.  The random weights keep nearly every score on one side
    of 0.5, so each head's score threshold is a quantile of the first
    request's valid scores (EAST 0.99: its candidates go through greedy
    NMS; DB 0.9: its CC tail labels the mask).  Returns the launches of
    one batch per head."""
    from repro_torch import kernels
    from repro_torch.data.images import RequestStream
    from repro_torch.launch.serve import STDService

    geo = dict(width=1.0, precision="bfp", buckets=(128, 256, 512),
               merge_ch=(128, 64, 32), max_batch=4, max_wait_ms=5,
               inflight=1, device="cuda")
    images = RequestStream(6, seed=2,
                           hw_range=((256, 512), (256, 512))).images()
    per_batch = {}
    for model, q in (("east", 0.99), ("db", 0.9)):
        want = ZOO_LAUNCHES[model]
        probe = STDService(**geo, model=model)
        x, valid, _ = probe.preprocess(images[0])
        hw = x.shape[:2]
        score = probe.factory.model(hw, "bfp", model).apply(
            probe.factory.params(hw, "bfp", model),
            torch.from_numpy(x[None]).cuda())["score"]
        thr = float(np.quantile(
            score[0, :valid[0] // 4, :valid[1] // 4].cpu().numpy(), q))
        params = probe.factory.params(HW, "f32", model)
        svc = STDService(**geo, model=model, score_thr=thr, params=params)
        kernels.reset_launch_counts()
        seq = [svc(img) for img in images]
        _checked_launches(kernels, len(images), f"{model}, 6 requests",
                          want)
        t0 = time.perf_counter()            # every engine built: warm
        if _box_keys([svc(img) for img in images]) != _box_keys(seq):
            fail(f"{model}: a second sequential pass gave other boxes")
        seq_ips = len(images) / (time.perf_counter() - t0)
        kernels.reset_launch_counts()
        batched = svc.serve_batched(images)
        sizes = [b["n"] for b in svc.stats["batching"]["batches"]]
        _checked_launches(kernels, len(sizes), f"{model}, serve_batched",
                          want)
        if _box_keys(batched) != _box_keys(seq):
            fail(f"{model}: batched boxes differ from sequential serving")
        if max(sizes) < 2:
            fail(f"{model}: no batching happened: batch sizes {sizes}")
        svc.serve_batched(images)           # every engine built: warm
        msg = (f"{model} at width 1.0, bfp: 6 requests, boxes "
               f"{[len(r) for r in seq]}, sequential {seq_ips:.2f} images/s,"
               f" batched {svc.stats['batched_tps']:.2f} images/s (warm) in "
               f"batches of {sizes}, equal to sequential; launches per "
               f"batch {want}")
        msg += f"; score threshold {thr:.4f} (quantile {q})"
        if model == "db":
            # the random mask has several hundred components a request:
            # a capacity above that keeps every request on compact rows
            dev = STDService(**geo, model=model, postprocess="device",
                             boxes_capacity=1024, score_thr=thr,
                             params=params)
            kernels.reset_launch_counts()
            got = [dev(img) for img in images]
            _checked_launches(kernels, len(images), "db device route", want)
            if _box_keys(got) != _box_keys(seq) or \
                    _box_keys(dev.serve_batched(images)) != _box_keys(seq):
                fail("db: device-route boxes differ from the host route's")
            if dev.stats["pp_overflow"]:
                fail("db: the device route fell back to label maps")
            msg += ("; device box tail (sequential and batched, compact "
                    "rows) equal")
        if sum(len(r) for r in seq) == 0:
            fail(f"{model}: no box in 6 requests")
        log(msg)
        per_batch[f"{model} serving batch"] = dict(want)
    return per_batch


# ---------------------------------------------------------------------------
# phase 3b: execution plans on a mesh of slots, all on cuda:0
# ---------------------------------------------------------------------------

def _plan_launches(name: str, bands: int, shards: int, per_forward: dict):
    """K1 and K2 run once per band and batch shard (each band runs the
    whole program); K3 once per batch, once per shard for DataParallel
    (its tail runs per shard)."""
    k3 = shards if name.startswith("data_parallel") else 1
    return {"winograd_tiles": per_forward["winograd_tiles"] * bands * shards,
            "bfp_matmul_quantized":
                per_forward["bfp_matmul_quantized"] * bands * shards,
            "local_spread_converge": per_forward["local_spread_converge"]
            * k3}


def _plans(mesh_of):
    """(name, plan, bands, batch shards) of phase_plans."""
    from repro_torch.runtime.executor import DataParallel, GridPlan, RowBand

    return (("row_band[model=2]", RowBand(mesh_of((1, 2))), 2, 1),
            ("row_band[model=4]", RowBand(mesh_of((1, 4))), 4, 1),
            ("data_parallel[data=2]", DataParallel(mesh_of((2, 1))), 1, 2),
            ("grid[data=2,model=2]", GridPlan(mesh_of((2, 2))), 2, 2))


def _median_step(torch, fn, *args) -> float:
    steps = []
    for _ in range(3):
        t0 = time.perf_counter()
        fn(*args)
        torch.cuda.synchronize()
        steps.append(time.perf_counter() - t0)
    return statistics.median(steps) * 1e3


def word_walk(torch, model, params, x, bands: int) -> str:
    """Walk the full plane and ``bands`` row bands of it word by word on
    the card (``FCNEngine.walk``'s trace) and name the first word whose
    band outputs, stacked, are not bit-equal to the full plane's, with
    the route it runs (K1, K2 or a torch/cuDNN op)."""
    from repro_torch.core.interpreter import finish
    from repro_torch.core.microcode import LayerType
    from repro_torch.runtime.executor import drive_bands

    eng, prog = model.engine, model.program
    full, parts = {}, [{} for _ in range(bands)]
    finish(eng.walk(params, x,
                    trace=lambda i, y: full.__setitem__(i, y.clone())))
    bh = x.shape[1] // bands
    band = model.for_plane((bh, x.shape[2]), plane_bands=bands)
    drive_bands([[(torch.device("cuda", 0), band.band_walk(
        params, x[:, m * bh:(m + 1) * bh],
        trace=lambda i, y, m=m: parts[m].__setitem__(i, y.clone())))
        for m in range(bands)]])
    differ = []
    for idx in full:
        got = torch.cat([p[idx] for p in parts], dim=1)
        if not torch.equal(got, full[idx]):
            d = float((got.float() - full[idx].float()).abs().max())
            differ.append((idx, d))
    if not differ:
        return "every word bit-equal"
    idx, d = differ[0]
    mc, spec = prog.words[idx], prog.layer_specs[idx]
    lt = LayerType(mc.layer_type)
    if lt == LayerType.CONV:
        route = ("K1" if eng._runs_k1(mc, spec) else "K2"
                 if eng._runs_k2(mc, spec)
                 else f"cuDNN conv {mc.kernel_size}x{mc.kernel_size}/"
                      f"{mc.stride_n}")
    elif lt == LayerType.UPSAMPLE:
        route = "upsample (tap GEMMs)"
    else:
        route = lt.name.lower()
    return (f"{len(differ)} of {len(full)} words differ; first word "
            f"{idx} {prog.weight_bindings.get(idx, '')!r} ({route}), max "
            f"|delta| {d:.4g}")


@contextlib.contextmanager
def checked_kernel_calls(torch, tally: dict):
    """Within the block every K1 and K2 launch also runs the kernel's
    plain version on the same card tensors and is held to it (K1 2e-3,
    K2 1e-4: ``k1_row``'s and ``k2_rows``' tolerances); ``tally[kernel]
    [shape]`` gathers ``[launches, max_abs_err]``.  The wrappers' own
    launch counters are not touched."""
    from repro_torch.kernels.bfp_matmul import ops as k2
    from repro_torch.kernels.winograd_conv import ops as k1

    kernel_k1, kernel_k2 = k1.winograd_tiles, k2.bfp_matmul_quantized

    def note(name, key, got, want, tol):
        err = float((got - want).abs().max())
        if not torch.allclose(got, want, atol=tol, rtol=tol):
            fail(f"{name} at {key}: kernel differs from plain (max abs "
                 f"{err})")
        entry = tally.setdefault(name, {}).setdefault(key, [0, 0.0])
        entry[0] += 1
        entry[1] = max(entry[1], err)

    def checked_k1(x, u, b=None, *, padding="SAME", relu=False):
        got = kernel_k1(x, u, b, padding=padding, relu=relu)
        note("winograd_tiles", tuple(x.shape) + (u.shape[-1],), got,
             k1.winograd_tiles_plain(x, u, b, padding=padding, relu=relu),
             2e-3)
        return got

    def checked_k2(ma, ea, mb, eb, **geo):
        got = kernel_k2(ma, ea, mb, eb, **geo)
        note("bfp_matmul_quantized",
             (ma.shape[0], ma.shape[1], mb.shape[1],
              geo.get("split_rows", 0)), got,
             k2.bfp_matmul_quantized_plain(
                 ma, ea, mb, eb, block_size=geo["block_size"],
                 mantissa_bits=geo["mantissa_bits"]), 1e-4)
        return got

    # the kernels' own bodies count on the module-level name
    checked_k1.launches = checked_k2.launches = 0
    k1.winograd_tiles, k2.bfp_matmul_quantized = checked_k1, checked_k2
    try:
        yield
    finally:
        k1.winograd_tiles, k2.bfp_matmul_quantized = kernel_k1, kernel_k2


def _check_plan(torch, pp, what, fn, params, x, vq, single, gate, launches,
                tally=None) -> dict:
    """One plan against SingleDevice's result ``single`` (maps, labels,
    boxes) on the same inputs: the first call (its band models are
    built) runs under :func:`checked_kernel_calls` when ``tally`` is
    given, whose launches must be the counted call's; the second is
    counted from 0 and must launch ``launches``; maps within ``gate``,
    labels and boxes equal.  Returns the counted launches."""
    from repro_torch import kernels

    want_maps, want_labels, want_boxes = single
    if tally is None:
        fn(params, x, vq)
    else:
        with checked_kernel_calls(torch, tally):
            fn(params, x, vq)
        seen = {k: sum(c for c, _ in v.values()) for k, v in tally.items()}
        if any(seen.get(k, 0) != launches[k]
               for k in ("winograd_tiles", "bfp_matmul_quantized")):
            fail(f"{what}: checked call launched {seen}, not {launches}")
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    labels, converged = fn(params, x, vq)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    want = dict.fromkeys(counts, 0)
    want.update(launches)
    if counts != want:
        fail(f"{what}: launches {counts} != {want}")
    if not bool(converged.all()):
        fail(f"{what}: CC labelling did not converge")
    maps = fn.forward(params, x)
    d = {k: float((maps[k] - want_maps[k]).abs().max())
         for k in ("score", "links", "logits")}
    for k in ("score", "links"):
        mean = float((maps[k] - want_maps[k]).abs().mean())
        if d[k] > gate[0] or mean > gate[1]:
            fail(f"{what}: {k} maps differ from SingleDevice's by "
                 f"{d[k]:.4g} (mean {mean:.4g}) beyond {gate[0]:.4g} / "
                 f"{gate[1]:.4g}")
    if not torch.equal(labels, want_labels):
        fail(f"{what}: CC labels differ from SingleDevice's")
    boxes = [pp.boxes_from_labels(labels[i].cpu().numpy())
             for i in range(labels.shape[0])]
    if boxes != want_boxes:
        fail(f"{what}: boxes differ from SingleDevice's")
    ms = _median_step(torch, fn, params, x, vq)
    bit = all(v == 0.0 for v in d.values())
    checked = ""
    if tally is not None:
        checked = ", every K1 and K2 launch of its first call within the " \
            f"plain version's tolerance ({_tally_text(tally)})"
    log(f"{what}: launches {counts}, labels and {sum(map(len, boxes))} "
        f"boxes equal SingleDevice's, map deltas (max) {d} "
        f"({'bit-identical' if bit else 'not bit-identical'}; gate "
        f"{gate[0]:.4g} / {gate[1]:.4g}){checked}, median step {ms:.2f} ms")
    return counts


def _tally_text(tally) -> str:
    return "; ".join(
        f"{k}: {sum(c for c, _ in v.values())} launches at {len(v)} shapes, "
        f"max_abs_err {max(e for _, e in v.values()):.3g}"
        for k, v in tally.items())


def phase_plans(torch, np):
    """RowBand (2 and 4 bands), DataParallel (2 shards) and GridPlan (2x2)
    with every mesh slot on cuda:0, on full-width VGG-16 PixelLink and the
    deployed ResNet-50 in bfp at 512x512, batch 2, and RowBand(4) of a
    256x512 plane (band offsets of 2 rows at stride 32): each plan's maps
    held to SingleDevice's by the map gate, CC labels and boxes equal,
    launches counted from 0 around one call (K1 17 x bands x shards, K2 7
    or 40 x bands x shards, K3 1, 2 for DataParallel's per-shard tail),
    the K1 and K2 launches of one call of each RowBand(4) and of GridPlan
    held to their plain versions (:func:`checked_kernel_calls`), and the
    median step of 3 on the host clock.  Then an STDService with a 4-band
    tall plan serves a 2048x512 request and a 512x2048 one (transposed),
    boxes equal to the same factory's SingleDevice engine on the same
    padded plane, and a service with a Planner over a (1, 4) mesh routes
    them the same way.  Returns launches per path for the kernels line,
    and the checked launches: ``{"rows": {kernel: [row, ...]},
    "band_row_launches": K1 launches at BAND4_CONV1_2 in VGG-16's
    RowBand(4) call}``."""
    from repro_torch import kernels
    from repro_torch.configs.pixellink_std import RESNET50, VGG16
    from repro_torch.data.images import SyntheticSTDData
    from repro_torch.launch.mesh import make_host_mesh, make_mesh
    from repro_torch.launch.serve import STDService
    from repro_torch.models.fcn import DetectionModel, build_head
    from repro_torch.models.fcn import postprocess as pp
    from repro_torch.runtime.executor import (EngineFactory, RowBand,
                                              SingleDevice)
    from repro_torch.runtime.planner import Planner

    def on_card0(shape):
        return make_host_mesh(shape, ("data", "model"), device="cuda:0")

    log(f"plan step times below: host clock, median of 3, every mesh slot "
        f"on one card ({card_name_and_power()}), so the slots run one "
        f"after another: not multi-GPU speeds")

    def inputs(hw, seed):
        images = SyntheticSTDData(hw, seed=seed).sample(0, BATCH)["images"]
        vq = torch.tensor([[hw[0] // 4, hw[1] // 4]] * BATCH,
                          dtype=torch.int32, device="cuda")
        return torch.from_numpy(images).cuda(), vq

    by_path, tallies = {}, {}
    unaligned = (256, 512)
    for cfg, per_forward in ((VGG16, VGG_LAUNCHES),
                             (RESNET50, RESNET_LAUNCHES)):
        def make_model(hw, precision, model, cfg=cfg):
            return DetectionModel(dataclasses.replace(cfg, image_size=hw),
                                  build_head(model), "cuda")

        factory = EngineFactory(make_model, device="cuda")
        for hw, seed in ((HW, 0), (unaligned, 3)):
            x, vq = inputs(hw, seed)
            params = factory.params(hw, "bfp")
            single = factory.plan_fn(hw, BATCH, SingleDevice(), "bfp")
            want_maps = single.forward(params, x)
            want_labels, _ = single(params, x, vq)
            torch.cuda.synchronize()
            gate = map_gate(cfg.backbone, want_maps["logits"])
            want = (want_maps, want_labels,
                    [pp.boxes_from_labels(want_labels[i].cpu().numpy())
                     for i in range(BATCH)])
            plane = f"{hw[0]}x{hw[1]}"
            log(f"{cfg.name} {plane} SingleDevice: median step "
                f"{_median_step(torch, single, params, x, vq):.2f} ms")
            plans = list(_plans(on_card0))
            if hw == unaligned:
                plans = [p for p in plans if p[0] == "row_band[model=4]"]
            elif torch.cuda.device_count() > 1:
                plans.append(("row_band[model=2] across 2 cards",
                              RowBand(make_mesh((1, 2), ("data", "model"))),
                              2, 1))
            for name, plan, bands, shards in plans:
                what = f"{cfg.name} {plane} {name}"
                tally = ({} if name in ("row_band[model=4]",
                                        "grid[data=2,model=2]") else None)
                by_path[f"{what} forward"] = _check_plan(
                    torch, pp, what, factory.plan_fn(hw, BATCH, plan, "bfp"),
                    params, x, vq, want, gate,
                    _plan_launches(name, bands, shards, per_forward), tally)
                if tally is not None:
                    tallies[what] = tally
            model = factory.model(hw, "bfp")
            for bands in ((2, 4) if hw == HW else (4,)):
                log(f"{cfg.name} {plane} word walk, {bands} bands against "
                    f"the full plane: "
                    f"{word_walk(torch, model, params, x, bands)}")
    if torch.cuda.device_count() < 2:
        log("RowBand(2) across two cards: skipped, "
            f"torch.cuda.device_count() = {torch.cuda.device_count()}")
    checked = {"rows": {}, "band_row_launches": tallies.get(
        f"{VGG16.name} {HW[0]}x{HW[1]} row_band[model=4]", {}).get(
        "winograd_tiles", {}).get(BAND4_CONV1_2, [0])[0]}
    for what, tally in tallies.items():
        for kernel, shapes in tally.items():
            checked["rows"].setdefault(kernel, []).append(dict(
                shape=f"{what}: its first call's {len(shapes)} shapes",
                launches_per_forward=sum(c for c, _ in shapes.values()),
                max_abs_err=max(e for _, e in shapes.values()),
                checked_on="card"))

    # over-tall and over-wide requests on a 4-band tall plan
    geo = dict(width=1.0, precision="bfp", buckets=(128, 256, 512),
               merge_ch=(128, 64, 32), device="cuda")
    tall_img = SyntheticSTDData((2048, 512), seed=1).sample(0, 1)["images"][0]
    wide_img = SyntheticSTDData((512, 2048), seed=2).sample(0, 1)["images"][0]
    svc = STDService(**geo, tall_plan=RowBand(on_card0((1, 4))))
    params = svc.factory.params(HW, "f32")
    served = {}
    for what, img in (("2048x512", tall_img), ("512x2048", wide_img)):
        xp, valid, tr = svc.preprocess(img)
        hw = xp.shape[:2]
        if tr != (what == "512x2048") or hw != (2048, 512):
            fail(f"tall plan, {what}: padded to {hw}, transposed {tr}")
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        boxes = svc(img)
        dt = (time.perf_counter() - t0) * 1e3
        by_path[f"tall plan {what} request"] = _checked_launches(
            kernels, 1, f"tall plan, {what}",
            _plan_launches("row_band", 4, 1, VGG_LAUNCHES))
        ref = svc.factory.plan_fn(hw, 1, SingleDevice(), "bfp")(
            svc.factory.params(hw, "bfp"),
            torch.from_numpy(xp[None]).cuda(),
            torch.tensor([[valid[0] // 4, valid[1] // 4]],
                         dtype=torch.int32, device="cuda"))[0]
        want = svc.postprocess(ref[0].cpu().numpy(), valid, tr)
        if _box_keys([boxes]) != _box_keys([want]):
            fail(f"tall plan, {what}: boxes differ from SingleDevice's on "
                 f"the same {hw} plane")
        served[what] = boxes
        first = (" (its first call builds the band models)"
                 if what == "2048x512" else "")
        log(f"STDService(tall_plan=RowBand(4 slots on cuda:0)) {what}: "
            f"padded to {hw}, transposed {tr}, {len(boxes)} boxes equal "
            f"SingleDevice's on the same plane, {dt:.1f} ms{first}")
    routed = STDService(**geo, params=params,
                        planner=Planner(on_card0((1, 4))))
    for what, img in (("2048x512", tall_img), ("512x2048", wide_img)):
        if _box_keys([routed(img)]) != _box_keys([served[what]]):
            fail(f"planner, {what}: boxes differ from the tall plan's")
    log(f"STDService(planner=Planner((1, 4) mesh on cuda:0)): boxes equal "
        f"the tall plan's; plan_choices {routed.stats['plan_choices']}")
    if set(routed.stats["plan_choices"].values()) != {"row_band[model=4]"}:
        fail(f"planner did not route the over-tall buckets to the 4-band "
             f"plan: {routed.stats['plan_choices']}")
    return by_path, checked


# ---------------------------------------------------------------------------
# phase 4: LM serving at full width: Zamba2 and the moe, audio and vlm
# families
# ---------------------------------------------------------------------------

def _finite(torch, name, t) -> None:
    if not bool(torch.isfinite(t).all()):
        fail(f"non-finite values in {name}")


def logit_gap(torch, what, got, want) -> None:
    """Prints how far ``got``'s logits are from ``want``'s and, where the
    argmax differs, ``want``'s gap between its top two logits there."""
    d = (got - want).abs()
    top2 = want.topk(2, dim=-1).values
    gap = top2[..., 0] - top2[..., 1]
    flips = got.argmax(-1) != want.argmax(-1)
    n = int(flips.sum())
    at = (f"{float(gap[flips].min()):.4g}..{float(gap[flips].max()):.4g}"
          if n else "none")
    log(f"logits {what}: max abs {float(d.max()):.4g}, mean abs "
        f"{float(d.mean()):.4g} (std {float(want.std()):.4g}); argmax "
        f"differs at {n} of {flips.numel()} positions, top-two gap there "
        f"{at} (median over all {float(gap.median()):.4g})")


def compare_routes(torch, model, params, prompts, logits, n_sites: int,
                   prefix=None) -> None:
    """The prefill's logits (attention through K4) against two other
    routes on the same weights and prompts, K5 in all three: the plain
    route, where every attention site runs ``flash_attention_plain``
    (f32 softmax and P.V) and K4 is held against it on that site's own
    q, k, v at phase 1's bf16 tolerance; and the dense route
    (``layers._sdpa_full``, P rounded to bf16 before P.V).  The logits'
    distances are printed, not gated: in bf16 the plain and dense routes
    end as far from each other as from K4's."""
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.launch import serve_lm
    from repro_torch.models.lm import layers

    kernel_op, sites = layers.flash_attention, []

    def plain_op(q, k, v, *, sm_scale=None, causal=True):
        scale = q.shape[-1] ** -0.5 if sm_scale is None else sm_scale
        want = flash_attention_plain(q, k, v, sm_scale=scale, causal=causal,
                                     kv_len=k.shape[2])
        got = kernel_op(q, k, v, sm_scale=sm_scale, causal=causal)
        d = (got.float() - want.float()).abs()
        # allclose(atol=rtol=1.6e-2) holds where this share is at most 1
        share = d / (1.6e-2 + 1.6e-2 * want.float().abs())
        sites.append((float(d.max()), float(share.max())))
        return want

    layers.flash_attention = plain_op
    try:
        plain = model.forward(params, prompts, prefix_embed=prefix,
                              ctx_extra=serve_lm.PREFILL_CTX)
    finally:
        layers.flash_attention = kernel_op
    dense = model.forward(params, prompts, prefix_embed=prefix,
                          ctx_extra={"use_flash": False, "use_kernel": True})
    for name, t in (("plain-route", plain), ("dense-route", dense)):
        _finite(torch, f"{name} logits", t)
    log(f"K4 vs plain at the {len(sites)} attention sites of the bf16 "
        f"prefill, on each site's own q, k, v, max abs (share of the "
        f"tolerance): " + ", ".join(f"{e:.3g} ({r:.3g})" for e, r in sites))
    if len(sites) != n_sites or max(r for _, r in sites) > 1:
        fail("K4 differs from the plain version at an attention site of "
             "the prefill (atol/rtol 1.6e-2)")
    logit_gap(torch, "K4 route vs plain route", logits, plain)
    logit_gap(torch, "dense route vs plain route", dense, plain)
    logit_gap(torch, "K4 route vs dense route", logits, dense)
    log("first greedy tokens, K4 / plain / dense route: " + " / ".join(
        str(t[:, -1].argmax(-1).tolist()) for t in (logits, plain, dense)))


def _family_config(arch: str, layers):
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    return cfg if layers is None else dataclasses.replace(cfg,
                                                          n_layers=layers)


def _free(torch) -> None:
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


@contextlib.contextmanager
def _drop_tally(routed: list):
    """Records each MoE layer's (pairs, dropped pairs) on the card while
    active (read after the run)."""
    from repro_torch.models.lm import moe

    inner = moe.route

    def recorded(gates, table):
        r = inner(gates, table)
        routed.append((r.keep.numel(), (~r.keep).sum()))
        return r

    moe.route = recorded
    try:
        yield
    finally:
        moe.route = inner


def serve_family(torch, arch: str, layers, prompt_len: int, k4: int,
                 k5: int, profile=False) -> dict:
    """One model of phase 4: seeded bf16 weights on the card, batch 4, a
    prefill of ``prompt_len`` tokens (and the stub's frames), 31 greedy
    decode steps, then ``compare_routes`` on the same prompts.  Returns
    the prefill's launch counts."""
    from repro_torch import kernels
    from repro_torch.launch import serve_lm
    from repro_torch.models.lm import LMModel

    cfg = _family_config(arch, layers)
    what = (f"{arch} ({cfg.n_layers} of "
            f"{_family_config(arch, None).n_layers} layers)"
            if layers is not None else arch)
    held = torch.cuda.memory_allocated()     # by earlier phases
    model = LMModel(cfg, "cuda")
    t0 = time.perf_counter()
    params = model.init_params(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    log(f"{what}: {cfg.param_count():,} parameters drawn on the card in "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{(torch.cuda.memory_allocated() - held) / 2**30:.2f} GiB")
    gen = torch.Generator(device="cuda").manual_seed(1)
    prompts = torch.randint(0, cfg.vocab, (LM_BATCH, prompt_len),
                            device="cuda", generator=gen)
    prefix = serve_lm.prefix_embed_for(
        cfg, LM_BATCH, torch.Generator(device="cuda").manual_seed(9))
    start = serve_lm.decode_start(cfg, prompt_len)
    max_len = start + LM_TOKENS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    routed = []
    kernels.reset_launch_counts()
    with _drop_tally(routed):
        t0 = time.perf_counter()
        tok, logits, cache = serve_lm.prefill(model, params, prompts,
                                              max_len, prefix)
        torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    launches = kernels.launch_counts()
    want = dict.fromkeys(launches, 0)
    want.update(flash_attention_padded=k4, ssd_chunk=k5)
    log(f"{what} prefill launches {launches} (first call {first_ms:.1f} ms)")
    if launches != want:
        fail(f"{what}: prefill launch counts {launches} != {want}")
    _finite(torch, f"{what} prefill logits", logits)
    if tuple(logits.shape) != (LM_BATCH, prompt_len, cfg.vocab):
        fail(f"{what}: prefill logits {tuple(logits.shape)}")
    drops = ""
    if routed:
        pairs = sum(n for n, _ in routed)
        dropped = int(sum(d for _, d in routed))
        drops = (f"; {dropped} of {pairs} (token, slot) pairs dropped at "
                 f"prefill ({100 * dropped / pairs:.2f}%) over "
                 f"{len(routed)} MoE layers")

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    rest, dlogits, cache = serve_lm.decode(model, params, tok, cache, start,
                                           LM_TOKENS - 1)
    torch.cuda.synchronize()
    t_dec = time.perf_counter() - t0
    if any(kernels.launch_counts().values()):
        fail(f"{what}: decode launched kernels {kernels.launch_counts()}")
    _finite(torch, f"{what} decode logits", dlogits)
    gen_toks = torch.cat([tok[:, None], rest], dim=1)
    if gen_toks.shape != (LM_BATCH, LM_TOKENS) or not bool(
            ((gen_toks >= 0) & (gen_toks < cfg.vocab)).all()):
        fail(f"{what}: generated tokens {tuple(gen_toks.shape)} outside "
             f"[0, {cfg.vocab})")
    peak = torch.cuda.max_memory_allocated()
    del cache, dlogits
    compare_routes(torch, model, params, prompts, logits, k4, prefix)

    steps = []
    for _ in range(3):
        t0 = time.perf_counter()
        _, again, _ = serve_lm.prefill(model, params, prompts, max_len,
                                       prefix)
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t0) * 1e3)
    log(f"{what} prefill logits bit-equal to the first prefill's: "
        f"{torch.equal(again, logits)}")
    del again
    tps = LM_BATCH * (LM_TOKENS - 1) / t_dec
    log(f"{what} batch {LM_BATCH} prompt {prompt_len}"
        f"{f' + {cfg.frontend_len} stub frames' if prefix is not None else ''}"
        f": prefill {statistics.median(steps):.2f} ms (median of 3 after "
        f"the first; {', '.join(f'{t:.2f}' for t in steps)}); decode "
        f"{LM_TOKENS - 1} steps {t_dec * 1e3:.1f} ms, {tps:.1f} tokens/s; "
        f"peak device memory {peak / 2**30:.2f} GiB ({held / 2**30:.2f} of "
        f"it held by earlier phases){drops}; sample "
        f"{gen_toks[0, :8].tolist()}")
    if profile:
        _, _, cache = serve_lm.prefill(model, params, prompts, max_len,
                                       prefix)
        profile_step(torch, serve_lm.prefill, model, params, prompts,
                     max_len, prefix, what=f"{arch} prefill")
        profile_step(torch, model.decode_step, params, tok[:, None], cache,
                     start, what=f"{arch} decode step")
    return launches


def phase_lm_serving(torch, profile=False) -> dict:
    _free(torch)
    out = {}
    for arch, layers, prompt_len, k4, k5 in LM_FAMILIES:
        t0 = time.perf_counter()
        out[f"{arch} prefill"] = serve_family(torch, arch, layers,
                                              prompt_len, k4, k5,
                                              profile=profile)
        _free(torch)
        log(f"{arch} took {time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 5: LM parity on the card
# ---------------------------------------------------------------------------

def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree.cpu()


def phase_lm_parity(torch):
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.launch import serve_lm
    from repro_torch.models.lm import LMModel

    cfg = dataclasses.replace(get_config("zamba2-2.7b"), n_layers=6,
                              attn_every=6, param_dtype="float32",
                              compute_dtype="float32")
    model = LMModel(cfg, "cuda")
    params = model.init_params(
        torch.Generator(device="cuda").manual_seed(2))
    prompt = torch.randint(
        0, cfg.vocab, (1, 120), device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(3))
    kernels.reset_launch_counts()
    tok, logits, cache = serve_lm.prefill(model, params, prompt, 128)
    torch.cuda.synchronize()
    counts = {k: kernels.launch_counts()[k] for k in LM_KERNELS}
    if counts != {"flash_attention_padded": 1, "ssd_chunk": 6}:
        fail(f"6-layer prefill launch counts {counts}")

    t0 = time.perf_counter()
    _, cpu_logits, _ = serve_lm.prefill(LMModel(cfg, "cpu"), _to_cpu(params),
                                        prompt.cpu(), 128)
    cpu_s = time.perf_counter() - t0
    d_prefill = float((logits.cpu() - cpu_logits).abs().max())

    rest, dlogits, _ = serve_lm.decode(model, params, tok, cache, 120, 8)
    seq = torch.cat([prompt, tok[:, None].long(), rest[:, :7].long()], dim=1)
    full = model.forward(params, seq)
    d_decode = float((dlogits - full[:, 120:128]).abs().max())
    log(f"zamba2 6-layer f32 parity: prefill(120) card vs CPU max abs "
        f"{d_prefill:.3g} (CPU run {cpu_s:.1f} s); 8 decode steps vs "
        f"one-shot forward(128) max abs {d_decode:.3g}")
    if d_prefill > 1e-2:
        fail(f"card prefill logits differ from the CPU run by {d_prefill}")
    if d_decode > 5e-3:
        fail(f"decode logits differ from the forward pass by {d_decode}")


# ---------------------------------------------------------------------------
# phase 5b: parity of the new families on the card
# ---------------------------------------------------------------------------

def family_parity(torch, arch: str, layers, prompt_len: int) -> None:
    """f32 at full width, batch 1, from ``init_params`` (the attention
    projections at their true fan-in).  The card's whole prefill (K4 at the
    decoder's self-attention) against the port's CPU run of the same call
    (1e-2); every layer of it against the CPU run of that layer on the
    card's input to it (2e-3 of the layer output's largest value: a wrong
    mask, scale or rotation moves it by tenths) and the head on the card's
    last hidden state (1e-2), which say where a whole-prefill gap comes
    from; 8 decode steps against the one-shot forward over the same
    tokens (5e-3)."""
    from repro_torch.launch import serve_lm
    from repro_torch.models.lm import LMModel

    cfg = dataclasses.replace(_family_config(arch, layers),
                              param_dtype="float32", compute_dtype="float32")
    model = LMModel(cfg, "cuda")
    params = model.init_params(torch.Generator(device="cuda").manual_seed(2))
    prompt = torch.randint(
        0, cfg.vocab, (1, prompt_len), device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(3))
    prefix = serve_lm.prefix_embed_for(
        cfg, 1, torch.Generator(device="cuda").manual_seed(4))
    start = serve_lm.decode_start(cfg, prompt_len)

    records = []        # (encoder?, layer, input, ctx, output) of the prefill
    inner = model._layer

    def recorded(fn, stacked, i, h, ctx, stacked_cache=None):
        y = inner(fn, stacked, i, h, ctx, stacked_cache)
        records.append((stacked is params.get("enc_layers"), i, h,
                        dict(ctx), y))
        return y

    model._layer = recorded
    tok, logits, cache = serve_lm.prefill(model, params, prompt, start + 8,
                                          prefix)
    del model._layer
    head = model._head(params, records[-1][4])
    rest, dlogits, _ = serve_lm.decode(model, params, tok, cache, start, 8)
    seq = torch.cat([prompt, tok[:, None].long(), rest[:, :7].long()], dim=1)
    full = model.forward(params, seq, prefix_embed=prefix)
    d_decode = float((dlogits - full[:, prompt_len:]).abs().max())
    del cache, full, dlogits

    t0 = time.perf_counter()
    cpu_params = _to_cpu(params)
    del params
    _free(torch)
    cpu_model = LMModel(cfg, "cpu")
    _, cpu_logits, _ = serve_lm.prefill(cpu_model, cpu_params, prompt.cpu(),
                                        start + 8, prefix.cpu())
    d_prefill = float((logits.cpu() - cpu_logits).abs().max())
    fns = {True: getattr(cpu_model, "enc_block", cpu_model.block).fn(),
           False: cpu_model.block.fn()}
    stages = []
    for enc, i, h, ctx, y in records:
        want = cpu_model._layer(
            fns[enc], cpu_params["enc_layers" if enc else "layers"], i,
            h.cpu(), {k: v.cpu() if isinstance(v, torch.Tensor) else v
                      for k, v in ctx.items()})
        stages.append((f"{'enc' if enc else 'dec'}{i}",
                       float((y.cpu() - want).abs().max()),
                       float(want.abs().max())))
    d_head = float((head.cpu() - cpu_model._head(
        cpu_params, records[-1][4].cpu())).abs().max())
    cpu_s = time.perf_counter() - t0
    log(f"{arch} f32 parity, {cfg.n_layers} decoder layers"
        f"{f' + {cfg.encoder_layers} encoder' if cfg.encoder_layers else ''}"
        f", prompt {prompt_len} + {cfg.frontend_len} stub frames: each "
        f"layer on the card's input, card vs CPU max abs (of the output's "
        f"largest value) " + ", ".join(f"{n} {d:.3g} ({m:.3g})"
                                       for n, d, m in stages)
        + f"; head {d_head:.3g}; whole prefill card vs CPU max abs "
        f"{d_prefill:.3g} (logit std {float(cpu_logits.std()):.3g}; CPU "
        f"runs, copy included, {cpu_s:.1f} s); 8 decode steps from "
        f"position {start} vs one-shot forward max abs {d_decode:.3g}")
    for name, d, m in stages:
        if d > 2e-3 * max(m, 1.0):
            fail(f"{arch}: layer {name} on the card differs from the CPU "
                 f"run on the same input by {d} (output max {m})")
    if d_head > 1e-2:
        fail(f"{arch}: the head on the card differs from the CPU by {d_head}")
    if d_prefill > 1e-2:
        fail(f"{arch}: card prefill logits differ from the CPU run by "
             f"{d_prefill}")
    if d_decode > 5e-3:
        fail(f"{arch}: decode logits differ from the forward pass by "
             f"{d_decode}")


def moe_parity(torch) -> None:
    """The routed block at full width on the card: kimi's routing equal to
    the CPU's on the same gates; grok's block at capacity factor 16 against
    the per-expert dense mixture; both archs' block in f32 at a cut d_ff
    against the CPU run."""
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.models.lm import moe
    from repro_torch.models.lm.params import materialize

    def table(cfg, **kw):
        return {"n_experts": cfg.n_experts, "top_k": cfg.top_k,
                "capacity_factor": cfg.capacity_factor,
                "fission": cfg.moe_fission, **kw}

    def block(cfg, d_ff, dtype, seed):
        meta = moe.moe_meta(cfg.d_model, d_ff, cfg.n_experts, dtype)
        return materialize(meta, torch.Generator(device="cuda")
                           .manual_seed(seed), "cuda")

    def tokens(cfg, dtype, seed):
        return torch.randn((1, 64, cfg.d_model), device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(seed)).to(dtype)

    kimi, grok = get_config("kimi-k2-1t-a32b"), get_config("grok-1-314b")
    # kimi's router: 64 tokens, 384 experts, top 8
    p = {"router": materialize(
        moe.moe_meta(kimi.d_model, 64, kimi.n_experts, "bfloat16")["router"],
        torch.Generator(device="cuda").manual_seed(5), "cuda")}
    gates = moe.router_gates(p, tokens(kimi, torch.bfloat16, 6)[0])
    got, want = moe.route(gates, table(kimi)), moe.route(gates.cpu(),
                                                         table(kimi))
    same = {n: bool(torch.equal(getattr(got, n).cpu(), getattr(want, n)))
            for n in ("topi", "pos", "keep")}
    log(f"kimi-k2 router on 64 tokens: card vs CPU on the same f32 gates "
        f"{same}, cap {got.cap} / {want.cap}, "
        f"{int((~got.keep).sum())} of {got.keep.numel()} pairs dropped")
    if not all(same.values()) or got.cap != want.cap:
        fail(f"kimi-k2 routing on the card differs from the CPU's: {same}")

    # grok's block at full width, nothing dropped
    p = block(grok, grok.d_ff, "bfloat16", 7)
    x = tokens(grok, torch.bfloat16, 8)
    t16 = table(grok, capacity_factor=16.0)
    y = moe.moe(p, x, table=t16).float()[0]
    xt = x[0].float()
    r = moe.route(moe.router_gates(p, x[0]), t16)
    if not bool(r.keep.all()):
        fail("grok's block at capacity factor 16 dropped a pair")
    dense = torch.zeros_like(xt)
    for e in range(grok.n_experts):
        h = F.silu(xt @ p["wg"][e].float()) * (xt @ p["wu"][e].float())
        w = torch.where(r.topi == e, r.topv, 0.0).sum(-1)
        dense += (h @ p["wd"][e].float()) * w[:, None]
    err = float((y - dense).abs().max())
    log(f"grok-1 routed block, bf16, 64 tokens at capacity factor 16 vs the "
        f"per-expert dense mixture in f32: max abs {err:.3g} (output max "
        f"{float(dense.abs().max()):.3g})")
    if not torch.allclose(y, dense, atol=1e-2, rtol=1e-2):
        fail(f"grok's routed block differs from the dense mixture by {err}")
    del p, dense, x, y
    _free(torch)

    # one layer's block in f32 at a cut d_ff, card against CPU
    for cfg, d_ff in ((grok, 1024), (kimi, 128)):
        p = block(cfg, d_ff, "float32", 9)
        x = tokens(cfg, torch.float32, 10)
        got = moe.moe(p, x, table=table(cfg))
        want = moe.moe(_to_cpu(p), x.cpu(), table=table(cfg))
        err = float((got.cpu() - want).abs().max())
        log(f"{cfg.name} moe, f32, d_ff cut to {d_ff}, 64 tokens: card vs "
            f"CPU max abs {err:.3g} (output max "
            f"{float(want.abs().max()):.3g})")
        if not torch.allclose(got.cpu(), want, atol=1e-4, rtol=1e-4):
            fail(f"{cfg.name} moe on the card differs from the CPU run by "
                 f"{err}")
        del p, x, got
        _free(torch)


def phase_lm_family_parity(torch) -> None:
    for arch, layers, prompt_len in (("whisper-tiny", None, 64),
                                     ("internvl2-76b", 4, 32)):
        family_parity(torch, arch, layers, prompt_len)
        _free(torch)
    moe_parity(torch)


# ---------------------------------------------------------------------------
# phase 6: the serving fleet and STD training
# ---------------------------------------------------------------------------

FLEET_POLICIES = ("round_robin", "least_loaded", "p99")
TRAIN_CFG = dict(backbone="vgg16", width=1.0, image_size=HW,
                 merge_ch=(128, 64, 32), mode="reference",
                 storage_fp16=False)
TRAIN_BATCH = 4
TRAIN_STEPS = 20


def phase_fleet(torch, np, served: dict) -> dict:
    """6a: a Router over 3 ServiceReplicas, each an STDService on cuda:0
    with phase 3's settings (device box tail, max_batch 4, max_wait_ms
    5), replica r0 routing through a Planner over a (1, 1) mesh.  Under
    each policy the 24 requests of phase 3 (every third in class
    "batch") get phase 3's sequential boxes, and every replica batch
    launches K1 17, K2 7 and K3 once; the fleet's Prometheus text names
    each replica once a line, and ``refit_now`` fits r0's CostParams.
    Returns the launches of one replica batch."""
    from repro_torch import kernels
    from repro_torch.data.images import RequestStream
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.router import Router, ServiceReplica
    from repro_torch.launch.serve import STDService
    from repro_torch.runtime.planner import CostParams, Planner
    from repro_torch.runtime.telemetry import prometheus_text

    geo = dict(width=1.0, precision="bfp", buckets=(128, 256, 512),
               merge_ch=(128, 64, 32), postprocess="device", max_batch=4,
               max_wait_ms=5, inflight=1, device="cuda",
               params=served["params"])
    svcs = [STDService(**geo, planner=Planner(
        make_host_mesh((1, 1), device="cuda:0")) if i == 0 else None)
        for i in range(3)]
    reps = [ServiceReplica(f"r{i}", s) for i, s in enumerate(svcs)]
    images, want = served["images"], _box_keys(served["boxes"])

    def run(policy):
        lat = [None] * len(images)
        with Router(reps, policy=policy) as router:
            t0 = time.perf_counter()
            futs = []
            for i, img in enumerate(images):
                t = time.perf_counter()
                fut = router.submit(img, deadline_class="batch"
                                    if i % 3 == 2 else "interactive")
                fut.add_done_callback(
                    lambda f, i=i, t=t: lat.__setitem__(
                        i, time.perf_counter() - t))
                futs.append(fut)
            got = [f.result(timeout=600) for f in futs]
            wall = time.perf_counter() - t0
        # each replica's batcher stopped with the router: its batches
        n_batches = sum(len(s.stats["batching"]["batches"]) for s in svcs)
        return got, wall, lat, dict(router.stats["placed"]), n_batches

    # every engine built on each replica, untimed
    run("round_robin")
    for policy in FLEET_POLICIES:
        kernels.reset_launch_counts()
        got, wall, lat, placed, n_batches = run(policy)
        launches = _checked_launches(kernels, n_batches,
                                     f"fleet, {policy}")
        if _box_keys(got) != want:
            fail(f"fleet, {policy}: boxes differ from phase 3's sequential "
                 f"boxes")
        lat = [v for v in lat if v is not None]
        if len(lat) != len(images):
            fail(f"fleet, {policy}: {len(lat)} latencies for "
                 f"{len(images)} requests")
        log(f"6a fleet of 3, {policy}: {len(images)} requests "
            f"{len(images) / wall:.2f} images/s, latency p50/p99 "
            f"{np.percentile(lat, 50) * 1e3:.2f} / "
            f"{np.percentile(lat, 99) * 1e3:.2f} ms, requests per replica "
            f"{placed}, {n_batches} replica batches, boxes equal phase 3's "
            f"sequential boxes, launches {launches}")
    with Router(reps, policy="p99") as router:
        fitted = router.refit_now()
        text = prometheus_text(router.metrics_snapshot())
    lines = text.splitlines()
    twice = [ln for ln in lines if ln.count('replica="') > 1]
    missing = [r.name for r in reps
               if not any(f'replica="{r.name}"' in ln for ln in lines)]
    if twice or missing:
        fail(f"fleet metrics: {len(twice)} lines name a replica twice "
             f"({twice[:2]}), replicas missing {missing}")
    if set(fitted) != {"r0"} or not isinstance(fitted["r0"], CostParams):
        fail(f"fleet refit_now: {fitted}")
    log(f"6a fleet metrics_prometheus: {len(lines)} lines, each replica "
        f"labelled once a line; refit_now fitted r0: {fitted['r0']}")
    return {"fleet, one replica batch": dict(VGG_LAUNCHES)}


@contextlib.contextmanager
def deterministic(torch):
    """Deterministic algorithms for this block only (the device box tail
    elsewhere has no deterministic CUDA path)."""
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark)
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev[0])
        torch.backends.cudnn.deterministic = prev[1]
        torch.backends.cudnn.benchmark = prev[2]


def _leaves_equal(torch, a, b) -> bool:
    from repro_torch.core import tree as tree_lib

    la, lb = tree_lib.leaves(a), tree_lib.leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def phase_training(torch, np):
    """6b: full-width VGG-16 PixelLink training in the reference datapath
    (512x512, batch 4, AdamW, cosine_with_warmup(3e-3, 5, 20)) through
    TrainRunner and a CheckpointManager, checkpoints every 5 steps: 20
    steps crash after step 13, the resume starts at 10, and its params
    and optimizer state are bit-equal to 20 uninterrupted steps.  Returns
    the final params."""
    import tempfile

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import tree as tree_lib
    from repro_torch.data.images import SyntheticSTDData
    from repro_torch.launch import train_std
    from repro_torch.models.fcn import PixelLinkModel, STDLoss
    from repro_torch.models.fcn.pixellink import STDConfig
    from repro_torch.optim import adamw, cosine_with_warmup
    from repro_torch.runtime.fault_tolerance import TrainRunner

    model = PixelLinkModel(STDConfig(**TRAIN_CFG), "cuda")
    params = model.init_params(torch.Generator().manual_seed(0))
    data = SyntheticSTDData(HW, seed=0)
    samples = {}

    def batch_fn(i):
        if i not in samples:
            samples[i] = data.sample(i, TRAIN_BATCH)
        return train_std.batch_on(samples[i], "cuda")

    opt_init, opt_update = adamw(cosine_with_warmup(3e-3, 5, TRAIN_STEPS),
                                 weight_decay=1e-4)
    step = train_std.make_train_step(model, STDLoss(), opt_update)
    state0 = (params, opt_init(params))
    with deterministic(torch), tempfile.TemporaryDirectory() as d:
        crashed = TrainRunner(step, batch_fn, CheckpointManager(d),
                              ckpt_every=5)
        try:
            crashed.run(state0, 0, TRAIN_STEPS, fail_at=13)
            fail("6b: the injected failure at step 13 did not fire")
        except RuntimeError as e:
            if "injected" not in str(e):
                raise
        runner = TrainRunner(step, batch_fn, CheckpointManager(d),
                             ckpt_every=5)
        start, state = runner.resume_or_init(state0)
        if start != 10:
            fail(f"6b: resumed at step {start}, not 10")
        _, resumed, status = runner.run(state, start, TRAIN_STEPS - start)
        mgr = CheckpointManager(os.path.join(d, "async"))
        t0 = time.perf_counter()
        mgr.save(TRAIN_STEPS, resumed, blocking=False)
        blocking_s = time.perf_counter() - t0
        mgr.wait()
        save_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        direct, losses, walls = state0, [], []
        for i in range(TRAIN_STEPS):
            b = batch_fn(i)
            t0 = time.perf_counter()
            direct, d_ = step(direct, b)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            losses.append(float(d_["loss"]))
        peak = torch.cuda.max_memory_allocated()
    if status != "done":
        fail(f"6b: the resumed run ended {status!r}")
    if not _leaves_equal(torch, resumed, direct):
        fail("6b: params and optimizer state resumed at step 10 differ from "
             "20 uninterrupted steps")
    if not all(np.isfinite(losses)):
        fail(f"6b: non-finite losses {losses}")
    if not np.mean(losses[-5:]) < losses[0]:
        fail(f"6b: the mean of the last 5 losses {np.mean(losses[-5:]):.4f}"
             f" is not below the first {losses[0]:.4f}")
    step_s = statistics.median(walls)
    state_bytes = sum(t.numel() * t.element_size()
                      for t in tree_lib.leaves(direct))
    runner_s = statistics.median(m["dt"] for m in runner.metrics_log)
    log(f"6b training VGG-16 PixelLink at width 1.0, 512x512, batch "
        f"{TRAIN_BATCH}, reference datapath, deterministic algorithms: "
        f"crash after step 13, resumed at 10, params and optimizer state "
        f"bit-equal to {TRAIN_STEPS} uninterrupted steps; losses "
        f"{losses[0]:.4f} -> {np.mean(losses[-5:]):.4f} (mean of the last "
        f"5); step {step_s * 1e3:.2f} ms median (host clock, TrainRunner "
        f"{runner_s * 1e3:.2f}), {TRAIN_BATCH / step_s:.2f} images/s, peak "
        f"memory {peak / 2**30:.2f} GiB; async save of "
        f"{state_bytes / 2**20:.1f} MiB: {blocking_s * 1e3:.1f} ms blocking,"
        f" {save_s * 1e3:.1f} ms to disk")
    return direct[0]


def phase_train_example(torch):
    """6c: ``launch/train_std.main(["--steps", "150"])`` on the card
    (width 0.25, 64x64): the held-out f-measure must improve."""
    from repro_torch.launch import train_std

    got = train_std.main(["--steps", "150"])
    log(f"6c train_std, 150 steps on the card: f-measure "
        f"{got['f_before']:.3f} -> {got['f_after']:.3f}")


def phase_deploy(torch, np, params) -> dict:
    """6d: 6b's trained params folded by ``normalize_weights`` and run in
    the optimized f32 datapath with the kernels (K1 17, K3 1 launches
    counted) through EngineFactory; their maps within phase 2's VGG-16
    gate of the reference-mode forward of the trained params.  Returns
    the launches."""
    from repro_torch import kernels
    from repro_torch.data.images import SyntheticSTDData
    from repro_torch.models.fcn import DetectionModel, PixelLinkModel
    from repro_torch.models.fcn import build_head
    from repro_torch.models.fcn.pixellink import STDConfig
    from repro_torch.runtime.executor import EngineFactory, SingleDevice

    trained = PixelLinkModel(STDConfig(**TRAIN_CFG), "cuda")
    deploy_cfg = STDConfig(**{**TRAIN_CFG, "mode": "optimized"})
    factory = EngineFactory(
        lambda hw, precision, model: DetectionModel(
            dataclasses.replace(deploy_cfg, image_size=hw),
            build_head(model), "cuda"), device="cuda")
    folded = factory.model(HW, "f32").normalize_weights(params)
    fn = factory.plan_fn(HW, BATCH, SingleDevice(), "f32")
    x = torch.from_numpy(SyntheticSTDData(HW, seed=0).sample(
        5000, BATCH)["images"]).cuda()
    vq = torch.full((BATCH, 2), HW[0] // 4, dtype=torch.int32, device="cuda")
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    labels, converged = fn(folded, x, vq)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    want = dict.fromkeys(launches, 0)
    want.update(winograd_tiles=17, local_spread_converge=1)
    if launches != want:
        fail(f"6d: launches {launches} != {want}")
    if not bool(converged.all()):
        fail("6d: CC labelling did not converge")
    maps = fn.forward(folded, x)
    with torch.no_grad():
        ref = trained.apply(params, x)
    deltas = {k: (float((maps[k] - ref[k]).abs().max()),
                  float((maps[k] - ref[k]).abs().mean()))
              for k in ("score", "links", "logits")}
    gate = map_gate("vgg16", None)
    for k in ("score", "links"):
        if deltas[k][0] > gate[0] or deltas[k][1] > gate[1]:
            fail(f"6d: deployed {k} maps differ from the reference-mode "
                 f"forward by {deltas[k]} (gate {gate})")
    log(f"6d deploy: trained params folded, optimized f32 datapath on K1 "
        f"and K3 (launches {launches}), maps against the reference-mode "
        f"forward (max, mean) {deltas}, gate {gate}; components per image "
        f"{[int(labels[i].unique().numel()) - 1 for i in range(BATCH)]}")
    return {"deploy check, one forward and CC tail": launches}


# ---------------------------------------------------------------------------
# phase 7: LM training on the card
# ---------------------------------------------------------------------------

LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_TRAIN_STEPS = 4, 512, 12


def phase_lm_refusal(torch, np) -> None:
    """7a: K4 and K5 under autograd on the card raise "no backward",
    through their wrappers and a kernel-route train-mode forward; under
    no_grad the same calls launch."""
    from repro_torch import configs
    from repro_torch.core import tree as tree_lib
    from repro_torch.kernels.flash_attention import flash_attention_padded
    from repro_torch.kernels.ssd_scan import ssd_chunk
    from repro_torch.models.lm import LMModel

    gen = torch.Generator(device="cuda").manual_seed(7)

    def rand(*shape):
        return torch.randn(shape, device="cuda", generator=gen)

    q, k, v = (rand(2, 8, 128, 64).requires_grad_(True) for _ in range(3))
    c, b = (rand(4, 1, 64, 32).requires_grad_(True) for _ in range(2))
    xdt = rand(4, 1, 4, 64, 16)
    scum = -torch.cumsum(rand(4, 1, 4, 64, 1).abs(), dim=3)
    calls = {"flash_attention_padded": lambda: flash_attention_padded(
                 q, k, v, sm_scale=0.125, causal=True, kv_len=128),
             "ssd_chunk": lambda: ssd_chunk(c, b, xdt, scum)}
    for name, arch in (("flash_attention_padded", "tinyllama-1.1b"),
                       ("ssd_chunk", "mamba2-370m")):
        wrapper = {"flash_attention_padded": flash_attention_padded,
                   "ssd_chunk": ssd_chunk}[name]
        model = LMModel(configs.get_smoke_config(arch), "cuda")
        live = tree_lib.tree_map(lambda t: t.requires_grad_(True),
                                 model.init_params(gen))
        toks = torch.randint(0, model.cfg.vocab, (2, 64), device="cuda",
                             generator=gen)
        ctx = {"use_flash": True, "use_kernel": True}
        for what, call in (("wrapper", calls[name]),
                           ("forward", lambda: model.forward(
                               live, toks, ctx_extra=ctx))):
            try:
                call()
                fail(f"7a: {name} {what} under autograd did not raise")
            except RuntimeError as e:
                if "no backward" not in str(e):
                    raise
            before = wrapper.launches
            with torch.no_grad():
                out = call()
            torch.cuda.synchronize()
            if wrapper.launches <= before:
                fail(f"7a: {name} {what} under no_grad did not launch")
            _finite(torch, f"7a {name} {what}",
                    out[0] if isinstance(out, tuple) else out)
    log("7a K4 and K5 under autograd on the card: wrappers and kernel-route "
        "forwards raise 'no backward'; under no_grad they launch")


LR1 = 3e-4 / 2000       # build_train_step's first-step learning rate
# bf16 card against CPU: the card's backward rounds each f32 cotangent to
# bf16 (2^-9 relative) and a bf16 activation can round to a neighbour
# (2^-8); a few such units bound the loss and each gradient leaf
BF16_LOSS_REL, BF16_GRAD_SHARE = 2.0 ** -8, 2.0 ** -5


def update_agreement(before, after, want_after, lr: float):
    """The AdamW update itself, ``after - before``, against the other
    side's ``want_after - before``: (the largest difference, the share of
    the entries the other side moved by over 3/4·lr that moved within
    lr/2 of it, the share of entries it moved so).  A first step moves a
    parameter by about lr·sign(g), so a step that leaves the parameters
    unchanged agrees on none of them."""
    worst, n_moved, n_close, n = 0.0, 0, 0, 0
    for b, a, w in zip(before, after, want_after):
        b = b.double().cpu()
        d, wd = a.double().cpu() - b, w.double().cpu() - b
        err = (d - wd).abs()
        worst = max(worst, float(err.max()))
        moved = wd.abs() > 0.75 * lr
        n += b.numel()
        n_moved += int(moved.sum())
        n_close += int((err[moved] <= 0.5 * lr).sum())
    return worst, n_close / max(n_moved, 1), n_moved / n


def _train_parity(torch, arch: str, layers: int, dtype: str) -> str:
    """One build_train_step on a one-slot mesh, card against CPU, from
    one seeded state."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import tree as tree_lib
    from repro_torch.launch import step_fns
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.lm import LMModel
    from repro_torch.optim import adamw, cosine_with_warmup
    from repro_torch.runtime import sharding

    cfg = dataclasses.replace(get_config(arch), n_layers=layers,
                              param_dtype=dtype, compute_dtype=dtype)
    params = LMModel(cfg, "cpu").init_params(
        torch.Generator().manual_seed(11))
    gen = torch.Generator().manual_seed(12)
    toks = torch.randint(0, cfg.vocab, (2, 128), generator=gen)
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, dims=1)}
    batch["labels"][:, -1] = -1
    shape = ShapeConfig("t", 128, 2, "train")
    opt_init = adamw(cosine_with_warmup(3e-4, 2000, 100_000))[0]
    out = {}
    for dev in ("cuda", "cpu"):
        mesh = make_host_mesh((1, 1), ("data", "model"), device=dev)
        built = step_fns.build_train_step(cfg, mesh, shape,
                                          moment_dtype="float32")
        p = tree_lib.tree_map(lambda t: t.to(dev), params)
        t0 = time.perf_counter()
        loss, grads = built.meta["value_and_grad"](p, batch)
        new, _, m = built.fn(p, opt_init(p), batch)
        param_sh = built.arg_shardings[0]
        out[dev] = (float(loss), float(m["loss"]),
                    sharding.gather_tree(grads, param_sh, "cpu"),
                    sharding.gather_tree(new, param_sh, "cpu"),
                    time.perf_counter() - t0)
        del built, p, grads, new
        _free(torch)
    (l_card, ls_card, g_card, p_card, t_card), \
        (l_cpu, ls_cpu, g_cpu, p_cpu, t_cpu) = out["cuda"], out["cpu"]
    f32 = dtype == "float32"
    loss_rel = abs(l_card - l_cpu) / abs(l_cpu)
    worst, worst_at = 0.0, ""
    for (path, a), b in zip(tree_lib.flatten_with_paths(g_card),
                            tree_lib.leaves(g_cpu)):
        a, b = a.float(), b.float()
        share = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
        if share > worst:
            worst, worst_at = share, path
    moved, agree, moved_share = update_agreement(
        tree_lib.leaves(params), tree_lib.leaves(p_card),
        tree_lib.leaves(p_cpu), LR1)
    loss_tol, grad_tol = (1e-5, 1e-3) if f32 else (BF16_LOSS_REL,
                                                   BF16_GRAD_SHARE)
    msg = (f"7b {arch} ({layers} layers, {dtype}, remat {cfg.remat}, batch "
           f"2 x 128): loss card {l_card:.7f} CPU {l_cpu:.7f} (rel "
           f"{loss_rel:.2e}, gate {loss_tol:.2e}); gradients worst "
           f"{worst:.2e} of the leaf's largest |g| at {worst_at} (gate "
           f"{grad_tol:.2e}); AdamW update card - CPU max {moved:.3g} "
           f"(2·lr {2 * LR1:.3g}), {agree:.4%} of the {moved_share:.2%} of "
           f"entries the CPU moved by over 3/4·lr within lr/2; card "
           f"{t_card:.1f} s, CPU {t_cpu:.1f} s")
    if loss_rel > loss_tol or worst > grad_tol:
        fail(msg)
    # a bf16 leaf does not show a first step of lr = 1.5e-7 (its spacing
    # is about 2^-8 of its value): the update is gated in f32
    if f32 and (moved > 2 * LR1 or agree < 0.999 or moved_share < 0.5):
        fail(msg)
    return msg


def phase_lm_train_parity(torch) -> None:
    """7b: TinyLlama-1.1B (2 layers) and Zamba2-2.7B (6 layers, one
    shared-attention site) at published widths in f32, and TinyLlama in
    bf16 (the card's ``low_precision_matmul`` backward)."""
    for arch, layers, dtype in (("tinyllama-1.1b", 2, "float32"),
                                ("zamba2-2.7b", 6, "float32"),
                                ("tinyllama-1.1b", 2, "bfloat16")):
        log(_train_parity(torch, arch, layers, dtype))


def phase_lm_training(torch, np, profile=False):
    """7c: TinyLlama-1.1B as published (22 layers, bf16, remat) trained
    12 steps at batch 4 x 512 through launch/train.make_step; then 2 steps
    with remat off from the same state.  Returns the launches, and for
    phase 9 the bytes of the state and batch it placed and the forward
    and backward's memory above them."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core import tree as tree_lib
    from repro_torch.data import Prefetcher, TokenDataset
    from repro_torch.launch import train
    from repro_torch.models.lm import LMModel, count_params
    from repro_torch.models.lm.params import materialize
    from repro_torch.optim import adamw, cosine_with_warmup, value_and_grad

    cfg = get_config("tinyllama-1.1b")
    n_params = count_params(cfg)
    tokens = LM_TRAIN_BATCH * LM_TRAIN_SEQ
    ds = TokenDataset(cfg.vocab, LM_TRAIN_SEQ, LM_TRAIN_BATCH, seed=0)
    opt_init, opt_update = adamw(
        cosine_with_warmup(1e-3, 20, max(LM_TRAIN_STEPS, 21)),
        weight_decay=0.01)
    model = LMModel(cfg, "cuda")
    params0 = model.init_params(torch.Generator(device="cuda").manual_seed(0))
    state0 = (params0, opt_init(params0), torch.zeros((), device="cuda"))

    def run(model, n_steps):
        step = train.make_step(model, opt_update)
        state, losses, norms, walls = state0, [], [], []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        feed = Prefetcher(ds.batch(i) for i in range(n_steps))
        for batch in feed:
            t0 = time.perf_counter()
            state, m = step(state, batch)
            losses.append(float(m["loss"]))    # waits for the step
            norms.append(float(m["grad_norm"]))
            walls.append(time.perf_counter() - t0)
        return losses, norms, walls, torch.cuda.max_memory_allocated()

    _free(torch)
    kernels.reset_launch_counts()
    losses, norms, walls, peak = run(model, LM_TRAIN_STEPS)
    launches = kernels.launch_counts()
    if any(launches.values()):
        fail(f"7c: LM training launched kernels {launches}")
    if not (np.isfinite(losses).all() and np.isfinite(norms).all()):
        fail(f"7c: non-finite losses {losses} or norms {norms}")
    step_s = statistics.median(walls[2:])
    flops = 8 * n_params * tokens             # 6·N·T and remat's forward
    log(f"7c TinyLlama-1.1B training ({n_params / 1e9:.3f} B params, 22 "
        f"layers, bf16, remat on, AdamW f32 moments), batch "
        f"{LM_TRAIN_BATCH} x {LM_TRAIN_SEQ}: losses {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}, grad norms {norms[0]:.3g} .. {norms[-1]:.3g}; "
        f"step {step_s * 1e3:.2f} ms median of steps 3-{LM_TRAIN_STEPS} "
        f"(host clock; first {walls[0] * 1e3:.0f} ms), "
        f"{tokens / step_s:.0f} tokens/s, peak memory {peak / 2**30:.2f} "
        f"GiB; bf16 bound {flops / 1e12:.2f} TFLOP / {BF16_PEAK / 1e12:.0f}"
        f" TFLOP/s = {flops / BF16_PEAK * 1e3:.2f} ms, "
        f"{flops / BF16_PEAK / step_s:.1%} of it; kernels launched: none")
    if profile:
        step = train.make_step(model, opt_update)
        first = {k: torch.from_numpy(v).cuda()
                 for k, v in ds.batch(0).items()}
        step(state0, first)
        profile_step(torch, step, state0, first,
                     what="7c TinyLlama-1.1B training step")
    plain = LMModel(dataclasses.replace(cfg, remat=False), "cuda")
    losses_off, _, walls_off, peak_off = run(plain, 2)
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses_off, losses))
    if rel > 1e-2:
        fail(f"7c: remat off losses {losses_off} vs on {losses[:2]}")
    # the forward and backward alone: the update's copies of the state
    # set the step's peak, whatever the activations
    batch = next(Prefetcher(iter([ds.batch(0)])))      # as 7c's steps
    grad_peak, held = {}, {}
    for name, m in (("on", model), ("off", plain)):
        _free(torch)
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        value_and_grad(train.make_loss(m), params0, batch)
        torch.cuda.synchronize()
        grad_peak[name] = torch.cuda.max_memory_allocated() - base
        # what the forward leaves for the backward: the buffers phase 9's
        # dry run counts (the leaves share the parameters' storage)
        live = tree_lib.tree_map(lambda t: t.detach().requires_grad_(True),
                                 params0)
        _free(torch)
        base = torch.cuda.memory_allocated()
        with torch.enable_grad():
            loss = train.make_loss(m)(live, batch)
        torch.cuda.synchronize()
        held[name] = torch.cuda.memory_allocated() - base
        del loss, live
    log(f"7c remat off, 2 steps from the same state: step peak "
        f"{peak_off / 2**30:.2f} GiB against {peak / 2**30:.2f} with remat;"
        f" forward and backward above the state: "
        f"{grad_peak['off'] / 2**30:.2f} GiB against "
        f"{grad_peak['on'] / 2**30:.2f} with remat (held after the forward "
        f"{held['off'] / 2**30:.2f} and {held['on'] / 2**30:.2f} GiB); "
        f"losses {losses_off} "
        f"against {losses[:2]} (max rel {rel:.2e}, "
        f"{'bit-equal' if losses_off == losses[:2] else 'not bit-equal'});"
        f" step {walls_off[-1] * 1e3:.2f} ms")
    # the arguments phase 9's dry run counts: params, AdamW state, batch
    state_bytes = sum(t.numel() * t.element_size() for t in
                      tree_lib.leaves((state0[0], state0[1], batch)))
    del state0, params0
    _free(torch)
    # the same draw without init_params' fan-in rescale (the reference's
    # init): one step, for its gradient norm against norms[0]
    drawn = materialize(model.param_meta(),
                        torch.Generator(device="cuda").manual_seed(0),
                        "cuda")
    _, m = train.make_step(model, opt_update)(
        (drawn, opt_init(drawn), torch.zeros((), device="cuda")), batch)
    log(f"7c first step from the init as drawn (attention fan-in = heads): "
        f"loss {float(m['loss']):.4f}, grad norm {float(m['grad_norm']):.4g}"
        f" against {norms[0]:.4g} from init_params (fan-in rescaled)")
    del drawn, m
    _free(torch)
    facts = {"n_params": n_params, "tokens": tokens,
             "state_bytes": state_bytes, "grad_peak": grad_peak,
             "held": held}
    return {"lm training step (TinyLlama-1.1B)": launches}, facts


def _checkpoint_bytes(directory: str, step: int) -> dict:
    d = os.path.join(directory, f"step_{step}")
    out = {}
    for f in sorted(os.listdir(d)):
        if f.endswith(".bin"):
            with open(os.path.join(d, f), "rb") as fh:
                out[f] = fh.read()
    return out


def phase_lm_resume(torch) -> None:
    """7d: launch/train.py --smoke on the card, crashed after step 5 with
    checkpoints every 2 steps, then resumed: the final checkpoint equals
    an uninterrupted run's byte for byte."""
    import tempfile

    from repro_torch.launch import train

    flags = ["--smoke", "--steps", "10", "--ckpt-every", "2",
             "--log-every", "100"]
    with tempfile.TemporaryDirectory() as d:
        train.main(flags + ["--ckpt-dir", os.path.join(d, "direct")])
        try:
            train.main(flags + ["--ckpt-dir", os.path.join(d, "crash"),
                                "--fail-at", "5"])
            fail("7d: the injected failure at step 5 did not fire")
        except RuntimeError as e:
            if "injected" not in str(e):
                raise
        logs = train.main(flags + ["--ckpt-dir", os.path.join(d, "crash")])
        direct = _checkpoint_bytes(os.path.join(d, "direct"), 10)
        resumed = _checkpoint_bytes(os.path.join(d, "crash"), 10)
    if [int(m["step"]) for m in logs] != list(range(5, 11)):
        fail(f"7d: resumed steps {[m['step'] for m in logs]}")
    if not direct or direct != resumed:
        diff = [k for k in direct if direct[k] != resumed.get(k)]
        fail(f"7d: resumed final state differs from the uninterrupted run "
             f"in {len(diff)} of {len(direct)} leaves: {diff[:4]}")
    log(f"7d launch.train --smoke on the card: crash after step 5, resume "
        f"at 4, final checkpoint ({len(direct)} leaves) bit-equal to 10 "
        f"uninterrupted steps")


def phase_lm_100m(torch) -> None:
    """7e: the ~100M-parameter example with a crash at step 120."""
    import tempfile

    from repro_torch.launch import train_lm_100m

    with tempfile.TemporaryDirectory() as d:
        got = train_lm_100m.main(["--steps", "200", "--crash-at", "120",
                                  "--ckpt-dir", os.path.join(d, "ckpt")])
    log(f"7e train_lm_100m: loss {got['first']:.3f} -> {got['last']:.3f} "
        f"over {got['steps']} logged steps ({got['status']})")


# phase 8: the pipeline at full width
PIPE_ARCH, PIPE_STAGES, PIPE_MICRO, PIPE_BATCH, PIPE_SEQ = \
    "internlm2-1.8b", 4, 4, 8, 512
K4_F32_TOL = 2e-3


def _timed_grad(torch, fn, runs: int = 3):
    """``fn() -> (y, loss, grads)`` once to warm up, then ``runs`` times:
    (the last result, the median host-clock ms)."""
    out, walls = fn(), []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return out, statistics.median(walls)


def phase_pipeline(torch) -> dict:
    """8: InternLM2-1.8B at published widths and full depth (24 layers,
    f32) through ``runtime.pipeline.pipeline_apply`` in 4 stages on a
    (4, 2) host mesh of cuda:0, 4 microbatches of 2 x 512, against the
    sequential per-microbatch loop over the 24 layers.  Returns the
    launches of the use_flash forward."""
    from torch.utils.checkpoint import checkpoint

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core import tree as tree_lib
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.lm import LMModel
    from repro_torch.models.lm import params as params_lib
    from repro_torch.runtime.pipeline import (microbatch, pipeline_apply,
                                              split_stages)

    cfg = dataclasses.replace(get_config(PIPE_ARCH), param_dtype="float32",
                              compute_dtype="float32")
    model = LMModel(cfg, "cuda")
    params = model.init_params(torch.Generator(device="cuda").manual_seed(0))
    toks = torch.randint(0, cfg.vocab, (PIPE_BATCH, PIPE_SEQ), device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(1))
    with torch.no_grad():
        x = microbatch(model._embed(params, toks), PIPE_MICRO)
    layers = params["layers"]
    del params
    _free(torch)
    L, S = cfg.n_layers, PIPE_STAGES
    mesh = make_host_mesh((S, 2), ("stage", "mdl"), device="cuda:0")
    layer_fn = model.layer_fn()

    # the dry run's account of the same forward and backward on meta
    meta_model = LMModel(cfg, "meta")
    meta_layers = params_lib.abstract(meta_model.param_meta()["layers"])
    meta_mesh = make_host_mesh((S, 2), ("stage", "mdl"), device="meta")
    meta_x = torch.empty(x.shape, device="meta")
    account = {}
    for remat in (True, False):
        staged = tree_lib.tree_map(lambda a: a.detach().requires_grad_(True),
                                   split_stages(meta_layers, S))

        def meta_step():
            y = pipeline_apply(meta_mesh, "stage", meta_model.layer_fn(),
                               staged, meta_x, remat=remat)
            torch.autograd.grad((y ** 2).sum(), tree_lib.leaves(staged))

        account[remat] = dryrun.account(meta_step,
                                        keep=tree_lib.leaves(staged))[1]

    def grads_of(y, leaves):
        loss = (y ** 2).sum()
        return float(loss.detach()), torch.autograd.grad(loss, leaves)

    def pipelined(remat=True):
        staged = tree_lib.tree_map(lambda a: a.detach().requires_grad_(True),
                                   split_stages(layers, S))
        y = pipeline_apply(mesh, "stage", layer_fn, staged, x, remat=remat)
        loss, g = grads_of(y, tree_lib.leaves(staged))
        return y.detach(), loss, [a.reshape(L, *a.shape[2:]) for a in g]

    def sequential():
        live = tree_lib.tree_map(lambda a: a.detach().requires_grad_(True),
                                 layers)
        ys = []
        for m in range(PIPE_MICRO):
            h = x[m]
            for i in range(L):
                lp = tree_lib.tree_map(lambda a: a[i], live)
                h = checkpoint(layer_fn, lp, h, use_reentrant=False)
            ys.append(h)
        y = torch.stack(ys)
        loss, g = grads_of(y, tree_lib.leaves(live))
        return y.detach(), loss, list(g)

    (y_pp, _, g_pp), pp_ms = _timed_grad(torch, pipelined)
    (y_sq, loss_sq, g_sq), sq_ms = _timed_grad(torch, sequential)
    scale = float(y_sq.abs().max())
    fwd_err = float((y_pp - y_sq).abs().max())
    worst, worst_at = 0.0, "every leaf"
    for (path, _), a, b in zip(tree_lib.flatten_with_paths(layers), g_pp,
                               g_sq, strict=True):
        share = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
        if share > worst:
            worst, worst_at = share, path
    del g_sq, y_sq, y_pp
    peak = {}
    for remat in (True, False):
        del g_pp
        _free(torch)
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        y, loss, g_pp = pipelined(remat)
        torch.cuda.synchronize()
        peak[remat] = torch.cuda.max_memory_allocated() - base
        if remat:
            loss_on = loss
        else:
            loss_off = loss
    del g_pp, y
    _free(torch)
    remat_rel = abs(loss_on - loss_off) / abs(loss_on)
    n_params = sum(a.numel() for a in tree_lib.leaves(layers))
    msg = (f"8 pipeline_apply, {PIPE_ARCH} at published widths, {L} layers"
           f" ({n_params / 1e9:.3f} B layer params, f32) in {S} stages on "
           f"a ({S}, 2) host mesh of cuda:0, {PIPE_MICRO} microbatches of "
           f"{PIPE_BATCH // PIPE_MICRO} x {PIPE_SEQ}: forward against the "
           f"sequential loop max |diff| {fwd_err:.3g} of largest |y| "
           f"{scale:.4g} (gate 1e-5 of it; "
           f"{'bit-equal' if fwd_err == 0 else 'not bit-equal'}); gradients "
           f"of sum(y^2) worst {worst:.2e} of the leaf's largest |g| at "
           f"{worst_at} (gate 1e-4); loss remat on {loss_on!r} off "
           f"{loss_off!r} (rel {remat_rel:.2e}, gate 1e-6, "
           f"{'bit-equal' if loss_on == loss_off else 'not bit-equal'}); "
           f"forward+backward {pp_ms:.1f} ms pipelined against {sq_ms:.1f} "
           f"ms for the loop (host clock, median of 3, every slot on one "
           f"card, both with remat; "
           f"{account[True]['flops'] / pp_ms / 1e9:.2f} TFLOP/s of the "
           f"{account[True]['flops'] / 1e12:.2f} TFLOP the dry run counts);"
           f" peak memory above the state {peak[True] / 2**30:.2f} GiB "
           f"with remat, {peak[False] / 2**30:.2f} GiB without (the dry "
           f"run's saved bytes {account[True]['saved_bytes'] / 2**30:.2f} "
           f"and {account[False]['saved_bytes'] / 2**30:.2f} GiB)")
    if fwd_err > 1e-5 * scale or worst > 1e-4 or remat_rel > 1e-6:
        fail(msg)
    log(msg)

    # K4 (f32) at every attention layer of the pipelined forward
    flash_fn = model.layer_fn({"use_flash": True})
    with torch.no_grad():
        kernels.reset_launch_counts()
        y_flash = pipeline_apply(mesh, "stage", flash_fn,
                                 split_stages(layers, S), x)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        ys = []
        for m in range(PIPE_MICRO):
            h = x[m]
            for i in range(L):
                h = flash_fn(tree_lib.tree_map(lambda a: a[i], layers), h)
            ys.append(h)
        y_loop = torch.stack(ys)
        y_plain = pipeline_apply(mesh, "stage", layer_fn,
                                 split_stages(layers, S), x)
    want = {k: 0 for k in launches}
    want["flash_attention_padded"] = L * PIPE_MICRO
    flash_err = float((y_flash - y_loop).abs().max())
    plain_err = float((y_flash - y_plain).abs().max())
    plain_scale = float(y_plain.abs().max())
    msg = (f"8 pipelined forward with use_flash under no_grad: launches "
           f"{launches} (want K4 {L} x {PIPE_MICRO} = {L * PIPE_MICRO}); "
           f"against the same loop max |diff| {flash_err:.3g} (gate "
           f"atol/rtol {K4_F32_TOL}), against the plain-attention pipeline "
           f"{plain_err:.3g} of largest |y| {plain_scale:.4g} (gate "
           f"{K4_F32_TOL} of it)")
    if launches != want or plain_err > K4_F32_TOL * plain_scale or \
            not torch.allclose(y_flash, y_loop, atol=K4_F32_TOL,
                               rtol=K4_F32_TOL):
        fail(msg)
    log(msg)
    del layers, x, y_flash, y_loop, y_plain
    _free(torch)
    return {f"pipeline forward ({PIPE_ARCH}, {L} layers in {S} stages, "
            f"use_flash)": launches}


def phase_dryrun(torch, facts: dict) -> None:
    """9: the dry run (``launch/dryrun.run_cell``, on the meta device) of
    phase 7c's cell, TinyLlama-1.1B as published at batch 4 x 512 on a
    1x1 mesh, remat on and off, against what 7c placed and measured on
    the card."""
    import tempfile

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun

    shape = ShapeConfig("lm_train_4x512", LM_TRAIN_SEQ, LM_TRAIN_BATCH,
                        "train")
    rec = {}
    with tempfile.TemporaryDirectory() as d:
        for remat in (True, False):
            r = dryrun.run_cell("tinyllama-1.1b", shape, mesh="1x1",
                                report_dir=d, verbose=False,
                                cfg_overrides={"remat": remat})
            if r["status"] != "ok":
                fail(f"9: the dry run failed: {r.get('traceback')}")
            rec[remat] = r
    args = rec[True]["memory"]["argument_size_bytes"]
    saved = {k: r["saved_bytes"] for k, r in rec.items()}
    peak, held = facts["grad_peak"], facts["held"]
    ratio = {k: saved[k] / peak["on" if k else "off"] for k in saved}
    held_ratio = {k: saved[k] / held["on" if k else "off"] for k in saved}
    bound = 8 * facts["n_params"] * facts["tokens"]
    msg = (f"9 dry run of 7c's cell on meta: argument bytes "
           f"{args} against {facts['state_bytes']} placed on the card "
           f"(params, AdamW state, batch); saved for the backward remat off "
           f"{saved[False] / 2**30:.3f} GiB = {ratio[False]:.3f} x the "
           f"card's forward+backward peak above the state "
           f"({peak['off'] / 2**30:.3f} GiB; gate 0.5-2) and "
           f"{held_ratio[False]:.3f} x what its forward left for the "
           f"backward ({held['off'] / 2**30:.3f} GiB); remat on "
           f"{saved[True] / 2**30:.3f} GiB = {ratio[True]:.3f} x the peak "
           f"({peak['on'] / 2**30:.3f} GiB), {held_ratio[True]:.3f} x held "
           f"({held['on'] / 2**30:.3f} GiB); counted FLOPs "
           f"{rec[True]['flops']:.4e} with remat, {rec[False]['flops']:.4e}"
           f" without, against 7c's 8·N·T {bound:.4e}; aten ops "
           f"{rec[True]['aten_ops']} with remat, {rec[False]['aten_ops']} "
           f"without; dry run {rec[True]['run_s']} + {rec[False]['run_s']} s"
           f" on the host")
    if args != facts["state_bytes"] or saved[False] <= saved[True] \
            or not 0.5 <= ratio[False] <= 2.0:
        fail(msg)
    log(msg)


def main() -> None:
    if not (SRC / "repro_torch" / "csrc").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout")
    sys.path.insert(0, str(SRC))
    # deterministic cuBLAS for phase 6b's bit-exact resume: read when CUDA
    # initializes
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    from repro_torch.core import resolve_device
    from repro_torch.kernels import build

    resolve_device("cuda")          # also switches TF32 off
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"on {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    build.library()
    log(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s")
    for line in build.build_log().splitlines():
        if "registers" in line or "spill" in line:
            log("ptxas: " + line.strip())
    sass = check_tensor_cores(build.library_path())

    profile = "--profile" in sys.argv[1:]
    from repro_torch.configs.pixellink_std import RESNET50, VGG16

    def timed(what, fn, *args, **kw):
        t = time.perf_counter()
        out = fn(*args, **kw)
        log(f"{what} took {time.perf_counter() - t:.1f} s")
        return out

    rows = timed("phase 1, FCN kernels", phase_kernels, torch, np,
                 profile=profile)
    zoo_rows = timed("phase 1, ResNet-50 and head shapes",
                     phase_zoo_kernels, torch, np, profile=profile)
    for name, extra in zoo_rows.items():
        rows[name] += extra
    rows.update(timed("phase 1, LM kernels", phase_lm_kernels, torch,
                      profile=profile))
    fcn = timed("phase 2, VGG-16", phase_model, torch, np, VGG16,
                VGG_LAUNCHES, profile=profile)
    resnet = timed("phase 2, ResNet-50", phase_model, torch, np, RESNET50,
                   RESNET_LAUNCHES, profile=profile)
    served = timed("phase 3, serving", phase_serving, torch, np,
                   profile=profile)
    zoo = timed("phase 3, EAST and DB serving", phase_zoo_serving, torch,
                np)
    plans, checked = timed("phase 3b, execution plans", phase_plans, torch,
                           np)
    for row in rows["winograd_tiles"]:
        if row["launches_per_forward"] is None:
            row["launches_per_forward"] = checked["band_row_launches"]
    if checked["band_row_launches"] != 4:
        fail(f"RowBand(4) launched K1 at {BAND4_CONV1_2} "
             f"{checked['band_row_launches']} times, not once per band")
    for name, extra in checked["rows"].items():
        rows[name] += extra
    served_lm = timed("phase 4, LM serving", phase_lm_serving, torch,
                      profile=profile)
    timed("phase 5", phase_lm_parity, torch)
    timed("phase 5b, family parity", phase_lm_family_parity, torch)
    fleet = timed("phase 6a, fleet", phase_fleet, torch, np, served)
    trained = timed("phase 6b, training", phase_training, torch, np)
    timed("phase 6c, train_std", phase_train_example, torch)
    deploy = timed("phase 6d, deploy check", phase_deploy, torch, np,
                   trained)
    timed("phase 7a, K4 and K5 refuse autograd", phase_lm_refusal, torch, np)
    timed("phase 7b, LM training parity", phase_lm_train_parity, torch)
    lm_train, train_facts = timed("phase 7c, LM training",
                                  phase_lm_training, torch, np,
                                  profile=profile)
    timed("phase 7d, LM resume", phase_lm_resume, torch)
    timed("phase 7e, train_lm_100m", phase_lm_100m, torch)
    pipe = timed("phase 8, pipeline", phase_pipeline, torch)
    timed("phase 9, dry run", phase_dryrun, torch, train_facts)
    launches = {k: fcn[k] for k in FCN_KERNELS}
    lm = served_lm["zamba2-2.7b prefill"]
    launches.update({k: lm[k] for k in LM_KERNELS})
    by_path = {"pixellink_resnet50 forward": resnet, **zoo, **plans,
               **fleet, **deploy, **served_lm, **lm_train, **pipe}

    meta = {
        "winograd_tiles": ("src/repro_torch/csrc/winograd_conv.cu",
                           "src/repro/kernels/winograd_conv/kernel.py:41"),
        "bfp_matmul_quantized": ("src/repro_torch/csrc/bfp_matmul.cu",
                                 "src/repro/kernels/bfp_matmul/kernel.py:33"),
        "local_spread_converge": ("src/repro_torch/csrc/cc_label.cu",
                                  "src/repro/kernels/cc_label/kernel.py:31"),
        "flash_attention_padded": (
            "src/repro_torch/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention/kernel.py:30"),
        "ssd_chunk": ("src/repro_torch/csrc/ssd_chunk.cu",
                      "src/repro/kernels/ssd_scan/kernel.py:30"),
    }
    out = []
    for name, shapes in rows.items():
        first = shapes[0]
        out.append({
            "name": name, "route": "cuda", "source": meta[name][0],
            "replaces": meta[name][1], "launches": launches[name],
            "max_abs_err": max(s["max_abs_err"] for s in shapes),
            **{k: first[k] for k in (
                "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "library_device_ms")},
            "launches_by_path": {p: c[name] for p, c in by_path.items()
                                 if c.get(name)},
            "shapes": shapes,
        })
        if name in sass:
            out[-1]["sass"] = sass[name]
    card = card_name_and_power()
    print(json.dumps({"kernels": out}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
