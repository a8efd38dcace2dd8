#!/usr/bin/env python3
"""Time K2 (10 mantissa bits, at merge1_c1 and head_logits), K3 and K4's
f32 kernel of one checkout on chip_smoke.py's phase-1 inputs, so that two
trees can be compared in one call on one card.

    python3 scripts/kernel_compare.py [--tree DIR]

``--tree`` names the root of the checkout whose ``src/repro_torch`` is
timed (default: this one); its kernels build into its own ``build/``.
Run each tree in its own process, in turns (parent, change, change,
parent).  K2's operands are seeded here (unit activations after ReLU,
He weights, as in chip_smoke) and quantized by the timed tree.  The other
inputs are built by this checkout's ``chip_smoke.k3_inputs``
(the synthetic maps and the serpentine batch, 32x32 tiles) and
``chip_smoke.k4_inputs`` (the f32 rows of ``K4_CASES``).  The script only
times, by chip_smoke's two methods (``ms``: events around each call on an
idle card; ``device_ms``: the calls queued behind a sleep); each tree's
own chip_smoke.py checks its kernels.  The last line is a JSON object of
the times.
"""
import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(ROOT))
    tree = Path(ap.parse_args().tree).resolve()
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    # this checkout's data/cc_cases (NumPy only), whatever tree is timed
    spec = importlib.util.spec_from_file_location(
        "cc_cases", ROOT / "src" / "repro_torch" / "data" / "cc_cases.py")
    cc_cases = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cc_cases)
    sys.path.insert(0, str(tree / "src"))
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    from repro_torch.core import resolve_device
    from repro_torch.kernels.bfp_matmul import (bfp_matmul_quantized,
                                                quantize_operands)
    from repro_torch.kernels.cc_label import local_spread_converge
    from repro_torch.kernels.flash_attention import flash_attention_padded

    dev = resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"tree {tree}: {smi}", flush=True)
    calls = {}
    gen = torch.Generator().manual_seed(2)
    for name, M, K, N in (("merge1_c1", 2048, 640, 128),
                          ("head_logits", 32768, 32, 9)):
        a = torch.relu(torch.randn((M, K), generator=gen)).to(dev)
        b = (torch.randn((K, N), generator=gen) * (2.0 / K) ** 0.5).to(dev)
        ops = quantize_operands(a, b)
        calls[f"K2 {name} 10 bits"] = (
            lambda o=ops: bfp_matmul_quantized(*o))
    k3 = chip_smoke.k3_inputs(torch, cc_cases)
    for name in ("synthetic", "serpentine"):
        args = [t.to(dev) for t in k3[name]]
        calls[f"K3 {name}"] = lambda a=args: local_spread_converge(*a)
    gen = torch.Generator(device=dev).manual_seed(1)
    for name, dims, dt, *_ in chip_smoke.K4_CASES:
        if dt == "float32":
            q, k, v, geo = chip_smoke.k4_inputs(torch, dims, torch.float32,
                                                gen)
            calls[f"K4 {name}"] = (
                lambda a=(q, k, v), g=geo: flash_attention_padded(*a, **g))
    times = {}
    for key, fn in calls.items():
        times[key] = dict(ms=chip_smoke.cuda_ms(torch, fn),
                          device_ms=chip_smoke.cuda_ms(torch, fn, queued=True))
        print(f"{key}: ms {times[key]['ms']:.4f} device_ms "
              f"{times[key]['device_ms']:.4f}", flush=True)
    print(json.dumps({"tree": str(tree), "card": smi, "times": times}),
          flush=True)


if __name__ == "__main__":
    main()
