"""Readings for the limits of a cell's check, and its knee, on the chip.

    python3 perfbench/calibrate.py --workload vgg16-serve-poisson \\
        --seeds 11 12 13 --control-seeds 3 --seconds 4
    python3 perfbench/calibrate.py --workload vgg16-serve-poisson \\
        --seeds 5 --rates 20 30 40 --seconds 10

One process, one set-up of CUDA and the kernels; each seed (or rate)
builds the cell's driver afresh with its own traffic (the weights are
the configuration's) and runs a short window at the cell's own load.
For every seed it prints one JSON line: the check's numbers (the
family's ``check``), and for the first ``--control-seeds`` seeds the
control's (its ``control``): for the FCN family the reference at
``--control-bits`` mantissa bits (int8 BFP) in the program's place.
With ``--rates`` the open loop runs at each rate instead and the line
gives offered and completed requests, latency percentiles and how far
the backlog grew (the mean latency of the window's last fifth over its
first fifth).  The benchmark's own runs never run this.
"""
import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None, *, root=None, device=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--control-seeds", type=int, default=0)
    ap.add_argument("--control-bits", type=int, default=7)
    ap.add_argument("--rates", type=float, nargs="*", default=())
    args = ap.parse_args(argv)
    root = Path(root) if root is not None else ROOT
    for p in (str(root / "src"), str(root)):
        if p not in sys.path:
            sys.path.insert(0, p)
    from perfbench import harness

    harness.cache_env(root)
    import numpy as np
    import torch

    from perfbench.trace import Tracer

    device = device or "cuda"
    runs = [(s, r) for s in args.seeds for r in (args.rates or [None])]
    for n, (seed, rate) in enumerate(runs):
        ctx = harness.open_cell(root, args.workload, seed, args.seconds,
                                False, device)
        if rate is not None:
            ctx.traffic = dict(ctx.traffic, rate_per_s=rate)
        dev = torch.device(device)
        fam = ctx.family
        params = fam.make_params(ctx, dev)
        pool = fam.pool(ctx)
        t0 = time.perf_counter()
        driver = harness.load_module(
            root / "perfbench" / "drivers" /
            f"{ctx.traffic['driver']}.py").Driver(ctx, params, pool)
        setup = time.perf_counter() - t0
        win = driver.window(args.seconds, Tracer(False, dev))
        records = driver.tap.records()
        driver.close()
        del driver
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        line = {"seed": seed, "setup_s": setup, "attempted": win.attempted,
                "failed": win.failed, "notes": win.notes}
        lat = np.asarray(win.latencies_s)
        if lat.size:
            k = max(lat.size // 5, 1)
            line.update(p50_ms=float(np.median(lat)) * 1e3,
                        p95_ms=float(np.percentile(lat, 95)) * 1e3,
                        growth=float(lat[-k:].mean() / lat[:k].mean()))
        if rate is not None:
            line.update(rate_per_s=rate, offered=win.attempted,
                        completed=len(lat),
                        mean_batch=(float(np.mean([b for b, _ in
                                                   win.stats["batches"]]))
                                    if win.stats.get("batches") else None))
        else:
            line["checks"] = fam.check(ctx, params, records, pool,
                                       win.served, win.failed)
            if n < args.control_seeds:
                line["control"] = fam.control(ctx, params, records, pool,
                                              args.control_bits)
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
