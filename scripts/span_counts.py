#!/usr/bin/env python3
"""Run one benchmark cell traced and print the counts its engine calls
carried: the mean per ``engine.run`` span of each count the port adds to
``SPANS``' tally (``bfp.fused`` from the BFP glue,
``cc.rounds`` and ``cc.syncs`` from the CC stitching), including those
no per-layer metric reads.

    python3 scripts/span_counts.py --workload resnet50-bulk-512 --seed 7

From the root of a checkout with a card.  It runs ``perfbench/run.py``
in this process with ``--trace 1`` (its result line prints as usual),
then reads the span log the traced slice left and prints one more JSON
line.
"""
import argparse
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from perfbench import run

    rc = run.main(["--workload", args.workload, "--seed", str(args.seed),
                   "--seconds", str(args.seconds), "--trace", "1"],
                  root=ROOT)
    if rc:
        sys.exit(rc)
    from repro_torch.runtime.telemetry import SPANS

    calls = [r.counts for r in SPANS.records() if r.name == "engine.run"]
    names = sorted({k for c in calls for k in c})
    print(json.dumps({
        "workload": args.workload, "seed": args.seed,
        "engine_runs": len(calls),
        "mean_counts": {k: statistics.mean(c.get(k, 0) for c in calls)
                        for k in names} if calls else {}}), flush=True)


if __name__ == "__main__":
    main()
