"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload vgg16-serve-poisson --seed 7 \\
        --seconds 20 --trace 0

From the root of a checkout with one NVIDIA GPU per chip the cell asks
for.  Set-up (weights from the seed on the card, the request pool, the
cell's own engines warmed, the kernel library from ``build/kernels/``)
is timed from the process start as ``setup_s``; the window lasts
``--seconds``; then the check of the configuration's family
(``families/<family>.py``) runs on what the window produced.  With
``--trace 1`` a profiled slice of the window gives the per-layer metrics
instead of the end-to-end ones.  The last line of
stdout is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics``, ``device`` (``breakdown`` with ``--trace 1``) and ``checks``,
each number compared beside its limit; stderr ends with the same checks.
Exits non-zero, printing no result, without enough cards, when a JAX
module is loaded, or when the program is missing.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, *, root=None, device=None, t_start=None) -> int:
    """``device`` None means the card, checked; the tests pass ``"cpu"``
    to run the same path at a small size."""
    args = parse(argv)
    root = Path(root) if root is not None else ROOT
    for p in (str(root / "src"), str(root)):
        if p not in sys.path:
            sys.path.insert(0, p)
    from perfbench import harness

    harness.cache_env(root)
    import torch

    try:
        ctx = harness.open_cell(root, args.workload, args.seed,
                                args.seconds, args.trace, device or "cuda")
    except (harness.BenchError, KeyError) as e:
        harness.say(f"cannot open the cell: {e!r}")
        return 2
    if device is None:
        chips = int(ctx.entry["chips"])
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < chips:
            harness.say(f"needs {chips} CUDA device(s); torch sees "
                        f"{torch.cuda.device_count()}")
            return 2
    try:
        out = harness.run_cell(ctx, T_START if t_start is None else t_start)
    except (harness.BenchError, ImportError) as e:
        harness.say(f"run failed: {e!r}")
        return 3
    bad = harness.forbidden_modules()
    if bad:
        harness.say(f"modules of JAX or the JAX package are loaded: {bad}")
        return 4
    harness.report(out, ctx.family.FLOORS)
    return 0


if __name__ == "__main__":
    sys.exit(main())
