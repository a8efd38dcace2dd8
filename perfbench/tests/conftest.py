"""Fixtures of the benchmark's own tests (run them from the repository
root: ``PYTHONPATH=src python -m pytest -q perfbench/tests``; on the card
``-m cuda`` runs the ones that need it).

``tiny_root`` is a temporary copy of the benchmark with throwaway cells
added as files and manifest entries only: the STD networks at width 0.125
through the same drivers, readers and check, small enough for the CPU.
"""
import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
for _p in (str(REPO / "src"), str(REPO)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

TINY_CELLS = {
    # cell: (config, traffic, the real cell whose metrics it reports; the
    # batcher's readers read nothing in the closed loop)
    "tiny-serve-open": ("tiny_vgg16", "tiny_open", "vgg16-serve-poisson"),
    "tiny-serve-closed": ("tiny_vgg16", "tiny_closed", "vgg16-serve-poisson"),
    "tiny-bulk": ("tiny_resnet50", "tiny_bulk", "resnet50-bulk-768p"),
}
TINY_LIMITS = {"logit_gap_max": 0.02, "logit_gap_mean": 0.002}


def write_json(path: Path, obj) -> None:
    path.write_text(json.dumps(obj, indent=1) + "\n")


def make_tiny_root(dst: Path) -> Path:
    shutil.copytree(REPO / "perfbench", dst / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", dst / "BENCHMARK.json")
    base = dst / "perfbench"
    bench = json.loads((dst / "BENCHMARK.json").read_text())
    # weight seeds whose maps have components at this width
    for bb, ws in (("vgg16", 3), ("resnet50", 1)):
        cfg = json.loads((base / "configs" / f"std_{bb}.json").read_text())
        cfg.update(name=f"tiny_{bb}", width=0.125, merge_ch=[16, 16, 8],
                   weight_seed=ws)
        write_json(base / "configs" / f"tiny_{bb}.json", cfg)
        shutil.copy(base / "configs" / f"std_{bb}.py",
                    base / "configs" / f"tiny_{bb}.py")
        bench["configs"].append({
            "name": f"tiny_{bb}", "source": "test",
            "file": f"perfbench/configs/tiny_{bb}.json",
            "reduced": ["width", "merge_ch", "weight_seed"],
            "why": "CPU test"})
    small = dict(sizes=[[48, 128], [48, 128]], pool=8, instances_mean=1.5,
                 buckets=[64, 128])
    for src, name, extra in (("ic15_poisson", "tiny_open",
                             {"rate_per_s": 10.0}),
                             ("ic15_single", "tiny_closed", {})):
        mix = json.loads((base / "traffic" / f"{src}.json").read_text())
        write_json(base / "traffic" / f"{name}.json",
                   dict(mix, **small, **extra))
    bulk = json.loads(
        (base / "traffic" / "ic15_bulk32_768p.json").read_text())
    bulk.update(sizes=[[64, 64], [64, 64]], pool=8, instances_mean=1.5,
                batch=4)
    write_json(base / "traffic" / "tiny_bulk.json", bulk)
    for cell, (cfg, traffic, like) in TINY_CELLS.items():
        bench["workloads"].append({"name": cell, "config": cfg,
                                   "traffic": traffic, "chips": 1,
                                   "why": "CPU test"})
        write_json(base / "workloads" / f"{cell}.json",
                   {"sample_calls": 2, "limits": TINY_LIMITS})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if like in m.get("workloads", ()):
                m["workloads"].append(cell)
    write_json(dst / "BENCHMARK.json", bench)
    return dst


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_tiny_root(tmp_path_factory.mktemp("bench"))


def run_cell(root, workload, seed=3_000_000_019, seconds=1.5, trace=0):
    """One CPU run of the harness; returns (exit code, last stdout line
    parsed, stderr)."""
    import contextlib
    import io
    import time

    from perfbench import run

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run.main(["--workload", workload, "--seed", str(seed),
                       "--seconds", str(seconds), "--trace", str(trace)],
                      root=root, device="cpu", t_start=time.perf_counter())
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()


@pytest.fixture
def cuda():
    """Skip without a card, deciding here and never at import."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")
