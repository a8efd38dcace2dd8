"""A model family that is not an FCN, added as new files alone: its
results are not boxes, it has its own reference check, and a fault
planted where its answers are produced reads ``correct: false``."""
import json
import shutil

import pytest

from conftest import REPO, run_cell, write_json

FAMILY = '''"""A toy family: a request is a vector x, its result the index
of the largest entry of W x and that entry."""
import numpy as np
import torch

FLOORS = ("results_compared",)


def make_params(ctx, device):
    g = torch.Generator(device=device)
    g.manual_seed(int(ctx.config["weight_seed"]))
    d = int(ctx.config["dim"])
    return torch.randn(d, d, generator=g, device=device)


def pool(ctx):
    rng = np.random.default_rng(np.random.SeedSequence([ctx.seed, 1]))
    d = int(ctx.config["dim"])
    return [rng.standard_normal(d).astype(np.float32)
            for _ in range(int(ctx.traffic["pool"]))]


def notes(served):
    return {"results": f"{sum(r is not None for _, r in served)} served"}


def check(ctx, params, records, pool, served, failed):
    """The served entry against W x in float64, and how far it lies below
    the reference's best, each over the largest |entry|."""
    w = params.double().cpu().numpy()
    value = below = 0.0
    n = 0
    for j, got in served:
        if got is None:
            continue
        y = w @ pool[j].astype(np.float64)
        scale = np.abs(y).max()
        value = max(value, abs(got[1] - y[got[0]]) / scale)
        below = max(below, (y.max() - y[got[0]]) / scale)
        n += 1
    lim = ctx.cell["limits"]
    return {"value_gap": {"value": value, "limit": lim["value_gap"]},
            "below_best": {"value": below, "limit": lim["below_best"]},
            "failed_requests": {"value": failed, "limit": 0},
            "results_compared": {"value": n, "limit": 1}}


def passed(checks):
    return all(v["value"] >= v["limit"] if k in FLOORS
               else v["value"] <= v["limit"] for k, v in checks.items())
'''

DRIVER = '''"""One client asking the toy family's question back to back."""
import time

import numpy as np
import torch

from perfbench.harness import Window


class Tap:
    def records(self):
        return []


class Driver:
    def __init__(self, ctx, params, pool):
        self.w = params
        self.pool = [torch.from_numpy(x) for x in pool]
        self.order = np.random.default_rng(ctx.seed).permutation(len(pool))
        self.tap = Tap()
        self.answer(self.pool[0])

    def answer(self, x):
        y = self.w @ x.to(self.w.device)
        k = int(torch.argmax(y))
        return k, float(y[k])

    def window(self, seconds, tracer):
        lat, served = [], []
        t0 = time.perf_counter()
        tracer.plan(t0, seconds)
        while True:
            t = time.perf_counter()
            tracer.tick(t)
            if t >= t0 + seconds or len(served) >= 2000:
                break
            j = int(self.order[len(served) % len(self.order)])
            served.append((j, self.answer(self.pool[j])))
            lat.append(time.perf_counter() - t)
        tracer.finish()
        return Window(attempted=len(served), failed=0, served=served,
                      seconds=time.perf_counter() - t0, latencies_s=lat,
                      images=len(served))

    def close(self):
        del self.w
'''


def make_toy_root(dst):
    """A copy of the benchmark with the toy family's cells added as new
    files and manifest entries: ``toy-loop``, and ``toy-loop-off`` whose
    driver names the runner-up in place of the largest entry."""
    shutil.copytree(REPO / "perfbench", dst / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    base = dst / "perfbench"
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    (base / "families" / "toy_dot.py").write_text(FAMILY)
    write_json(base / "configs" / "toy_dot.json",
               {"name": "toy_dot", "source": "test", "family": "toy_dot",
                "dim": 16, "weight_seed": 5})
    (base / "configs" / "toy_dot.py").write_text(
        "def layers(cfg):\n    return {'dim': cfg['dim']}\n")
    bench["configs"].append({"name": "toy_dot", "source": "test",
                             "file": "perfbench/configs/toy_dot.json",
                             "reduced": [], "why": "CPU test"})
    (base / "drivers" / "toy_loop.py").write_text(DRIVER)
    off = DRIVER.replace("k = int(torch.argmax(y))",
                         "k = int(torch.argsort(y)[-2])")
    assert off != DRIVER
    (base / "drivers" / "toy_loop_off.py").write_text(off)
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for cell, driver in (("toy-loop", "toy_loop"),
                         ("toy-loop-off", "toy_loop_off")):
        write_json(base / "traffic" / f"{driver}.json",
                   {"driver": driver, "pool": 8})
        write_json(base / "workloads" / f"{cell}.json",
                   {"limits": {"value_gap": 1e-5, "below_best": 1e-5}})
        bench["workloads"].append({"name": cell, "config": "toy_dot",
                                   "traffic": driver, "chips": 1,
                                   "why": "CPU test"})
        e2e["latency_p50_ms"]["workloads"].append(cell)
    write_json(dst / "BENCHMARK.json", bench)
    return dst


@pytest.fixture(scope="module")
def toy_root(tmp_path_factory):
    return make_toy_root(tmp_path_factory.mktemp("toy"))


def test_only_new_files(toy_root):
    """Every file of the benchmark is in the copy as it is here."""
    for path in (REPO / "perfbench").rglob("*"):
        if path.is_file() and "__pycache__" not in path.parts:
            rel = path.relative_to(REPO)
            assert (toy_root / rel).read_bytes() == path.read_bytes(), rel


def test_toy_family_runs_correct(toy_root):
    from perfbench import harness

    bench = json.loads((toy_root / "BENCHMARK.json").read_text())
    names = [m["name"] for m in harness.metrics_for(bench, "toy-loop",
                                                    False)]
    assert sorted(names) == ["device_mem_gib", "latency_p50_ms",
                             "setup_s"]
    rc, out, err = run_cell(toy_root, "toy-loop", seconds=0.5)
    assert rc == 0, err
    assert out["correct"] is True, out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert out["checks"]["results_compared"]["value"] == out["attempted"]
    # a CPU run writes no number under the device metric
    assert set(out["metrics"]) == {"latency_p50_ms", "setup_s"}
    assert all(out["metrics"][k]["value"] > 0 for k in out["metrics"])
    assert "[perfbench] results: " in err
    tail = err.strip().splitlines()[-len(out["checks"]):]
    assert tail[-1].startswith("check results_compared ")
    assert " >= 1" in tail[-1] and " <= " in tail[0]


def test_toy_family_fault_is_incorrect(toy_root):
    rc, out, err = run_cell(toy_root, "toy-loop-off", seconds=0.5)
    assert rc == 0, err
    assert out["correct"] is False
    assert out["checks"]["below_best"]["value"] > \
        out["checks"]["below_best"]["limit"]
