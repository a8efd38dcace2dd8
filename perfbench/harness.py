"""The benchmark's machinery, driven by data.

``BENCHMARK.json`` names the cells, configurations and metrics; every
piece belonging to one of them is a file found by its name:

* ``perfbench/workloads/<cell>.json``: the cell's limits for the check
  and how many engine calls its check keeps (``sample_calls``);
* ``perfbench/configs/<config>.json``: the configuration as it is run,
  and ``<config>.py`` beside it: its plain description, ``layers(cfg)``;
* ``perfbench/families/<family>.py``: what depends on the model family
  the configuration names (``family``, ``fcn`` by default): weights,
  request pool, notes on the results and the check (``families/fcn.py``
  lists the hooks);
* ``perfbench/traffic/<traffic>.json``: the mix, read by ``traffic.py``
  and by the driver it names;
* ``perfbench/drivers/<driver>.py``: one way of driving the program,
  a ``Driver(ctx, params, pool)`` with ``tap``, ``window(seconds,
  tracer)`` and ``close()``;
* ``perfbench/metrics/<metric>.py``: one reader per metric,
  ``read(rec)``, which returns ``None`` where it finds nothing to read.

:func:`run_cell` runs one cell once and returns the result line.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional, Tuple

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class BenchError(RuntimeError):
    """A run that cannot give a result."""


def load_module(path: Path) -> ModuleType:
    """A data-named Python file, imported by its path."""
    if not path.is_file():
        raise BenchError(f"missing {path}")
    name = "perfbench_file_" + "".join(
        c if c.isalnum() else "_" for c in str(path))
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json(path: Path) -> Dict[str, Any]:
    if not path.is_file():
        raise BenchError(f"missing {path}")
    return json.loads(path.read_text())


@dataclasses.dataclass
class Window:
    """What a driver's window produced.  ``served``: (pool index, the
    family's result, or None for a failed request) per result;
    ``seconds``: the window's length as measured; ``stats``: the drivers'
    raw per-layer readings; ``notes``: lines for stderr."""

    attempted: int
    failed: int
    served: List[Tuple[int, Optional[Any]]]
    seconds: float
    latencies_s: List[float] = dataclasses.field(default_factory=list)
    images: int = 0
    batches: int = 0
    stats: Dict[str, Any] = dataclasses.field(default_factory=dict)
    notes: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Ctx:
    """One run: the checkout, the cell and everything it names."""

    root: Path
    name: str
    entry: Dict[str, Any]          # the cell's BENCHMARK.json entry
    cell: Dict[str, Any]           # perfbench/workloads/<cell>.json
    config: Dict[str, Any]         # the configuration as it is run
    traffic: Dict[str, Any]
    layers: Any                    # the configuration's plain description
    family: ModuleType             # perfbench/families/<family>.py
    metrics: List[Dict[str, Any]]  # this run's metric entries
    seed: int
    seconds: float
    trace: bool
    device: Any


def open_cell(root: Path, name: str, seed: int, seconds: float,
              trace: bool, device) -> Ctx:
    root = Path(root)
    bench = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise BenchError(f"no workload {name!r} in BENCHMARK.json")
    entry = cells[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[entry["config"]]
    cfg_path = root / cfg_entry["file"]
    config = _json(cfg_path)
    layers = load_module(cfg_path.with_suffix(".py")).layers(config)
    base = root / "perfbench"
    family = load_module(base / "families" /
                         f"{config.get('family', 'fcn')}.py")
    return Ctx(root=root, name=name, entry=entry,
               cell=_json(base / "workloads" / f"{name}.json"),
               config=config,
               traffic=_json(base / "traffic" / f"{entry['traffic']}.json"),
               layers=layers, family=family,
               metrics=metrics_for(bench, name, trace),
               seed=int(seed), seconds=float(seconds), trace=bool(trace),
               device=device)


def metrics_for(bench: Dict[str, Any], cell: str, trace: bool
                ) -> List[Dict[str, Any]]:
    """The cell's end-to-end metrics (``--trace 0``) or its per-layer
    metrics (``--trace 1``): those that list it, and those without a
    list whose end-to-end metric it reports."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", ())
            or ("workloads" not in m and m["moves"] in names)]


def cache_env(root: Path) -> None:
    """Every compiler cache inside the checkout, at fixed paths.  The
    program's host threading is left at its own default."""
    cache = Path(root) / "build" / "perfbench-cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(cache / sub)
    # a library of the program that would load JAX by itself must not
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules() -> List[str]:
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def card(device) -> Dict[str, Any]:
    import torch

    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0)}
    return {"platform": "cpu", "kind": "cpu"}


def power_limit() -> str:
    """``name, power.limit`` of the card, for the record on stderr."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def say(msg: str) -> None:
    print(f"[perfbench] {msg}", file=sys.stderr, flush=True)


def run_cell(ctx: Ctx, t_start: float) -> Dict[str, Any]:
    """Set up, measure, check and read one run; returns the result."""
    import torch

    from perfbench.trace import Tracer, top

    dev = torch.device(ctx.device)
    mix = ctx.traffic
    fam = ctx.family
    params = fam.make_params(ctx, dev)
    pool = fam.pool(ctx)
    driver = load_module(ctx.root / "perfbench" / "drivers" /
                         f"{mix['driver']}.py").Driver(ctx, params, pool)
    tracer = Tracer(ctx.trace, dev)
    tracer.warm()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t_start
    win = driver.window(ctx.seconds, tracer)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    records = driver.tap.records()
    driver.close()
    del driver
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    win.notes.update(fam.notes(win.served))
    for k, v in sorted(win.notes.items()):
        say(f"{k}: {v}")
    checks = fam.check(ctx, params, records, pool, win.served, win.failed)
    rec = {"ctx": ctx, "window": win, "trace": tracer.summary,
           "setup_s": setup_s, "memory_peak_bytes": peak}
    metrics = {}
    root = ctx.root / "perfbench" / "metrics"
    for m in ctx.metrics:
        value = load_module(root / f"{m['name']}.py").read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = dict(card(dev), count=int(ctx.entry["chips"]),
                  memory_peak_bytes=int(peak))
    out: Dict[str, Any] = {"correct": bool(fam.passed(checks)),
                           "attempted": win.attempted, "failed": win.failed,
                           "metrics": metrics, "device": device}
    if ctx.trace and tracer.summary is not None:
        device.update(busy_s=tracer.summary["busy_s"],
                      window_s=tracer.summary["window_s"])
        out["breakdown"] = {
            "device_ops": top(tracer.summary["device_ops"]),
            "idle_gaps": top(tracer.summary["idle_gaps"])}
    out["checks"] = checks
    return out


def report(out: Dict[str, Any], floors) -> None:
    """The checks as the last lines of stderr (``floors`` name those whose
    limit is a floor), the result as the last line of stdout."""
    if out["device"]["platform"] == "gpu":
        say(f"card: {power_limit()}")
    for k, v in out["checks"].items():
        rel = ">=" if k in floors else "<="
        print(f"check {k} {v['value']!r} {rel} {v['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)

