"""The manifest against the files it names, the rules on names, and a
throwaway cell, configuration and metric added as files alone."""
import json
import re

import pytest

from conftest import REPO, TINY_CELLS, run_cell, write_json

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def bench():
    return json.loads((REPO / "BENCHMARK.json").read_text())


def test_every_name_finds_its_files():
    from perfbench import harness

    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    for c in b["configs"]:
        assert (REPO / c["file"]).is_file()
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert c["reduced"] == []
    for w in b["workloads"]:
        ctx = harness.open_cell(REPO, w["name"], 1, 1, 0, "cpu")
        assert ctx.layers and ctx.cell["limits"]
        assert (REPO / "perfbench" / "drivers" /
                f"{ctx.traffic['driver']}.py").is_file()
    for m in b["end_to_end"] + b["per_layer"]:
        mod = harness.load_module(REPO / "perfbench" / "metrics" /
                                  f"{m['name']}.py")
        assert callable(mod.read)


def test_names_units_and_arrows():
    b = bench()
    cells = {w["name"]: w for w in b["workloads"]}
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    every = (list(cells) + [c["name"] for c in b["configs"]]
             + list(e2e) + [m["name"] for m in b["per_layer"]]
             + [w["traffic"] for w in cells.values()])
    assert all(NAME.match(n) for n in every), every
    assert len({(w["config"], w["traffic"]) for w in cells.values()}) == \
        len(cells)
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            reported = e2e[m["moves"]].get("workloads", list(cells))
            assert w in reported, (m["name"], w)
    for w in cells:
        from perfbench.harness import metrics_for

        assert any(m["name"] == "setup_s" for m in metrics_for(b, w, False))
        assert len(metrics_for(b, w, False)) >= 2
        assert metrics_for(b, w, True)
    assert len(json.dumps(b)) < 64 * 1024


def test_result_line_shape(tiny_root):
    rc, out, err = run_cell(tiny_root, "tiny-serve-closed")
    assert rc == 0, err
    assert list(out)[:5] == RESULT_KEYS and list(out)[-1] == "checks"
    assert out["correct"] is True, out["checks"]
    assert set(out["metrics"]) == {"latency_p50_ms", "setup_s"}
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    tail = err.strip().splitlines()[-len(out["checks"]):]
    assert [ln.split()[1] for ln in tail] == list(out["checks"])


def test_traced_line_shape(tiny_root):
    # long enough that the traced slice (the window's last 40%) starts
    # after a batch even on a loaded CPU
    rc, out, _ = run_cell(tiny_root, "tiny-bulk", seconds=4.0, trace=1)
    assert rc == 0 and out["correct"] is True
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    # a CPU run writes no number under a device metric
    assert set(out["metrics"]) == {"engine.step_ms.bulk"}


def test_a_cell_config_and_metric_added_as_files(tmp_path):
    from conftest import make_tiny_root

    root = make_tiny_root(tmp_path)
    base = root / "perfbench"
    b = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((base / "configs" / "tiny_vgg16.json").read_text())
    cfg.update(name="tiny_vgg16_narrow", merge_ch=[8, 8, 8])
    write_json(base / "configs" / "tiny_vgg16_narrow.json", cfg)
    (base / "configs" / "tiny_vgg16_narrow.py").write_text(
        (base / "configs" / "tiny_vgg16.py").read_text())
    b["configs"].append({"name": "tiny_vgg16_narrow", "source": "test",
                         "file": "perfbench/configs/tiny_vgg16_narrow.json",
                         "reduced": [], "why": "test"})
    bulk = json.loads((base / "traffic" / "tiny_bulk.json").read_text())
    write_json(base / "traffic" / "tiny_bulk_b2.json", dict(bulk, batch=2))
    b["workloads"].append({"name": "added", "config": "tiny_vgg16_narrow",
                           "traffic": "tiny_bulk_b2", "chips": 1,
                           "why": "test"})
    write_json(base / "workloads" / "added.json",
               {"sample_calls": 2, "limits": {"logit_gap_max": 0.02,
                                              "logit_gap_mean": 0.002}})
    (base / "metrics" / "added.batches.py").write_text(
        "def read(rec):\n    return rec['window'].batches\n")
    b["per_layer"].append({"name": "added.batches", "unit": "batches",
                           "better": "higher", "source": "host_clock",
                           "layer": "test", "moves": "images_per_s",
                           "workloads": ["added"]})
    b["end_to_end"][[m["name"] for m in b["end_to_end"]]
                    .index("images_per_s")]["workloads"].append("added")
    write_json(root / "BENCHMARK.json", b)
    rc, out, err = run_cell(root, "added")
    assert rc == 0 and out["correct"] is True, err
    assert set(out["metrics"]) == {"images_per_s", "setup_s"}
    rc, out, err = run_cell(root, "added", trace=1)
    assert rc == 0 and out["metrics"]["added.batches"]["value"] > 0, err


@pytest.mark.parametrize("cell", sorted(TINY_CELLS))
def test_tiny_cells_run_correct(tiny_root, cell):
    rc, out, err = run_cell(tiny_root, cell)
    assert rc == 0, err
    assert out["correct"] is True and out["failed"] == 0, out["checks"]
    assert out["checks"]["images_compared"]["value"] >= 1


def test_refuses_without_a_card_or_the_program(tmp_path, tiny_root):
    import contextlib
    import io
    import shutil

    import torch

    from perfbench import run

    if not torch.cuda.is_available():
        err = io.StringIO()
        with contextlib.redirect_stderr(err), \
                contextlib.redirect_stdout(io.StringIO()) as out:
            rc = run.main(["--workload", "resnet50-bulk-768p", "--seed", "1",
                           "--seconds", "1"], root=REPO)
        assert rc != 0 and out.getvalue() == ""
    # only BENCHMARK.json and perfbench/: the program cannot be imported
    bare = tmp_path / "bare"
    shutil.copytree(tiny_root / "perfbench", bare / "perfbench")
    shutil.copy(tiny_root / "BENCHMARK.json", bare)
    import subprocess
    import sys

    proc = subprocess.run(
        [sys.executable, "-c",
         "import sys; sys.path.insert(0, '.');"
         "from perfbench import run;"
         "sys.exit(run.main(['--workload', 'tiny-bulk', '--seed', '1',"
         " '--seconds', '1'], root='.', device='cpu'))"],
        cwd=bare, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert proc.returncode != 0 and proc.stdout.strip() == "", proc.stderr
