"""The LM family (``families/lm.py``) on the CPU: a tiny Zamba2-shaped
prefill cell, added as new files to a copy of the benchmark, runs
``correct`` through the harness; faults planted in a copy of its driver
(the adapter term dropped; the logits of the position before the last
kept as the first token's) read ``correct: false``; and the LM
reference and counts import nothing of the program or of JAX."""
import json
import shutil

import pytest

from conftest import REPO, run_cell, write_json
from test_perfbench_imports import imported_tops

TINY = dict(
    name="tiny_zamba2", hidden_size=64, attention_hidden_size=128,
    attention_head_dim=32, kv_channels=16, num_attention_heads=4,
    num_key_value_heads=4, num_query_groups=4, intermediate_size=128,
    ffn_hidden_size=128, vocab_size=256, num_hidden_layers=9,
    hybrid_layer_ids=[2, 4, 7], n_mamba_heads=8, mamba_headdim=16,
    mamba_d_state=16, mamba_ngroups=2, chunk_size=8, adapter_rank=4,
    max_position_embeddings=64, dtype="float32", weight_seed=3)
FAULTS = {
    "tiny-lm-no-adapter": (
        "self.params = ctx.family.nest(params)",
        "self.params = ctx.family.nest(dict(params, **{'sites/adapter/b': "
        "torch.zeros_like(params['sites/adapter/b'])}))"),
    "tiny-lm-off-by-one": ('"logits": logits[r, -1].clone()',
                           '"logits": logits[r, -2].clone()'),
}
LM_FILES = ["plain/zamba2.py", "counts_lm.py", "spans_lm.py"]


def tiny_config():
    cfg = json.loads((REPO / "perfbench" / "configs" /
                      "zamba2_7b.json").read_text())
    cfg.update(TINY)
    cfg["layers_block_type"] = [
        "hybrid" if i in TINY["hybrid_layer_ids"] else "mamba"
        for i in range(TINY["num_hidden_layers"])]
    return cfg


def make_lm_root(dst):
    shutil.copytree(REPO / "perfbench", dst / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    base = dst / "perfbench"
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    write_json(base / "configs" / "tiny_zamba2.json", tiny_config())
    shutil.copy(base / "configs" / "zamba2_7b.py",
                base / "configs" / "tiny_zamba2.py")
    bench["configs"].append({"name": "tiny_zamba2", "source": "test",
                             "file": "perfbench/configs/tiny_zamba2.json",
                             "reduced": [], "why": "CPU test"})
    mix = json.loads((base / "traffic" / "lm_prefill_b8.json").read_text())
    driver = (base / "drivers" / "lm_prefill.py").read_text()
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    cells = {"tiny-lm": "lm_prefill"}
    for cell, (old, new) in FAULTS.items():
        name = cell.replace("-", "_")
        assert old in driver
        (base / "drivers" / f"{name}.py").write_text(
            driver.replace(old, new))
        cells[cell] = name
    for cell, drv in cells.items():
        write_json(base / "traffic" / f"{cell}.json",
                   dict(mix, driver=drv, batch=2, lengths=[16, 24, 8],
                        decode_tokens=4))
        write_json(base / "workloads" / f"{cell}.json",
                   {"sample_calls": 2,
                    "limits": {"logit_gap_max": 1e-4,
                               "logit_gap_mean": 1e-5}})
        bench["workloads"].append({"name": cell, "config": "tiny_zamba2",
                                   "traffic": cell, "chips": 1,
                                   "why": "CPU test"})
        e2e["latency_p50_ms"]["workloads"].append(cell)
        for m in bench["per_layer"]:
            if "zamba2-7b-prefill-b8" in m.get("workloads", ()):
                m["workloads"].append(cell)
    write_json(dst / "BENCHMARK.json", bench)
    return dst


@pytest.fixture(scope="module")
def lm_root(tmp_path_factory):
    return make_lm_root(tmp_path_factory.mktemp("lm"))


def test_lm_family_runs_correct(lm_root):
    rc, out, err = run_cell(lm_root, "tiny-lm", seconds=0.5)
    assert rc == 0, err
    assert out["correct"] is True, out["checks"]
    checks = out["checks"]
    assert checks["requests_compared"]["value"] == 2
    assert checks["logit_gap_max"]["value"] < 1e-5
    assert out["failed"] == 0 and out["attempted"] % 6 == 0
    # whole cycles of three lengths, batches of 2
    assert set(out["metrics"]) == {"latency_p50_ms", "setup_s"}
    assert "[perfbench] prefill: " in err
    tail = err.strip().splitlines()[-len(checks):]
    assert tail[-1].startswith("check requests_compared ")


def test_lm_traced_run_reads_no_device_metric_on_cpu(lm_root):
    """A CPU run writes no number under a span or device metric, and
    the readers do not raise on it; the host clock's mean latency over
    the window's requests is read."""
    rc, out, err = run_cell(lm_root, "tiny-lm", seconds=0.5, trace=1)
    assert rc == 0, err
    assert out["correct"] is True
    assert set(out["metrics"]) == {"lm.ttft_mean_ms.prefill"}
    assert out["metrics"]["lm.ttft_mean_ms.prefill"]["value"] > 0


@pytest.mark.parametrize("cell", list(FAULTS))
def test_lm_planted_fault_is_incorrect(lm_root, cell):
    rc, out, err = run_cell(lm_root, cell, seconds=0.5)
    assert rc == 0, err
    assert out["correct"] is False
    gap = out["checks"]["logit_gap_max"]
    assert gap["value"] > 100 * gap["limit"]


def test_lm_control_is_worse_than_program(lm_root):
    """calibrate.py's control: the reference at 4 mantissa bits reads
    gaps far above the program's on the same kept requests."""
    import contextlib
    import io

    from perfbench import calibrate

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = calibrate.main(["--workload", "tiny-lm", "--seeds", "5",
                             "--control-seeds", "1", "--control-bits", "4",
                             "--seconds", "0.2"], root=lm_root,
                            device="cpu")
    assert rc == 0
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    prog = line["checks"]["logit_gap_max"]["value"]
    assert line["control"]["logit_gap_max"] > 100 * prog


def test_reference_imports_no_program():
    for rel in LM_FILES + ["families/lm.py"]:
        tops = set(imported_tops(REPO / "perfbench" / rel))
        assert not tops & {"repro", "jax", "jaxlib", "flax"}, (rel, tops)
    for rel in LM_FILES:
        tops = set(imported_tops(REPO / "perfbench" / rel))
        assert "repro_torch" not in tops, (rel, tops)
