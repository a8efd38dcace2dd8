"""Nothing the benchmark loads is JAX or the JAX package (top-level
names compared whole), and the reference imports nothing of the
program."""
import ast
import subprocess
import sys

from conftest import REPO

REFERENCE = ["plain/bfp.py", "plain/cc.py", "plain/fcn.py",
             "plain/layers.py", "compare.py", "counts.py", "traffic.py",
             "taps.py", "trace.py"]


def imported_tops(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


def test_reference_imports_no_program():
    for rel in REFERENCE:
        tops = set(imported_tops(REPO / "perfbench" / rel))
        assert not tops & {"repro", "repro_torch", "jax", "jaxlib",
                           "flax"}, (rel, tops)


def test_a_run_loads_no_jax(tiny_root):
    code = (
        "import sys, io, contextlib; sys.path[:0] = ['.', %r];"
        "from perfbench import run, harness;"
        "o = io.StringIO();"
        "ctx = contextlib.redirect_stdout(o);"
        "ctx.__enter__();"
        "rc = run.main(['--workload', 'tiny-bulk', '--seed', '2',"
        " '--seconds', '1'], root='.', device='cpu');"
        "ctx.__exit__(None, None, None);"
        "tops = {m.split('.')[0] for m in sys.modules};"
        "print(rc, sorted(tops & {'jax', 'jaxlib', 'flax', 'repro'}),"
        " 'repro_torch' in tops)") % str(REPO / "src")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tiny_root,
                          capture_output=True, text=True, timeout=600)
    assert proc.stdout.strip().splitlines()[-1] == "0 [] True", proc.stderr


def test_the_check_names_a_forbidden_module():
    from perfbench import harness

    had = "repro" in sys.modules
    sys.modules.setdefault("repro.core", type(sys)("repro.core"))
    try:
        assert "repro" in harness.forbidden_modules()
        assert "repro_torch" not in harness.forbidden_modules()
    finally:
        if not had:
            del sys.modules["repro.core"]
