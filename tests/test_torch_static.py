"""Static checks on the port: no module of repro_torch, and not
chip_smoke.py, imports JAX, the reference package ``repro`` or
``ml_dtypes``."""
import os
import re

import pytest

ROOT = os.path.join(os.path.dirname(__file__), "..")
FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b(?!_torch)"
    r"|from\s+repro(\.|\s)|import\s+jaxlib\b|from\s+jaxlib\b"
    r"|import\s+ml_dtypes\b|from\s+ml_dtypes\b)",
    re.MULTILINE)


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _, names in os.walk(os.path.join(ROOT, "src", "repro_torch")):
        files += [os.path.join(base, n) for n in names if n.endswith(".py")]
    return sorted(files)


def test_port_has_its_modules():
    names = {os.path.relpath(f, ROOT) for f in _port_files()}
    for want in ("chip_smoke.py", "src/repro_torch/core/interpreter.py",
                 "src/repro_torch/kernels/winograd_conv/ops.py",
                 "src/repro_torch/kernels/bfp_matmul/ops.py",
                 "src/repro_torch/kernels/cc_label/ops.py",
                 "src/repro_torch/kernels/flash_attention/ops.py",
                 "src/repro_torch/kernels/ssd_scan/ops.py",
                 "src/repro_torch/configs/base.py",
                 "src/repro_torch/models/lm/params.py",
                 "src/repro_torch/models/lm/layers.py",
                 "src/repro_torch/models/lm/ssm.py",
                 "src/repro_torch/models/lm/moe.py",
                 "src/repro_torch/models/lm/transformer.py",
                 "src/repro_torch/launch/serve.py",
                 "src/repro_torch/launch/serve_lm.py",
                 "src/repro_torch/launch/router.py",
                 "src/repro_torch/launch/train_std.py",
                 "src/repro_torch/runtime/fault_tolerance.py",
                 "src/repro_torch/runtime/collectives.py",
                 "src/repro_torch/optim/optimizers.py",
                 "src/repro_torch/optim/schedules.py",
                 "src/repro_torch/optim/grad_utils.py",
                 "src/repro_torch/checkpoint/checkpoint.py",
                 "src/repro_torch/core/tree.py"):
        assert want in names


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_reference_import(path):
    with open(path) as f:
        text = f.read()
    bad = FORBIDDEN.findall(text)
    assert not bad, f"{path} imports {bad}"


def test_pattern_catches_the_forms():
    for line in ("import jax", "import jax.numpy as jnp", "from jax import lax",
                 "from repro.core import bfp", "import repro",
                 "    from repro.models.fcn import postprocess",
                 "import ml_dtypes", "from ml_dtypes import bfloat16"):
        assert FORBIDDEN.search(line), line
    for line in ("import repro_torch", "from repro_torch.core import bfp",
                 "# jax is the reference"):
        assert not FORBIDDEN.search(line), line


def test_every_kernel_source_is_built():
    from repro_torch.kernels import build

    csrc = sorted(n for n in os.listdir(build.CSRC) if n.endswith(".cu"))
    assert csrc == sorted(build.SOURCES)
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
