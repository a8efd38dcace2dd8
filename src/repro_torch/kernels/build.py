"""Build the port's CUDA kernels at first use and bind them with ctypes.

The sources in ``repro_torch/csrc/*.cu`` expose a plain C interface (no
PyTorch headers), so ``nvcc`` compiles each in seconds.  One ``nvcc -c``
per source runs in parallel for ``sm_90a``, then one link step makes
``libkernels.so`` under ``build/kernels/<hash>/`` at the repository root,
keyed by a hash of the sources and flags: a checkout builds everything it
needs from its own files, and an unchanged tree reuses the library.  The
compiler's per-kernel register and spill report (``-Xptxas -v``) is kept
beside it in ``build.log``.

Every C entry point launches on the stream it is given, allocates
nothing and returns ``cudaGetLastError()``; :func:`check` turns a
non-zero status into an exception.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = ("winograd_conv.cu", "bfp_matmul.cu", "cc_label.cu",
           "flash_attention.cu", "ssd_chunk.cu", "bfp_quantize.cu")
HEADERS = ("tf32x3.cuh",)
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
SIGNATURES = {
    # x, u, bias, out, n, h, w, cin, cout, pad, out_h, out_w, relu, stream
    "winograd_conv_fused": (_P,) * 4 + (_I,) * 9 + (_P,),
    # ma, ea, mb, eb, out, M, N, K, block_size, mantissa_bits, tile_m,
    # tile_n, splits, stream
    "bfp_matmul_f32": (_P,) * 5 + (_I,) * 8 + (_P,),
    # labels, pos, lnk, out, N, H, W, th, tw, stream
    "cc_local_spread": (_P,) * 4 + (_I,) * 5 + (_P,),
    # q, k, v, out, B, Hq, Hkv, Lq, Lkv, D, kv_len, scale, causal, dtype,
    # stream
    "flash_attention_fwd": (_P,) * 4 + (_I,) * 7 + (_F, _I, _I, _P),
    # c, b, xdt, scum, y, st, strides (18 int64), BC, G, HPG, Lc, N, P,
    # stream
    "ssd_chunk_f32": (_P,) * 7 + (_I,) * 6 + (_P,),
    # x, dtype, mant, expo, val, outer, K, inner, block_size,
    # mantissa_bits, nearest, stream
    "bfp_quantize": (_P, _I) + (_P,) * 3 + (_I,) * 6 + (_P,),
}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_ROOT / source_hash() / "libkernels.so"


def build() -> Path:
    """Compile and link the library unless this tree's build exists."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="tmp-", dir=BUILD_ROOT))
    nvcc = _nvcc()
    procs = []
    for name in SOURCES:
        obj = tmp / (name + ".o")
        procs.append((name, obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log = []
    failed = []
    for name, _, proc in procs:
        out, _ = proc.communicate()
        log.append(f"== {name}\n{out}")
        if proc.returncode:
            failed.append(name)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
    link = subprocess.run(
        [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp / lib.name),
         *(str(obj) for _, obj, _ in procs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    log.append(f"== link\n{link.stdout}")
    if link.returncode:
        raise RuntimeError("linking the kernels failed:\n" + "\n".join(log))
    (tmp / "build.log").write_text("\n".join(log))
    try:
        tmp.rename(lib.parent)
    except OSError:             # another process finished the same build
        shutil.rmtree(tmp, ignore_errors=True)
    return lib


def build_log() -> str:
    path = library_path().parent / "build.log"
    return path.read_text() if path.exists() else ""


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, args in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(args)
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def check(status: int, name: str) -> None:
    if status != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {status}")


def stream_handle(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
