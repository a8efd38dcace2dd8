#!/usr/bin/env python3
"""Where K1's, K5's and K4 f32's time goes: time source variants with one
part removed, on one NVIDIA GPU.

    python3 scripts/kernel_ablation.py

Each variant is a copy of ``src/repro_torch/csrc/{tf32x3.cuh,
winograd_conv.cu, ssd_chunk.cu, flash_attention.cu}`` with one text
substitution (its
results are wrong by design; only its time is read), built with the
port's nvcc flags into ``build/ablation/<variant>/``; the registers
and spills ptxas reports for each are printed.  K1 runs at
VGG-16 PixelLink's conv1_2, conv3_2 and conv5_1 (batch 2, 512x512), K5
at Zamba2-2.7B's prefill chunk on the strided views ``ssd_scan`` hands
it, K4's f32 kernel at Zamba2-2.7B's prefill attention (B 4, H 32, L 512,
D 80, causal).  Times are device time: the median of 20 calls queued behind a
sleep, bracketed by CUDA events.  The difference between ``base`` and a
variant is what the removed part costs.
"""
import ctypes
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

VARIANTS = {
    "base": [],
    # one TF32 product per product instead of three
    "1xtf32": [("tf32x3.cuh", "  mma(d, ahi, blo);\n  mma(d, alo, bhi);\n",
                ""),
               ("flash_attention.cu", "if (j < jn) mma(sc[j], ahi, blo[j]);",
                "if (j < jn && D < 0) mma(sc[j], ahi, blo[j]);"),
               ("flash_attention.cu", "if (j < jn) mma(sc[j], alo, bhi[j]);",
                "if (j < jn && D < 0) mma(sc[j], alo, bhi[j]);"),
               ("flash_attention.cu", "mma(o[n], ahi, blo[n]);",
                "if (D < 0) mma(o[n], ahi, blo[n]);"),
               ("flash_attention.cu", "mma(o[n], alo, bhi[n]);",
                "if (D < 0) mma(o[n], alo, bhi[n]);")],
    "k1_no_transform": [("winograd_conv.cu", "{  // rows t_i0",
                         "if (nk < 0) {  // rows t_i0")],
    "k1_no_next_load": [("winograd_conv.cu", "if (ks + 1 < nk) {",
                         "if (ks + 1 < nk && nk < 0) {")],
    "k1_no_mma_section": [("winograd_conv.cu",
                           "mma3(acc[z], ahi, alo, bhi, blo);",
                           "if (nk < 0) mma3(acc[z], ahi, alo, bhi, blo);")],
    "k5_no_y": [("ssd_chunk.cu", "if (strip < 0) continue;",
                 "if (strip < 0 || Lc > 0) continue;")],
    "k5_no_st": [("ssd_chunk.cu", "if (u0 < UNITS) {",
                  "if (u0 < UNITS && Lc < 0) {")],
    "k5_no_exp": [("ssd_chunk.cu", "* __expf(s0", "* (s0")],
    # K4 f32: the S = Q K^T section (K's fragment loads, splits, mma), the
    # P V section, the next tile's copies, the softmax's exp2
    "k4_no_s_section": [("flash_attention.cu", "if (j < jn) mma(sc[j],",
                         "if (j < jn && D < 0) mma(sc[j],")],
    "k4_no_pv_section": [("flash_attention.cu", "mma(o[n],",
                          "if (D < 0) mma(o[n],")],
    # every split (K1, K5, K4 f32) rounded by cvt.rna instead of truncated
    "rna_split": [("tf32x3.cuh", "  hi = __float_as_uint(x) & 0xffffe000u;\n"
                   "  lo = __float_as_uint(x - __uint_as_float(hi));\n",
                   '  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));\n'
                   '  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo)\n'
                   '      : "f"(x - __uint_as_float(hi)));\n')],
    "k4_no_next_load": [("flash_attention.cu", "if (t + 1 < ntiles) {",
                         "if (t + 1 < ntiles && D < 0) {")],
    "k4_no_exp": [("flash_attention.cu",
                   "const float p = ex2(sc[j][e] - mx[e >> 1]);",
                   "const float p = sc[j][e] - mx[e >> 1];")],
}
FILES = ("tf32x3.cuh", "winograd_conv.cu", "ssd_chunk.cu",
         "flash_attention.cu")


def build_variants():
    from repro_torch.kernels import build

    csrc, out = build.CSRC, ROOT / "build" / "ablation"
    procs = {}
    for name, subs in VARIANTS.items():
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        for f in FILES:
            text = (csrc / f).read_text()
            for file, old, new in subs:
                if file == f:
                    if old not in text:
                        sys.exit(f"{name}: {old!r} not in {f}")
                    text = text.replace(old, new)
            (d / f).write_text(text)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o",
             str(d / "lib.so"),
             str(d / "winograd_conv.cu"), str(d / "ssd_chunk.cu"),
             str(d / "flash_attention.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"nvcc failed on {name}:\n{log[-3000:]}")
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
        spills = re.findall(r"(\d+) bytes spill stores", log)
        print(f"{name}: registers {min(regs)}-{max(regs)}, spill stores "
              f"{max(int(b) for b in spills)} bytes at most", flush=True)
        lib = ctypes.CDLL(str(out / name / "lib.so"))
        lib.winograd_conv_fused.argtypes = list(build.SIGNATURES[
            "winograd_conv_fused"])
        lib.ssd_chunk_f32.argtypes = list(build.SIGNATURES["ssd_chunk_f32"])
        lib.flash_attention_fwd.argtypes = list(build.SIGNATURES[
            "flash_attention_fwd"])
        libs[name] = lib
    return libs


def device_ms(torch, fn, iters=20):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    events = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        events.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in events)


def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    from repro_torch.core import winograd as wg

    libs = build_variants()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    k1 = {}
    for name, (hw, cin, cout) in {"conv1_2": (512, 64, 64),
                                  "conv3_2": (128, 256, 256),
                                  "conv5_1": (32, 512, 512)}.items():
        x = torch.randn((2, hw, hw, cin), device=dev, generator=gen)
        w = torch.randn((3, 3, cin, cout), device=dev, generator=gen) \
            * (2 / (9 * cin)) ** 0.5
        u = wg.transform_weights(w).reshape(36, cin, cout).contiguous()
        b = torch.randn((cout,), device=dev, generator=gen)
        k1[name] = (x, u, b, torch.empty((2, hw, hw, cout), device=dev))
    # Zamba2 chunk: operands in (B, nc, Lc, H | G, ...) memory, as views
    Bz, nc, H, Lc, N, P = 4, 4, 80, 128, 64, 64
    cm = torch.randn((Bz, nc, Lc, 1, N), device=dev, generator=gen)
    bm = torch.randn_like(cm)
    xm = torch.randn((Bz, nc, Lc, H, P), device=dev, generator=gen)
    sm = torch.cumsum(-torch.rand((Bz, nc, Lc, H), device=dev,
                                  generator=gen), 2)
    BC = Bz * nc
    c = cm.permute(0, 1, 3, 2, 4).reshape(BC, 1, Lc, N)
    b = bm.permute(0, 1, 3, 2, 4).reshape(BC, 1, Lc, N)
    xdt = xm.permute(0, 1, 3, 2, 4).reshape(BC, 1, H, Lc, P)
    scum = sm.permute(0, 1, 3, 2).reshape(BC, 1, H, Lc, 1)
    y = torch.empty((BC, Lc, 1, H, P), device=dev).permute(0, 2, 3, 1, 4)
    st = torch.empty((BC, 1, H, P, N), device=dev)
    strides = (ctypes.c_longlong * 18)(
        *c.stride()[:3], *b.stride()[:3], *xdt.stride()[:4],
        *scum.stride()[:4], *y.stride()[:4])
    # Zamba2 attention, f32
    qa = torch.randn((4, 32, 512, 80), device=dev, generator=gen)
    ka, va = torch.randn_like(qa), torch.randn_like(qa)
    oa = torch.empty_like(qa)
    stream = torch.cuda.current_stream().cuda_stream
    for name, lib in libs.items():
        row = [name]
        for shape, (x, u, bias, out) in k1.items():
            n, hh, ww, cin = x.shape

            def fn():
                return lib.winograd_conv_fused(
                    x.data_ptr(), u.data_ptr(), bias.data_ptr(),
                    out.data_ptr(), n, hh, ww, cin, u.shape[2], 1, hh, ww, 1,
                    stream)
            if fn():
                sys.exit(f"{name}: K1 launch failed")
            row.append(f"K1 {shape} {device_ms(torch, fn):.4f} ms")

        def fn5():
            return lib.ssd_chunk_f32(
                c.data_ptr(), b.data_ptr(), xdt.data_ptr(), scum.data_ptr(),
                y.data_ptr(), st.data_ptr(), strides, BC, 1, H, Lc, N, P,
                stream)
        if fn5():
            sys.exit(f"{name}: K5 launch failed")
        row.append(f"K5 {device_ms(torch, fn5):.4f} ms")

        def fn4():
            return lib.flash_attention_fwd(
                qa.data_ptr(), ka.data_ptr(), va.data_ptr(), oa.data_ptr(),
                4, 32, 32, 512, 512, 80, 512, ctypes.c_float(80 ** -0.5), 1,
                0, stream)
        if fn4():
            sys.exit(f"{name}: K4 launch failed")
        row.append(f"K4 f32 {device_ms(torch, fn4):.4f} ms")
        print(" | ".join(row), flush=True)


if __name__ == "__main__":
    main()
