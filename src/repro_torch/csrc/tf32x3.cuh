// TF32 tensor-core products and cp.async copies, shared by K1
// (winograd_conv.cu), K5 (ssd_chunk.cu) and K4's f32 kernel
// (flash_attention.cu), which take f32-accurate products in "3xTF32", and
// K2 (bfp_matmul.cu), whose operands are exact in TF32.
//
// An f32 operand x is split where it is read into hi = x with its 13 low
// bits cleared (truncated to TF32) and lo = x - hi, exact in f32 and
// passed as it is: the tensor cores read only the top 19 bits of a TF32
// operand, so lo is truncated there.  hi and lo keep 11 significant bits
// each, and hi + lo equals x to 2^-21 relative.  A product a * b is
// issued as hi_a*lo_b + lo_a*hi_b + hi_a*hi_b into one f32 accumulator
// (the dropped lo_a*lo_b is below 2^-20 of it).  One TF32 term alone
// leaves 2^-11 relative per operand, which the Winograd transforms
// (coefficients up to 8), K5's decayed sums and the nearly one-hot
// softmax of K4 at large |v| carry past their tolerances.  The split is
// two ALU operations; `cvt.rna.tf32` (round to nearest, 2^-22) is the
// dearer instruction where every fragment read is split, and the
// truncating split stays far inside every kernel's tolerance (emulated
// on the CPU in tests/test_torch_kernels.py::TestTF32Premise and
// tests/test_torch_lm_kernels.py; timed both ways by
// scripts/kernel_ablation.py).
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32x3 {

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a * b, m16n8k8, TF32 operands, f32 accumulators.  Fragments (g =
// lane / 4, q = lane % 4): a0 (g, q), a1 (g + 8, q), a2 (g, q + 4), a3
// (g + 8, q + 4); b0 (k q, n g), b1 (k q + 4, n g); d0 (g, 2q), d1 (g,
// 2q + 1), d2 (g + 8, 2q), d3 (g + 8, 2q + 1).
__device__ __forceinline__ void mma(float* d, const uint32_t* a,
                                    const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// the three products of a split pair, small terms first
__device__ __forceinline__ void mma3(float* d, const uint32_t* ahi,
                                     const uint32_t* alo, const uint32_t* bhi,
                                     const uint32_t* blo) {
  mma(d, ahi, blo);
  mma(d, alo, bhi);
  mma(d, ahi, bhi);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes, of which the first `src_bytes` are read and the rest zeroed
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");
}

// 4 bytes, zeroed where `src_bytes` is 0
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

}  // namespace tf32x3
