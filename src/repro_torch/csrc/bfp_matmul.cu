// K2: block floating-point matmul, C = A * B with both operands given as
// BFP mantissas and shared exponents along K.
//
// Replaces the TPU kernel `_bfp_matmul_kernel` (entry
// `bfp_matmul_quantized`) in src/repro/kernels/bfp_matmul/kernel.py.
//
// Inputs: mA (M, K) int16 mantissas with one int32 exponent per (row,
// K block) in eA (M, KB); mB (K, N) int16 mantissas with N-major
// exponents eB (N, KB); KB = ceil(K / block_size).  Each element is
// dequantized exactly as m * 2^(e - mantissa_bits), with 2^x built in
// the f32 exponent field (never exp2f or ldexpf), and the K sweep
// accumulates in f32 (the paper's wide accumulator, §IV.C).
//
// What bounds it on an H100: the f32 FMAs of the CUDA cores (67 TFLOP/s)
// for the merge convs (merge1_c1 of a 512x512 batch of 2: M = 2,048,
// K = 640, N = 128, 335 MFLOP against 3.8 MB), bytes for head_logits
// (M = 32,768, K = 32, N = 9).
// The design is a plain shared-memory tiled SGEMM: a 256-thread block
// owns a 64 x 64 output tile and each thread a 4 x 4 register tile;
// each 32-deep K slice of A and B is loaded as int16 mantissas,
// dequantized once on the way into shared memory and reused by 16
// threads.  Ragged M, N and K are masked in the loads and the stores.
// The dequantized operands carry at most 10 significant bits, so they
// would be exact in TF32 (and in FP16 inside its exponent range): moving
// the inner product onto the tensor cores is left to the PR that makes
// this kernel fast.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TM = 64;
constexpr int TN = 64;
constexpr int TK = 32;
constexpr int THREADS = 256;   // 16 x 16, each 4 x 4 outputs

__device__ __forceinline__ float exp2i(int e) {
  e = min(max(e, -126), 127);
  return __int_as_float((e + 127) << 23);
}

__global__ void __launch_bounds__(THREADS)
bfp_matmul_kernel(const int16_t* __restrict__ ma, const int* __restrict__ ea,
                  const int16_t* __restrict__ mb, const int* __restrict__ eb,
                  float* __restrict__ out, int M, int N, int K, int KB,
                  int block_size, int mantissa_bits) {
  __shared__ float as[TK][TM + 4];
  __shared__ float bs[TK][TN + 4];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.y * TM;
  const int n0 = blockIdx.x * TN;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += TK) {
    // A slice (TM x TK), k fastest in global memory
    for (int i = tid; i < TM * TK; i += THREADS) {
      const int kk = i % TK;
      const int r = i / TK;
      const int gm = m0 + r, gk = k0 + kk;
      float val = 0.f;
      if (gm < M && gk < K) {
        const int e = ea[(size_t)gm * KB + gk / block_size];
        val = (float)ma[(size_t)gm * K + gk] * exp2i(e - mantissa_bits);
      }
      as[kk][r] = val;
    }
    // B slice (TK x TN), n fastest in global memory
    for (int i = tid; i < TK * TN; i += THREADS) {
      const int nn = i % TN;
      const int kk = i / TN;
      const int gn = n0 + nn, gk = k0 + kk;
      float val = 0.f;
      if (gn < N && gk < K) {
        const int e = eb[(size_t)gn * KB + gk / block_size];
        val = (float)mb[(size_t)gk * N + gn] * exp2i(e - mantissa_bits);
      }
      bs[kk][nn] = val;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = as[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn < N) out[(size_t)gm * N + gn] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" int bfp_matmul_f32(const int16_t* ma, const int* ea,
                              const int16_t* mb, const int* eb, float* out,
                              int M, int N, int K, int block_size,
                              int mantissa_bits, cudaStream_t stream) {
  const int KB = (K + block_size - 1) / block_size;
  dim3 grid((N + TN - 1) / TN, (M + TM - 1) / TM);
  bfp_matmul_kernel<<<grid, THREADS, 0, stream>>>(
      ma, ea, mb, eb, out, M, N, K, KB, block_size, mantissa_bits);
  return (int)cudaGetLastError();
}
