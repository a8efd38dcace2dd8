// K1: Winograd F(4x4, 3x3) tile contraction with the output transform,
// bias and ReLU fused, writing the NHWC plane directly.
//
// Replaces the TPU kernel `_winograd_mm_kernel` (entry
// `winograd_tile_matmul`) in src/repro/kernels/winograd_conv/kernel.py.
//
// Computes, for every transformed input tile p and output channel f:
//   M[p, z, f] = sum_c V[p, z, c] * U[z, c, f]        (z = 0..35)
//   Y[p]       = A^T M[p] A  (6x6 -> 4x4), + bias[f], optional ReLU
// and stores Y at (n, 4*ti + r, 4*tj + c, f) of the NHWC output, cropping
// the ragged last tile row and column.  V is (P, 36, Cin) and U is
// (36, Cin, Cout), both f32; P = N * th * tw in (n, ti, tj) order.
//
// What bounds it on an H100: the bytes and the f32 FMAs come out close.
// V holds 36/16 = 2.25x the elements of the input plane, so at conv1_2
// of a 512x512 image (P = 16,384 tiles, 64 -> 64 channels) V is 151 MB
// and Y 67 MB, about 65 us at 3.35 TB/s, against 4.8 GFLOP, 72 us at
// the 67 TFLOP/s f32 rate of the CUDA cores; deeper layers (more
// channels, fewer tiles) are bound by the FMAs.  The design keeps M out of device memory: each
// thread holds all 36 partial sums of its (tile, channel) pairs in
// registers across the whole Cin sweep and applies A^T M A, bias and
// ReLU there, so the only traffic is V and U in and Y out.  Blocks stage
// a BK-deep slice of V and U in shared memory; each warp owns TP tiles
// and its 32 lanes own 32 consecutive output channels, so V reads are
// warp-wide broadcasts and U reads and Y stores are coalesced.  Plain
// f32 FMAs on the CUDA cores: the transformed operands are not exact in
// TF32.  Fusing the input transform B^T X B (which would remove V from
// device memory) is later work.
#include <cuda_runtime.h>

namespace {

constexpr int BP = 16;                 // tiles per block
constexpr int BN = 32;                 // output channels per block
constexpr int BK = 8;                  // input channels per smem stage
constexpr int THREADS = 256;
constexpr int TP = BP / (THREADS / 32);  // tiles per thread (2)
constexpr int SMEM_BYTES = (BP * 36 * BK + 36 * BK * BN) * 4;

// Rows of A^T applied to a 6-vector.
__device__ __forceinline__ void at6(const float m[6], float o[4]) {
  o[0] = m[0] + m[1] + m[2] + m[3] + m[4];
  o[1] = m[1] - m[2] + 2.f * m[3] - 2.f * m[4];
  o[2] = m[1] + m[2] + 4.f * m[3] + 4.f * m[4];
  o[3] = m[1] - m[2] + 8.f * m[3] - 8.f * m[4] + m[5];
}

__global__ void __launch_bounds__(THREADS)
winograd_tile_kernel(const float* __restrict__ v, const float* __restrict__ u,
                     const float* __restrict__ bias, float* __restrict__ out,
                     int P, int cin, int cout, int th, int tw, int out_h,
                     int out_w, int relu) {
  extern __shared__ float smem[];
  float* vs = smem;                    // [BP][BK][36]
  float* us = smem + BP * 36 * BK;     // [36][BK][BN]
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int p0 = blockIdx.x * BP;
  const int n0 = blockIdx.y * BN;

  float acc[TP][36];
#pragma unroll
  for (int t = 0; t < TP; ++t)
#pragma unroll
    for (int z = 0; z < 36; ++z) acc[t][z] = 0.f;

  for (int k0 = 0; k0 < cin; k0 += BK) {
    // V slice: global order (p, z, kk) with kk fastest -> vs[p][kk][z]
    for (int i = tid; i < BP * 36 * BK; i += THREADS) {
      const int kk = i % BK;
      const int z = (i / BK) % 36;
      const int p = i / (BK * 36);
      const int gp = p0 + p, gk = k0 + kk;
      vs[(p * BK + kk) * 36 + z] =
          (gp < P && gk < cin) ? v[((size_t)gp * 36 + z) * cin + gk] : 0.f;
    }
    // U slice: global order (z, kk, nn) with nn fastest -> us[z][kk][nn]
    for (int i = tid; i < 36 * BK * BN; i += THREADS) {
      const int nn = i % BN;
      const int kk = (i / BN) % BK;
      const int z = i / (BN * BK);
      const int gn = n0 + nn, gk = k0 + kk;
      us[i] = (gn < cout && gk < cin) ? u[((size_t)z * cin + gk) * cout + gn]
                                      : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
#pragma unroll
      for (int z = 0; z < 36; ++z) {
        const float uval = us[(z * BK + kk) * BN + lane];
#pragma unroll
        for (int t = 0; t < TP; ++t) {
          const float vval = vs[((warp * TP + t) * BK + kk) * 36 + z];
          acc[t][z] = fmaf(vval, uval, acc[t][z]);
        }
      }
    }
    __syncthreads();
  }

  const int gn = n0 + lane;
  if (gn >= cout) return;
  const float b = bias ? bias[gn] : 0.f;
#pragma unroll
  for (int t = 0; t < TP; ++t) {
    const int gp = p0 + warp * TP + t;
    if (gp >= P) continue;
    const int tj = gp % tw;
    const int ti = (gp / tw) % th;
    const int n = gp / (tw * th);
    // tmp = A^T M  (4 x 6), column by column
    float tmp[4][6];
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      float col[6], o[4];
#pragma unroll
      for (int i = 0; i < 6; ++i) col[i] = acc[t][i * 6 + j];
      at6(col, o);
#pragma unroll
      for (int r = 0; r < 4; ++r) tmp[r][j] = o[r];
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float y[4];
      at6(tmp[r], y);
      const int oy = ti * 4 + r;
      if (oy >= out_h) continue;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int ox = tj * 4 + c;
        if (ox >= out_w) continue;
        float val = y[c] + b;
        if (relu) val = fmaxf(val, 0.f);
        out[(((size_t)n * out_h + oy) * out_w + ox) * cout + gn] = val;
      }
    }
  }
}

}  // namespace

extern "C" int winograd_tile_conv(const float* v, const float* u,
                                  const float* bias, float* out, int n,
                                  int th, int tw, int cin, int cout,
                                  int out_h, int out_w, int relu,
                                  cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        winograd_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const int P = n * th * tw;
  dim3 grid((P + BP - 1) / BP, (cout + BN - 1) / BN);
  winograd_tile_kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(
      v, u, bias, out, P, cin, cout, th, tw, out_h, out_w, relu);
  return (int)cudaGetLastError();
}
