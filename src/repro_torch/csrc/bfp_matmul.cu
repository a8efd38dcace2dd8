// K2: block floating-point matmul, C = A * B with both operands given as
// BFP mantissas and shared exponents along K.
//
// Replaces the TPU kernel `_bfp_matmul_kernel` (entry
// `bfp_matmul_quantized`, whose `pl.pallas_call` is at
// src/repro/kernels/bfp_matmul/kernel.py:95).
//
// Inputs: mA (M, K) int16 mantissas with one int32 exponent per (row,
// K block) in eA (M, KB); mB (K, N) int16 mantissas with N-major
// exponents eB (N, KB); KB = ceil(K / block_size).  Each element is
// dequantized exactly as m * 2^(e - mantissa_bits), with 2^x built in
// the f32 exponent field (never exp2f or ldexpf), and the K sweep
// accumulates in f32 (the paper's wide accumulator, §IV.C).
//
// Tensor cores in TF32, exactly.  BFP quantization leaves |m| <= 2^10 for
// mantissa_bits <= 10 (trunc gives |m| < 2^10; nearest's carry can reach
// 2^10 itself), so every dequantized operand has at most 11 significant
// bits times a power of two.  TF32 keeps 10 stored bits plus the implicit
// one, so the f32 bit patterns are valid TF32 unchanged (their low 13
// bits are zero), every product of two of them (at most 22 bits) is
// exact in f32, and the result differs from the f32 CUDA-core version only
// by the order of the f32 sums.  That is the paper's and every main
// path's width (mantissa_bits <= 10).
//
// Wider mantissas, 11-15 bits (the reference's int16 range), take the
// template flag X3: |m| <= 2^15 leaves at most 16 significant bits, so
// tf32x3.cuh's truncating split gives hi (the top 11 bits) and lo (the
// remaining 5 or fewer), each exact in TF32, and the three-product sum
// hi*lo + lo*hi + hi*hi of K1 and K5 drops only lo*lo, below 2^-20 of the
// product.  The split happens where a fragment is read, so the 10-bit
// instances (X3 false) compile to the same code as before.
//
// What bounds it on an H100: bytes and fill.  merge1_c1 of a 512x512
// batch of 2 (M 2,048, K 640, N 128) is 335 MFLOP, 0.7 us at the 495
// TFLOP/s TF32 peak, against 3.8 MB, 1.1 us at 3.35 TB/s; head_logits
// (M 32,768, K 32, N 9) is all bytes.  The first version ran f32 FMAs on
// the CUDA cores, loaded scalar mantissas with a division and an
// uncoalesced exponent read per element, did not overlap loads, and used
// one 64 x 64 tile (64 blocks at merge1_c1, 86% of the tile masked at
// N 9).  This design:
// - `mma.sync.m16n8k8` TF32 with f32 accumulators in registers, four
//   warps a block.  At these shapes the MMA rate is not the limit, and
//   mma.sync takes a 16-column tile and any split of the tile over the
//   warps, with no swizzled shared-memory layout to match;
// - the wrapper picks the tile from N (64 x 64, 64 x 32, or 128 x 16 for
//   N <= 16) and splits K into S = 1, 2, 4 or 8 ranges until the grid has
//   ~132 blocks (merge1_c1: 64 tiles x 4).  The S blocks of a tile form a
//   thread-block cluster; each leaves its partial tile in its shared
//   memory, and after a cluster barrier block z adds rows z*TM/S.. of all
//   S partials in rank order through distributed shared memory.  The sum
//   order is fixed (no atomics), so every run gives the same bits;
// - the block's exponents (TM x KB and TN x KB ints) are one contiguous
//   run each in device memory; they are staged into shared memory once,
//   with coalesced loads, while the first mantissa tile is in flight;
// - mantissas arrive as 16-byte `cp.async` vectors, double-buffered over
//   32-deep K steps, where K (for A) or N (for B) is a multiple of 8;
//   otherwise, and past the ragged edges, by masked scalar loads;
// - each K step is dequantized once into f32 tiles (A K-major, B written
//   transposed, K-major) whose padded rows make the fragment reads free
//   of bank conflicts; the block index of each of the 32 K positions is
//   computed once per step (no division per element), and a vector of 8
//   mantissas along K inside one block shares one scale.
// What still holds it back: a block's K steps run load, dequantize and
// MMA one after another on four warps, and each element of B is
// dequantized again by every tile row (32 times at merge1_c1).
#include "tf32x3.cuh"

namespace {

using tf32x3::cp_async16;
using tf32x3::cp_async_commit;
using tf32x3::mma;
using tf32x3::mma3;
using tf32x3::smem_u32;
using tf32x3::split;

constexpr int TK = 32;          // K per step: four k8 MMA steps
constexpr int STAGES = 2;       // mantissa tiles: double-buffered
constexpr int THREADS = 128;    // four warps
constexpr int LDF = TK + 4;     // f32 tile row stride (floats)
constexpr int SMEM_MAX = 232448;
constexpr int MAX_DEVICES = 64;

__device__ __forceinline__ float exp2i(int e) {
  e = min(max(e, -126), 127);
  return __int_as_float((e + 127) << 23);
}

// all but the newest STAGES - 1 groups have landed
__device__ __forceinline__ void cp_async_wait_stage() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(STAGES - 1) : "memory");
}

// all threads of all blocks of the cluster; orders shared-memory writes
// before the reads of the other blocks
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// a float in the shared memory of block `rank` of this cluster, at the
// offset `p` has in this block's
__device__ __forceinline__ float ld_cluster(const float* p, int rank) {
  uint32_t remote;
  float v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote) : "r"(smem_u32(p)), "r"(rank));
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
               : "=f"(v) : "r"(remote) : "memory");
  return v;
}

// raw A [STAGES][TM][TK] and B [STAGES][TK][TN] int16, f32 A [TM][LDF]
// and B^T [TN][LDF], block indices [STAGES][TK], exponents [TM][KB] and
// [TN][KB].  Mirrored by bfp_matmul/ops.py:smem_bytes.
__host__ __device__ constexpr size_t smem_bytes(int tm, int tn, int kb) {
  return (size_t)STAGES * TK * (tm + tn) * 2 + (size_t)(tm + tn) * LDF * 4 +
         (size_t)STAGES * TK * 4 + (size_t)(tm + tn) * kb * 4;
}

// One block per (TM x TN tile, K split); the S splits of a tile form a
// cluster along z and add their partial tiles in rank order.  X3: each
// operand enters as hi + lo TF32 terms (mantissa_bits 11-15).
template <int TM, int TN, int WM, int S, bool X3>
__global__ void __launch_bounds__(THREADS)
bfp_matmul_kernel(const int16_t* __restrict__ ma, const int* __restrict__ ea,
                  const int16_t* __restrict__ mb, const int* __restrict__ eb,
                  float* __restrict__ out, int M, int N, int K, int KB,
                  int block_size, int mantissa_bits) {
  constexpr int WN = 4 / WM;              // warps along N
  constexpr int WTM = TM / WM, WTN = TN / WN;
  constexpr int MI = WTM / 16, NI = WTN / 8;
  static_assert(WTM % 16 == 0 && WTN % 8 == 0, "warp tile");
  static_assert(TM % S == 0 && TM * TN * 4 <= STAGES * TK * (TM + TN) * 2,
                "the partial tile reuses the mantissa ring");
  extern __shared__ __align__(16) uint8_t smem[];
  int16_t* ra = reinterpret_cast<int16_t*>(smem);
  int16_t* rb = ra + STAGES * TM * TK;
  float* af = reinterpret_cast<float*>(rb + STAGES * TK * TN);
  float* bt = af + TM * LDF;
  int* kbi = reinterpret_cast<int*>(bt + TN * LDF);
  int* es_a = kbi + STAGES * TK;
  int* es_b = es_a + TM * KB;

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * TM, n0 = blockIdx.y * TN;
  const bool vec_a = K % 8 == 0 && (reinterpret_cast<uintptr_t>(ma) & 15) == 0;
  const bool vec_b = N % 8 == 0 && (reinterpret_cast<uintptr_t>(mb) & 15) == 0;
  // this split's K steps [t0, t1)
  const int per = ((K + TK - 1) / TK + S - 1) / S;
  const int t0 = blockIdx.z * per, t1 = min((K + TK - 1) / TK, t0 + per);

  // queue K step t's mantissas into buffer st, and its block indices
  auto issue = [&](int t, int st) {
    const int k0 = t * TK;
    for (int v = tid; v < TM * TK / 8; v += THREADS) {
      const int r = v / (TK / 8), c = v % (TK / 8) * 8;
      const int gm = m0 + r, gk = k0 + c;
      int16_t* dst = ra + (st * TM + r) * TK + c;
      if (vec_a) {
        const bool in = gm < M && gk < K;
        cp_async16(dst, in ? ma + (size_t)gm * K + gk : ma, in ? 16 : 0);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          dst[j] = gm < M && gk + j < K ? ma[(size_t)gm * K + gk + j] : 0;
      }
    }
    for (int v = tid; v < TK * TN / 8; v += THREADS) {
      const int kr = v / (TN / 8), c = v % (TN / 8) * 8;
      const int gk = k0 + kr, gn = n0 + c;
      int16_t* dst = rb + (st * TK + kr) * TN + c;
      if (vec_b) {
        const bool in = gk < K && gn < N;
        cp_async16(dst, in ? mb + (size_t)gk * N + gn : mb, in ? 16 : 0);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          dst[j] = gk < K && gn + j < N ? mb[(size_t)gk * N + gn + j] : 0;
      }
    }
    if (tid < TK) kbi[st * TK + tid] = min((k0 + tid) / block_size, KB - 1);
  };

  for (int t = t0; t < t0 + STAGES - 1; ++t) {
    if (t < t1) issue(t, t - t0);
    cp_async_commit();
  }
  // the tile's exponents are contiguous runs of eA and eB
  {
    const int na = min(TM, M - m0) * KB, nb = min(TN, N - n0) * KB;
    const int* ga = ea + (size_t)m0 * KB;
    const int* gb = eb + (size_t)n0 * KB;
    for (int i = tid; i < TM * KB; i += THREADS) es_a[i] = i < na ? ga[i] : 0;
    for (int i = tid; i < TN * KB; i += THREADS) es_b[i] = i < nb ? gb[i] : 0;
  }

  const int warp = tid / 32, lane = tid % 32, g = lane / 4, tq = lane % 4;
  const int wm = warp / WN, wn = warp % WN;
  float acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int t = t0; t < t1; ++t) {
    const int st = (t - t0) % STAGES;
    // step t + STAGES - 1 reuses the buffer step t - 1 was converted from
    const int ahead = t + STAGES - 1;
    if (ahead < t1) issue(ahead, (ahead - t0) % STAGES);
    cp_async_commit();
    cp_async_wait_stage();              // step t's group has landed
    __syncthreads();

    const int* kb = kbi + st * TK;
    for (int v = tid; v < TM * TK / 8; v += THREADS) {
      const int r = v / (TK / 8), c = v % (TK / 8) * 8;
      const int4 raw =
          *reinterpret_cast<const int4*>(ra + (st * TM + r) * TK + c);
      const int16_t* m = reinterpret_cast<const int16_t*>(&raw);
      const int* er = es_a + r * KB;
      float f[8];
      if (kb[c] == kb[c + 7]) {
        const float s = exp2i(er[kb[c]] - mantissa_bits);
#pragma unroll
        for (int j = 0; j < 8; ++j) f[j] = (float)m[j] * s;
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          f[j] = (float)m[j] * exp2i(er[kb[c + j]] - mantissa_bits);
      }
      float4* dst = reinterpret_cast<float4*>(af + r * LDF + c);
      dst[0] = make_float4(f[0], f[1], f[2], f[3]);
      dst[1] = make_float4(f[4], f[5], f[6], f[7]);
    }
    // B^T: a thread takes 8 K positions of one column, so that they share
    // one exponent where they lie in one block and land in 16-byte stores
    for (int v = tid; v < TK * TN / 8; v += THREADS) {
      const int n = v % TN, c = v / TN * 8;
      const int16_t* m = rb + (st * TK + c) * TN + n;
      const int* er = es_b + n * KB;
      float f[8];
      if (kb[c] == kb[c + 7]) {
        const float s = exp2i(er[kb[c]] - mantissa_bits);
#pragma unroll
        for (int j = 0; j < 8; ++j) f[j] = (float)m[j * TN] * s;
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          f[j] = (float)m[j * TN] * exp2i(er[kb[c + j]] - mantissa_bits);
      }
      float4* dst = reinterpret_cast<float4*>(bt + n * LDF + c);
      dst[0] = make_float4(f[0], f[1], f[2], f[3]);
      dst[1] = make_float4(f[4], f[5], f[6], f[7]);
    }
    __syncthreads();

#pragma unroll
    for (int k8 = 0; k8 < TK; k8 += 8) {
      uint32_t a[MI][4], b[NI][2];
      if constexpr (!X3) {
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          const float* p = af + (wm * WTM + i * 16 + g) * LDF + k8 + tq;
          a[i][0] = __float_as_uint(p[0]);
          a[i][1] = __float_as_uint(p[8 * LDF]);
          a[i][2] = __float_as_uint(p[4]);
          a[i][3] = __float_as_uint(p[8 * LDF + 4]);
        }
#pragma unroll
        for (int j = 0; j < NI; ++j) {
          const float* p = bt + (wn * WTN + j * 8 + g) * LDF + k8 + tq;
          b[j][0] = __float_as_uint(p[0]);
          b[j][1] = __float_as_uint(p[4]);
        }
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int j = 0; j < NI; ++j) mma(acc[i][j], a[i], b[j]);
      } else {
        uint32_t al[MI][4], bl[NI][2];
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          const float* p = af + (wm * WTM + i * 16 + g) * LDF + k8 + tq;
          split(p[0], a[i][0], al[i][0]);
          split(p[8 * LDF], a[i][1], al[i][1]);
          split(p[4], a[i][2], al[i][2]);
          split(p[8 * LDF + 4], a[i][3], al[i][3]);
        }
#pragma unroll
        for (int j = 0; j < NI; ++j) {
          const float* p = bt + (wn * WTN + j * 8 + g) * LDF + k8 + tq;
          split(p[0], b[j][0], bl[j][0]);
          split(p[4], b[j][1], bl[j][1]);
        }
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int j = 0; j < NI; ++j)
            mma3(acc[i][j], a[i], al[i], b[j], bl[j]);
      }
    }
  }

  // accumulator (m16n8): rows g and g + 8, columns 2*tq and 2*tq + 1
  if constexpr (S == 1) {
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int col = n0 + wn * WTN + j * 8 + 2 * tq;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = m0 + wm * WTM + i * 16 + g + 8 * h;
          if (row >= M) continue;
          if (col < N) out[(size_t)row * N + col] = acc[i][j][2 * h];
          if (col + 1 < N)
            out[(size_t)row * N + col + 1] = acc[i][j][2 * h + 1];
        }
      }
    return;
  }
  // split K: the partial tile goes to shared memory, over the mantissa ring
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  float* part = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm * WTM + i * 16 + g + 8 * h;
        const int c = wn * WTN + j * 8 + 2 * tq;
        part[r * TN + c] = acc[i][j][2 * h];
        part[r * TN + c + 1] = acc[i][j][2 * h + 1];
      }
  cluster_sync();
  // block z sums rows [z, z + 1) * TM / S of the tile over the splits in
  // rank order and stores them, N fastest
  constexpr int ROWS = TM / S;
  for (int e = tid; e < ROWS * TN; e += THREADS) {
    const int r = blockIdx.z * ROWS + e / TN, c = e % TN;
    float sum = ld_cluster(part + r * TN + c, 0);
#pragma unroll
    for (int q = 1; q < S; ++q) sum += ld_cluster(part + r * TN + c, q);
    if (m0 + r < M && n0 + c < N) out[(size_t)(m0 + r) * N + n0 + c] = sum;
  }
  // no block leaves while another still reads its partial tile
  cluster_sync();
}

template <int TM, int TN, int WM, int S, bool X3>
int launch(const int16_t* ma, const int* ea, const int16_t* mb, const int* eb,
           float* out, int M, int N, int K, int block_size, int mantissa_bits,
           cudaStream_t stream) {
  const int KB = (K + block_size - 1) / block_size;
  const size_t smem = smem_bytes(TM, TN, KB);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  // the largest size set so far on each device: the attribute belongs
  // to the current device's context, and a mesh launches on several
  static size_t configured[MAX_DEVICES] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  cudaError_t err;
  if (smem > configured[dev]) {
    err = cudaFuncSetAttribute(bfp_matmul_kernel<TM, TN, WM, S, X3>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured[dev] = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((M + TM - 1) / TM, (N + TN - 1) / TN, S);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = S;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, bfp_matmul_kernel<TM, TN, WM, S, X3>, ma,
                           ea, mb, eb, out, M, N, K, KB, block_size,
                           mantissa_bits);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// tile_m x tile_n is one of the instantiated tiles and splits one of
// 1, 2, 4, 8 (bfp_matmul/ops.py:launch_shape); mantissa_bits above 10 take
// the hi + lo instances, above 15 (int16's range) are refused
extern "C" int bfp_matmul_f32(const int16_t* ma, const int* ea,
                              const int16_t* mb, const int* eb, float* out,
                              int M, int N, int K, int block_size,
                              int mantissa_bits, int tile_m, int tile_n,
                              int splits, cudaStream_t stream) {
  if (M < 1 || N < 1 || K < 1 || block_size < 1 || mantissa_bits < 0 ||
      mantissa_bits > 15)
    return (int)cudaErrorInvalidValue;
  const bool x3 = mantissa_bits > 10;
#define BFP_SPLIT(TM, TN, WM, S)                                          \
  if (tile_m == TM && tile_n == TN && splits == S)                        \
    return x3 ? launch<TM, TN, WM, S, true>(ma, ea, mb, eb, out, M, N, K, \
                                            block_size, mantissa_bits,    \
                                            stream)                       \
              : launch<TM, TN, WM, S, false>(ma, ea, mb, eb, out, M, N, K,\
                                             block_size, mantissa_bits,   \
                                             stream);
#define BFP_TILE(TM, TN, WM)                                              \
  BFP_SPLIT(TM, TN, WM, 1)                                                \
  BFP_SPLIT(TM, TN, WM, 2)                                                \
  BFP_SPLIT(TM, TN, WM, 4)                                                \
  BFP_SPLIT(TM, TN, WM, 8)
  BFP_TILE(64, 64, 2)
  BFP_TILE(64, 32, 2)
  BFP_TILE(128, 16, 4)
#undef BFP_TILE
#undef BFP_SPLIT
  return (int)cudaErrorInvalidValue;
}
