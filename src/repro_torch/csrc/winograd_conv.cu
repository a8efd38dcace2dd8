// K1: Winograd F(4x4, 3x3) convolution, stride 1, with the input
// transform, the 36 per-position products, the output transform, bias and
// ReLU in one kernel that reads the NHWC input plane and writes the
// cropped NHWC output plane.
//
// Replaces the TPU kernel `_winograd_mm_kernel` (entry
// `winograd_tile_matmul`, whose `pl.pallas_call` is at
// src/repro/kernels/winograd_conv/kernel.py:105).  The reference leaves
// the input transform V = B^T X B to XLA; here it is formed in shared
// memory, so V (2.25x the input plane) never reaches device memory.
//
// Computes, for every 4x4 output tile p of image n and output channel f:
//   V[p, z, c] = (B^T X_p B)[z]      X_p the 6x6 input patch of tile p
//   M[p, z, f] = sum_c V[p, z, c] * U[z, c, f]        (z = 0..35)
//   Y[p]       = A^T M[p] A  (6x6 -> 4x4), + bias[f], optional ReLU
// x is (n, H, W, Cin) f32, U = G W G^T is (36, Cin, Cout) f32 (formed by
// the wrapper), out (n, out_h, out_w, Cout).  SAME (pad 1) and VALID (pad
// 0) padding and the ragged last tile row and column read zeros.
//
// What bounds it on an H100: at conv1_2 of a 512x512 batch of 2 (64 -> 64
// channels) the bytes, x + U + y = 269 MB, 80 us at 3.35 TB/s; at conv5_1
// (32x32, 512 -> 512) the operations, 3 x 2.42 GFLOP of TF32 products,
// 15 us at 495 TFLOP/s.  Measured (PERF.md): 0.62 ms and 0.19 ms, the
// time spread over the MMA section (45% at conv1_2), the transform and
// the loads, which run in turn between barriers; `mma.sync` TF32 issues
// about one product per 10 cycles per scheduler here.
//
// Design.  Products on the TF32 tensor cores (`mma.sync.m16n8k8`) in
// 3xTF32 (tf32x3.cuh): one TF32 term misses the 2e-3 tolerance by 19-29x,
// because the transforms' coefficients (up to 8) amplify its rounding.
// - A block owns TR x TC = 32 (or 16) output tiles of one image and 32
//   output channels.  A warp owns one m16n8 fragment (16 tiles x 8
//   channels) for half of the 36 positions (three rows of M): 72 f32
//   accumulators a thread, kept across the whole Cin sweep.  At the end
//   A^T M A, linear in M, is applied to each half in registers; the
//   second half's warps hand their partial 4x4 tiles to the first half's
//   through shared memory, which add them, apply bias and ReLU and write
//   the NHWC plane once.  (All 36 positions in one warp, 144
//   accumulators, spilled.)
// - Cin is swept 8 channels a step.  The (4 TR + 2) x (4 TC + 2) x 8
//   input patch and the 36 x 8 x 32 slice of U arrive by `cp.async`
//   (16 bytes where Cin, resp. Cout, is a multiple of 4; scalar loads
//   otherwise, as at conv1_1's Cin 3), double-buffered: step k + 1 loads
//   while step k transforms and multiplies.
// - Each (tile, channel) of a step is transformed (B^T X B in registers)
//   by two threads, three rows of V each, and stored split into hi and
//   lo; U is split as its fragments are read.
// - Shared-memory layouts are free of bank conflicts: a patch row pads one
//   pixel in every four (the four tiles a warp transforms are 4 columns
//   apart, and a tile's 36 pixels lie at fixed offsets), V's channel
//   index is XOR-swizzled by bit 2 of the tile and U's column index by
//   the K row.
// - 16 warps (32 tiles) where the grid then has two blocks per SM or more,
//   otherwise 8 warps (16 tiles, e.g. at conv5_1's 8 x 8 tile planes).
// Budget (build.log, -Xptxas -v, CUDA 12.8): 127 registers (16 warps, the
// 128 a thread may have) or 254 (8 warps), no spills; 195,840 or 135,936
// bytes of shared memory: one block per SM.
#include "tf32x3.cuh"

namespace {

using namespace tf32x3;

constexpr int BK = 8;        // input channels per step
constexpr int SMEM_MAX = 232448;
constexpr int MAX_DEVICES = 64;

// A block: TR x TC output tiles x 8 WN output channels; 16-tile groups x
// WN channel groups x two halves of the 36 positions, one warp each
template <int TR, int TC, int WN>
struct Geo {
  static constexpr int TP = TR * TC;              // tiles per block
  static constexpr int WM = TP / 16;              // warps along the tiles
  static constexpr int BN = WN * 8;               // channels per block
  static constexpr int THREADS = WM * WN * 2 * 32;
  static constexpr int PAIRS = TP * BK;           // (tile, channel) a step
  static constexpr int VR = 6 * PAIRS / THREADS;  // rows of V a thread forms
  static constexpr int PH = 4 * TR + 2, PW = 4 * TC + 2;
  static constexpr int NPIX = PH * PW;
  static constexpr int RS = (PW + PW / 4) * BK;   // patch row stride, floats
  static constexpr int PATCH = PH * RS;                      // floats
  static constexpr int UST = 36 * BK * BN;                   // floats
  static constexpr int VST = 36 * TP * BK;                   // floats
  static constexpr int XCH = THREADS / 2 * 16;    // partial Y exchange
  static constexpr size_t SMEM = (size_t)(2 * PATCH + 2 * UST + 2 * VST) * 4;
  static_assert(TP % 16 == 0 && (VR == 6 || VR == 3), "transform split");
  static_assert(BN == 16 || BN == 32, "U swizzle");
  static_assert(XCH <= 2 * PATCH + 2 * UST + 2 * VST, "exchange space");
  static_assert(SMEM <= SMEM_MAX, "shared memory");
};

// U column swizzle: the 8-column group is XORed by k, so that fragment
// rows q and q + 4 of one warp fall in distinct banks
template <int BN>
__device__ __forceinline__ int uswz(int k) {
  return BN == 32 ? (k & 3) << 3 : ((k >> 1) & 1) << 3;
}

// patch offset of column col of a row: one pixel of padding after every
// four, so that the four tiles a warp transforms (4 columns apart) fall in
// distinct banks and a tile's 36 pixels lie at fixed offsets from its first
__device__ __forceinline__ int pcol(int col) { return (col + (col >> 2)) * BK; }

// rows of B^T applied to a 6-vector
__device__ __forceinline__ void bt6(const float d[6], float o[6]) {
  o[0] = 4.f * d[0] - 5.f * d[2] + d[4];
  o[1] = -4.f * d[1] - 4.f * d[2] + d[3] + d[4];
  o[2] = 4.f * d[1] - 4.f * d[2] - d[3] + d[4];
  o[3] = -2.f * d[1] - d[2] + 2.f * d[3] + d[4];
  o[4] = 2.f * d[1] - d[2] - 2.f * d[3] + d[4];
  o[5] = 4.f * d[1] - 5.f * d[3] + d[5];
}

// rows of A^T applied to a 6-vector
__device__ __forceinline__ void at6(const float m[6], float o[4]) {
  o[0] = m[0] + m[1] + m[2] + m[3] + m[4];
  o[1] = m[1] - m[2] + 2.f * m[3] - 2.f * m[4];
  o[2] = m[1] + m[2] + 4.f * m[3] + 4.f * m[4];
  o[3] = m[1] - m[2] + 8.f * m[3] - 8.f * m[4] + m[5];
}

// A^T[r][i], the output transform's coefficients
__device__ __forceinline__ float at(int r, int i) {
  constexpr float T[4][6] = {{1, 1, 1, 1, 1, 0},
                             {0, 1, -1, 2, -2, 0},
                             {0, 1, 1, 4, 4, 0},
                             {0, 1, -1, 8, -8, 1}};
  return T[r][i];
}

template <int TR, int TC, int WN>
__global__ void __launch_bounds__(Geo<TR, TC, WN>::THREADS, 1)
winograd_fused_kernel(const float* __restrict__ x, const float* __restrict__ u,
                      const float* __restrict__ bias, float* __restrict__ out,
                      int H, int W, int cin, int cout, int pad, int out_h,
                      int out_w, int th, int tw, int relu) {
  using G = Geo<TR, TC, WN>;
  constexpr int BN = G::BN;
  extern __shared__ __align__(16) float smem[];
  float* patch = smem;                  // [2][PATCH], pixel-padded
  float* us = patch + 2 * G::PATCH;     // [2][36][BK][BN], columns swizzled
  float* vhi = us + 2 * G::UST;         // [36][TP][BK], channel ^ tile bit 2
  float* vlo = vhi + G::VST;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  // warp -> (half of the positions, tile group, channel group)
  const int wz = warp / (G::WM * WN), wm = warp / WN % G::WM, wn = warp % WN;
  // block -> (image, tile-row block, tile-column block, channel block),
  // channel blocks fastest so that neighbours share the input patch in L2
  const int nblk = (cout + BN - 1) / BN;
  const int n0 = (blockIdx.x % nblk) * BN;
  const int tb = blockIdx.x / nblk;
  const int tbc = (tw + TC - 1) / TC, tbr = (th + TR - 1) / TR;
  const int ti0 = (tb / tbc % tbr) * TR, tj0 = (tb % tbc) * TC;
  const int img = tb / (tbc * tbr);

  // queue input channels [k0, k0 + BK) of the patch and of U into stage st
  auto issue = [&](int k0, int st) {
    const int y0 = 4 * ti0 - pad, x0 = 4 * tj0 - pad;   // patch origin
    const float* ximg = x + (size_t)img * H * W * cin;
    float* pd = patch + st * G::PATCH;
    if (cin % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0) {
#pragma unroll 1
      for (int i = tid; i < G::NPIX * 2; i += G::THREADS) {
        const int p = i >> 1, c = k0 + 4 * (i & 1);
        const int r = p / G::PW, col = p % G::PW;
        const int gy = y0 + r, gx = x0 + col;
        const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W && c < cin;
        cp_async16(pd + r * G::RS + pcol(col) + 4 * (i & 1),
                   in ? ximg + ((size_t)gy * W + gx) * cin + c : x,
                   in ? 16 : 0);
      }
    } else {
#pragma unroll 1
      for (int i = tid; i < G::NPIX * BK; i += G::THREADS) {
        const int p = i / BK, c = k0 + i % BK;
        const int r = p / G::PW, col = p % G::PW;
        const int gy = y0 + r, gx = x0 + col;
        const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W && c < cin;
        pd[r * G::RS + pcol(col) + i % BK] =
            in ? ximg[((size_t)gy * W + gx) * cin + c] : 0.f;
      }
    }
    float* ud = us + st * G::UST;
    if (cout % 4 == 0 && (reinterpret_cast<uintptr_t>(u) & 15) == 0) {
#pragma unroll 1
      for (int i = tid; i < 36 * BK * (BN / 4); i += G::THREADS) {
        const int c4 = i % (BN / 4) * 4, kk = i / (BN / 4) % BK;
        const int z = i / (BK * BN / 4);
        const int gk = k0 + kk, gn = n0 + c4;
        const bool in = gk < cin && gn < cout;
        cp_async16(ud + (z * BK + kk) * BN + (c4 ^ uswz<BN>(kk)),
                   in ? u + ((size_t)z * cin + gk) * cout + gn : u,
                   in ? 16 : 0);
      }
    } else {
#pragma unroll 1
      for (int i = tid; i < 36 * BK * BN; i += G::THREADS) {
        const int nn = i % BN, kk = i / BN % BK, z = i / (BK * BN);
        const int gk = k0 + kk, gn = n0 + nn;
        ud[(z * BK + kk) * BN + (nn ^ uswz<BN>(kk))] =
            gk < cin && gn < cout ? u[((size_t)z * cin + gk) * cout + gn]
                                  : 0.f;
      }
    }
  };

  // this warp's 18 positions z = 18 wz + zz: rows 3 wz .. 3 wz + 2 of M
  float acc[18][4];
#pragma unroll
  for (int z = 0; z < 18; ++z)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[z][e] = 0.f;

  // the (tile, channel) and the rows of V this thread forms in every step
  const int t_pair = tid % G::PAIRS, t_i0 = tid / G::PAIRS * G::VR;
  const int t_tile = t_pair / BK, t_ch = t_pair % BK;
  const int t_base = 4 * (t_tile / TC) * G::RS + 5 * (t_tile % TC) * BK + t_ch;
  const int t_off = t_tile * BK + (t_ch ^ (((t_tile >> 2) & 1) << 2));
  // this thread's fragment offsets: V rows g and g + 8 of the warp's 16
  // tiles at channels q and q + 4 (swizzled); U rows q and q + 4 at the
  // warp's column g (swizzled); both at the warp's first position
  const int a_row = (wm * 16 + g) * BK, a_sw = ((g >> 2) & 1) << 2;
  const int a0 = 18 * wz * G::TP * BK + a_row + (q ^ a_sw);
  const int a1 = 18 * wz * G::TP * BK + a_row + ((q + 4) ^ a_sw);
  const int ucol = (wn * 8 + g) ^ uswz<BN>(q);
  const int b0 = 18 * wz * BK * BN + q * BN + ucol;
  const int b1 = 18 * wz * BK * BN + (q + 4) * BN + ucol;

  const int nk = (cin + BK - 1) / BK;
  issue(0, 0);
  cp_async_commit();
  for (int ks = 0; ks < nk; ++ks) {
    const int st = ks & 1;
    cp_async_wait_all();
    __syncthreads();      // step ks landed; every warp is past step ks - 1
    if (ks + 1 < nk) {
      issue((ks + 1) * BK, st ^ 1);
      cp_async_commit();
    }
    {  // rows t_i0 .. t_i0 + VR - 1 of V = B^T X B, stored split
      const float* pd = patch + st * G::PATCH;
      float t6[G::VR][6];
#pragma unroll
      for (int l = 0; l < 6; ++l) {
        float d[6], o[6];
#pragma unroll
        for (int k = 0; k < 6; ++k)
          d[k] = pd[t_base + k * G::RS + pcol(l)];
        bt6(d, o);
#pragma unroll
        for (int i = 0; i < G::VR; ++i)
          t6[i][l] = G::VR == 6 ? o[i] : (t_i0 ? o[3 + i] : o[i]);
      }
#pragma unroll
      for (int i = 0; i < G::VR; ++i) {
        float o[6];
        bt6(t6[i], o);
#pragma unroll
        for (int j = 0; j < 6; ++j) {
          uint32_t hi, lo;
          split(o[j], hi, lo);
          const int idx = (6 * (t_i0 + i) + j) * G::TP * BK + t_off;
          vhi[idx] = __uint_as_float(hi);
          vlo[idx] = __uint_as_float(lo);
        }
      }
    }
    __syncthreads();
    const float* ud = us + st * G::UST;
#pragma unroll
    for (int z = 0; z < 18; ++z) {
      const float* vh = vhi + z * G::TP * BK;
      const float* vl = vlo + z * G::TP * BK;
      uint32_t ahi[4], alo[4], bhi[2], blo[2];
      ahi[0] = __float_as_uint(vh[a0]);
      ahi[1] = __float_as_uint(vh[a0 + 8 * BK]);
      ahi[2] = __float_as_uint(vh[a1]);
      ahi[3] = __float_as_uint(vh[a1 + 8 * BK]);
      alo[0] = __float_as_uint(vl[a0]);
      alo[1] = __float_as_uint(vl[a0 + 8 * BK]);
      alo[2] = __float_as_uint(vl[a1]);
      alo[3] = __float_as_uint(vl[a1 + 8 * BK]);
      const float* uz = ud + z * BK * BN;
      split(uz[b0], bhi[0], blo[0]);
      split(uz[b1], bhi[1], blo[1]);
      mma3(acc[z], ahi, alo, bhi, blo);
    }
  }

  // A^T M A is linear in M: each warp transforms its three rows of M,
  // the second half's warps hand their partial Y to the first half's
  // through shared memory, which add, apply bias and ReLU, and store.
  __syncthreads();                     // every warp is done with V and U
  float* xch = smem + (warp % (G::WM * WN)) * 32 * 16 + lane;  // [k][lane]
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    // accumulator e: tile g + 8 (e / 2), channel 2q + (e % 2)
    float y[4][4];                     // partial A^T M A
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) y[r][c] = 0.f;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      float row[6], o[4];
#pragma unroll
      for (int j = 0; j < 6; ++j) row[j] = acc[6 * i + j][e];
      at6(row, o);                     // (M A)[i, :]
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float a = wz ? at(r, 3 + i) : at(r, i);
#pragma unroll
        for (int c = 0; c < 4; ++c) y[r][c] = fmaf(a, o[c], y[r][c]);
      }
    }
    if (wz) {
#pragma unroll
      for (int k = 0; k < 16; ++k) xch[k * 32] = y[k / 4][k % 4];
    }
    __syncthreads();
    if (!wz) {
      const int tile = wm * 16 + g + 8 * (e >> 1);
      const int gn = n0 + wn * 8 + 2 * q + (e & 1);
      const int ti = ti0 + tile / TC, tj = tj0 + tile % TC;
      if (gn < cout && ti < th && tj < tw) {
        const float b = bias ? bias[gn] : 0.f;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int oy = 4 * ti + r;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int ox = 4 * tj + c;
            float val = y[r][c] + xch[(4 * r + c) * 32] + b;
            if (relu) val = fmaxf(val, 0.f);
            if (oy < out_h && ox < out_w)
              out[(((size_t)img * out_h + oy) * out_w + ox) * cout + gn] =
                  val;
          }
        }
      }
    }
    __syncthreads();
  }
}

template <int TR, int TC, int WN>
int launch(const float* x, const float* u, const float* bias, float* out,
           long blocks, int H, int W, int cin, int cout, int pad, int out_h,
           int out_w, int th, int tw, int relu, cudaStream_t stream) {
  using G = Geo<TR, TC, WN>;
  // the attribute belongs to the current device's context: set it once
  // per device, so that a mesh of cards can launch on each
  static bool configured[MAX_DEVICES] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!configured[dev]) {
    cudaError_t err = cudaFuncSetAttribute(
        winograd_fused_kernel<TR, TC, WN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::SMEM);
    if (err != cudaSuccess) return (int)err;
    configured[dev] = true;
  }
  if (blocks > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  winograd_fused_kernel<TR, TC, WN><<<(unsigned)blocks, G::THREADS, G::SMEM,
                                      stream>>>(
      x, u, bias, out, H, W, cin, cout, pad, out_h, out_w, th, tw, relu);
  return (int)cudaGetLastError();
}

long cdiv(long a, long b) { return (a + b - 1) / b; }

}  // namespace

// pad is 1 (SAME) or 0 (VALID); the output plane is out_h x out_w
extern "C" int winograd_conv_fused(const float* x, const float* u,
                                   const float* bias, float* out, int n,
                                   int h, int w, int cin, int cout, int pad,
                                   int out_h, int out_w, int relu,
                                   cudaStream_t stream) {
  if (n < 1 || h < 1 || w < 1 || cin < 1 || cout < 1 || pad < 0 ||
      pad > 1 || out_h < 1 || out_w < 1 || out_h != h + 2 * pad - 2 ||
      out_w != w + 2 * pad - 2)
    return (int)cudaErrorInvalidValue;
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    sms = sms > 0 ? sms : 132;
  }
  const int th = (int)cdiv(out_h, 4), tw = (int)cdiv(out_w, 4);
  const long nblk = cdiv(cout, 32);
  const long wide = n * cdiv(th, 4) * cdiv(tw, 8) * nblk;
  if (wide >= 2L * sms)
    return launch<4, 8, 4>(x, u, bias, out, wide, h, w, cin, cout, pad,
                           out_h, out_w, th, tw, relu, stream);
  return launch<4, 4, 4>(x, u, bias, out,
                         n * cdiv(th, 4) * cdiv(tw, 4) * nblk, h, w, cin,
                         cout, pad, out_h, out_w, th, tw, relu, stream);
}
