// K5: Mamba2 SSD intra-chunk block, per (batch-chunk, group, head).
//
// Replaces the TPU kernel `_ssd_chunk_kernel` (entry `ssd_chunk`, whose
// `pl.pallas_call` is at src/repro/kernels/ssd_scan/kernel.py:70).
//
// Inputs, f32, any strides with the innermost one 1: c, b (BC, G, Lc, N);
// xdt (BC, G, HPG, Lc, P); scum (BC, G, HPG, Lc, 1), the inclusive
// cumulative sum of dt * A inside the chunk.  Outputs: y (BC, G, HPG, Lc,
// P) at the strides it is given and st (BC, G, HPG, P, N) contiguous.
// For every head of a group:
//     cb[t, s]  = C_t . B_s
//     W[t, s]   = cb[t, s] exp(scum_t - scum_s) for s <= t, else 0
//     y         = W xdt
//     st[p, n]  = sum_t xdt[t, p] exp(scum_last - scum_t) B[t, n]
// The exponent is masked (to -inf) before the exp: the t < s entries
// would be exp(+large) = inf, and inf * 0 = NaN (the reference masks the
// exponent for the same reason).
//
// What bounds it on an H100: at the Zamba2 prefill shape (BC 16, G 1,
// HPG 80, Lc 128, N 64, P 64) the bytes, 106.5 MB, 32 us at 3.35 TB/s;
// the products, 2.71 GFLOP counting the lower triangle of cb and y,
// three times over in 3xTF32, take 16 us at 495 TFLOP/s.  Measured
// (PERF.md, H100 SXM at 700 W): 0.178 ms; y takes 0.08 of it and st 0.05, with two warps per
// scheduler to hide each step's three dependent products.
//
// Design: the three products run on the TF32 tensor cores
// (`mma.sync.m16n8k8`, 3xTF32 as in tf32x3.cuh: one TF32 term uses 81% of
// the 3e-3 tolerance at Zamba2's shape).  A 128-thread block owns one
// (chunk, group) and a run of heads, about two blocks per SM.
// - Each warp owns two 16-row strips of the chunk, w and S - 1 - w, so
//   that the causal work is even (S = Lc / 16).  It forms its strips of
//   cb = C B^T once per block and keeps them in registers as m16n8
//   accumulators (at most 18 column tiles, 72 floats): no Lc x Lc tile in
//   shared memory, and only the column tiles s <= t are formed.
// - Per head, W = cb o exp(scum_t - scum_s) is formed in those registers
//   and feeds y = W xdt as the A operand.  The accumulator holds columns
//   2q, 2q + 1 of a tile where the A fragment wants q, q + 4, so the k
//   index is permuted: A takes the accumulator as it lies and B reads
//   xdt rows 2q and 2q + 1.  Only the k-steps s <= t are issued.
// - st = (xdt o e)^T B: each warp owns one 16-row block of p and a run
//   of 8-column tiles of n; same permuted k over t.
// - The next head's xdt and scum arrive by `cp.async` (16 bytes where the
//   rows allow, else 4) while this head computes: two buffers.  c, b,
//   xdt and scum are read in place through their strides, so the caller
//   makes no contiguous copies.
// - Row strides of Lc x (P + 4) and Lc x (N + 4) floats make every
//   fragment read free of bank conflicts.
// Budget (build.log, -Xptxas -v, CUDA 12.8): 132-196 registers across
// the 12 instances (190 at Zamba2's P 64, N 64), no spills; shared memory
// at Zamba2's shape 105,984 bytes (two blocks per SM), at N 128 138,752.
#include <math.h>
#include <string.h>

#include "tf32x3.cuh"

namespace {

using namespace tf32x3;

constexpr int THREADS = 128;     // four warps
constexpr int LMAX = 128;        // chunk length
constexpr int MAXK = 18;         // column tiles of a warp's two strips
constexpr int SMEM_MAX = 232448;
constexpr int ST_UNITS = 8;      // st tiles a warp sums at a time

struct Strides {                 // element strides, innermost dim omitted
  long long c[3], b[3], x[4], s[4], y[4];
};

__host__ __device__ inline int padded(int lc) { return (lc + 15) & ~15; }

// floats of shared memory: B, the C-then-xdt region, scum x 2, decays
__host__ __device__ inline int smem_floats(int Lc, int NN, int PP) {
  const int lp = padded(Lc), ldb = NN + 4, ldx = PP + 4;
  const int region = lp * ldb > 2 * lp * ldx ? lp * ldb : 2 * lp * ldx;
  return lp * ldb + region + 3 * lp;
}

// rows [0, lp) x columns [0, pcol) of a row-major matrix with row stride
// rs into dst (row stride ld), zero past rows x cols
__device__ __forceinline__ void load_rows(float* dst, int ld, const float* src,
                                          long long rs, int rows, int cols,
                                          int lp, int pcol, int tid) {
  const bool vec = cols % 4 == 0 && rs % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  if (vec) {
#pragma unroll 1
    for (int i = tid; i < lp * (pcol / 4); i += THREADS) {
      const int r = i / (pcol / 4), c4 = i % (pcol / 4) * 4;
      const bool in = r < rows && c4 < cols;
      cp_async16(dst + r * ld + c4, in ? src + r * rs + c4 : src,
                 in ? 16 : 0);
    }
  } else {
#pragma unroll 1
    for (int i = tid; i < lp * pcol; i += THREADS) {
      const int r = i / pcol, cc = i % pcol;
      const bool in = r < rows && cc < cols;
      cp_async4(dst + r * ld + cc, in ? src + r * rs + cc : src, in ? 4 : 0);
    }
  }
}

template <int PP, int NN>
__global__ void __launch_bounds__(THREADS, 1)
ssd_chunk_kernel(const float* __restrict__ c, const float* __restrict__ b,
                 const float* __restrict__ xdt,
                 const float* __restrict__ scum, float* __restrict__ y,
                 float* __restrict__ st, Strides sd, int G, int HPG, int Lc,
                 int N, int P, int heads_per_block) {
  constexpr int LDX = PP + 4, LDB = NN + 4, PT = PP / 8, NT = NN / 8;
  constexpr int MT = PP / 16, UNITS = MT * NT, UPW = (UNITS + 3) / 4;
  constexpr int UC = UPW < ST_UNITS ? UPW : ST_UNITS;
  extern __shared__ __align__(16) float smem[];
  const int lp = padded(Lc), S = lp / 16;
  float* bs = smem;                                   // [lp][LDB]
  float* reg = bs + lp * LDB;          // C [lp][LDB], then xdt [2][lp][LDX]
  float* sc = reg + (lp * LDB > 2 * lp * LDX ? lp * LDB : 2 * lp * LDX);
  float* el = sc + 2 * lp;             // [lp] exp(scum_last - scum)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int bc = blockIdx.x, grp = blockIdx.y;
  const int h0 = blockIdx.z * heads_per_block;
  const int h1 = min(HPG, h0 + heads_per_block);

  load_rows(bs, LDB, b + bc * sd.b[0] + grp * sd.b[1], sd.b[2], Lc, N, lp,
            NN, tid);
  load_rows(reg, LDB, c + bc * sd.c[0] + grp * sd.c[1], sd.c[2], Lc, N, lp,
            NN, tid);
  cp_async_commit();

  // this warp's strips: w and S - 1 - w (one of them when they coincide)
  const int sA = warp <= S - 1 - warp ? warp : -1;
  const int sB = S - 1 - warp > warp ? S - 1 - warp : -1;
  const int nA = sA < 0 ? 0 : 2 * sA + 2, nB = sB < 0 ? 0 : 2 * sB + 2;

  cp_async_wait_all();
  __syncthreads();
  // cb of the strips, column tiles s <= t only: tile kk < nA is column
  // tile kk of strip sA, the rest column tiles of strip sB
  float cbr[MAXK][4];
#pragma unroll
  for (int kk = 0; kk < MAXK; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) cbr[kk][e] = 0.f;
    if (kk >= nA + nB) continue;
    const int t0 = 16 * (kk < nA ? sA : sB), j = kk < nA ? kk : kk - nA;
    const float* ca = reg + (t0 + g) * LDB + q;
    const float* bb = bs + (8 * j + g) * LDB + q;
#pragma unroll 1
    for (int k0 = 0; k0 < NN; k0 += 8) {
      uint32_t ahi[4], alo[4], bhi[2], blo[2];
      split(ca[k0], ahi[0], alo[0]);
      split(ca[k0 + 8 * LDB], ahi[1], alo[1]);
      split(ca[k0 + 4], ahi[2], alo[2]);
      split(ca[k0 + 8 * LDB + 4], ahi[3], alo[3]);
      split(bb[k0], bhi[0], blo[0]);
      split(bb[k0 + 4], bhi[1], blo[1]);
      mma3(cbr[kk], ahi, alo, bhi, blo);
    }
  }
  __syncthreads();      // C is read: its region takes xdt from here on

  auto issue_head = [&](int h, int buf) {
    const float* xp = xdt + bc * sd.x[0] + grp * sd.x[1] + h * sd.x[2];
    load_rows(reg + buf * lp * LDX, LDX, xp, sd.x[3], Lc, P, lp, PP, tid);
    const float* sp = scum + bc * sd.s[0] + grp * sd.s[1] + h * sd.s[2];
    for (int t = tid; t < lp; t += THREADS)
      cp_async4(sc + buf * lp + t, t < Lc ? sp + t * sd.s[3] : sp,
                t < Lc ? 4 : 0);
    cp_async_commit();
  };

  issue_head(h0, 0);
  for (int h = h0; h < h1; ++h) {
    const int buf = (h - h0) & 1;
    cp_async_wait_all();
    __syncthreads();    // head h landed; every warp is past head h - 1
    if (h + 1 < h1) issue_head(h + 1, buf ^ 1);
    const float* xs = reg + buf * lp * LDX;
    const float* scb = sc + buf * lp;
    for (int t = tid; t < lp; t += THREADS)
      el[t] = t < Lc ? __expf(scb[Lc - 1] - scb[t]) : 0.f;

    // y = W xdt over this warp's strips
    float* yh = y + bc * sd.y[0] + grp * sd.y[1] + h * sd.y[2];
#pragma unroll
    for (int part = 0; part < 2; ++part) {
      const int strip = part == 0 ? sA : sB;
      if (strip < 0) continue;
      const int lo = part == 0 ? 0 : nA, hi = part == 0 ? nA : nA + nB;
      const int tg = 16 * strip + g;
      const float sg = scb[tg], sg8 = scb[tg + 8];
      float acc[PT][4];
#pragma unroll
      for (int n = 0; n < PT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < MAXK; ++kk) {
        if (kk < lo || kk >= hi) continue;
        const int s0 = 8 * (kk - lo) + 2 * q;     // columns s0, s0 + 1
        const float ss0 = scb[s0], ss1 = scb[s0 + 1];
        const float w0 = cbr[kk][0] * __expf(s0 <= tg ? sg - ss0 : -INFINITY);
        const float w1 =
            cbr[kk][1] * __expf(s0 + 1 <= tg ? sg - ss1 : -INFINITY);
        const float w2 =
            cbr[kk][2] * __expf(s0 <= tg + 8 ? sg8 - ss0 : -INFINITY);
        const float w3 =
            cbr[kk][3] * __expf(s0 + 1 <= tg + 8 ? sg8 - ss1 : -INFINITY);
        // k permuted: A k-slot q is column 2q, slot q + 4 column 2q + 1
        uint32_t ahi[4], alo[4];
        split(w0, ahi[0], alo[0]);
        split(w2, ahi[1], alo[1]);
        split(w1, ahi[2], alo[2]);
        split(w3, ahi[3], alo[3]);
        const float* xr = xs + s0 * LDX + g;
#pragma unroll
        for (int n = 0; n < PT; ++n) {
          uint32_t bhi[2], blo[2];
          split(xr[8 * n], bhi[0], blo[0]);
          split(xr[LDX + 8 * n], bhi[1], blo[1]);
          mma3(acc[n], ahi, alo, bhi, blo);
        }
      }
#pragma unroll
      for (int n = 0; n < PT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = tg + 8 * (e >> 1), p = 8 * n + 2 * q + (e & 1);
          if (t < Lc && p < P) yh[t * sd.y[3] + p] = acc[n][e];
        }
    }
    __syncthreads();    // the decays are in

    // st = (xdt o e)^T B: rows p of block mi, column tiles nj0 ..
    const int u0 = warp * UPW;
    if (u0 < UNITS) {
      const int mi = u0 / NT;
      float* sth = st + (((size_t)bc * G + grp) * HPG + h) * P * N;
#pragma unroll
      for (int ub = 0; ub < UPW; ub += UC) {   // UC units' sums at a time
        const int nj0 = (u0 + ub) % NT;
        float acc[UC][4];
#pragma unroll
        for (int i = 0; i < UC; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
        for (int k0 = 0; k0 < lp; k0 += 8) {
          const int ta = k0 + 2 * q;              // k permuted as above
          const float e0 = el[ta], e1 = el[ta + 1];
          const float* xa = xs + ta * LDX + 16 * mi + g;
          uint32_t ahi[4], alo[4];
          split(xa[0] * e0, ahi[0], alo[0]);
          split(xa[8] * e0, ahi[1], alo[1]);
          split(xa[LDX] * e1, ahi[2], alo[2]);
          split(xa[LDX + 8] * e1, ahi[3], alo[3]);
          const float* br = bs + ta * LDB + 8 * nj0 + g;
#pragma unroll
          for (int i = 0; i < UC; ++i) {
            uint32_t bhi[2], blo[2];
            split(br[8 * i], bhi[0], blo[0]);
            split(br[LDB + 8 * i], bhi[1], blo[1]);
            mma3(acc[i], ahi, alo, bhi, blo);
          }
        }
#pragma unroll
        for (int i = 0; i < UC; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int p = 16 * mi + g + 8 * (e >> 1);
            const int n = 8 * (nj0 + i) + 2 * q + (e & 1);
            if (p < P && n < N)
              sth[p * N + n] = acc[i][e];
          }
      }
    }
  }
}

template <int PP, int NN>
int launch(const float* c, const float* b, const float* xdt,
           const float* scum, float* y, float* st, const Strides& sd, int BC,
           int G, int HPG, int Lc, int N, int P, cudaStream_t stream) {
  const size_t smem = (size_t)smem_floats(Lc, NN, PP) * sizeof(float);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  static size_t configured = 0;     // the largest size set so far
  if (smem > configured) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_chunk_kernel<PP, NN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured = smem;
  }
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    sms = sms > 0 ? sms : 132;
  }
  // about two blocks per SM: heads are shared out among the (chunk,
  // group) pairs' blocks
  const long pairs = (long)BC * G;
  long per_pair = 2L * sms / pairs;
  per_pair = per_pair < 1 ? 1 : (per_pair > HPG ? HPG : per_pair);
  const int heads_per_block = (int)((HPG + per_pair - 1) / per_pair);
  const int hblocks = (HPG + heads_per_block - 1) / heads_per_block;
  dim3 grid(BC, G, hblocks);
  ssd_chunk_kernel<PP, NN><<<grid, THREADS, smem, stream>>>(
      c, b, xdt, scum, y, st, sd, G, HPG, Lc, N, P, heads_per_block);
  return (int)cudaGetLastError();
}

int pad16(int d) { return d <= 16 ? 16 : d <= 32 ? 32 : d <= 64 ? 64 : 128; }

}  // namespace

// strides: 18 element strides, c (BC, G, Lc), b (BC, G, Lc), xdt (BC, G,
// HPG, Lc), scum (BC, G, HPG, Lc), y (BC, G, HPG, Lc); the innermost
// stride of c, b, xdt and y is 1
extern "C" int ssd_chunk_f32(const float* c, const float* b, const float* xdt,
                             const float* scum, float* y, float* st,
                             const long long* strides, int BC, int G, int HPG,
                             int Lc, int N, int P, cudaStream_t stream) {
  if (BC < 1 || BC > 0x7fffffff || G < 1 || G > 65535 || HPG < 1 ||
      Lc < 1 || Lc > LMAX || N < 1 || N > 128 || P < 1 || P > 64)
    return (int)cudaErrorInvalidValue;
  static_assert(sizeof(Strides) == 18 * sizeof(long long), "strides");
  Strides sd;
  memcpy(&sd, strides, sizeof(sd));
  const int pp = pad16(P), nn = pad16(N);
#define SSD_LAUNCH(PP, NN)                                                  \
  if (pp == PP && nn == NN)                                                 \
    return launch<PP, NN>(c, b, xdt, scum, y, st, sd, BC, G, HPG, Lc, N, P, \
                          stream);
#define SSD_LAUNCH_ROW(PP) \
  SSD_LAUNCH(PP, 16) SSD_LAUNCH(PP, 32) SSD_LAUNCH(PP, 64) SSD_LAUNCH(PP, 128)
  SSD_LAUNCH_ROW(16)
  SSD_LAUNCH_ROW(32)
  SSD_LAUNCH_ROW(64)
#undef SSD_LAUNCH_ROW
#undef SSD_LAUNCH
  return (int)cudaErrorInvalidValue;
}
