// K5: Mamba2 SSD intra-chunk block, per (batch-chunk, group, head).
//
// Replaces the TPU kernel `_ssd_chunk_kernel` (entry `ssd_chunk`) in
// src/repro/kernels/ssd_scan/kernel.py.
//
// Inputs, all f32 and contiguous: c, b (BC, G, Lc, N); xdt (BC, G, HPG,
// Lc, P); scum (BC, G, HPG, Lc, 1), the inclusive cumulative sum of
// dt * A inside the chunk.  Outputs: y (BC, G, HPG, Lc, P) and st (BC,
// G, HPG, P, N).  For every head of a group:
//     cb[t, s]  = C_t . B_s
//     W[t, s]   = cb[t, s] exp(scum_t - scum_s) for s <= t, else 0
//     y         = W xdt
//     st[p, n]  = sum_t xdt[t, p] exp(scum_last - scum_t) B[t, n]
// The decay is formed only for s <= t: the masked entries would be
// exp(+large) = inf, and inf * 0 = NaN (the reference masks the exponent
// for the same reason).
//
// What bounds it on an H100: at the Zamba2 prefill shape (BC 16, G 1,
// HPG 80, Lc 128, N 64, P 64) 4.06 GFLOP with cb formed once per
// (chunk, group), against 107 MB moved: the f32 FMAs (67 TFLOP/s outside
// the tensor cores) bound it at 61 us, bytes at 32 us.
// The TPU kernel recomputes cb for every head (80 times at Zamba2).  Here
// a 256-thread block owns one (chunk, group) and a run of heads, and
// keeps in shared memory cb (formed once, Lc x Lc), B, and per head xdt
// and W (Lc x Lc, each decay computed once).  Three register-tiled
// products run on a 16 x 16 thread grid: cb = C B^T (8 x 8 patches),
// y = W xdt (8 rows x P/16 columns, stopping at the diagonal) and
// st = (xdt exp(s_last - scum))^T B (P/16 x N/16 patches).  The patch
// widths are template arguments picked at launch, so no lane computes
// padding.  As many heads share a block as keep the grid near one block
// per SM (shared memory holds one block per SM at Lc 128).  Tensor cores
// are left to the PR that makes this kernel fast.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int LMAX = 128;        // chunk length, state and head dims
constexpr int RT = 8;            // rows per thread: 16 x 8 = 128 rows

__host__ __device__ inline size_t smem_floats(int Lc, int N, int P) {
  const int wcols = Lc > N ? Lc : N;
  return (size_t)Lc * Lc + (size_t)Lc * wcols + (size_t)Lc * (N + 1) +
         (size_t)Lc * P + 2 * (size_t)Lc;
}

template <int SP, int SN>
__global__ void __launch_bounds__(THREADS)
ssd_chunk_kernel(const float* __restrict__ c, const float* __restrict__ b,
                 const float* __restrict__ xdt,
                 const float* __restrict__ scum, float* __restrict__ y,
                 float* __restrict__ st, int G, int HPG, int Lc, int N,
                 int P, int heads_per_block) {
  extern __shared__ float smem[];
  const int ldb = N + 1;
  float* cb = smem;                          // [Lc][Lc]
  float* wr = cb + Lc * Lc;                  // [Lc][max(Lc, N)]: C, then W
  float* bs = wr + Lc * (Lc > N ? Lc : N);   // [Lc][N + 1]
  float* xs = bs + Lc * ldb;                 // [Lc][P] xdt of the head
  float* sc = xs + Lc * P;                   // [Lc] scum of the head
  float* el = sc + Lc;                       // [Lc] exp(scum_last - scum)

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int bc = blockIdx.x;
  const int g = blockIdx.y;
  const int h0 = blockIdx.z * heads_per_block;
  const int h1 = min(HPG, h0 + heads_per_block);
  const size_t cg = ((size_t)bc * G + g) * Lc * N;

  for (int i = tid; i < Lc * N; i += THREADS) {
    wr[i] = c[cg + i];
    bs[(i / N) * ldb + i % N] = b[cg + i];
  }
  __syncthreads();

  // cb = C B^T: rows ty + 16 i, columns tx + 16 j
  {
    float acc[RT][RT];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < RT; ++j) acc[i][j] = 0.f;
    for (int n = 0; n < N; ++n) {
      float a[RT], bb[RT];
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const int t = ty + 16 * i;
        a[i] = t < Lc ? wr[t * N + n] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < RT; ++j) {
        const int s = tx + 16 * j;
        bb[j] = s < Lc ? bs[s * ldb + n] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < RT; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int t = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < RT; ++j) {
        const int s = tx + 16 * j;
        if (t < Lc && s < Lc) cb[t * Lc + s] = acc[i][j];
      }
    }
  }

  const int r0 = ty * RT;                 // y rows r0 .. r0 + 7
  const int s_end = min(Lc, r0 + RT);     // W is zero past the diagonal
  for (int h = h0; h < h1; ++h) {
    const size_t hx = ((size_t)bc * G + g) * HPG + h;
    __syncthreads();   // cb is complete; the previous head is done
    for (int i = tid; i < Lc * P; i += THREADS) xs[i] = xdt[hx * Lc * P + i];
    for (int i = tid; i < Lc; i += THREADS) sc[i] = scum[hx * Lc + i];
    __syncthreads();
    for (int i = tid; i < Lc * Lc; i += THREADS) {
      const int t = i / Lc, s = i % Lc;
      wr[i] = s <= t ? cb[i] * expf(sc[t] - sc[s]) : 0.f;
    }
    for (int i = tid; i < Lc; i += THREADS) el[i] = expf(sc[Lc - 1] - sc[i]);
    __syncthreads();

    // y = W xdt: rows r0 + i, columns tx + 16 j
    {
      float acc[RT][SP];
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < SP; ++j) acc[i][j] = 0.f;
      for (int s = 0; s < s_end; ++s) {
        float w[RT], xv[SP];
#pragma unroll
        for (int i = 0; i < RT; ++i)
          w[i] = r0 + i < Lc ? wr[(r0 + i) * Lc + s] : 0.f;
#pragma unroll
        for (int j = 0; j < SP; ++j) {
          const int p = tx + 16 * j;
          xv[j] = p < P ? xs[s * P + p] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < RT; ++i)
#pragma unroll
          for (int j = 0; j < SP; ++j) acc[i][j] = fmaf(w[i], xv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const int r = r0 + i;
#pragma unroll
        for (int j = 0; j < SP; ++j) {
          const int p = tx + 16 * j;
          if (r < Lc && p < P) y[(hx * Lc + r) * P + p] = acc[i][j];
        }
      }
    }

    // st = (xdt e)^T B: rows p = ty + 16 i, columns n = tx + 16 j
    {
      float acc[SP][SN];
#pragma unroll
      for (int i = 0; i < SP; ++i)
#pragma unroll
        for (int j = 0; j < SN; ++j) acc[i][j] = 0.f;
      for (int t = 0; t < Lc; ++t) {
        const float e = el[t];
        float xa[SP], bb[SN];
#pragma unroll
        for (int i = 0; i < SP; ++i) {
          const int p = ty + 16 * i;
          xa[i] = p < P ? xs[t * P + p] * e : 0.f;
        }
#pragma unroll
        for (int j = 0; j < SN; ++j) {
          const int n = tx + 16 * j;
          bb[j] = n < N ? bs[t * ldb + n] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < SP; ++i)
#pragma unroll
          for (int j = 0; j < SN; ++j) acc[i][j] = fmaf(xa[i], bb[j], acc[i][j]);
      }
      float* sth = st + hx * P * N;
#pragma unroll
      for (int i = 0; i < SP; ++i) {
        const int p = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < SN; ++j) {
          const int n = tx + 16 * j;
          if (p < P && n < N) sth[p * N + n] = acc[i][j];
        }
      }
    }
  }
}

template <int SP, int SN>
int launch(const float* c, const float* b, const float* xdt,
           const float* scum, float* y, float* st, int BC, int G, int HPG,
           int Lc, int N, int P, cudaStream_t stream) {
  const size_t smem = smem_floats(Lc, N, P) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel<SP, SN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    sms = sms > 0 ? sms : 132;
  }
  // about one block per SM: heads are shared out among the (chunk, group)
  // pairs' blocks
  const long pairs = (long)BC * G;
  long per_pair = sms / pairs;
  per_pair = per_pair < 1 ? 1 : (per_pair > HPG ? HPG : per_pair);
  const int blocks_per_pair = (int)per_pair;
  const int heads_per_block = (HPG + blocks_per_pair - 1) / blocks_per_pair;
  const int hblocks = (HPG + heads_per_block - 1) / heads_per_block;
  dim3 grid(BC, G, hblocks);
  ssd_chunk_kernel<SP, SN><<<grid, THREADS, smem, stream>>>(
      c, b, xdt, scum, y, st, G, HPG, Lc, N, P, heads_per_block);
  return (int)cudaGetLastError();
}

int tiles(int d) {   // 16-wide column tiles, rounded up to 1, 2, 4 or 8
  const int t = (d + 15) / 16;
  return t <= 1 ? 1 : t <= 2 ? 2 : t <= 4 ? 4 : 8;
}

}  // namespace

#define SSD_LAUNCH(SP, SN)                                                  \
  if (sp == SP && sn == SN)                                                 \
    return launch<SP, SN>(c, b, xdt, scum, y, st, BC, G, HPG, Lc, N, P,     \
                          stream);
#define SSD_LAUNCH_ROW(SP) \
  SSD_LAUNCH(SP, 1) SSD_LAUNCH(SP, 2) SSD_LAUNCH(SP, 4) SSD_LAUNCH(SP, 8)

extern "C" int ssd_chunk_f32(const float* c, const float* b, const float* xdt,
                             const float* scum, float* y, float* st, int BC,
                             int G, int HPG, int Lc, int N, int P,
                             cudaStream_t stream) {
  if (BC < 1 || G < 1 || G > 65535 || HPG < 1 || Lc < 1 || Lc > LMAX ||
      N < 1 || N > LMAX || P < 1 || P > LMAX ||
      smem_floats(Lc, N, P) * sizeof(float) > 232448)
    return (int)cudaErrorInvalidValue;
  const int sp = tiles(P), sn = tiles(N);
  SSD_LAUNCH_ROW(1)
  SSD_LAUNCH_ROW(2)
  SSD_LAUNCH_ROW(4)
  SSD_LAUNCH_ROW(8)
  return (int)cudaErrorInvalidValue;
}
