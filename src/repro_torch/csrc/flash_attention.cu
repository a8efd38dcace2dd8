// K4: blockwise online-softmax attention (flash), causal or not, with GQA.
//
// Replaces the TPU kernel `_flash_kernel` (entry `flash_attention_padded`)
// in src/repro/kernels/flash_attention/kernel.py.
//
// q (B, Hq, Lq, D), k and v (B, Hkv, Lkv, D), all contiguous, in f32 or
// bf16; out (B, Hq, Lq, D) in q's type.  Query head h reads KV head
// h / (Hq / Hkv).  Columns at or past kv_len are masked, and with `causal`
// column c is masked for row r when c > r (global indices, Lq == Lkv as
// in the reference).  Scores, the running max m, the normaliser l and the
// (64 x D) accumulator are f32; the flush writes acc / max(l, 1e-30) in
// the output type.  A ragged Lq or Lkv is masked in the kernel (rows past
// Lq are neither read nor written, KV rows past Lkv read as zeros), so the
// caller pads nothing.
//
// What bounds it on an H100: at the Zamba2 prefill shape (B 4, H 32,
// L 512, D 80, causal) 5.37 GFLOP against 42 MB of q/k/v/o in bf16, so
// the f32 FMAs (67 TFLOP/s outside the tensor cores) bound it at 80 us;
// bytes alone would take 12.5 us.
// The design is the plain one: one 256-thread block per (64-row query
// block, query head, batch).  The query tile, and one 64-row K and V tile
// at a time, sit in shared memory as f32 (converted once on load).  Each
// thread computes a 4 x 4 patch of the 64 x 64 score tile, the 4 threads
// of a row run the online softmax with warp shuffles, and each thread
// accumulates a 4-row x D/16 patch of P.V in registers.  The KV sweep
// stops at the causal limit and at kv_len, the counterpart of the
// reference's `pl.when` early-out.  Tensor cores (wgmma on bf16 tiles)
// and TMA are left to the PR that makes this kernel fast.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;          // query rows per block
constexpr int BN = 64;          // KV rows per step
constexpr int THREADS = 256;
constexpr int DMAX = 128;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);   // round to nearest even, as torch's .to()
}

// shared memory: qs[BM][D+1], ks[BN][D+1], vs[BN][D], ss[BM][BN+1],
// m[BM], l[BM], alpha[BM]
__host__ __device__ inline size_t smem_floats(int D) {
  return (size_t)BM * (D + 1) + (size_t)BN * (D + 1) + (size_t)BN * D +
         (size_t)BM * (BN + 1) + 3 * BM;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int Hq, int Hkv,
             int Lq, int Lkv, int D, int kv_len, float scale, int causal) {
  extern __shared__ float smem[];
  const int ldq = D + 1;
  float* qs = smem;
  float* ks = qs + BM * ldq;
  float* vs = ks + BN * ldq;
  float* ss = vs + BN * D;
  float* m_s = ss + BM * (BN + 1);
  float* l_s = m_s + BM;
  float* a_s = l_s + BM;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const T* qg = q + ((size_t)b * Hq + h) * Lq * D;
  const T* kg = k + ((size_t)b * Hkv + hk) * Lkv * D;
  const T* vg = v + ((size_t)b * Hkv + hk) * Lkv * D;
  T* og = out + ((size_t)b * Hq + h) * Lq * D;

  for (int i = tid; i < BM * D; i += THREADS) {
    const int r = i / D, d = i % D;
    qs[r * ldq + d] = (q0 + r < Lq) ? to_f32(qg[(size_t)(q0 + r) * D + d]) : 0.f;
  }
  if (tid < BM) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }

  // score patch: rows ty*4 + i, columns tx + 16*j
  const int ty = tid / 16, tx = tid % 16;
  // softmax: 4 threads per row, 16 columns each (part + 4*j)
  const int srow = tid / 4, spart = tid % 4;
  // accumulator patch: rows ty*4 + i, columns tx + 16*j (j < D/16)
  float acc[4][DMAX / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DMAX / 16; ++j) acc[i][j] = 0.f;

  int kv_end = min(Lkv, kv_len);
  if (causal) kv_end = min(kv_end, q0 + BM);
  for (int k0 = 0; k0 < kv_end; k0 += BN) {
    __syncthreads();   // previous step's readers of ks/vs/ss are done
    for (int i = tid; i < BN * D; i += THREADS) {
      const int r = i / D, d = i % D;
      const bool in = k0 + r < Lkv;
      ks[r * ldq + d] = in ? to_f32(kg[(size_t)(k0 + r) * D + d]) : 0.f;
      vs[r * D + d] = in ? to_f32(vg[(size_t)(k0 + r) * D + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float a[4], bb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty * 4 + i) * ldq + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bb[j] = ks[(tx + 16 * j) * ldq + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bb[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + tx + 16 * j;
        const bool keep = c < kv_len && (!causal || c <= r);
        ss[(ty * 4 + i) * (BN + 1) + tx + 16 * j] =
            keep ? s[i][j] * scale : NEG_INF;
      }
    }
    __syncthreads();

    // online softmax over this block, 4 threads per row
    {
      float* row = ss + srow * (BN + 1);
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < BN / 4; ++j) mx = fmaxf(mx, row[spart + 4 * j]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = m_s[srow];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < BN / 4; ++j) {
        const float p = expf(row[spart + 4 * j] - m_new);
        row[spart + 4 * j] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      __syncwarp();
      if (spart == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[srow] = alpha;
        l_s[srow] = l_s[srow] * alpha + sum;
        m_s[srow] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P . V
    const int ncol = (D - tx + 15) / 16;   // columns tx + 16*j < D
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float al = a_s[ty * 4 + i];
#pragma unroll
      for (int j = 0; j < DMAX / 16; ++j) acc[i][j] *= al;
    }
    for (int c = 0; c < BN; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ss[(ty * 4 + i) * (BN + 1) + c];
#pragma unroll
      for (int j = 0; j < DMAX / 16; ++j) {
        if (j < ncol) {
          const float vv = vs[c * D + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
        }
      }
    }
  }
  __syncthreads();

  const int ncol = (D - tx + 15) / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= Lq) continue;
    const float inv_l = 1.f / fmaxf(l_s[ty * 4 + i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DMAX / 16; ++j) {
      if (j < ncol)
        og[(size_t)r * D + tx + 16 * j] = from_f32<T>(acc[i][j] * inv_l);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Hq, int Hkv, int Lq, int Lkv, int D, int kv_len, float scale,
           int causal, cudaStream_t stream) {
  if (D < 1 || D > DMAX || Hkv < 1 || Hq % Hkv != 0 || kv_len < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_floats(D) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Lq + BM - 1) / BM, Hq, B);
  flash_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Hq, Hkv, Lq, Lkv, D,
      kv_len, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, int B, int Hq,
                                   int Hkv, int Lq, int Lkv, int D,
                                   int kv_len, float scale, int causal,
                                   int dtype, cudaStream_t stream) {
  if (dtype == 0)
    return launch<float>(q, k, v, out, B, Hq, Hkv, Lq, Lkv, D, kv_len, scale,
                         causal, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, B, Hq, Hkv, Lq, Lkv, D,
                                 kv_len, scale, causal, stream);
  return (int)cudaErrorInvalidValue;
}
