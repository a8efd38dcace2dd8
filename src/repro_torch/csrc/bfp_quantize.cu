// BFP quantize: the block floating-point encoding of paper Algorithm 1
// (core/bfp.py:quantize, and its roundtrip) in one pass over the tensor.
//
// Replaces no TPU kernel: the reference leaves Algorithm 1 to XLA, which
// fuses the chain of element-wise ops and the block max into a couple of
// fusions.  In eager PyTorch the same chain is 22 launches a roundtrip,
// each moving f32 or int32 over the whole tensor; the FCN engine runs it
// on both operands of every conv.
//
// The tensor is viewed as (outer, K, inner) and quantized in blocks of
// `block_size` along K, with the ragged last block zero-padded.  For each
// element x (FP16 or f32, widened to f32 exactly):
//   1. |x| < 2^-126 (zero, f32 subnormal) counts as zero;
//   2. e = frexp exponent, from the bits (x = m * 2^e, |m| in [0.5, 1)),
//      -2^30 for a zero;
//   3. xi = max e over the block, at least -2^29 (an all-zero block);
//   4. d = min(xi - e, 31);
//   5. mi = trunc(m * 2^mantissa_bits), plus sign(mi) * 2^(d-1) for
//      rounding "nearest" when d > 0, then mi >> d (arithmetic: negative
//      mantissas round toward minus infinity, as the hardware's shift).
// Two forms of output:
//   - quantize: int16 mantissas in x's layout and int32 block exponents
//     xi laid out (outer, inner, KB), as core/bfp.py's movedim(x, axis,
//     -1).shape[:-1] + (KB,), which K2 (csrc/bfp_matmul.cu) takes;
//   - roundtrip: f32 (mi >> d) * 2^clamp(xi - mantissa_bits, -126, 127),
//     the clamp of core/bfp.py:exp2i, not the true power: the value of
//     roundtrip(x.to(float32)), which the FCN engine (and the reference's
//     engine) takes, whatever x's stored type.
// Every step is integer or exact in f32, so the result is core/bfp.py's
// bit for bit.  That holds for an infinity or a NaN too, as those ops
// take them on the card: frexp gives them exponent 0, and the mantissa's
// float-to-int conversion saturates +-inf and takes a NaN to 0 (the
// sums then wrap as int32 does).  A random ResNet-50 overflows its FP16
// storage, so the engine meets them.
//
// What bounds it on an H100: bytes.  The kernel reads the tensor once in
// its stored type and writes its output once; no intermediate reaches
// device memory.  Two layouts:
//   - contiguous K (inner == 1, block_size 32, K a multiple of 8): four
//     threads a block, each with one 8-value vector (one 16-byte load of
//     FP16, two of f32); two __shfl_xor_sync steps give the block max, and
//     the mantissas or values leave as 16-byte stores;
//   - any other view (weights along Cin, B along K, the 3-channel stem,
//     other block sizes): one thread per (outer, block, inner) column,
//     with consecutive threads on consecutive inner positions, so the
//     loads coalesce whenever inner > 1; each thread reads its block
//     twice (the block max, then the encoding), the second time from L1
//     or L2.
#include <cuda_fp16.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int ZERO_EXP = -(1 << 30);        // frexp exponent of a zero
constexpr int ZERO_BLOCK_EXP = -(1 << 29);  // exponent of an all-zero block

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__half v) { return __half2float(v); }

// frexp exponent of v: ZERO_EXP for a zero or an f32 subnormal, 0 for an
// infinity or a NaN
__device__ __forceinline__ int exponent_of(float v) {
  const uint32_t ef = (__float_as_uint(v) >> 23) & 0xFF;
  return ef == 0 ? ZERO_EXP : ef == 0xFF ? 0 : (int)ef - 126;
}

// trunc(m * 2^mantissa_bits) of v's frexp mantissa m as int32 (0 for a
// zero or an f32 subnormal; +-inf saturate, a NaN is 0), mantissa_bits
// <= 24: |m| * 2^24 is the significand
__device__ __forceinline__ int mantissa_of(float v, int mantissa_bits) {
  const uint32_t bits = __float_as_uint(v);
  const uint32_t ef = (bits >> 23) & 0xFF;
  if (ef == 0) return 0;
  if (ef == 0xFF)
    return (bits & 0x7FFFFF) ? 0 : ((bits >> 31) ? INT_MIN : INT_MAX);
  const int a = (int)(((bits & 0x7FFFFF) | 0x800000) >> (24 - mantissa_bits));
  return (bits >> 31) ? -a : a;
}

__device__ __forceinline__ float exp2i(int e) {
  e = min(max(e, -126), 127);
  return __int_as_float((e + 127) << 23);
}

// steps 4 and 5 for one element of a block with exponent xi
__device__ __forceinline__ int encode(float v, int xi, int mantissa_bits,
                                      bool nearest) {
  int mi = mantissa_of(v, mantissa_bits);
  const int d = min(xi - exponent_of(v), 31);
  if (nearest && d > 0) {  // wraps as int32, for a saturated mantissa
    const unsigned half = 1u << (d - 1);
    mi = (int)((unsigned)mi + (mi > 0 ? half : (mi < 0 ? 0u - half : 0u)));
  }
  return mi >> d;
}

__device__ __forceinline__ float decode(int q, float scale) {
  return __fmul_rn((float)q, scale);
}

// 8 consecutive values from a 16-byte aligned address
__device__ __forceinline__ void load8(const __half* p, float (&v)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __half2* h = reinterpret_cast<const __half2*>(&raw);
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const float2 f = __half22float2(h[t]);
    v[2 * t] = f.x;
    v[2 * t + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// Contiguous K, block_size 32: lane j of each group of four holds values
// 8j..8j+7 of one block (a group never straddles two warps).  Lanes past
// the last group still take part in the shuffles.
template <typename T, bool RT>
__global__ void __launch_bounds__(THREADS)
bfp_quantize_rows_kernel(const T* __restrict__ x, int16_t* __restrict__ mant,
                         int* __restrict__ expo, float* __restrict__ val,
                         unsigned lanes, int K, unsigned KB,
                         int mantissa_bits, bool nearest) {
  const unsigned g = blockIdx.x * THREADS + threadIdx.x;
  const unsigned b = g >> 2, j = g & 3;
  const unsigned row = b / KB, kb = b - row * KB;
  const int k0 = (int)(kb * 32 + j * 8);
  const bool live = g < lanes && k0 < K;
  const size_t off = (size_t)row * K + k0;
  float v[8];
  if (live) {
    load8(x + off, v);
  } else {
#pragma unroll
    for (int t = 0; t < 8; ++t) v[t] = 0.f;
  }
  int emax = ZERO_EXP;
#pragma unroll
  for (int t = 0; t < 8; ++t) emax = max(emax, exponent_of(v[t]));
  emax = max(emax, __shfl_xor_sync(0xffffffffu, emax, 1));
  emax = max(emax, __shfl_xor_sync(0xffffffffu, emax, 2));
  const int xi = max(emax, ZERO_BLOCK_EXP);
  if (!live) return;
  int q[8];
#pragma unroll
  for (int t = 0; t < 8; ++t) q[t] = encode(v[t], xi, mantissa_bits, nearest);
  if (RT) {
    const float scale = exp2i(xi - mantissa_bits);
    float4 lo, hi;
    lo.x = decode(q[0], scale);
    lo.y = decode(q[1], scale);
    lo.z = decode(q[2], scale);
    lo.w = decode(q[3], scale);
    hi.x = decode(q[4], scale);
    hi.y = decode(q[5], scale);
    hi.z = decode(q[6], scale);
    hi.w = decode(q[7], scale);
    float4* out = reinterpret_cast<float4*>(val + off);
    out[0] = lo;
    out[1] = hi;
  } else {
    uint4 packed;
    uint32_t* w = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
    for (int t = 0; t < 4; ++t)
      w[t] = (uint32_t)(uint16_t)(int16_t)q[2 * t] |
             ((uint32_t)(uint16_t)(int16_t)q[2 * t + 1] << 16);
    *reinterpret_cast<uint4*>(mant + off) = packed;
    if (j == 0) expo[b] = xi;
  }
}

// Any view: one thread per (outer, block, inner) column of the block.
template <typename T, bool RT>
__global__ void __launch_bounds__(THREADS)
bfp_quantize_cols_kernel(const T* __restrict__ x, int16_t* __restrict__ mant,
                         int* __restrict__ expo, float* __restrict__ val,
                         unsigned lanes, int K, unsigned inner, unsigned KB,
                         int block_size, int mantissa_bits, bool nearest) {
  const unsigned g = blockIdx.x * THREADS + threadIdx.x;
  if (g >= lanes) return;
  const unsigned i = g % inner, r = g / inner;
  const unsigned o = r / KB, kb = r - o * KB;
  const int k0 = (int)kb * block_size, k1 = min(K, k0 + block_size);
  const size_t base = (size_t)o * K * inner + i;
  int emax = ZERO_EXP;
  for (int k = k0; k < k1; ++k)
    emax = max(emax, exponent_of(widen(x[base + (size_t)k * inner])));
  const int xi = max(emax, ZERO_BLOCK_EXP);
  const float scale = exp2i(xi - mantissa_bits);
  for (int k = k0; k < k1; ++k) {
    const size_t at = base + (size_t)k * inner;
    const int q = encode(widen(x[at]), xi, mantissa_bits, nearest);
    if (RT)
      val[at] = decode(q, scale);
    else
      mant[at] = (int16_t)q;
  }
  if (!RT) expo[((size_t)o * inner + i) * KB + kb] = xi;
}

unsigned grid_for(unsigned lanes) {
  return (unsigned)(((unsigned long long)lanes + THREADS - 1) / THREADS);
}

template <typename T, bool RT>
cudaError_t launch(const T* x, int16_t* mant, int* expo, float* val,
                   int outer, int K, int inner, int block_size,
                   int mantissa_bits, bool nearest, cudaStream_t stream) {
  const unsigned KB = (unsigned)((K + block_size - 1) / block_size);
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(mant) |
                         reinterpret_cast<uintptr_t>(val)) & 15) == 0;
  if (inner == 1 && block_size == 32 && K % 8 == 0 && aligned) {
    const unsigned lanes = (unsigned)outer * KB * 4;
    bfp_quantize_rows_kernel<T, RT>
        <<<grid_for(lanes), THREADS, 0, stream>>>(
            x, mant, expo, val, lanes, K, KB, mantissa_bits, nearest);
  } else {
    const unsigned lanes = (unsigned)outer * KB * (unsigned)inner;
    bfp_quantize_cols_kernel<T, RT>
        <<<grid_for(lanes), THREADS, 0, stream>>>(
            x, mant, expo, val, lanes, K, (unsigned)inner, KB, block_size,
            mantissa_bits, nearest);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, int16_t* mant, int* expo, float* val,
                     int outer, int K, int inner, int block_size,
                     int mantissa_bits, bool nearest, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  return val != nullptr
             ? launch<T, true>(xt, mant, expo, val, outer, K, inner,
                               block_size, mantissa_bits, nearest, stream)
             : launch<T, false>(xt, mant, expo, val, outer, K, inner,
                                block_size, mantissa_bits, nearest, stream);
}

}  // namespace

// x: (outer, K, inner) contiguous, dtype 0 f32 or 1 FP16.  Roundtrip form
// with `val` (f32, x's layout), quantize form with `mant` (int16, x's
// layout) and `expo` (int32, (outer, inner, KB)); the caller keeps the
// (outer, block, inner) count under 2^32 (bfp_quantize/ops.py).
extern "C" int bfp_quantize(const void* x, int dtype, int16_t* mant,
                            int* expo, float* val, int outer, int K,
                            int inner, int block_size, int mantissa_bits,
                            int nearest, cudaStream_t stream) {
  if (outer < 0 || K < 1 || inner < 1 || block_size < 1 ||
      mantissa_bits < 0 || mantissa_bits > 24 || (dtype != 0 && dtype != 1) ||
      (val == nullptr && (mant == nullptr || expo == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (outer == 0) return (int)cudaSuccess;
  return (int)(dtype == 1
                   ? dispatch<__half>(x, mant, expo, val, outer, K, inner,
                                      block_size, mantissa_bits, nearest != 0,
                                      stream)
                   : dispatch<float>(x, mant, expo, val, outer, K, inner,
                                     block_size, mantissa_bits, nearest != 0,
                                     stream));
}
