// Cross-attention decode step over split-half packed int4 K/V, Hopper
// (sm_90a).
//
// Replaces the TPU kernel yourmt3_tpu/ops/pallas/decode_attention.py
// `int4_cross_attention` (body `_int4_cross_kernel`): one query per
// (stream, head) against a static (dk/2, T) tile of packed nibbles, with
// the same exact algebra (nib = stored nibble = value + 8):
//   logits_t = ks_t * (sum_d q_lo[d]*lo(k[d,t]) + q_hi[d]*hi(k[d,t]) - 8*sum(q))
//   p = exp(logits - max), w = p * vs
//   out[d]        = (sum_t w_t*lo(v[d,t]) - 8*sum(w)) / max(sum(p), 1e-30)
//   out[d + dk/2] = (sum_t w_t*hi(v[d,t]) - 8*sum(w)) / max(sum(p), 1e-30)
//
// Layouts (identical to the reference):
//   q      (S, H, dk)        fp32 or bf16
//   k4, v4 (S, H, dk/2, T)   uint8: byte (d, t) = element d (low nibble)
//                            | element d + dk/2 (high nibble), both +8
//   ks, vs (S, H, T)         fp32 row scales
//   out    (S, H, dk)        q's dtype
//
// Bound on an H100 SXM (3.35 TB/s): the work is bytes. Each call reads
// the packed K and V once (2*S*H*dk/2*T bytes) and the fp32 scales
// (2*S*H*T*4 bytes). At the flagship's shape (S = 104 streams = 8
// segments x 13 channels, H = 6, dk = 64, T = 256) that is 10.2 MB of
// nibbles plus 1.28 MB of scales, about 3.4 us; at the tuned batch of 48
// segments (S = 624) about 69 MB, 20.6 us. The operations (4*dk per
// column and head, fp32) are a few percent of that.
//
// Design (simple first; TMA, a changed layout or fewer scale bytes are
// later work):
//   * one CTA of 128 threads per (stream, head): S*H CTAs, 624 at batch 8
//     and 3744 at batch 48, so every SM has several;
//   * T is walked in chunks of TC = 256 columns: the (dk/2, TC) packed
//     tile is staged into shared memory with 16-byte loads (byte loads
//     when T is not a multiple of 16), rows padded by 16 bytes so the
//     V pass reads without bank conflicts;
//   * pass 1: each thread takes columns t, t + 128, ... of the K tile,
//     unpacks both nibbles in registers and writes the logit into a
//     T-float row in shared memory; block-wide max and sums (warp
//     shuffles, then one word per warp);
//   * pass 2: R = 128/(dk/2) threads share each packed row d of the V
//     tile, accumulate sum w*lo and sum w*hi in registers over all
//     chunks, and combine with warp shuffles.
// Built without --use_fast_math: expf is the accurate one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "kernels.h"

namespace {

constexpr int NT = 128;
constexpr int NWARPS = NT / 32;
constexpr int TC = 256;           // columns per staged chunk
constexpr int SROW = TC + 16;     // padded shared row, bytes

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even
}

// Block-wide max / sum; every thread gets the result. Ends with a
// barrier, so shared writes made before the call are visible after it.
__device__ float block_max(float x, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < NWARPS; ++w) r = fmaxf(r, red[w]);
  __syncthreads();
  return r;
}

__device__ float block_sum(float x, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  float r = 0.f;
#pragma unroll
  for (int w = 0; w < NWARPS; ++w) r += red[w];
  __syncthreads();
  return r;
}

// Copy rows 0..DK2-1, columns c0..c0+n-1 of a (DK2, T) byte tile into
// shared memory (row stride SROW).
template <int DK2>
__device__ void stage(const uint8_t* __restrict__ src, uint8_t* dst, int T,
                      int c0, int n) {
  if ((T & 15) == 0) {  // n is then a multiple of 16 too
    const int per_row = n >> 4;
    for (int i = threadIdx.x; i < DK2 * per_row; i += NT) {
      const int d = i / per_row, j = (i % per_row) << 4;
      *reinterpret_cast<uint4*>(dst + d * SROW + j) =
          *reinterpret_cast<const uint4*>(src + static_cast<size_t>(d) * T +
                                          c0 + j);
    }
  } else {
    for (int i = threadIdx.x; i < DK2 * n; i += NT) {
      const int d = i / n, j = i % n;
      dst[d * SROW + j] = src[static_cast<size_t>(d) * T + c0 + j];
    }
  }
}

template <typename TQ, int DK2>
__global__ void __launch_bounds__(NT) int4_cross_kernel(
    const TQ* __restrict__ q, const uint8_t* __restrict__ k4,
    const float* __restrict__ ks, const uint8_t* __restrict__ v4,
    const float* __restrict__ vs, TQ* __restrict__ out, int T) {
  constexpr int DK = 2 * DK2;
  constexpr int R = NT / DK2;  // threads per packed V row (pass 2)
  static_assert(NT % DK2 == 0 && R <= 32, "DK2 must divide the CTA");

  __shared__ __align__(16) uint8_t s_tile[DK2 * SROW];
  __shared__ float s_q[DK];
  __shared__ float s_red[NWARPS];
  extern __shared__ float s_w[];  // T logits, then T weights w = p * vs

  const int tid = threadIdx.x;
  const size_t sh = blockIdx.x;  // (stream, head) pair, row-major
  const uint8_t* kt = k4 + sh * DK2 * T;
  const uint8_t* vt = v4 + sh * DK2 * T;
  const float* kss = ks + sh * T;
  const float* vss = vs + sh * T;

  for (int i = tid; i < DK; i += NT) s_q[i] = to_float(q[sh * DK + i]);
  __syncthreads();
  float qsum = 0.f;
#pragma unroll
  for (int i = 0; i < DK; ++i) qsum += s_q[i];

  // ---- pass 1: logits
  float lmax = -INFINITY;
  for (int c0 = 0; c0 < T; c0 += TC) {
    const int n = min(TC, T - c0);
    stage<DK2>(kt, s_tile, T, c0, n);
    __syncthreads();
    for (int j = tid; j < n; j += NT) {
      float raw = 0.f;
#pragma unroll 8
      for (int d = 0; d < DK2; ++d) {
        const int b = s_tile[d * SROW + j];
        raw += s_q[d] * static_cast<float>(b & 15) +
               s_q[d + DK2] * static_cast<float>(b >> 4);
      }
      const float lg = (raw - 8.f * qsum) * kss[c0 + j];
      s_w[c0 + j] = lg;
      lmax = fmaxf(lmax, lg);
    }
    __syncthreads();  // the tile is restaged by the next chunk
  }
  const float m = block_max(lmax, s_red);

  // ---- softmax weights: p = exp(logit - m), w = p * vs
  float psum = 0.f, wsum = 0.f;
  for (int t = tid; t < T; t += NT) {
    const float p = expf(s_w[t] - m);
    const float w = p * vss[t];
    psum += p;
    wsum += w;
    s_w[t] = w;
  }
  const float denom = fmaxf(block_sum(psum, s_red), 1e-30f);
  wsum = block_sum(wsum, s_red);

  // ---- pass 2: w . V, R threads per packed row
  const int d = tid / R;
  const int part = tid % R;
  float acc_lo = 0.f, acc_hi = 0.f;
  for (int c0 = 0; c0 < T; c0 += TC) {
    const int n = min(TC, T - c0);
    stage<DK2>(vt, s_tile, T, c0, n);
    __syncthreads();
    for (int j = part; j < n; j += R) {
      const int b = s_tile[d * SROW + j];
      const float w = s_w[c0 + j];
      acc_lo += w * static_cast<float>(b & 15);
      acc_hi += w * static_cast<float>(b >> 4);
    }
    __syncthreads();
  }
#pragma unroll
  for (int off = R / 2; off > 0; off >>= 1) {
    acc_lo += __shfl_xor_sync(0xffffffffu, acc_lo, off);
    acc_hi += __shfl_xor_sync(0xffffffffu, acc_hi, off);
  }
  if (part == 0) {
    TQ* o = out + sh * DK;
    store(o + d, (acc_lo - 8.f * wsum) / denom);
    store(o + d + DK2, (acc_hi - 8.f * wsum) / denom);
  }
}

template <typename TQ, int DK2>
cudaError_t launch(const void* q, const uint8_t* k4, const float* ks,
                   const uint8_t* v4, const float* vs, void* out, int S, int H,
                   int T, cudaStream_t stream) {
  int4_cross_kernel<TQ, DK2><<<S * H, NT, T * sizeof(float), stream>>>(
      static_cast<const TQ*>(q), k4, ks, v4, vs, static_cast<TQ*>(out), T);
  return cudaGetLastError();
}

template <typename TQ>
cudaError_t dispatch_dk(int dk, const void* q, const uint8_t* k4,
                        const float* ks, const uint8_t* v4, const float* vs,
                        void* out, int S, int H, int T, cudaStream_t stream) {
  switch (dk) {
    case 16: return launch<TQ, 8>(q, k4, ks, v4, vs, out, S, H, T, stream);
    case 32: return launch<TQ, 16>(q, k4, ks, v4, vs, out, S, H, T, stream);
    case 64: return launch<TQ, 32>(q, k4, ks, v4, vs, out, S, H, T, stream);
    case 128: return launch<TQ, 64>(q, k4, ks, v4, vs, out, S, H, T, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int int4_cross_attention_launch(const void* q, const void* k4,
                                           const void* ks, const void* v4,
                                           const void* vs, void* out, int S,
                                           int H, int dk, int T, int q_dtype,
                                           void* stream) {
  if (S < 1 || H < 1 || T < 1 || T > INT4_MAX_T)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* k = static_cast<const uint8_t*>(k4);
  const uint8_t* v = static_cast<const uint8_t*>(v4);
  const float* kss = static_cast<const float*>(ks);
  const float* vss = static_cast<const float*>(vs);
  cudaError_t err;
  if (q_dtype == 0)
    err = dispatch_dk<float>(dk, q, k, kss, v, vss, out, S, H, T, st);
  else if (q_dtype == 1)
    err = dispatch_dk<__nv_bfloat16>(dk, q, k, kss, v, vss, out, S, H, T, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
