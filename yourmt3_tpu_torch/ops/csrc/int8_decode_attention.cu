// Decode attention over dense int8 K/V caches, Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package computes this step in jnp
// (yourmt3_tpu/ops/kv_quant.py `int8_decode_attention`), and so did the
// port (ops/kv_quant.py `int8_decode_attention_plain`), which casts the
// whole int8 K and V caches to fp32 at every step before two fp32 products.
// It serves the dense int8 self caches of the flagships' decoders and the
// int8 cross K/V of the fast decode path, with the plain version's staging:
//   logit_mj = (sum_d bf16(q_md) k_jd) * ks_j + bias_mj     fp32
//   e_mj = exp(logit_mj - max_j logit_mj)
//   w_mj = bf16((e_mj / sum_j e_mj) * vs_j)
//   out_md = sum_j w_mj v_jd                                 fp32, stored in q's dtype
//
// Layouts:
//   q      (S, H, M, dk)   fp32 or bf16: M query rows per KV head (G under
//                          grouped heads, else 1)
//   k, v   (S, H, L, dk)   int8, the whole cache
//   ks, vs (S, H, L)       fp32 row scales
//   bias   (1, H, M, n)    fp32, any strides, or none
//   out    (S, H, M, dk)   q's dtype
// Rows read: [0, live), live = min(pos + 1, n) with a position (the
// launch's host value, or a 0-dim int64 tensor on the device, read there),
// all n rows without one (cross-attention). Rows past the position add
// nothing in the plain version either: its bias row holds -1e9 there, whose
// exp is exactly 0 in fp32. The C interface and the limits are in kernels.h.
//
// Bound on an H100 SXM (3.35 TB/s): the work is bytes. At the flagship's
// beam shape (S = 208, H = 6, dk = 64) a call at position p reads
// 208*6*(p+1)*(2*64 + 2*4) B, 43 MB at p = 255, about 13 us; the
// operations (4*dk per row and query, fp32) are a few percent of that.
//
// Design:
//   * one CTA of 4 warps per (stream, head), no split of the rows: the
//     flagship's grids are 624 and 1248 CTAs, all resident at once, so a
//     call costs its chain of dependent steps; the launch does not depend
//     on the position, so one CUDA graph of a decode step serves every
//     position;
//   * warps own whole rows, as in the paged kernel: a row of dk int8 values
//     is C = dk/16 chunks of 16 bytes, lane t reads chunk t % C of row
//     group t / C, so a warp reads 32/C rows per load with 16-byte loads on
//     neighbouring addresses; int8 values become floats by a byte permute
//     and an add, not the quarter-rate I2F;
//   * K and V are read once each: the first step's K and V chunks (U = 4
//     rows a lane, 128 rows of the CTA at dk = 64, so the whole V of a live
//     range up to 128 rows) go out before q is read, and V is in registers
//     while the logits and the softmax are computed;
//   * two passes over the logits, held in shared memory (M * n floats),
//     because the weights are rounded to bf16 after they are normalised, as
//     in the plain version (no online softmax): the logits, their max, the
//     exponentials and their sum, then w . V with each weight formed where
//     it is used. Products and sums are rounded one at a time (__fmul_rn,
//     __fadd_rn), as the plain version rounds them;
//   * the warps' accumulators meet once, in shared memory, summed in warp
//     order. The kernel allocates nothing and never syncs with the host.
// Built without --use_fast_math: expf and the division are the accurate ones.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "kernels.h"

namespace {

constexpr int NT = 128;
constexpr int NWARPS = NT / 32;
constexpr int U = 4;      // rows per lane per step
constexpr int VALS = 16;  // int8 values in a 16-byte chunk
constexpr float NEG = -3.0e38f;
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  const void* q;
  const int8_t* k;
  const int8_t* v;
  const float* ks;
  const float* vs;
  const float* bias;
  void* out;
  const int64_t* pos_dev;  // the position on the device, or null: pos
  int64_t bias_h, bias_m, bias_j;  // the bias's strides, in elements
  int H, M, L, n, pos;  // pos < 0 without a position
  int q_bf16;
};

// 16 int8 values → floats: b ^ 0x80 = b + 128 as an unsigned byte u; the
// float with bits 0x4B0000uu is 2^23 + u exactly, so subtracting 2^23 + 128
// gives b exactly
__device__ __forceinline__ void cvt(const uint4& r, float* out) {
  const unsigned w[4] = {r.x ^ 0x80808080u, r.y ^ 0x80808080u, r.z ^ 0x80808080u,
                         r.w ^ 0x80808080u};
#pragma unroll
  for (int i = 0; i < VALS; ++i)
    out[i] = __uint_as_float(__byte_perm(w[i / 4], 0x4B000000u, 0x7440u | (i % 4))) -
             8388736.f;
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));  // round to nearest even
}

__device__ __forceinline__ uint4 ld16(const int8_t* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

template <int C, int MQ>
__global__ void __launch_bounds__(NT) int8_decode_kernel(const Params p) {
  constexpr int DK = C * VALS;
  constexpr int G = 32 / C;                // row groups of a warp
  constexpr int STRIDE = NWARPS * G * U;   // rows of a CTA step
  extern __shared__ float smem[];  // logits, then exponentials: (M, n); then (NWARPS, M, DK)
  __shared__ float s_max[NWARPS][MQ], s_sum[NWARPS][MQ];

  const int sh = blockIdx.x;  // s * H + h
  const int h = sh % p.H;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int c = lane % C;
  const int g = lane / C;
  int live = p.n;
  if (p.pos_dev != nullptr) {  // clamped: a stray value reads no row past n
    const int64_t d = *p.pos_dev;
    live = d >= p.n - 1 ? p.n : d < 0 ? 1 : static_cast<int>(d) + 1;
  } else if (p.pos >= 0) {
    live = min(p.pos + 1, p.n);
  }
  const size_t row0 = static_cast<size_t>(sh) * p.L;  // row 0 of this (stream, head)
  const int8_t* kb = p.k + row0 * DK + c * VALS;
  const int8_t* vb = p.v + row0 * DK + c * VALS;
  const float* ksr = p.ks + row0;
  const float* vsr = p.vs + row0;
  const float* biasr = p.bias == nullptr ? nullptr : p.bias + h * p.bias_h;

  uint4 kr[U], vr[U];
  float ksc[U], vsc[U], bs[U][MQ];
  auto load_k = [&](int b0) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = b0 + u * G + g;
      kr[u] = make_uint4(0u, 0u, 0u, 0u);
      ksc[u] = 0.f;
#pragma unroll
      for (int m = 0; m < MQ; ++m) bs[u][m] = 0.f;
      if (j < live) {
        kr[u] = ld16(kb + static_cast<size_t>(j) * DK);
        ksc[u] = __ldg(ksr + j);
        if (biasr != nullptr) {
#pragma unroll
          for (int m = 0; m < MQ; ++m)
            if (m < p.M) bs[u][m] = __ldg(biasr + m * p.bias_m + j * p.bias_j);
        }
      }
    }
  };
  auto load_v = [&](int b0) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = b0 + u * G + g;
      vr[u] = make_uint4(0u, 0u, 0u, 0u);
      vsc[u] = 0.f;
      if (j < live) {
        vr[u] = ld16(vb + static_cast<size_t>(j) * DK);
        vsc[u] = __ldg(vsr + j);
      }
    }
  };

  // the first step's K and V go out before q is read
  const int first = warp * (G * U);
  if (first < live) {
    load_k(first);
    load_v(first);
  }

  float qr[MQ][VALS];
#pragma unroll
  for (int m = 0; m < MQ; ++m) {
    const size_t off = (static_cast<size_t>(sh) * p.M + (m < p.M ? m : 0)) * DK + c * VALS;
#pragma unroll
    for (int i = 0; i < VALS; ++i) {
      float x = p.q_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p.q)[off + i])
                         : round_bf16(static_cast<const float*>(p.q)[off + i]);
      qr[m][i] = m < p.M ? x : 0.f;
    }
  }

  // pass 1: logits into shared memory, each row's written by lane c == 0
  // of its group (every lane of the group holds the same sum)
  float mx[MQ];
#pragma unroll
  for (int m = 0; m < MQ; ++m) mx[m] = NEG;
  // the trip count is warp-uniform, so the shuffles below are safe
  for (int b0 = first; b0 < live;) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = b0 + u * G + g;
      float kf[VALS];
      cvt(kr[u], kf);
#pragma unroll
      for (int m = 0; m < MQ; ++m) {
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < VALS; ++i) dot = fmaf(qr[m][i], kf[i], dot);
#pragma unroll
        for (int off = C / 2; off > 0; off >>= 1) dot += __shfl_xor_sync(FULL, dot, off);
        if (j < live && m < p.M) {
          const float lg = __fadd_rn(__fmul_rn(dot, ksc[u]), bs[u][m]);
          mx[m] = fmaxf(mx[m], lg);
          if (c == 0) smem[m * p.n + j] = lg;
        }
      }
    }
    b0 += STRIDE;
    if (b0 < live) load_k(b0);
  }
#pragma unroll
  for (int m = 0; m < MQ; ++m) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx[m] = fmaxf(mx[m], __shfl_xor_sync(FULL, mx[m], off));
    if (lane == 0) s_max[warp][m] = mx[m];
  }
  __syncthreads();

  // exponentials and their sum (each thread over rows t, t + NT, ...; then
  // the warp's lanes; then the warps in order)
  float sum[MQ];
#pragma unroll
  for (int m = 0; m < MQ; ++m) {
    float mm = s_max[0][m];
#pragma unroll
    for (int w = 1; w < NWARPS; ++w) mm = fmaxf(mm, s_max[w][m]);
    sum[m] = 0.f;
    if (m < p.M) {
      for (int j = threadIdx.x; j < live; j += NT) {
        const float e = expf(smem[m * p.n + j] - mm);
        smem[m * p.n + j] = e;
        sum[m] += e;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum[m] += __shfl_xor_sync(FULL, sum[m], off);
    if (lane == 0) s_sum[warp][m] = sum[m];
  }
  __syncthreads();
#pragma unroll
  for (int m = 0; m < MQ; ++m) {
    sum[m] = s_sum[0][m];
#pragma unroll
    for (int w = 1; w < NWARPS; ++w) sum[m] += s_sum[w][m];
  }

  // pass 2: w . V, the weight of row j formed where it is used
  float acc[MQ][VALS];
#pragma unroll
  for (int m = 0; m < MQ; ++m)
#pragma unroll
    for (int i = 0; i < VALS; ++i) acc[m][i] = 0.f;
  for (int b0 = first; b0 < live;) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = b0 + u * G + g;
      if (j < live) {
        float vf[VALS];
        cvt(vr[u], vf);
#pragma unroll
        for (int m = 0; m < MQ; ++m) {
          if (m < p.M) {
            const float w = round_bf16(__fmul_rn(smem[m * p.n + j] / sum[m], vsc[u]));
#pragma unroll
            for (int i = 0; i < VALS; ++i) acc[m][i] = fmaf(w, vf[i], acc[m][i]);
          }
        }
      }
    }
    b0 += STRIDE;
    if (b0 < live) load_v(b0);
  }

  // the warp's sums: lanes of one chunk c summed over the row groups
#pragma unroll
  for (int m = 0; m < MQ; ++m)
#pragma unroll
    for (int i = 0; i < VALS; ++i)
#pragma unroll
      for (int off = 16; off >= C; off >>= 1)
        acc[m][i] += __shfl_xor_sync(FULL, acc[m][i], off);
  __syncthreads();  // every warp is done with the exponentials
  if (g == 0) {
#pragma unroll
    for (int m = 0; m < MQ; ++m)
      if (m < p.M) {
#pragma unroll
        for (int i = 0; i < VALS; ++i) smem[(warp * p.M + m) * DK + c * VALS + i] = acc[m][i];
      }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < p.M * DK; t += NT) {
    float a = smem[t];
#pragma unroll
    for (int w = 1; w < NWARPS; ++w) a += smem[w * p.M * DK + t];
    const size_t o = static_cast<size_t>(sh) * p.M * DK + t;
    if (p.q_bf16)
      static_cast<__nv_bfloat16*>(p.out)[o] = __float2bfloat16(a);
    else
      static_cast<float*>(p.out)[o] = a;
  }
}

template <int C, int MQ>
cudaError_t launch(const Params& p, int S, cudaStream_t stream) {
  constexpr int DK = C * VALS;
  const int floats = max(p.M * p.n, NWARPS * p.M * DK);
  int8_decode_kernel<C, MQ><<<S * p.H, NT, floats * sizeof(float), stream>>>(p);
  return cudaGetLastError();
}

template <int C>
cudaError_t dispatch_m(const Params& p, int S, cudaStream_t stream) {
  if (p.M <= 1) return launch<C, 1>(p, S, stream);
  if (p.M <= 2) return launch<C, 2>(p, S, stream);
  if (p.M <= 4) return launch<C, 4>(p, S, stream);
  return launch<C, 8>(p, S, stream);
}

}  // namespace

extern "C" int int8_decode_attention_launch(
    const void* q, const void* k, const float* ks, const void* v, const float* vs,
    const float* bias, int64_t bias_h, int64_t bias_m, int64_t bias_j, void* out, int S,
    int H, int M, int L, int dk, int n, const int64_t* pos_dev, int pos, int q_dtype,
    void* stream) {
  if (S < 1 || H < 1 || M < 1 || M > INT8_DECODE_MAX_M || n < 1 || n > L ||
      n > INT8_DECODE_MAX_ROWS || (pos_dev == nullptr && pos >= n) ||
      (q_dtype != 0 && q_dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{q, static_cast<const int8_t*>(k), static_cast<const int8_t*>(v), ks, vs,
                 bias, out, pos_dev, bias_h, bias_m, bias_j, H, M, L, n,
                 pos_dev != nullptr ? -1 : pos, q_dtype};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dk) {
    case 16: return static_cast<int>(dispatch_m<1>(p, S, st));
    case 32: return static_cast<int>(dispatch_m<2>(p, S, st));
    case 64: return static_cast<int>(dispatch_m<4>(p, S, st));
    case 128: return static_cast<int>(dispatch_m<8>(p, S, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
