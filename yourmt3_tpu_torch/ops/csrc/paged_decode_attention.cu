// Paged single-query decode attention for Hopper (sm_90a), split-KV.
//
// Replaces the TPU kernel yourmt3_tpu/ops/pallas/decode_attention.py
// `paged_decode_attention` (body `_kernel`): one decode step of
// single-query attention over a paged KV cache, online softmax, causal
// mask j <= pos, and one of three biases: the T5 relative bias rebuilt
// from the (buckets, H) table, an explicit (H, L) row, or none
// (cross-attention). With int8 pages the per-position fp32 K and V scales
// fold into the logits and the softmax weights.
//
// Layouts (identical to the reference):
//   q      (S, H, dk)               fp32 or bf16
//   k, v   (NB, S, H, block, dk)    fp32, bf16 or int8 pages
//   ks, vs (S, NB, H, block)        fp32 row scales (int8 pages only)
//   table  (buckets, H) fp32, dist_buckets (n_dist,) int32: bucket of each
//          distance pos - j; distances >= n_dist take the last bucket
//   row    (H, L) fp32
//   out    (S, H, dk)               q's dtype
//   work   fp32 scratch for split partials: (S*H, nsplit, 2) of (m, l),
//          then (S*H, nsplit, dk) of unnormalised accumulators
// The C interface and the limits are in kernels.h.
//
// Bound on an H100 SXM (3.35 TB/s): the work is bytes. At the t5_small
// decode shape (S = 8, H = 6, dk = 64, block = 128, NB = 8, int8) and
// pos = 1023 one call must read 2*8*6*1024*64 B of int8 K/V plus
// 2*8*6*1024*4 B of scales, about 6.7 MB, so about 2.0 us. Only rows
// 0 .. pos are read.
//
// Design:
//   * split-KV: the live rows [0, pos] of a (stream, head) are cut into
//     contiguous ranges of `split_rows` rows, one CTA each (grid
//     S*H x nsplit). paged_decode_split_rows picks split_rows, a multiple
//     of 64 and at least 128, so the grid covers the card about three
//     times, the CTAs an SM holds at once (t5_small, pos 1023: 48 x 8 CTAs
//     of 128 rows, one step of every warp); when S*H alone fills the card,
//     or the live rows are few, there is one range and the CTA writes the
//     output itself. Otherwise each CTA writes a partial softmax state
//     (its max m, normaliser l, accumulator acc[dk]) and
//     paged_decode_merge_kernel, launched right after on the same stream,
//     rescales the partials by exp(m_i - m), sums them and writes the
//     output. A range that starts past pos writes the empty partial
//     (m = -1e30, l = 0), which the merge weighs by 0;
//   * warps own their rows: a row of dk values is C = dk*sizeof(T)/16
//     chunks of 16 bytes, lane t of a warp owns chunk t % C of row group
//     t / C, so a warp reads G = 32/C whole rows per step with 16-byte
//     loads, neighbouring lanes on neighbouring addresses. Each warp keeps
//     its own online-softmax state (m warp-uniform, l and acc per lane)
//     over its rows, and the four warps merge once at the end through
//     shared memory: no barrier inside the loop;
//   * bytes in flight: each lane loads the K and V chunks of U = 4 rows
//     into registers, with their scales and bias buckets, before the first
//     dot product, so a warp has 4 KB of K and V in flight per step (int8,
//     dk = 64); the first step's loads go out before the prologue's (q,
//     the bias table) and its barrier. int8 values become floats by a byte
//     permute and an add, not the quarter-rate I2F;
//   * fp32 accumulation throughout; the T5 bias gathers the port's own
//     bucket-by-distance table, so the bucket boundaries equal those of
//     the dense path bit for bit.
// Built without --use_fast_math: expf is the accurate one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "kernels.h"

namespace {

constexpr int NT = 128;
constexpr int NWARPS = NT / 32;
constexpr int U = 4;  // rows per lane per step
constexpr int SPLIT_ALIGN = 64;
constexpr int MIN_SPLIT_ROWS = 128;
constexpr int CTAS_PER_SM = 3;  // resident at about 160 registers a thread
constexpr int MAX_SPLITS = 4096;  // the merge keeps one float per range in shared memory
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

template <typename T>
struct Chunk;  // 16 bytes of T → VALS floats

template <>
struct Chunk<float> {
  static constexpr int VALS = 4;
  __device__ static void cvt(const uint4& r, float* out) {
    out[0] = __uint_as_float(r.x);
    out[1] = __uint_as_float(r.y);
    out[2] = __uint_as_float(r.z);
    out[3] = __uint_as_float(r.w);
  }
};

template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int VALS = 8;
  __device__ static void cvt(const uint4& r, float* out) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

template <>
struct Chunk<int8_t> {
  static constexpr int VALS = 16;
  // b ^ 0x80 = b + 128 as an unsigned byte u; the float with bits
  // 0x4B0000uu is 2^23 + u exactly, so subtracting 2^23 + 128 gives b
  // exactly: a byte permute and an add instead of a quarter-rate I2F
  __device__ static void cvt(const uint4& r, float* out) {
    const unsigned w[4] = {r.x ^ 0x80808080u, r.y ^ 0x80808080u,
                           r.z ^ 0x80808080u, r.w ^ 0x80808080u};
#pragma unroll
    for (int i = 0; i < 16; ++i)
      out[i] = __uint_as_float(__byte_perm(w[i / 4], 0x4B000000u, 0x7440u | (i % 4)))
               - 8388736.f;
  }
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even
}

__device__ __forceinline__ uint4 ld16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* ks;
  const float* vs;
  const float* rel_table;
  const int32_t* dist_buckets;
  const float* bias_row;
  void* out;
  float* part_ml;   // (S*H, nsplit, 2); null when nsplit == 1
  float* part_acc;  // (S*H, nsplit, dk)
  int n_dist, num_buckets, S, H, NB, block, pos, split_rows, nsplit;
};

template <typename TQ, typename TKV, int C>
__global__ void __launch_bounds__(NT) paged_decode_kernel(const Params p) {
  using CK = Chunk<TKV>;
  constexpr int VALS = CK::VALS;
  constexpr int DK = C * VALS;
  constexpr int G = 32 / C;   // row groups of a warp
  constexpr int RW = G * U;   // rows of a warp step

  __shared__ float s_tab[PAGED_MAX_BUCKETS];
  __shared__ float s_m[NWARPS], s_l[NWARPS];
  __shared__ float s_acc[NWARPS][DK];

  const int sh = blockIdx.x;  // s * H + h
  const int s = sh / p.H;
  const int h = sh - s * p.H;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int c = lane % C;
  const int g = lane / C;
  const int r0 = blockIdx.y * p.split_rows;
  const int r1 = min(r0 + p.split_rows, p.pos + 1);  // may be <= r0
  const int L = p.NB * p.block;
  const TKV* kb = static_cast<const TKV*>(p.k);
  const TKV* vb = static_cast<const TKV*>(p.v);

  // element offset of row j's first value in a page tensor
  auto row_of = [&](int j, int& b, int& jl) -> size_t {
    b = j / p.block;
    jl = j - b * p.block;
    return ((static_cast<size_t>(b) * p.S + s) * p.H + h) * p.block + jl;
  };

  // one step's registers: the K and V chunks of U rows, their scales, and
  // their bias (row mode) or bias bucket (table mode)
  uint4 kr[U], vr[U];
  float ksc[U], vsc[U], bias[U];
  int bkt[U];
  bool ok[U];
  // the K and V chunks of the step at row b0
  auto load_kv = [&](int b0) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = b0 + u * G + g;
      kr[u] = vr[u] = make_uint4(0u, 0u, 0u, 0u);
      if (j < r1) {
        int b, jl;
        const size_t off = row_of(j, b, jl) * DK + c * VALS;
        kr[u] = ld16(kb + off);
        vr[u] = ld16(vb + off);
      }
    }
  };
  auto load_scalars = [&](int b0) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = b0 + u * G + g;
      ok[u] = j < r1;
      ksc[u] = vsc[u] = 1.f;
      bias[u] = 0.f;
      bkt[u] = 0;
      if (ok[u]) {
        int b, jl;
        row_of(j, b, jl);
        if (p.ks != nullptr) {
          const size_t sc = ((static_cast<size_t>(s) * p.NB + b) * p.H + h) * p.block + jl;
          ksc[u] = __ldg(p.ks + sc);
          vsc[u] = __ldg(p.vs + sc);
        }
        if (p.rel_table != nullptr) {
          const int d = p.pos - j;  // >= 0: j < r1 <= pos + 1
          bkt[u] = d < p.n_dist ? __ldg(p.dist_buckets + d) : p.num_buckets - 1;
        } else if (p.bias_row != nullptr) {
          bias[u] = __ldg(p.bias_row + static_cast<size_t>(h) * L + j);
        }
      }
    }
  };

  // the first step's loads go out before the prologue's own loads and
  // barrier, so their latencies overlap
  constexpr int STRIDE = NWARPS * RW;
  int base = r0 + warp * RW;
  if (base < r1) {
    load_kv(base);
    load_scalars(base);
  }

  float qr[VALS];
  const TQ* qp = static_cast<const TQ*>(p.q) + static_cast<size_t>(sh) * DK + c * VALS;
#pragma unroll
  for (int i = 0; i < VALS; ++i) qr[i] = to_float(qp[i]);
  if (p.rel_table != nullptr)
    for (int i = threadIdx.x; i < p.num_buckets; i += NT)
      s_tab[i] = p.rel_table[i * p.H + h];
  __syncthreads();

  float m = NEG_INF, l = 0.f;
  float acc[VALS];
#pragma unroll
  for (int i = 0; i < VALS; ++i) acc[i] = 0.f;

  // the trip count is warp-uniform, so the shuffles below are safe
  while (base < r1) {
    float lg[U];
    float mx = NEG_INF;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[VALS];
      CK::cvt(kr[u], kf);
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < VALS; ++i) dot += qr[i] * kf[i];
#pragma unroll
      for (int off = C / 2; off > 0; off >>= 1) dot += __shfl_xor_sync(FULL, dot, off);
      const float bu = p.rel_table != nullptr ? s_tab[bkt[u]] : bias[u];
      lg[u] = ok[u] ? dot * ksc[u] + bu : NEG_INF;
      mx = fmaxf(mx, lg[u]);
    }
#pragma unroll
    for (int off = 16; off >= C; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
    // row base + g of group 0 is live, so m_new is a real logit
    const float m_new = fmaxf(m, mx);
    const float corr = expf(m - m_new);
    l *= corr;
#pragma unroll
    for (int i = 0; i < VALS; ++i) acc[i] *= corr;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float pu = ok[u] ? expf(lg[u] - m_new) : 0.f;
      l += pu;
      const float w = pu * vsc[u];
      float vf[VALS];
      CK::cvt(vr[u], vf);
#pragma unroll
      for (int i = 0; i < VALS; ++i) acc[i] += w * vf[i];
    }
    m = m_new;

    base += STRIDE;
    if (base < r1) {
      load_kv(base);
      load_scalars(base);
    }
  }

  // the warp's state: lanes of one chunk c summed over the row groups
#pragma unroll
  for (int off = 16; off >= C; off >>= 1) {
    l += __shfl_xor_sync(FULL, l, off);
#pragma unroll
    for (int i = 0; i < VALS; ++i) acc[i] += __shfl_xor_sync(FULL, acc[i], off);
  }
  if (g == 0) {
#pragma unroll
    for (int i = 0; i < VALS; ++i) s_acc[warp][c * VALS + i] = acc[i];
  }
  if (lane == 0) {
    s_m[warp] = m;
    s_l[warp] = l;
  }
  __syncthreads();

  // merge the warps (a warp with no rows has m = -1e30, l = 0, acc = 0)
  float mm = s_m[0];
#pragma unroll
  for (int w = 1; w < NWARPS; ++w) mm = fmaxf(mm, s_m[w]);
  float fw[NWARPS];
  float ll = 0.f;
#pragma unroll
  for (int w = 0; w < NWARPS; ++w) {
    fw[w] = expf(s_m[w] - mm);
    ll += s_l[w] * fw[w];
  }
  const size_t part = static_cast<size_t>(sh) * p.nsplit + blockIdx.y;
  for (int d = threadIdx.x; d < DK; d += NT) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) a += s_acc[w][d] * fw[w];
    if (p.nsplit == 1)
      store(static_cast<TQ*>(p.out) + static_cast<size_t>(sh) * DK + d, a / fmaxf(ll, 1e-30f));
    else
      p.part_acc[part * DK + d] = a;
  }
  if (p.nsplit > 1 && threadIdx.x == 0) {
    p.part_ml[2 * part] = mm;
    p.part_ml[2 * part + 1] = ll;
  }
}

// One CTA per (stream, head): out = sum_i e_i acc_i / max(sum_i e_i l_i,
// 1e-30) with e_i = exp(m_i - max_i m_i). Range 0 always holds row 0, so
// the max is a real logit and an empty range's e_i is exactly 0. Each
// thread reads its first accumulators while the first warp reads the
// (m, l) of all ranges at once and leaves e_i in shared memory (nsplit
// floats, dynamic).
template <int DK>
__host__ __device__ constexpr int merge_threads() { return DK < 32 ? 32 : DK; }

template <typename TQ, int DK>
__global__ void __launch_bounds__(merge_threads<DK>()) paged_decode_merge_kernel(
    const float* __restrict__ ml, const float* __restrict__ acc,
    TQ* __restrict__ out, int nsplit) {
  constexpr int PRE = 8;  // accumulators a thread reads before the weights
  extern __shared__ float s_e[];
  __shared__ float s_l;
  const int sh = blockIdx.x;
  const int d = min(static_cast<int>(threadIdx.x), DK - 1);
  const float* m = ml + static_cast<size_t>(sh) * nsplit * 2;
  const float* a = acc + static_cast<size_t>(sh) * nsplit * DK + d;
  float pre[PRE];
#pragma unroll
  for (int k = 0; k < PRE; ++k) pre[k] = k < nsplit ? a[k * DK] : 0.f;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    float mm = NEG_INF;
    for (int i = lane; i < nsplit; i += 32) mm = fmaxf(mm, m[2 * i]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mm = fmaxf(mm, __shfl_xor_sync(FULL, mm, off));
    float ll = 0.f;
    for (int i = lane; i < nsplit; i += 32) {
      const float e = expf(m[2 * i] - mm);
      s_e[i] = e;
      ll += m[2 * i + 1] * e;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) ll += __shfl_xor_sync(FULL, ll, off);
    if (lane == 0) s_l = ll;
  }
  __syncthreads();
  if (static_cast<int>(threadIdx.x) >= DK) return;
  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < PRE; ++k)
    if (k < nsplit) sum += pre[k] * s_e[k];
  for (int i = PRE; i < nsplit; ++i) sum += a[static_cast<size_t>(i) * DK] * s_e[i];
  store(out + static_cast<size_t>(sh) * DK + d, sum / fmaxf(s_l, 1e-30f));
}

template <typename TQ, typename TKV, int C>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr int DK = C * Chunk<TKV>::VALS;
  paged_decode_kernel<TQ, TKV, C>
      <<<dim3(p.S * p.H, p.nsplit), NT, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.nsplit == 1) return err;
  paged_decode_merge_kernel<TQ, DK>
      <<<p.S * p.H, merge_threads<DK>(), p.nsplit * sizeof(float), stream>>>(
          p.part_ml, p.part_acc, static_cast<TQ*>(p.out), p.nsplit);
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
cudaError_t dispatch_dk(int dk, const Params& p, cudaStream_t stream) {
  constexpr int VALS = Chunk<TKV>::VALS;
  switch (dk) {
    case 16: return launch<TQ, TKV, 16 / VALS>(p, stream);
    case 32: return launch<TQ, TKV, 32 / VALS>(p, stream);
    case 64: return launch<TQ, TKV, 64 / VALS>(p, stream);
    case 128: return launch<TQ, TKV, 128 / VALS>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename TQ>
cudaError_t dispatch_kv(int kv_dtype, int dk, const Params& p, cudaStream_t stream) {
  switch (kv_dtype) {
    case 0: return dispatch_dk<TQ, float>(dk, p, stream);
    case 1: return dispatch_dk<TQ, __nv_bfloat16>(dk, p, stream);
    case 2: return dispatch_dk<TQ, int8_t>(dk, p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// All the live rows (one range) when S*H fills the card, else a multiple
// of 64 such that the grid covers the card about CTAS_PER_SM times (as
// many CTAs as an SM holds at once, so every range is in flight
// together), but at least MIN_SPLIT_ROWS: below that the merge costs more
// than the range saves. PERF.md has the sweep over range sizes that chose
// both.
extern "C" int paged_decode_split_rows(int S, int H, int rows, int sms) {
  const int pairs = S * H;
  if (pairs >= sms || rows <= MIN_SPLIT_ROWS) return rows;
  const int want = (CTAS_PER_SM * sms + pairs - 1) / pairs;  // ranges per pair
  const int per = (rows + want - 1) / want;
  return max((per + SPLIT_ALIGN - 1) / SPLIT_ALIGN * SPLIT_ALIGN, MIN_SPLIT_ROWS);
}

extern "C" int paged_decode_attention_launch(
    const void* q, const void* k, const void* v, const float* ks,
    const float* vs, const float* rel_table, const int32_t* dist_buckets,
    int n_dist, int num_buckets, const float* bias_row, void* out,
    float* work, int S, int H, int NB, int block, int dk, int pos,
    int split_rows, int nsplit, int q_dtype, int kv_dtype, void* stream) {
  if (block < 1 || block > PAGED_MAX_BLOCK || num_buckets > PAGED_MAX_BUCKETS || S < 1 ||
      H < 1 || NB < 1 || pos < 0 || split_rows < 1 || nsplit < 1 ||
      nsplit > MAX_SPLITS || (nsplit > 1 && work == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{q, k, v, ks, vs, rel_table, dist_buckets, bias_row, out,
           work, work == nullptr ? nullptr : work + static_cast<size_t>(S) * H * nsplit * 2,
           n_dist, num_buckets, S, H, NB, block, pos, split_rows, nsplit};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (q_dtype == 0)
    err = dispatch_kv<float>(kv_dtype, dk, p, st);
  else if (q_dtype == 1)
    err = dispatch_kv<__nv_bfloat16>(kv_dtype, dk, p, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
