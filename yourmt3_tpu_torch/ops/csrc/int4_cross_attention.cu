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
// What limits it: at S = 104 all 624 (stream, head) pairs fit on the card
// at once, so a call costs its chain of dependent steps, which the design
// keeps to one DRAM round trip and one CTA barrier; at S = 624 the fp32
// nibble arithmetic takes about as long as the bytes (PERF.md), and the
// next pair's loads go out while this one is computed.
//   * a grid of at most as many CTAs of 4 warps as the card holds at once
//     (the occupancy API); CTA b takes pairs b, b + grid, ... in turn;
//   * a pair's T is walked in chunks of TC = 256 columns, and warp w owns
//     columns [64w, 64w + 64) of each chunk from its loads to its softmax
//     state;
//   * for each (pair, chunk) item a warp issues its slice of the K tile,
//     the ks and vs rows and (on a pair's first chunk) its own copy of q as
//     one group of 16-byte cp.async, its slice of the V tile as a second
//     (plain loads when T is not a multiple of 16), and the next item's
//     before it computes this one: at the flagship's T = 256 a pair's K
//     and V tiles and both scale rows are in flight together, and V
//     arrives while the logits are computed. Rows are padded to TC + 16
//     bytes, so the V pass's 16-byte reads of 8 rows touch 32 different
//     banks;
//   * logits: lane l takes columns 2l and 2l + 1 of the warp's slice, q
//     read from shared memory (a broadcast; q in registers raised the
//     register count and was slower); nibbles become floats by a byte
//     permute into the bits of 2^23 + n and one exact add, on the
//     full-rate pipes (an I2F conversion runs at a quarter rate);
//   * each warp keeps its own online-softmax state (running max m, sum p,
//     sum w and the dk accumulators) over its columns, with warp shuffles
//     only: no block-wide reduction;
//   * w . V: each lane owns packed row(s) of the V tile (or a share of one
//     row at dk < 64) and reads 16 columns at once;
//   * the 4 warps' states meet once per pair, in shared memory after one
//     barrier: the (m, l) merge of split attention, exp(m_w - max m) per
//     warp; parity buffers let the next pair's warps run on meanwhile.
// Built without --use_fast_math: expf is the accurate one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "kernels.h"

namespace {

constexpr int NT = 128;
constexpr int NWARPS = NT / 32;
constexpr int TC = 256;           // columns per chunk
constexpr int WC = TC / NWARPS;   // columns per warp in a chunk
constexpr int SROW = TC + 16;     // padded shared row, bytes

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even
}

// 16 bytes global → shared, bypassing L1. A warp reads 64 bytes of each
// 128-byte line and the warp beside it the other 64: the L2 prefetch hint
// fetches the whole line for the first.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Byte k of x (a nibble, masked by the caller) as a float: the bits
// 0x4B0000xx are 2^23 + xx, and the subtraction is exact. A permute and
// an add run at the full rate; an I2F conversion at a quarter of it.
template <int K>
__device__ __forceinline__ float byte_to_float(unsigned x) {
  return __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7440u | K)) - 8388608.f;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// One pipeline stage: a chunk's K and V tiles (DK2 rows of SROW bytes)
// and its ks and vs rows.
template <int DK2>
struct Stage {
  static constexpr int BYTES = 2 * DK2 * SROW + 2 * TC * 4;
  uint8_t* k;
  uint8_t* v;
  float* ks;
  float* vs;
  __device__ explicit Stage(uint8_t* base)
      : k(base), v(base + DK2 * SROW),
        ks(reinterpret_cast<float*>(base + 2 * DK2 * SROW)), vs(ks + TC) {}
};

// The warp's slice [c0 + 64w, + nw) of the (DK2, T) tile `src` into `dst`
// (row stride SROW), 16 bytes per copy; nw a multiple of 16.
template <int DK2>
__device__ __forceinline__ void copy_tile_async(uint8_t* dst, const uint8_t* src, int T,
                                                int c0, int w, int nw, int lane) {
  constexpr int UNITS = WC / 16;  // 16-byte pieces of a row's slice
  const uint8_t* from = src + c0 + w * WC;
  uint8_t* to = dst + w * WC;
#pragma unroll
  for (int u = lane; u < DK2 * UNITS; u += 32) {
    const int d = u / UNITS, j = (u % UNITS) * 16;
    if (j < nw) cp_async16(to + d * SROW + j, from + static_cast<size_t>(d) * T + j);
  }
}

// The same with plain loads, any T; bytes past the slice read as 0.
template <int DK2>
__device__ __forceinline__ void copy_tile(uint8_t* dst, const uint8_t* src, int T,
                                          int c0, int w, int nw, int lane) {
  for (int u = lane; u < DK2 * WC; u += 32) {
    const int d = u / WC, j = u % WC;
    dst[d * SROW + w * WC + j] = j < nw ? src[static_cast<size_t>(d) * T + c0 + w * WC + j] : 0;
  }
}

// Issue the warp's share of one work item, chunk c0 of (stream, head)
// pair `sh`, into `st`: the K slice, the ks and vs slices (the softmax
// step needs all three) and, on a pair's first chunk, the warp's own copy
// of q, commit; the V slice, commit. Every lane commits two groups,
// copies or not.
template <typename TQ, int DK2>
__device__ __forceinline__ void issue_item(const Stage<DK2>& st, TQ* q_dst, const TQ* q,
                                           const uint8_t* k4, const float* ks,
                                           const uint8_t* v4, const float* vs, size_t sh,
                                           int T, int c0, int w, int lane, bool aligned) {
  constexpr int DK = 2 * DK2;
  const uint8_t* kt = k4 + sh * DK2 * T;
  const uint8_t* vt = v4 + sh * DK2 * T;
  const float* kss = ks + sh * T;
  const float* vss = vs + sh * T;
  const int nw = min(max(T - c0 - w * WC, 0), WC);
  if (aligned) {
    copy_tile_async<DK2>(st.k, kt, T, c0, w, nw, lane);
    if (lane < nw / 4) cp_async16(st.ks + w * WC + 4 * lane, kss + c0 + w * WC + 4 * lane);
    else if (lane >= 16 && lane - 16 < nw / 4)
      cp_async16(st.vs + w * WC + 4 * (lane - 16), vss + c0 + w * WC + 4 * (lane - 16));
    constexpr int QCOPIES = DK * static_cast<int>(sizeof(TQ)) / 16;
    if (c0 == 0 && lane < QCOPIES)
      cp_async16(reinterpret_cast<uint8_t*>(q_dst) + 16 * lane,
                 reinterpret_cast<const uint8_t*>(q + sh * DK) + 16 * lane);
    cp_async_commit();
    copy_tile_async<DK2>(st.v, vt, T, c0, w, nw, lane);
    cp_async_commit();
  } else {
    copy_tile<DK2>(st.k, kt, T, c0, w, nw, lane);
    copy_tile<DK2>(st.v, vt, T, c0, w, nw, lane);
    for (int j = lane; j < WC; j += 32) {
      st.ks[w * WC + j] = j < nw ? kss[c0 + w * WC + j] : 0.f;
      st.vs[w * WC + j] = j < nw ? vss[c0 + w * WC + j] : 0.f;
    }
    if (c0 == 0)
      for (int i = lane; i < DK; i += 32) q_dst[i] = q[sh * DK + i];
    cp_async_commit();
    cp_async_commit();
  }
}

template <typename TQ, int DK2>
__global__ void __launch_bounds__(NT) int4_cross_kernel(
    const TQ* __restrict__ q, const uint8_t* __restrict__ k4,
    const float* __restrict__ ks, const uint8_t* __restrict__ v4,
    const float* __restrict__ vs, TQ* __restrict__ out, int P, int T, int aligned_in) {
  constexpr int DK = 2 * DK2;
  constexpr int CPL = WC / 32;                  // logit columns per lane
  constexpr int LPR = DK2 < 32 ? 32 / DK2 : 1;  // lanes per packed V row
  constexpr int RPL = DK2 > 32 ? DK2 / 32 : 1;  // packed V rows per lane
  static_assert(CPL == 1 || CPL == 2, "a warp's slice is 32 or 64 columns");
  static_assert(DK2 >= 8 && DK2 <= 64, "dk in (16, 32, 64, 128)");

  // per pair parity: each warp's own copy of q, and the warps' states
  __shared__ __align__(16) TQ s_qraw[2][NWARPS][DK];
  __shared__ __align__(16) float s_q[NWARPS][DK];  // the warp's q in fp32
  __shared__ __align__(16) float s_w[NWARPS][WC];  // w = p * vs of the slice
  __shared__ float s_state[2][NWARPS][3];          // m, sum p, sum w
  __shared__ float s_acc[2][NWARPS][DK];           // sum w * nib, per output
  extern __shared__ __align__(16) uint8_t s_stage[];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int w = tid >> 5;
  const bool aligned = aligned_in != 0;
  const int nch = (T + TC - 1) / TC;
  const int pairs = (P - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
  const int items = pairs * nch;  // (pair, chunk) work items of this CTA, in order
  auto pair_of = [&](int pi) {
    return static_cast<size_t>(blockIdx.x) + static_cast<size_t>(pi) * gridDim.x;
  };
  auto stage = [&](int k) { return Stage<DK2>(s_stage + (k & 1) * Stage<DK2>::BYTES); };

  issue_item<TQ, DK2>(stage(0), s_qraw[0][w], q, k4, ks, v4, vs, pair_of(0), T, 0, w, lane,
                      aligned);
  const int row0 = DK2 < 32 ? lane % DK2 : lane;  // rows row0 + 32 i
  const int part = DK2 < 32 ? lane / DK2 : 0;
  float m = -INFINITY, l = 0.f, wsum = 0.f, qsum = 0.f;
  float acc_lo[RPL], acc_hi[RPL];

  int pi = 0, c = 0;  // item k is chunk c of the CTA's pair pi
  for (int k = 0; k < items; ++k) {
    const Stage<DK2> st = stage(k);
    const int c0 = c * TC;
    const int nw = min(max(T - c0 - w * WC, 0), WC);
    const bool more = k + 1 < items;
    const int next_c = c + 1 == nch ? 0 : c + 1, next_pi = next_c == 0 ? pi + 1 : pi;
    if (more) {  // the next item goes out before this one is computed
      issue_item<TQ, DK2>(stage(k + 1), s_qraw[next_pi & 1][w], q, k4, ks, v4, vs,
                          pair_of(next_pi), T, next_c * TC, w, lane, aligned);
      cp_async_wait<3>();  // pending: this item's V, the next item's two groups
    } else {
      cp_async_wait<1>();
    }
    __syncwarp();  // this item's K slice, ks, vs (and q) are in
    if (c == 0) {  // a new pair: its q in fp32, a fresh softmax state
      float s = 0.f;
      for (int i = lane; i < DK; i += 32) {
        const float x = to_float(s_qraw[pi & 1][w][i]);
        s_q[w][i] = x;
        s += x;
      }
      qsum = warp_sum(s);
      m = -INFINITY;
      l = wsum = 0.f;
#pragma unroll
      for (int i = 0; i < RPL; ++i) acc_lo[i] = acc_hi[i] = 0.f;
      __syncwarp();
    }

    // logits of the lane's CPL columns, then the warp's online softmax
    float alpha = 1.f;
    if (nw > 0) {
      const uint8_t* kc = st.k + w * WC + CPL * lane;
      const float* qw = s_q[w];
      float r[CPL] = {};
#pragma unroll
      for (int d0 = 0; d0 < DK2; d0 += 4) {
        const float4 ql4 = *reinterpret_cast<const float4*>(qw + d0);
        const float4 qh4 = *reinterpret_cast<const float4*>(qw + d0 + DK2);
        const float ql[4] = {ql4.x, ql4.y, ql4.z, ql4.w};
        const float qh[4] = {qh4.x, qh4.y, qh4.z, qh4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const unsigned u = CPL == 2 ? *reinterpret_cast<const uint16_t*>(kc + (d0 + e) * SROW)
                                      : kc[(d0 + e) * SROW];
          const unsigned lo = u & 0x0F0Fu, hi = (u >> 4) & 0x0F0Fu;
          r[0] += ql[e] * byte_to_float<0>(lo) + qh[e] * byte_to_float<0>(hi);
          if constexpr (CPL == 2)
            r[CPL - 1] += ql[e] * byte_to_float<1>(lo) + qh[e] * byte_to_float<1>(hi);
        }
      }
      const float* ksc = st.ks + w * WC + CPL * lane;
      const float* vsc = st.vs + w * WC + CPL * lane;
      float lg[CPL], mx = -INFINITY;
#pragma unroll
      for (int e = 0; e < CPL; ++e) {
        lg[e] = CPL * lane + e < nw ? (r[e] - 8.f * qsum) * ksc[e] : -INFINITY;
        mx = fmaxf(mx, lg[e]);
      }
      const float m_new = fmaxf(m, warp_max(mx));
      alpha = expf(m - m_new);  // 0 on the pair's first chunk
      float psum = 0.f, wpart = 0.f;
#pragma unroll
      for (int e = 0; e < CPL; ++e) {
        // a column past T was never copied: its vs slot may hold anything
        const float p = expf(lg[e] - m_new);
        const float wt = CPL * lane + e < nw ? p * vsc[e] : 0.f;
        s_w[w][CPL * lane + e] = wt;
        psum += p;
        wpart += wt;
      }
      l = l * alpha + warp_sum(psum);
      wsum = wsum * alpha + warp_sum(wpart);
      m = m_new;
    }
    if (more) cp_async_wait<2>(); else cp_async_wait<0>();
    __syncwarp();  // the V slice and the weights are in

    // w . V over the slice, 16 columns per read
#pragma unroll
    for (int i = 0; i < RPL; ++i) {
      acc_lo[i] *= alpha;
      acc_hi[i] *= alpha;
    }
    const int units = (nw + 15) >> 4;
    for (int j = part; j < units; j += LPR) {
      const float4* wp = reinterpret_cast<const float4*>(&s_w[w][16 * j]);
      float wv[16];
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const float4 f = wp[x];
        wv[4 * x] = f.x; wv[4 * x + 1] = f.y; wv[4 * x + 2] = f.z; wv[4 * x + 3] = f.w;
      }
#pragma unroll
      for (int i = 0; i < RPL; ++i) {
        const uint4 raw = *reinterpret_cast<const uint4*>(
            st.v + (row0 + 32 * i) * SROW + w * WC + 16 * j);
        const unsigned words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const unsigned lo = words[x] & 0x0F0F0F0Fu, hi = (words[x] >> 4) & 0x0F0F0F0Fu;
          const float* wx = wv + 4 * x;
          acc_lo[i] = fmaf(wx[0], byte_to_float<0>(lo), acc_lo[i]);
          acc_hi[i] = fmaf(wx[0], byte_to_float<0>(hi), acc_hi[i]);
          acc_lo[i] = fmaf(wx[1], byte_to_float<1>(lo), acc_lo[i]);
          acc_hi[i] = fmaf(wx[1], byte_to_float<1>(hi), acc_hi[i]);
          acc_lo[i] = fmaf(wx[2], byte_to_float<2>(lo), acc_lo[i]);
          acc_hi[i] = fmaf(wx[2], byte_to_float<2>(hi), acc_hi[i]);
          acc_lo[i] = fmaf(wx[3], byte_to_float<3>(lo), acc_lo[i]);
          acc_hi[i] = fmaf(wx[3], byte_to_float<3>(hi), acc_hi[i]);
        }
      }
    }
    __syncwarp();  // this stage is refilled for item k + 2

    if (c == nch - 1) {  // the pair is done: the lanes that share a row add
                         // up, then the warps' states meet
#pragma unroll
      for (int off = DK2; off < 32; off <<= 1) {
#pragma unroll
        for (int i = 0; i < RPL; ++i) {
          acc_lo[i] += __shfl_xor_sync(0xffffffffu, acc_lo[i], off);
          acc_hi[i] += __shfl_xor_sync(0xffffffffu, acc_hi[i], off);
        }
      }
      float(*state)[3] = s_state[pi & 1];
      float(*sacc)[DK] = s_acc[pi & 1];
      if (lane == 0) {
        state[w][0] = m;
        state[w][1] = l;
        state[w][2] = wsum;
      }
      if (part == 0) {
#pragma unroll
        for (int i = 0; i < RPL; ++i) {
          sacc[w][row0 + 32 * i] = acc_lo[i];
          sacc[w][row0 + 32 * i + DK2] = acc_hi[i];
        }
      }
      // one barrier per pair: the parity buffers are written again two
      // pairs on, after the next pair's barrier, which the readers pass
      // only when they are done here
      __syncthreads();
      if (tid < DK) {
        float mx = state[0][0];
#pragma unroll
        for (int x = 1; x < NWARPS; ++x) mx = fmaxf(mx, state[x][0]);
        float den = 0.f, ws = 0.f, a = 0.f;
#pragma unroll
        for (int x = 0; x < NWARPS; ++x) {
          const float e = expf(state[x][0] - mx);  // 0 for a warp with no columns
          den += e * state[x][1];
          ws += e * state[x][2];
          a += e * sacc[x][tid];
        }
        store(out + pair_of(pi) * DK + tid, (a - 8.f * ws) / fmaxf(den, 1e-30f));
      }
    }
    pi = next_pi;
    c = next_c;
  }
}

// CTAs of the grid: every (stream, head) pair gets one while the card
// holds that many at once (two pairs or more per CTA were slower at
// S = 104, PERF.md); past that, each CTA walks pairs blockIdx.x + i *
// gridDim.x, loading the next while it computes this one.
template <typename TQ, int DK2>
int grid_for(int P, size_t smem) {
  static int resident = 0;  // CTAs one SM holds, per instance
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return -1;
  if (resident == 0 && cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                           &resident, int4_cross_kernel<TQ, DK2>, NT, smem) != cudaSuccess)
    return -1;
  return min(P, max(resident, 1) * sms);
}

template <typename TQ, int DK2>
cudaError_t launch(const void* q, const uint8_t* k4, const float* ks,
                   const uint8_t* v4, const float* vs, void* out, int S, int H,
                   int T, cudaStream_t stream) {
  const size_t smem = 2 * static_cast<size_t>(Stage<DK2>::BYTES);
  if (smem > 48 * 1024) {  // dk 128 only
    const cudaError_t e = cudaFuncSetAttribute(
        int4_cross_kernel<TQ, DK2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int P = S * H;
  const int grid = grid_for<TQ, DK2>(P, smem);
  if (grid < 1) return cudaGetLastError();
  const bool aligned = (T & 15) == 0 && (reinterpret_cast<uintptr_t>(q) & 15) == 0;
  int4_cross_kernel<TQ, DK2><<<grid, NT, smem, stream>>>(
      static_cast<const TQ*>(q), k4, ks, v4, vs, static_cast<TQ*>(out), P, T, aligned);
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
