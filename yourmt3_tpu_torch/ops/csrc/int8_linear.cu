// The int8-weight product of the decoder's linear layers, Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package computes this product in jnp
// (yourmt3_tpu/models/layers.py:110-117, a dot_general on the int8 weight
// cast to the compute dtype, then the fp32 per-channel scale), which XLA
// fuses on the TPU. The port ran it as five kernels a call: the weight's
// cast to bf16, the GEMM, the product's cast to fp32, the scale and the
// cast back (ops/weight_quant.py `int8_linear_plain`). This kernel computes
//   y_mn = bf16(fp32(bf16(sum_k x_mk w_nk)) * scale_n)    bf16 x
//   y_mn = (sum_k x_mk w_nk) * scale_n                     fp32 x
// with the sum in fp32, reading the int8 weight itself.
//
// Layouts:
//   x      (M, K)  bf16 or fp32, dense in its last dimension, rows ldx
//                  elements apart, every row on a 16-byte boundary
//   w      (N, K)  int8, contiguous
//   scale  (N,)    fp32
//   out    (M, N)  x's dtype, contiguous
// K is a multiple of 16. The C interface and the limits are in kernels.h.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s dense bf16): at the
// flagship's decode shapes (M = 104 or 208 rows; K and N from 384 to 1024)
// a call moves a few hundred KB and does at most 0.44 GFLOP: its bound is
// 0.1-0.35 us, below a launch. The time goes to latency, the chain from
// the first load to the last store, and to how many SMs one call fills. At
// the cross projection's M = 26,624 rows it is the bytes each block reads
// from L2.
//
// Design:
//   * one block of 4 warps per 32 x 32 output tile, one algorithm for every
//     shape: the grid is ceil(M/32) * ceil(N/32) blocks, N tiles fastest,
//     so the blocks that read the same x rows run together (48 to 224
//     blocks at the decode shapes);
//   * x and the int8 weight stream through a ring of 4 stages in shared
//     memory, 16-byte cp.async zero-filled past M, N and K, three stages in
//     flight before the first is used (K = 384 is all in flight at once);
//     16-byte chunks are XOR-swizzled by row, so the fragment reads of a
//     quarter warp (x) or half warp (weights) hit distinct banks;
//   * bf16: the 4 warps split each stage's 128 k in four slices of 32, and
//     each warp computes the whole tile on its slice with mma.sync m16n8k16
//     (fp32 accumulation): 16 products a stage. The int8 weights become
//     bf16 in registers (exact: a byte permute into the fp32 2^23 + 128 +
//     b, a subtraction, the high halves packed). A thread reads 8
//     consecutive k of its weight row (8 bytes) and of each of its x rows
//     (16 bytes); the mma's k order within 16 is permuted the same way in
//     both operands, so the sum is the same;
//   * the warps' partial tiles meet once in shared memory, summed in warp
//     order: a fixed order, no atomics, no split across blocks, so two runs
//     agree bit for bit and a CUDA graph's replay equals the eager call;
//   * the epilogue rounds the sum to bf16 (nearest even), widens it,
//     multiplies by the fp32 scale and rounds again, the plain version's
//     two roundings, and writes the only bytes the kernel writes to device
//     memory;
//   * fp32 x (a small fp32 model served with int8 weights): the same tiles
//     and ring, fp32 FFMA (no TF32), each thread 2 rows x 4 columns summed
//     over k in order, then the scale.
// The kernel allocates nothing and never syncs with the host.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <type_traits>

#include "kernels.h"

namespace {

constexpr int NT = 128;
constexpr int NWARPS = NT / 32;
constexpr int BM = 32, BN = 32;  // the output tile of a block
constexpr int NSTAGE = 4;
constexpr int ROW_BYTES = 256;  // a stage's x row: 16 chunks of 16 bytes
constexpr int XCH = ROW_BYTES / 16;
constexpr int RED_LD = BN + 8;  // floats a row of a warp's partial tile

template <typename T>
struct Tile {
  static constexpr int BK = ROW_BYTES / static_cast<int>(sizeof(T));  // k a stage: 128, 64
  static constexpr int WCH = BK / 16;  // 16-byte chunks of a stage's weight row: 8, 4
  static constexpr int X_BYTES = BM * ROW_BYTES;
  static constexpr int STAGE = X_BYTES + BN * BK;
  static constexpr int SMEM = NSTAGE * STAGE;  // 48 KB (bf16), 40 KB (fp32)
};
static_assert(Tile<__nv_bfloat16>::SMEM <= 48 * 1024, "the ring needs no opt-in");
static_assert(NWARPS * BM * RED_LD * 4 <= Tile<__nv_bfloat16>::SMEM,
              "the warps' partial tiles fit in the ring");

struct Params {
  const void* x;
  int64_t ldx;  // elements between x's rows
  const int8_t* w;
  const float* scale;
  void* out;
  int M, N, K;
};

// physical chunk of chunk c of row r: x rows (16 chunks) and weight rows
// (WCH chunks)
__device__ __forceinline__ int x_chunk(int r, int c) { return c ^ ((r & 1) << 2); }
template <int WCH>
__device__ __forceinline__ int w_chunk(int r, int c) {
  return c ^ (((r & 3) << 1) & (WCH - 1));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// stage k0 .. k0 + BK of x's rows m0.. and the weight's rows n0.. into `st`
template <typename T>
__device__ __forceinline__ void load_stage(const Params& p, unsigned char* st, int m0,
                                           int n0, int k0) {
  using TL = Tile<T>;
  constexpr int EX = 16 / static_cast<int>(sizeof(T));  // x elements a chunk
  const T* x = static_cast<const T*>(p.x);
  static_assert(BM * XCH % NT == 0 && BN * TL::WCH % NT == 0, "whole copies a thread");
#pragma unroll
  for (int i = 0; i < BM * XCH / NT; ++i) {
    const int id = threadIdx.x + i * NT;
    const int r = id / XCH, c = id % XCH;
    const int m = m0 + r, k = k0 + c * EX;
    const bool ok = m < p.M && k < p.K;
    cp_async16(st + r * ROW_BYTES + x_chunk(r, c) * 16,
               ok ? x + static_cast<int64_t>(m) * p.ldx + k : x, ok);
  }
  unsigned char* ws = st + TL::X_BYTES;
#pragma unroll
  for (int i = 0; i < BN * TL::WCH / NT; ++i) {
    const int id = threadIdx.x + i * NT;
    const int r = id / TL::WCH, c = id % TL::WCH;
    const int n = n0 + r, k = k0 + c * 16;
    const bool ok = n < p.N && k < p.K;
    cp_async16(ws + r * TL::BK + w_chunk<TL::WCH>(r, c) * 16,
               ok ? p.w + static_cast<int64_t>(n) * p.K + k : p.w, ok);
  }
}

// 4 int8 values → two bf16 pairs (bytes 0, 1 and 2, 3; the lower k in the
// low half): b ^ 0x80 = b + 128 as an unsigned byte u; the float with bits
// 0x4B0000uu is 2^23 + u exactly, so subtracting 2^23 + 128 gives b, whose
// low 16 bits are zero, so its high half is its bf16
__device__ __forceinline__ void int8x4_to_bf16x2(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  uint32_t f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __float_as_uint(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440u | i)) -
                           8388736.f);
  lo = __byte_perm(f[0], f[1], 0x7632u);
  hi = __byte_perm(f[2], f[3], 0x7632u);
}

__device__ __forceinline__ void mma16816(float* c, const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// bf16: this warp's 32 k of the stage into the whole tile. acc[(mi*4 + ni)*4
// + j] is fragment (mi, ni) of the 2 x 4 m16n8 fragments. Lane (g, t) reads
// k 8t .. 8t+7 of the warp's slice; in product h its k slots 2t, 2t+1 hold
// k 8t + 4h + 0, 1 and slots 2t+8, 2t+9 hold 8t + 4h + 2, 3, in A and in B.
__device__ __forceinline__ void mma_stage(float (&acc)[32], const unsigned char* st) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  uint32_t a[2][2][4];  // [mi][row g, g + 8][word]
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = mi * 16 + hh * 8 + g;
      const uint4 v = *reinterpret_cast<const uint4*>(st + r * ROW_BYTES +
                                                      x_chunk(r, 4 * warp + t) * 16);
      a[mi][hh][0] = v.x;
      a[mi][hh][1] = v.y;
      a[mi][hh][2] = v.z;
      a[mi][hh][3] = v.w;
    }
  const unsigned char* ws = st + Tile<__nv_bfloat16>::X_BYTES;
  constexpr int WB = Tile<__nv_bfloat16>::BK;
  uint32_t b[4][4];  // [ni][2h + slot half]
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int r = ni * 8 + g;
    const uint2 v = *reinterpret_cast<const uint2*>(
        ws + r * WB + w_chunk<WB / 16>(r, 2 * warp + (t >> 1)) * 16 + (t & 1) * 8);
    int8x4_to_bf16x2(v.x, b[ni][0], b[ni][1]);
    int8x4_to_bf16x2(v.y, b[ni][2], b[ni][3]);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const uint32_t af[4] = {a[mi][0][2 * h], a[mi][1][2 * h], a[mi][0][2 * h + 1],
                              a[mi][1][2 * h + 1]};
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        mma16816(&acc[(mi * 4 + ni) * 4], af, b[ni][2 * h], b[ni][2 * h + 1]);
    }
}

// fp32: the stage's 64 k in order into rows ty, ty + 16 and columns tx + 8j
// (acc[i * 4 + j])
__device__ __forceinline__ void fma_stage(float (&acc)[8], const unsigned char* st) {
  const int ty = threadIdx.x >> 3, tx = threadIdx.x & 7;
  const unsigned char* ws = st + Tile<float>::X_BYTES;
  constexpr int WB = Tile<float>::BK;
#pragma unroll 4
  for (int c = 0; c < XCH; ++c) {  // 4 k a chunk
    float xr[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = ty + 16 * i;
      const float4 v =
          *reinterpret_cast<const float4*>(st + r * ROW_BYTES + x_chunk(r, c) * 16);
      xr[i][0] = v.x;
      xr[i][1] = v.y;
      xr[i][2] = v.z;
      xr[i][3] = v.w;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = tx + 8 * j;
      const uint32_t wv = *reinterpret_cast<const uint32_t*>(
          ws + n * WB + w_chunk<WB / 16>(n, c >> 2) * 16 + (c & 3) * 4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float wf = static_cast<float>(static_cast<int>(wv << (24 - 8 * e)) >> 24);
#pragma unroll
        for (int i = 0; i < 2; ++i) acc[i * 4 + j] = fmaf(xr[i][e], wf, acc[i * 4 + j]);
      }
    }
  }
}

__device__ __forceinline__ __nv_bfloat16 finish(float sum, float scale, __nv_bfloat16*) {
  return __float2bfloat16_rn(__fmul_rn(__bfloat162float(__float2bfloat16_rn(sum)), scale));
}
__device__ __forceinline__ float finish(float sum, float scale, float*) {
  return __fmul_rn(sum, scale);
}

// bf16 columns n .. n + 7 of row m
__device__ __forceinline__ void store8(const Params& p, int m, int n, const float (&v)[8]) {
  if (m >= p.M) return;
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(p.out) + static_cast<int64_t>(m) * p.N + n;
  __nv_bfloat16 r[8];
#pragma unroll
  for (int j = 0; j < 8; ++j)
    r[j] = finish(v[j], n + j < p.N ? __ldg(p.scale + n + j) : 0.f, o);
  if (p.N % 8 == 0 && n + 8 <= p.N) {  // 16-byte aligned
    uint32_t pk[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      pk[q] = static_cast<uint32_t>(__bfloat16_as_ushort(r[2 * q])) |
              (static_cast<uint32_t>(__bfloat16_as_ushort(r[2 * q + 1])) << 16);
    *reinterpret_cast<uint4*>(o) = make_uint4(pk[0], pk[1], pk[2], pk[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (n + j < p.N) o[j] = r[j];
  }
}

template <typename T>
__global__ void __launch_bounds__(NT) int8_linear_kernel(const Params p) {
  using TL = Tile<T>;
  constexpr bool BF16 = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tiles_n = (p.N + BN - 1) / BN;
  const int n0 = (blockIdx.x % tiles_n) * BN;
  const int m0 = (blockIdx.x / tiles_n) * BM;
  const int nk = (p.K + TL::BK - 1) / TL::BK;

  // stages 0 .. NSTAGE - 2 go out at once (a group each, empty past K);
  // then each step issues the stage NSTAGE - 1 ahead into the slot the
  // previous step read
#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < nk) load_stage<T>(p, smem + s * TL::STAGE, m0, n0, s * TL::BK);
    cp_async_commit();
  }
  float acc[BF16 ? 32 : 8];
#pragma unroll
  for (int i = 0; i < (BF16 ? 32 : 8); ++i) acc[i] = 0.f;
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<NSTAGE - 2>();  // this thread's copies of stage kt have landed
    __syncthreads();              // every thread's, and stage kt - 1 is read
    const int next = kt + NSTAGE - 1;
    if (next < nk)
      load_stage<T>(p, smem + (next % NSTAGE) * TL::STAGE, m0, n0, next * TL::BK);
    cp_async_commit();
    const unsigned char* st = smem + (kt % NSTAGE) * TL::STAGE;
    if constexpr (BF16)
      mma_stage(acc, st);
    else
      fma_stage(acc, st);
  }

  if constexpr (BF16) {
    // the warps' partial tiles, (NWARPS, BM, RED_LD) floats over the ring,
    // summed in warp order
    cp_async_wait<0>();
    __syncthreads();
    float* red = reinterpret_cast<float*>(smem);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const float* c = &acc[(mi * 4 + ni) * 4];
        float* d = red + (warp * BM + mi * 16 + g) * RED_LD + ni * 8 + 2 * t;
        *reinterpret_cast<float2*>(d) = make_float2(c[0], c[1]);
        *reinterpret_cast<float2*>(d + 8 * RED_LD) = make_float2(c[2], c[3]);
      }
    __syncthreads();
    const int r = threadIdx.x >> 2, c0 = (threadIdx.x & 3) * 8;
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      v[j] = red[r * RED_LD + c0 + j];
#pragma unroll
      for (int w = 1; w < NWARPS; ++w)
        v[j] = __fadd_rn(v[j], red[(w * BM + r) * RED_LD + c0 + j]);
    }
    store8(p, m0 + r, n0 + c0, v);
  } else {
    const int ty = threadIdx.x >> 3, tx = threadIdx.x & 7;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = m0 + ty + 16 * i;
      if (m >= p.M) continue;
      T* o = static_cast<T*>(p.out) + static_cast<int64_t>(m) * p.N;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + tx + 8 * j;
        if (n < p.N) o[n] = finish(acc[i * 4 + j], __ldg(p.scale + n), o);
      }
    }
  }
}

template <typename T>
cudaError_t launch(const Params& p, int blocks, cudaStream_t stream) {
  int8_linear_kernel<T><<<blocks, NT, Tile<T>::SMEM, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int int8_linear_launch(const void* x, int64_t ldx, const void* w,
                                  const float* scale, void* out, int M, int N, int K,
                                  int x_dtype, void* stream) {
  const int64_t blocks =
      static_cast<int64_t>((N + BN - 1) / BN) * static_cast<int64_t>((M + BM - 1) / BM);
  if (M < 1 || N < 1 || K < INT8_LINEAR_K_MULTIPLE || K % INT8_LINEAR_K_MULTIPLE != 0 ||
      blocks > INT_MAX || (x_dtype != 0 && x_dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{x, ldx, static_cast<const int8_t*>(w), scale, out, M, N, K};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nb = static_cast<int>(blocks);
  return static_cast<int>(x_dtype == 1 ? launch<__nv_bfloat16>(p, nb, st)
                                       : launch<float>(p, nb, st));
}
