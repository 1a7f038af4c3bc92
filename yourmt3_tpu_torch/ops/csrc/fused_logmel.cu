// Fused log-mel spectrogram as a shared-memory FFT, Hopper (sm_90a).
//
// Replaces the TPU kernel yourmt3_tpu/ops/pallas/frontend_kernel.py
// `fused_logmel` (body `_kernel`), which computes, with the window folded
// into the DFT bases,
//
//   frame t  = padded[t*hop : t*hop + n_fft]   (reflect-padded row)
//   X_t      = DFT(window * frame t), bins 0 .. n_fft/2
//   mag      = sqrt(|X_t|^2 + 1e-12)           (squared if power == 2)
//   out      = log(max(mag @ mel, log_offset))
//
// as two GEMMs against the bases, because the TPU's matrix unit makes
// that the fast way there. On the H100 the same function is an FFT: about
// 5*N*log2(N)/2 fp32 operations per frame instead of 4*N*(N/2+1), 150x
// less arithmetic at N = 2048, and the triangular filterbank is summed
// over its nonzero bands only (each bin feeds at most 2 of the mels).
//
// Layouts (the constants packed once by ops/fused_logmel.py:pack_bases,
// the audio padded by the operator, csrc/torch_ops.cpp):
//   padded   (B, Lp)       fp32, audio reflect-padded by n_fft/2
//   window   (N,)          fp32, the bases' zero-frequency column
//   twiddles (N - R0, 2)   fp32 (re, im), computed in float64 on the host:
//                          for the radix-8 pass of Ns, entry (Ns - R0) +
//                          (r-1)*Ns + q is exp(-2 pi i r q / (8 Ns))
//   bands    (M, 3)        int32 per mel column: first nonzero bin lo, one
//                          past the last hi, offset of its weights
//   weights  (nnz,)        fp32, column m's rows lo .. hi-1
//   out      (B, T, M)     fp32
//
// Bound on an H100 SXM: at the default config (T = 256, N = 2048, 1025
// bins, 512 mels) and the training batch of 16, the FFTs are 128 complex
// transforms per segment of 5*N*log2(N) = 113 kFLOP, 0.23 GFLOP in all
// (3.4 us at the 67 TFLOP/s of fp32 outside the tensor cores; the split,
// the magnitudes and the ~2000 band weights per frame add a few per cent),
// against 2.1 MB of audio in and 8.4 MB of log-mel out (3.1 us at 3.35
// TB/s). The kernel's own limit is shared memory: each radix-8 pass reads
// and writes every point once.
//
// Design:
//   * one CTA of N/8 threads per (segment, tile of TT frames, TT even);
//     the wrapper picks TT (ops/fused_logmel.py:frames_per_cta);
//   * the CTA copies its frames' span of the padded row, (TT-1)*hop + N
//     samples, into shared memory once, the twiddle table and the mel
//     weights beside it; samples past the row read as 0, so a frame past T
//     is harmless and is not stored;
//   * frames 2p and 2p+1 of the tile, windowed as they are read from the
//     span, are the real and imaginary parts of one complex N-point FFT;
//   * Stockham (autosort) schedule: a first pass of radix R0 in {2, 4, 8}
//     (log2 N mod 3), then radix-8 passes; each thread holds 8 points in
//     registers per pass (the DFT of 8 by radix-2 stages whose only
//     constant is sqrt(1/2)), multiplies by the table's twiddles, and the
//     passes exchange through two shared buffers of N points in turn.
//     Point i is stored at swz(i), i with its low four bits XORed by bits
//     4-6, so the strided writes of the first two passes at N = 2048 and
//     the consecutive reads of every pass touch each bank once a wavefront;
//   * split: X_2p[k] = (Z[k] + conj Z[N-k]) / 2, X_2p+1[k] = (Z[k] -
//     conj Z[N-k]) / 2i; both frames' magnitudes go to the buffer the last
//     pass read from;
//   * each thread then takes (frame, mel) outputs o, o + N/8, ... of the
//     pair, sums its band of magnitudes times the band's weights, takes
//     the log and writes it: a pair's 2*M outputs are one contiguous run.
//     These are the same mel columns for every pair, so a thread loads
//     its columns' bands into registers once: read from global memory per
//     output, the bands made the mel product the kernel's slowest stage
//     on an H100 SXM (PERF.md).
// Built without --use_fast_math: sqrtf and logf are the accurate ones,
// and no twiddle comes from __sinf/__cosf.

#include <cuda_runtime.h>
#include <stdint.h>

#include "kernels.h"

namespace {

constexpr float SQRT_HALF = 0.70710678118654752f;

__device__ __forceinline__ int swz(int i) {
  return i ^ (((i >> 3) & 12) | ((i >> 4) & 3));
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// natural-order DFT of R in {2, 4, 8} points, radix-2 decimation in
// frequency (the plain version's _dft)
template <int R>
__device__ __forceinline__ void dft(float2* v) {
  if constexpr (R == 8) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 a = v[i], b = v[i + 4];
      v[i] = make_float2(a.x + b.x, a.y + b.y);
      const float2 d = make_float2(a.x - b.x, a.y - b.y);
      if (i == 0) v[4] = d;
      else if (i == 1) v[5] = make_float2(SQRT_HALF * (d.x + d.y), SQRT_HALF * (d.y - d.x));
      else if (i == 2) v[6] = make_float2(d.y, -d.x);
      else v[7] = make_float2(SQRT_HALF * (d.y - d.x), -SQRT_HALF * (d.x + d.y));
    }
  }
  if constexpr (R >= 4) {
#pragma unroll
    for (int s = 0; s < R; s += 4) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float2 a = v[s + i], b = v[s + i + 2];
        v[s + i] = make_float2(a.x + b.x, a.y + b.y);
        v[s + i + 2] = i == 0 ? make_float2(a.x - b.x, a.y - b.y)
                              : make_float2(a.y - b.y, b.x - a.x);
      }
    }
  }
#pragma unroll
  for (int s = 0; s < R; s += 2) {
    const float2 a = v[s], b = v[s + 1];
    v[s] = make_float2(a.x + b.x, a.y + b.y);
    v[s + 1] = make_float2(a.x - b.x, a.y - b.y);
  }
  // bit-reversed → natural order
  if constexpr (R == 8) {
    float2 t = v[1]; v[1] = v[4]; v[4] = t;
    t = v[3]; v[3] = v[6]; v[6] = t;
  } else if constexpr (R == 4) {
    const float2 t = v[1]; v[1] = v[2]; v[2] = t;
  }
}

template <int LOG2N>
struct Fft {
  static constexpr int N = 1 << LOG2N;
  static constexpr int NT = N / 8;  // threads per CTA, 8 points each
  static constexpr int R0 = 1 << (LOG2N % 3 == 0 ? 3 : LOG2N % 3);
};



template <int LOG2N>
__global__ void __launch_bounds__(Fft<LOG2N>::NT)
fused_logmel_kernel(const float* __restrict__ padded,
                    const float* __restrict__ window,
                    const float2* __restrict__ twiddles,
                    const int* __restrict__ bands,
                    const float* __restrict__ weights, float* __restrict__ out,
                    int Lp, int T, int hop, int M, int nnz, int TT, float log_offset,
                    int power2) {
  using F = Fft<LOG2N>;
  constexpr int N = F::N, NT = F::NT, R0 = F::R0, NB = N / 2 + 1;
  constexpr int MAX_OUT = (2 * LOGMEL_MAX_MELS + NT - 1) / NT;  // outputs per thread
  extern __shared__ float4 smem4[];
  float2* buf0 = reinterpret_cast<float2*>(smem4);
  float2* buf1 = buf0 + N;
  float2* tw = buf1 + N;              // N - R0 twiddles
  float* sweight = reinterpret_cast<float*>(tw + (N - R0 + 1) / 2 * 2);  // nnz
  float* span = sweight + ((nnz + 3) & ~3);

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TT;
  const int span_len = (TT - 1) * hop + N;
  const float* row = padded + static_cast<size_t>(b) * Lp;
  const int base = t0 * hop;
  for (int i = tid; i < span_len; i += NT) {
    const int idx = base + i;
    span[i] = idx < Lp ? row[idx] : 0.f;
  }
  for (int i = tid; i < N - R0; i += NT) tw[i] = twiddles[i];
  for (int i = tid; i < nnz; i += NT) sweight[i] = weights[i];
  // A thread takes outputs tid + j NT of every pair's 2M: the same mel
  // columns for each pair, so their bands stay in registers.
  int band_lo[MAX_OUT], band_width[MAX_OUT], band_off[MAX_OUT];
#pragma unroll
  for (int j = 0; j < MAX_OUT; ++j) {
    const int i = tid + j * NT;
    const int m = i % M;
    band_lo[j] = i < 2 * M ? __ldg(bands + 3 * m) + (i >= M ? NB : 0) : 0;
    band_width[j] = i < 2 * M ? __ldg(bands + 3 * m + 1) - __ldg(bands + 3 * m) : 0;
    band_off[j] = i < 2 * M ? __ldg(bands + 3 * m + 2) : 0;
  }
  float w[8];  // this thread's window values in the first pass
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    const int bf = tid + (s / R0) * NT;  // butterfly
    w[s] = __ldg(window + bf + (s % R0) * (N / R0));
  }
  __syncthreads();

  for (int p = 0; 2 * p < TT; ++p) {
    if (t0 + 2 * p >= T) break;  // the same for every thread of the CTA
    const float* f0 = span + 2 * p * hop;
    const float* f1 = f0 + hop;
    // pass 1: radix R0, Ns = 1 (no twiddles), 8/R0 butterflies per thread
#pragma unroll
    for (int g = 0; g < 8 / R0; ++g) {
      const int bf = tid + g * NT;
      float2 v[R0];
#pragma unroll
      for (int r = 0; r < R0; ++r) {
        const int n = bf + r * (N / R0);
        const float wn = w[g * R0 + r];
        v[r] = make_float2(wn * f0[n], wn * f1[n]);
      }
      dft<R0>(v);
#pragma unroll
      for (int r = 0; r < R0; ++r) buf0[swz(bf * R0 + r)] = v[r];
    }
    __syncthreads();
    // radix-8 passes, Ns = R0, 8 R0, ..., N/8
    float2* src = buf0;
    float2* dst = buf1;
#pragma unroll
    for (int ns = R0; ns < N; ns *= 8) {
      float2 v[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) v[r] = src[swz(tid + r * NT)];
      const int q = tid & (ns - 1);
      const float2* t = tw + (ns - R0) + q;
#pragma unroll
      for (int r = 1; r < 8; ++r) v[r] = cmul(v[r], t[(r - 1) * ns]);
      dft<8>(v);
      const int d = (tid - q) * 8 + q;
#pragma unroll
      for (int r = 0; r < 8; ++r) dst[swz(d + r * ns)] = v[r];
      __syncthreads();
      float2* x = src; src = dst; dst = x;
    }
    // split the pair's spectra; magnitudes into the free buffer
    float* mag = reinterpret_cast<float*>(dst);  // frame 2p: [0, NB), 2p+1: [NB, 2NB)
    for (int k = tid; k < NB; k += NT) {
      const float2 a = src[swz(k)];
      const float2 c = src[swz((N - k) & (N - 1))];
      const float er = (a.x + c.x) * 0.5f, ei = (a.y - c.y) * 0.5f;
      const float orr = (a.y + c.y) * 0.5f, oi = (a.x - c.x) * 0.5f;
      float m0 = sqrtf(er * er + ei * ei + 1e-12f);
      float m1 = sqrtf(orr * orr + oi * oi + 1e-12f);
      if (power2) { m0 *= m0; m1 *= m1; }
      mag[k] = m0;
      mag[NB + k] = m1;
    }
    __syncthreads();
    // band-sparse mel product and log; the pair's rows are contiguous
    const int t = t0 + 2 * p;
    const int live = min(2, T - t) * M;  // 2M, or M when frame 2p+1 is past T
    float* o = out + (static_cast<size_t>(b) * T + t) * M;
#pragma unroll
    for (int j = 0; j < MAX_OUT; ++j) {
      const int i = tid + j * NT;
      if (i < live) {
        const float* mg = mag + band_lo[j];  // frame 2p+1's bins follow 2p's
        const float* wt = sweight + band_off[j];
        float acc = 0.f;
#pragma unroll 4
        for (int k = 0; k < band_width[j]; ++k) acc = fmaf(mg[k], wt[k], acc);
        o[i] = logf(fmaxf(acc, log_offset));
      }
    }
    __syncthreads();  // the buffers are rewritten by the next pair
  }
}

template <int LOG2N>
cudaError_t launch(const float* padded, const float* window, const float2* tw,
                   const int* bands, const float* weights, float* out, int B,
                   int Lp, int T, int hop, int M, int nnz, int TT, float log_offset,
                   int power2, cudaStream_t stream) {
  using F = Fft<LOG2N>;
  const size_t smem = (2 * F::N + (F::N - F::R0 + 1) / 2 * 2) * sizeof(float2) +
                      static_cast<size_t>((nnz + 3) & ~3) * sizeof(float) +
                      static_cast<size_t>(((TT - 1) * hop + F::N + 3) & ~3) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_logmel_kernel<LOG2N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((T + TT - 1) / TT, B);
  fused_logmel_kernel<LOG2N><<<grid, F::NT, smem, stream>>>(
      padded, window, tw, bands, weights, out, Lp, T, hop, M, nnz, TT, log_offset, power2);
  return cudaGetLastError();
}

}  // namespace

extern "C" int fused_logmel_launch(const void* padded, const void* window,
                                   const void* twiddles, const void* bands,
                                   const void* weights, void* out, int B, int Lp,
                                   int T, int n_fft, int hop, int M, int nnz,
                                   float log_offset, int power2, int frames_per_cta,
                                   void* stream) {
  if (B < 1 || T < 1 || hop < 1 || M < 1 || M > LOGMEL_MAX_MELS || nnz < 0 ||
      frames_per_cta < 2 || frames_per_cta % 2 || frames_per_cta > LOGMEL_MAX_TILE)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* p = static_cast<const float*>(padded);
  const float* w = static_cast<const float*>(window);
  const float2* tw = static_cast<const float2*>(twiddles);
  const int* bd = static_cast<const int*>(bands);
  const float* wt = static_cast<const float*>(weights);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tt = frames_per_cta;
  switch (n_fft) {
    case 256: return launch<8>(p, w, tw, bd, wt, o, B, Lp, T, hop, M, nnz, tt, log_offset, power2, st);
    case 512: return launch<9>(p, w, tw, bd, wt, o, B, Lp, T, hop, M, nnz, tt, log_offset, power2, st);
    case 1024: return launch<10>(p, w, tw, bd, wt, o, B, Lp, T, hop, M, nnz, tt, log_offset, power2, st);
    case 2048: return launch<11>(p, w, tw, bd, wt, o, B, Lp, T, hop, M, nnz, tt, log_offset, power2, st);
    case 4096: return launch<12>(p, w, tw, bd, wt, o, B, Lp, T, hop, M, nnz, tt, log_offset, power2, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
