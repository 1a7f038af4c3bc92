// Fused log-mel spectrogram, Hopper (sm_90a).
//
// Replaces the TPU kernel yourmt3_tpu/ops/pallas/frontend_kernel.py
// `fused_logmel` (body `_kernel`): framing -> DFT as two GEMMs against the
// window-folded cos/sin bases -> magnitude -> mel GEMM -> log, with the
// (B, T, n_fft) frames and the (B, T, n_bins) spectra never written to
// device memory.
//
//   frame t      = padded[t*hop : t*hop + n_fft]   (reflect-padded row)
//   re, im       = frame @ cos, frame @ sin        (fp32 accumulation)
//   mag          = sqrt(re^2 + im^2 + 1e-12)        (squared if power == 2)
//   acc          = mag @ mel                        (fp32, on chip)
//   out          = log(max(acc, log_offset))
//
// Layouts (prepared once by the wrapper, ops/fused_logmel.py):
//   padded (B, Lp)            fp32, audio reflect-padded by n_fft/2
//   cs     (n_fft, 2, Fp)     fp32: per sample, the Fp cos values, then
//                             the Fp sin values; bins padded with zero
//                             columns to Fp, a multiple of FT = 128
//   mel    (Fp, M)            fp32, zero rows past n_bins
//   out    (B, T, M)          fp32
//
// Bound on an H100 SXM: the work is operations. One 32767-sample segment
// at the default config (T = 256, n_fft = 2048, 1025 bins, 512 mels) is
// 2*2*256*2048*1025 + 2*256*1025*512 = 2.42 GFLOP of fp32 multiply-adds
// (38.7 GFLOP at the training batch of 16: 0.58 ms at the 67 TFLOP/s of
// fp32 outside the tensor cores), against about 24 MB of bytes (19 MB of
// them the bases and the filterbank, read once), 7 us at 3.35 TB/s.
//
// Design (plain fp32 FMA first; tensor cores via TF32 or a split-bf16
// product, and a persistent schedule, are later work):
//   * one CTA of 256 threads per (segment, tile of TT = 8*FPT frames);
//     the wrapper picks the largest FPT in {4, 2, 1} whose grid covers the
//     card's SMs (B = 16 -> FPT = 2, 256 CTAs; B = 8 -> FPT = 1, 256 CTAs;
//     on an H100 SXM each is the fastest of the three at its batch);
//   * the CTA copies its frames' span of the padded row, (TT-1)*hop +
//     n_fft samples, into shared memory once: frames are read from it in
//     place, never materialised; samples past the row read as 0, so a
//     last tile that runs past T is harmless and is not stored;
//   * the bases stream through shared memory in chunks of KB = 32 samples
//     x 128 bins (cos and sin, 32 KB), double-buffered with cp.async, so
//     each CTA reads each basis row from L2 once for its 8 warps (with
//     per-warp __ldg of the bases the first version of this kernel took
//     6.2 ms at B = 16 on an H100 SXM, see PERF.md); a
//     staged row holds the tile's 128 cos values, then its 128 sin values,
//     so each warp's 16-byte loads cover 512 contiguous bytes (no bank
//     conflicts);
//   * warp w owns frames w*FPT .. w*FPT+FPT-1, lane l owns bins 4l..4l+3 of
//     each 128-bin tile: per sample n, two 16-byte shared-memory basis
//     loads feed 8*FPT FMAs, the frame value is a shared-memory broadcast;
//   * the DFT sums are taken in two levels, partial sums over a chunk
//     added to the totals: a plain running fp32 sum over 2048 samples next
//     to a loud tone drifts by up to ~1e-3 in log-mel from the exact
//     value; two levels cut that ~4x (the plain version sums the same way);
//   * the tile's magnitudes go to shared memory, then each lane adds
//     mag @ mel for mel columns l, l+32, ... into FPT*(M/32) registers,
//     so the mel accumulator stays on chip across all frequency tiles;
//   * the epilogue takes the log and writes each output once.
// Built without --use_fast_math: sqrtf and logf are the accurate ones.

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;     // 8 warps: one frame group each
constexpr int FT = 128;     // bins per frequency tile, 4 per lane
constexpr int MAX_MJ = 16;  // mel columns per lane: M <= 512
constexpr int KB = 32;      // samples per staged chunk and partial sum
constexpr int ROW4 = 2 * FT / 4;  // float4 per staged basis row: cos, sin

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows n0 .. n0+KB-1 of the bases for bins f0 .. f0+FT-1 → buf (KB x
// ROW4): per row, FT/4 float4 of cos, then FT/4 of sin
__device__ __forceinline__ void stage_bases(float4* buf, const float4* cs,
                                            int n0, int f0, int Fp) {
  const size_t row = static_cast<size_t>(Fp) / 2;  // float4 per sample
  for (int i = threadIdx.x; i < KB * ROW4; i += NT) {
    const int r = i / ROW4, j = i % ROW4;
    const int half = j / (FT / 4);  // 0: cos, 1: sin
    cp_async16(buf + i, cs + (n0 + r) * row + half * (Fp / 4) + f0 / 4
                            + j % (FT / 4));
  }
}

template <int FPT>
__global__ void __launch_bounds__(NT)
fused_logmel_kernel(const float* __restrict__ padded,
                    const float4* __restrict__ cs,
                    const float* __restrict__ mel, float* __restrict__ out,
                    int Lp, int T, int n_fft, int hop, int Fp, int M,
                    float log_offset, int power2) {
  constexpr int TT = 8 * FPT;
  extern __shared__ float smem[];
  const int span = (TT - 1) * hop + n_fft;
  float* frames = smem;
  float* mag = smem + ((span + 3) & ~3);  // 16-byte aligned, TT x FT
  float4* sbuf = reinterpret_cast<float4*>(mag + TT * FT);  // 2 x KB x ROW4

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TT;
  const int lane = threadIdx.x & 31;
  const int grp = threadIdx.x >> 5;
  const int mj = M / 32;

  const float* row = padded + static_cast<size_t>(b) * Lp;
  const int base = t0 * hop;
  for (int i = threadIdx.x; i < span; i += NT) {
    const int idx = base + i;
    frames[i] = idx < Lp ? row[idx] : 0.f;
  }

  float acc[FPT][MAX_MJ];
#pragma unroll
  for (int i = 0; i < FPT; ++i)
#pragma unroll
    for (int j = 0; j < MAX_MJ; ++j) acc[i][j] = 0.f;
  __syncthreads();

  const float* fr = frames + grp * FPT * hop;
  for (int f0 = 0; f0 < Fp; f0 += FT) {
    float re[FPT][4], im[FPT][4];
#pragma unroll
    for (int i = 0; i < FPT; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) re[i][q] = im[i][q] = 0.f;

    const int chunks = n_fft / KB;
    stage_bases(sbuf, cs, 0, f0, Fp);
    cp_async_commit();
    for (int ch = 0; ch < chunks; ++ch) {
      if (ch + 1 < chunks) {  // prefetch the next chunk into the other buffer
        stage_bases(sbuf + ((ch + 1) & 1) * KB * ROW4, cs, (ch + 1) * KB, f0,
                    Fp);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const float4* bases = sbuf + (ch & 1) * KB * ROW4 + lane;
      const float* frn = fr + ch * KB;
      // partial sums over the chunk, added to the totals after it
      float pr[FPT][4], pi[FPT][4];
#pragma unroll
      for (int i = 0; i < FPT; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) pr[i][q] = pi[i][q] = 0.f;
#pragma unroll 8
      for (int r = 0; r < KB; ++r) {
        const float4 c = bases[r * ROW4];
        const float4 s = bases[r * ROW4 + FT / 4];
#pragma unroll
        for (int i = 0; i < FPT; ++i) {
          const float x = frn[i * hop + r];
          pr[i][0] = fmaf(x, c.x, pr[i][0]);
          pr[i][1] = fmaf(x, c.y, pr[i][1]);
          pr[i][2] = fmaf(x, c.z, pr[i][2]);
          pr[i][3] = fmaf(x, c.w, pr[i][3]);
          pi[i][0] = fmaf(x, s.x, pi[i][0]);
          pi[i][1] = fmaf(x, s.y, pi[i][1]);
          pi[i][2] = fmaf(x, s.z, pi[i][2]);
          pi[i][3] = fmaf(x, s.w, pi[i][3]);
        }
      }
#pragma unroll
      for (int i = 0; i < FPT; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          re[i][q] += pr[i][q];
          im[i][q] += pi[i][q];
        }
      __syncthreads();  // this buffer is restaged for chunk ch + 2
    }

#pragma unroll
    for (int i = 0; i < FPT; ++i) {
      float m[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        m[q] = sqrtf(re[i][q] * re[i][q] + im[i][q] * im[i][q] + 1e-12f);
        if (power2) m[q] *= m[q];
      }
      *reinterpret_cast<float4*>(mag + (grp * FPT + i) * FT + lane * 4) =
          make_float4(m[0], m[1], m[2], m[3]);
    }
    __syncthreads();

    const float* mg = mag + grp * FPT * FT;
    const float* melp = mel + static_cast<size_t>(f0) * M + lane;
#pragma unroll 2
    for (int f = 0; f < FT; ++f) {
      float mv[FPT];
#pragma unroll
      for (int i = 0; i < FPT; ++i) mv[i] = mg[i * FT + f];
      const float* w = melp + static_cast<size_t>(f) * M;
#pragma unroll
      for (int j = 0; j < MAX_MJ; ++j) {
        if (j < mj) {
          const float wj = __ldg(w + 32 * j);
#pragma unroll
          for (int i = 0; i < FPT; ++i) acc[i][j] = fmaf(mv[i], wj, acc[i][j]);
        }
      }
    }
    __syncthreads();  // mag is rewritten by the next tile
  }

#pragma unroll
  for (int i = 0; i < FPT; ++i) {
    const int t = t0 + grp * FPT + i;
    if (t < T) {
      float* o = out + (static_cast<size_t>(b) * T + t) * M + lane;
#pragma unroll
      for (int j = 0; j < MAX_MJ; ++j)
        if (j < mj) o[32 * j] = logf(fmaxf(acc[i][j], log_offset));
    }
  }
}

template <int FPT>
cudaError_t launch(const float* padded, const float4* cs, const float* mel,
                   float* out, int B, int Lp, int T, int n_fft, int hop,
                   int Fp, int M, float log_offset, int power2,
                   cudaStream_t stream) {
  constexpr int TT = 8 * FPT;
  const int span = (TT - 1) * hop + n_fft;
  const size_t smem = (static_cast<size_t>((span + 3) & ~3) + TT * FT) * sizeof(float)
                      + 2 * KB * ROW4 * sizeof(float4);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fused_logmel_kernel<FPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  dim3 grid((T + TT - 1) / TT, B);
  fused_logmel_kernel<FPT><<<grid, NT, smem, stream>>>(
      padded, cs, mel, out, Lp, T, n_fft, hop, Fp, M, log_offset, power2);
  return cudaGetLastError();
}

}  // namespace

// frames_per_thread (FPT) in {1, 2, 4}; n_fft a multiple of 32; Fp a
// multiple of 128; M a multiple of 32 and at most 512. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for arguments that have no instance.
extern "C" int fused_logmel_launch(const void* padded, const void* cs,
                                   const void* mel, void* out, int B, int Lp,
                                   int T, int n_fft, int hop, int Fp, int M,
                                   float log_offset, int power2,
                                   int frames_per_thread, void* stream) {
  if (B < 1 || T < 1 || n_fft < KB || n_fft % KB || hop < 1 || Fp < FT || Fp % FT ||
      M < 32 || M % 32 || M > 32 * MAX_MJ)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* p = static_cast<const float*>(padded);
  const float4* c = static_cast<const float4*>(cs);
  const float* m = static_cast<const float*>(mel);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (frames_per_thread) {
    case 1: return launch<1>(p, c, m, o, B, Lp, T, n_fft, hop, Fp, M, log_offset, power2, st);
    case 2: return launch<2>(p, c, m, o, B, Lp, T, n_fft, hop, Fp, M, log_offset, power2, st);
    case 4: return launch<4>(p, c, m, o, B, Lp, T, n_fft, hop, Fp, M, log_offset, power2, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
