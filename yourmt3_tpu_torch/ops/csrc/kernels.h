// The C interface of the port's CUDA kernels: one launch function per
// kernel, defined in <name>.cu, and the limits of the kernels' instances.
// The kernels and the PyTorch binding (torch_ops.cpp) both include this
// file; it includes no torch header. Each launch function returns
// cudaGetLastError() after its launches, or cudaErrorInvalidValue for
// arguments that have no instance.

#pragma once

#include <stdint.h>

// The operators check these with Python's error types before launching.
constexpr int PAGED_MAX_BLOCK = 256;    // rows per page
constexpr int PAGED_MAX_BUCKETS = 256;  // T5 bias table rows, held in shared memory
constexpr int INT4_MAX_T = 4096;        // encoder frames, walked in chunks of 256 columns
constexpr int LOGMEL_MIN_NFFT = 256;    // FFT sizes: powers of two in [MIN, MAX]
constexpr int LOGMEL_MAX_NFFT = 4096;
constexpr int LOGMEL_MAX_TILE = 64;     // frames per CTA: even, in [2, MAX]
constexpr int LOGMEL_MAX_MELS = 512;    // mel columns: their bands stay in registers
constexpr int INT8_DECODE_MAX_ROWS = 1024;  // rows a call reads: their logits stay in shared memory
constexpr int INT8_DECODE_MAX_M = 8;        // query rows per KV head

extern "C" {

// Rows per split-KV range for a cache of `length` rows: a function of the
// cache length alone, so the split is the same at every batch size and
// every position (paged_decode_attention.cu).
int paged_decode_split_rows(int length);

// dtype codes: 0 = fp32, 1 = bf16, 2 = int8 (pages only). Pointers that a
// mode does not use are null. The position is *pos_dev, read on the
// device, where pos_dev is not null, else pos (in [0, NB*block)). The
// cache's rows [0, NB*block) are cut into nsplit ranges of split_rows;
// ranges past the position are empty. With nsplit > 1, `work` holds
// S*H*nsplit*(2 + dk) floats.
int paged_decode_attention_launch(
    const void* q, const void* k, const void* v, const float* ks,
    const float* vs, const float* rel_table, const int32_t* dist_buckets,
    int n_dist, int num_buckets, const float* bias_row, void* out,
    float* work, int S, int H, int NB, int block, int dk, const int64_t* pos_dev,
    int pos, int split_rows, int nsplit, int q_dtype, int kv_dtype, void* stream);

// q_dtype: 0 = fp32, 1 = bf16.
int int4_cross_attention_launch(const void* q, const void* k4, const void* ks,
                                const void* v4, const void* vs, void* out,
                                int S, int H, int dk, int T, int q_dtype,
                                void* stream);

// q (S, H, M, dk) fp32 (q_dtype 0) or bf16 (1); k, v (S, H, L, dk) int8;
// ks, vs (S, H, L); bias (1, H, M, n) with the given strides, or null. The
// rows read are [0, min(pos + 1, n)) with the position *pos_dev, read on
// the device, where pos_dev is not null, else pos where pos >= 0; all n
// rows where pos < 0.
int int8_decode_attention_launch(const void* q, const void* k, const float* ks,
                                 const void* v, const float* vs, const float* bias,
                                 int64_t bias_h, int64_t bias_m, int64_t bias_j,
                                 void* out, int S, int H, int M, int L, int dk, int n,
                                 const int64_t* pos_dev, int pos, int q_dtype,
                                 void* stream);

// window, twiddles, bands and weights in the layout of
// ops/fused_logmel.py:pack_bases; frames_per_cta even, in [2,
// LOGMEL_MAX_TILE].
int fused_logmel_launch(const void* padded, const void* window,
                        const void* twiddles, const void* bands,
                        const void* weights, void* out, int B, int Lp, int T,
                        int n_fft, int hop, int M, int nnz, float log_offset,
                        int power2, int frames_per_cta, void* stream);

// n in [1, 1024].
int launch_probe_launch(const void* x, void* out, int n, void* stream);

}  // extern "C"
