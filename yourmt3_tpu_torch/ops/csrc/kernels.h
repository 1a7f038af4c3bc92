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
constexpr int INT4_MAX_T = 4096;        // encoder frames: the logits row is in shared memory
constexpr int LOGMEL_DFT_BLOCK = 32;    // samples per partial DFT sum; n_fft is a multiple
constexpr int LOGMEL_FREQ_TILE = 128;   // bins per frequency tile; Fp is a multiple
constexpr int LOGMEL_MAX_MELS = 512;    // mel columns, a multiple of 32

extern "C" {

// Rows per split-KV range for `rows` live rows of S*H (stream, head)
// pairs on a card of `sms` SMs (paged_decode_attention.cu).
int paged_decode_split_rows(int S, int H, int rows, int sms);

// dtype codes: 0 = fp32, 1 = bf16, 2 = int8 (pages only). Pointers that a
// mode does not use are null. The live rows [0, pos] are cut into nsplit
// ranges of split_rows; with nsplit > 1, `work` holds S*H*nsplit*(2 + dk)
// floats.
int paged_decode_attention_launch(
    const void* q, const void* k, const void* v, const float* ks,
    const float* vs, const float* rel_table, const int32_t* dist_buckets,
    int n_dist, int num_buckets, const float* bias_row, void* out,
    float* work, int S, int H, int NB, int block, int dk, int pos,
    int split_rows, int nsplit, int q_dtype, int kv_dtype, void* stream);

// q_dtype: 0 = fp32, 1 = bf16.
int int4_cross_attention_launch(const void* q, const void* k4, const void* ks,
                                const void* v4, const void* vs, void* out,
                                int S, int H, int dk, int T, int q_dtype,
                                void* stream);

// frames_per_thread in {1, 2, 4}; the bases in the layout of
// ops/fused_logmel.py:pack_bases.
int fused_logmel_launch(const void* padded, const void* cs, const void* mel,
                        void* out, int B, int Lp, int T, int n_fft, int hop,
                        int Fp, int M, float log_offset, int power2,
                        int frames_per_thread, void* stream);

// n in [1, 1024].
int launch_probe_launch(const void* x, void* out, int n, void* stream);

}  // extern "C"
