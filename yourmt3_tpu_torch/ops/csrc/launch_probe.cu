// Launch-overhead probe, Hopper (sm_90a).
//
// Replaces the TPU kernel of scripts/bench_kernels.py `tiny` (body
// `tiny_kernel`): out = x + 1 on an (8, 128) fp32 tile. It does no work
// worth the name (4 KB read, 4 KB written: about 2.4 ns at 3.35 TB/s), so
// its time per launch is what a launch itself costs: issued eagerly from
// Python through ctypes, or replayed inside a CUDA graph.
//
// Design: one CTA, one thread per element (up to 1024 elements).

#include <cuda_runtime.h>

namespace {

__global__ void launch_probe_kernel(const float* __restrict__ x,
                                    float* __restrict__ out, int n) {
  const int i = threadIdx.x;
  if (i < n) out[i] = x[i] + 1.0f;
}

}  // namespace

// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// for n outside [1, 1024].
extern "C" int launch_probe_launch(const void* x, void* out, int n,
                                   void* stream) {
  if (n < 1 || n > 1024) return static_cast<int>(cudaErrorInvalidValue);
  launch_probe_kernel<<<1, n, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
