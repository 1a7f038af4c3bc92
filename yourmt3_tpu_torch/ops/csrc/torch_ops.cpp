// PyTorch operators for the port's hand-written CUDA kernels.
//
// This is the one translation unit of the build that includes torch
// headers: the kernels (*.cu) keep plain C launch functions, declared with
// their limits in kernels.h, so editing a kernel recompiles only its own
// file. Each operator checks its arguments here (ValueError and TypeError
// in Python, with the messages the Python checks had), allocates its
// output and scratch with at::empty, and launches on the current stream
// under a device guard. The operators are
// registered for CUDA only: the Python wrappers send CPU tensors to the
// plain versions, and nothing falls back from one to the other.
//
//   torch.ops.yourmt3_tpu_torch.paged_decode_attention   csrc/paged_decode_attention.cu
//   torch.ops.yourmt3_tpu_torch.paged_decode_splits      (its split choice)
//   torch.ops.yourmt3_tpu_torch.int4_cross_attention     csrc/int4_cross_attention.cu
//   torch.ops.yourmt3_tpu_torch.fused_logmel             csrc/fused_logmel.cu
//   torch.ops.yourmt3_tpu_torch.launch_probe             csrc/launch_probe.cu

#include <ATen/core/Tensor.h>
#include <ATen/ops/empty.h>
#include <ATen/ops/reflection_pad1d.h>
#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <torch/library.h>

#include <cstdint>
#include <initializer_list>
#include <vector>

#include "kernels.h"

namespace {

using at::Tensor;
using c10::ScalarType;
using OptTensor = c10::optional<Tensor>;

bool is_dk(int64_t dk) { return dk == 16 || dk == 32 || dk == 64 || dk == 128; }

// device, dtype, shape and layout, in the order the Python checks had
void check(const Tensor& t, const char* name, const Tensor& ref, const char* ref_name,
           std::initializer_list<ScalarType> dtypes,
           c10::optional<c10::IntArrayRef> shape = c10::nullopt) {
  TORCH_CHECK_VALUE(t.device() == ref.device(), name, " is on ", t.device(), ", ",
                    ref_name, " on ", ref.device());
  bool ok = false;
  for (ScalarType d : dtypes) ok = ok || t.scalar_type() == d;
  if (!ok) {
    std::string names;
    for (ScalarType d : dtypes) names += std::string(names.empty() ? "" : ", ") + c10::toString(d);
    TORCH_CHECK_TYPE(false, name, " has dtype ", t.scalar_type(), ", kernel takes (",
                     names, ")");
  }
  if (shape.has_value())
    TORCH_CHECK_VALUE(t.sizes() == *shape, name, " has shape ", t.sizes(),
                      ", expected ", *shape);
  TORCH_CHECK_VALUE(t.is_contiguous(), name, " must be contiguous");
}

int dtype_code(ScalarType t) {
  return t == ScalarType::Float ? 0 : t == ScalarType::BFloat16 ? 1 : 2;
}

int sm_count(c10::DeviceIndex dev) {
  static int counts[64] = {0};
  int& n = counts[dev];
  if (n == 0) C10_CUDA_CHECK(cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev));
  return n;
}

void check_launch(int err, const char* what) {
  TORCH_CHECK(err == 0, what, " launch failed: ",
              cudaGetErrorString(static_cast<cudaError_t>(err)), " (", err, ")");
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void* stream_of(const Tensor& t) {
  return c10::cuda::getCurrentCUDAStream(t.device().index()).stream();
}

const float* fptr(const OptTensor& t) {
  return t.has_value() ? t->data_ptr<float>() : nullptr;
}

// q (S, H, dk) or (S, H, 1, dk) → the 3-D view
Tensor as_3d(const Tensor& q) {
  if (q.dim() == 4) {
    TORCH_CHECK_VALUE(q.size(2) == 1, "q must be (S, H, 1, dk), got ", q.sizes());
    return q.select(2, 0);
  }
  TORCH_CHECK_VALUE(q.dim() == 3, "q must be (S, H, dk) or (S, H, 1, dk), got ",
                    q.sizes());
  return q;
}

// [nsplit, split_rows] for live rows [0, pos] of S*H pairs on card `dev`
std::vector<int64_t> splits_for(int64_t S, int64_t H, int64_t pos, c10::DeviceIndex dev) {
  const int64_t rows = pos + 1;
  const int64_t split_rows = paged_decode_split_rows(
      static_cast<int>(S), static_cast<int>(H), static_cast<int>(rows), sm_count(dev));
  return {(rows + split_rows - 1) / split_rows, split_rows};
}

Tensor paged_decode_attention(const Tensor& q, const Tensor& k_cache,
                              const Tensor& v_cache, int64_t pos,
                              const OptTensor& bias_row, const OptTensor& rel_table,
                              const OptTensor& dist_buckets, const OptTensor& k_scale,
                              const OptTensor& v_scale) {
  TORCH_CHECK_VALUE(!(bias_row.has_value() && rel_table.has_value()),
                    "bias_row and rel_table are mutually exclusive");
  TORCH_CHECK_VALUE(k_scale.has_value() == v_scale.has_value(),
                    "k_scale and v_scale come together");
  const Tensor q3 = as_3d(q);
  const int64_t S = q3.size(0), H = q3.size(1), dk = q3.size(2);
  TORCH_CHECK_VALUE(k_cache.dim() == 5, "k_cache must be (NB, S, H, block, dk), got ",
                    k_cache.sizes());
  const int64_t NB = k_cache.size(0), block = k_cache.size(3), L = NB * block;
  const std::vector<int64_t> page{NB, S, H, block, dk};
  check(q3, "q", q3, "q", {ScalarType::Float, ScalarType::BFloat16});
  check(k_cache, "k_cache", q3, "q",
        {ScalarType::Float, ScalarType::BFloat16, ScalarType::Char}, page);
  check(v_cache, "v_cache", q3, "q", {k_cache.scalar_type()}, page);
  const bool quantized = k_cache.scalar_type() == ScalarType::Char;
  TORCH_CHECK_VALUE(quantized == k_scale.has_value(),
                    "int8 pages need k_scale/v_scale; float pages take none");
  if (quantized) {
    const std::vector<int64_t> sc{S, NB, H, block};
    check(*k_scale, "k_scale", q3, "q", {ScalarType::Float}, sc);
    check(*v_scale, "v_scale", q3, "q", {ScalarType::Float}, sc);
  }
  TORCH_CHECK_VALUE(is_dk(dk), "dk=", dk, " not in (16, 32, 64, 128)");
  TORCH_CHECK_VALUE(1 <= block && block <= PAGED_MAX_BLOCK, "block=", block,
                    " must be in [1, ", PAGED_MAX_BLOCK, "]");
  TORCH_CHECK_VALUE(0 <= pos && pos < L, "pos=", pos, " outside [0, ", L, ")");
  for (const Tensor* t : {&k_cache, &v_cache})
    TORCH_CHECK_VALUE(reinterpret_cast<uintptr_t>(t->data_ptr()) % 16 == 0,
                      t == &k_cache ? "k_cache" : "v_cache", " must be 16-byte aligned");
  int64_t n_dist = 0, num_buckets = 0;
  if (rel_table.has_value()) {
    num_buckets = rel_table->size(0);
    check(*rel_table, "rel_table", q3, "q", {ScalarType::Float},
          std::vector<int64_t>{num_buckets, H});
    TORCH_CHECK_VALUE(num_buckets <= PAGED_MAX_BUCKETS, num_buckets, " buckets > ",
                      PAGED_MAX_BUCKETS);
    TORCH_CHECK_VALUE(dist_buckets.has_value(), "rel_table needs dist_buckets");
    check(*dist_buckets, "dist_buckets", q3, "q", {ScalarType::Int});
    TORCH_CHECK_VALUE(dist_buckets->dim() == 1, "dist_buckets must be 1-D");
    n_dist = dist_buckets->size(0);
  }
  if (bias_row.has_value())
    check(*bias_row, "bias_row", q3, "q", {ScalarType::Float},
          std::vector<int64_t>{H, L});

  const c10::cuda::CUDAGuard guard(q.device());
  const std::vector<int64_t> sp = splits_for(S, H, pos, q.device().index());
  const int64_t nsplit = sp[0];
  Tensor out = at::empty({S, H, dk}, q.options());
  Tensor work;
  if (nsplit > 1) work = at::empty({S * H * nsplit * (2 + dk)}, q.options().dtype(at::kFloat));
  const int err = paged_decode_attention_launch(
      q3.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), fptr(k_scale),
      fptr(v_scale), fptr(rel_table),
      rel_table.has_value() ? dist_buckets->data_ptr<int32_t>() : nullptr,
      static_cast<int>(n_dist), static_cast<int>(num_buckets),
      bias_row.has_value() ? bias_row->data_ptr<float>() : nullptr, out.data_ptr(),
      nsplit > 1 ? work.data_ptr<float>() : nullptr, static_cast<int>(S),
      static_cast<int>(H), static_cast<int>(NB), static_cast<int>(block),
      static_cast<int>(dk), static_cast<int>(pos), static_cast<int>(sp[1]),
      static_cast<int>(nsplit), dtype_code(q.scalar_type()),
      dtype_code(k_cache.scalar_type()), stream_of(q));
  check_launch(err, "paged_decode_attention");
  return q.dim() == 4 ? out.unsqueeze(2) : out;
}

std::vector<int64_t> paged_decode_splits(int64_t streams, int64_t heads, int64_t pos) {
  TORCH_CHECK_VALUE(streams >= 1 && heads >= 1 && pos >= 0,
                    "paged_decode_splits takes streams, heads >= 1 and pos >= 0");
  return splits_for(streams, heads, pos, c10::cuda::current_device());
}

Tensor int4_cross_attention(const Tensor& q, const Tensor& k4, const Tensor& ks,
                            const Tensor& v4, const Tensor& vs) {
  const Tensor q3 = as_3d(q);
  const int64_t S = q3.size(0), H = q3.size(1), dk = q3.size(2);
  TORCH_CHECK_VALUE(is_dk(dk), "dk=", dk, " not in (16, 32, 64, 128)");
  TORCH_CHECK_VALUE(k4.dim() == 4, "k4 must be (S, H, dk/2, T), got ", k4.sizes());
  const int64_t T = k4.size(3);
  TORCH_CHECK_VALUE(1 <= T && T <= INT4_MAX_T, "T=", T, " outside [1, ", INT4_MAX_T, "]");
  check(q3, "q", q3, "q", {ScalarType::Float, ScalarType::BFloat16});
  const std::vector<int64_t> packed{S, H, dk / 2, T}, scales{S, H, T};
  for (const Tensor* t : {&k4, &v4}) {
    const char* name = t == &k4 ? "k4" : "v4";
    check(*t, name, q3, "q", {ScalarType::Byte}, packed);
    TORCH_CHECK_VALUE(T % 16 != 0 || reinterpret_cast<uintptr_t>(t->data_ptr()) % 16 == 0,
                      name, " must be 16-byte aligned");
  }
  check(ks, "ks", q3, "q", {ScalarType::Float}, scales);
  check(vs, "vs", q3, "q", {ScalarType::Float}, scales);

  const c10::cuda::CUDAGuard guard(q.device());
  Tensor out = at::empty({S, H, dk}, q.options());
  const int err = int4_cross_attention_launch(
      q3.data_ptr(), k4.data_ptr(), ks.data_ptr(), v4.data_ptr(), vs.data_ptr(),
      out.data_ptr(), static_cast<int>(S), static_cast<int>(H), static_cast<int>(dk),
      static_cast<int>(T), dtype_code(q.scalar_type()), stream_of(q));
  check_launch(err, "int4_cross_attention");
  return q.dim() == 4 ? out.unsqueeze(2) : out;
}

// cs (n_fft, 2, Fp) and mel (Fp, n_mels): the layout of
// ops/fused_logmel.py:pack_bases
Tensor fused_logmel(const Tensor& audio, const Tensor& cs, const Tensor& mel,
                    int64_t input_frames, int64_t num_frames, int64_t hop_length,
                    double log_offset, bool power2, int64_t frames_per_thread) {
  TORCH_CHECK_VALUE(audio.dim() == 2 && audio.size(1) == input_frames, "audio must be (B, ",
                    input_frames, "), got ", audio.sizes());
  TORCH_CHECK_VALUE(cs.dim() == 3 && cs.size(1) == 2, "packed cos/sin must be (n_fft, 2, Fp), got ",
                    cs.sizes());
  TORCH_CHECK_VALUE(mel.dim() == 2, "packed mel must be (Fp, n_mels), got ", mel.sizes());
  const int64_t n_fft = cs.size(0), fp = cs.size(2), n_mels = mel.size(1);
  TORCH_CHECK_VALUE(n_fft % LOGMEL_DFT_BLOCK == 0, "n_fft=", n_fft,
                    ": the kernel takes a multiple of ", LOGMEL_DFT_BLOCK);
  TORCH_CHECK_VALUE(fp % LOGMEL_FREQ_TILE == 0, "packed cos/sin has ", fp,
                    " bins: the kernel takes a multiple of ", LOGMEL_FREQ_TILE);
  TORCH_CHECK_VALUE(n_mels % 32 == 0 && 32 <= n_mels && n_mels <= LOGMEL_MAX_MELS, "n_mels=",
                    n_mels, ": the kernel takes a multiple of 32 up to ", LOGMEL_MAX_MELS);
  TORCH_CHECK_VALUE(frames_per_thread == 1 || frames_per_thread == 2 || frames_per_thread == 4,
                    "frames_per_thread=", frames_per_thread, " not in (1, 2, 4)");
  check(audio, "audio", audio, "audio", {ScalarType::Float});
  check(cs, "packed cos/sin", audio, "audio", {ScalarType::Float});
  check(mel, "packed mel", audio, "audio", {ScalarType::Float},
        std::vector<int64_t>{fp, n_mels});

  const c10::cuda::CUDAGuard guard(audio.device());
  const Tensor padded = at::reflection_pad1d(audio, {n_fft / 2, n_fft / 2}).contiguous();
  const int64_t B = audio.size(0);
  Tensor out = at::empty({B, num_frames, n_mels}, audio.options());
  const int err = fused_logmel_launch(
      padded.data_ptr(), cs.data_ptr(), mel.data_ptr(), out.data_ptr(),
      static_cast<int>(B), static_cast<int>(padded.size(1)), static_cast<int>(num_frames),
      static_cast<int>(n_fft), static_cast<int>(hop_length), static_cast<int>(fp),
      static_cast<int>(n_mels), static_cast<float>(log_offset), power2 ? 1 : 0,
      static_cast<int>(frames_per_thread), stream_of(audio));
  check_launch(err, "fused_logmel");
  return out;
}

Tensor launch_probe(const Tensor& x) {
  static constexpr int64_t shape[] = {8, 128};
  check(x, "x", x, "x", {ScalarType::Float}, c10::IntArrayRef(shape));
  const c10::cuda::CUDAGuard guard(x.device());
  Tensor out = at::empty(shape, x.options());
  check_launch(launch_probe_launch(x.data_ptr(), out.data_ptr(),
                                   static_cast<int>(x.numel()), stream_of(x)),
               "launch_probe");
  return out;
}

}  // namespace

TORCH_LIBRARY(yourmt3_tpu_torch, m) {
  m.def("paged_decode_attention(Tensor q, Tensor k_cache, Tensor v_cache, int pos, "
        "Tensor? bias_row=None, Tensor? rel_table=None, Tensor? dist_buckets=None, "
        "Tensor? k_scale=None, Tensor? v_scale=None) -> Tensor");
  m.def("paged_decode_splits(int streams, int heads, int pos) -> int[]",
        &paged_decode_splits);
  m.def("int4_cross_attention(Tensor q, Tensor k4, Tensor ks, Tensor v4, Tensor vs) "
        "-> Tensor");
  m.def("fused_logmel(Tensor audio, Tensor cs, Tensor mel, int input_frames, "
        "int num_frames, int hop_length, float log_offset, bool power2, "
        "int frames_per_thread) -> Tensor");
  m.def("launch_probe(Tensor x) -> Tensor");
}

// No gradients: the autograd keys fall through to the CUDA kernels, which
// spares each call the dispatcher's boxed autograd fallback.
TORCH_LIBRARY_IMPL(yourmt3_tpu_torch, Autograd, m) {
  for (const char* name : {"paged_decode_attention", "int4_cross_attention",
                           "fused_logmel", "launch_probe"})
    m.impl(name, torch::CppFunction::makeFallthrough());
}

TORCH_LIBRARY_IMPL(yourmt3_tpu_torch, CUDA, m) {
  m.impl("paged_decode_attention", &paged_decode_attention);
  m.impl("int4_cross_attention", &int4_cross_attention);
  m.impl("fused_logmel", &fused_logmel);
  m.impl("launch_probe", &launch_probe);
}
