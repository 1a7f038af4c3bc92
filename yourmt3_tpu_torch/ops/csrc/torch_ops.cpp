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
//   torch.ops.yourmt3_tpu_torch.int8_decode_attention    csrc/int8_decode_attention.cu
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

// [nsplit, split_rows] for a cache of `length` rows: the same for every
// batch and every position
std::vector<int64_t> splits_for(int64_t length) {
  const int64_t split_rows = paged_decode_split_rows(static_cast<int>(length));
  return {(length + split_rows - 1) / split_rows, split_rows};
}

Tensor paged_decode_attention(const Tensor& q, const Tensor& k_cache,
                              const Tensor& v_cache, const Tensor& pos,
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
  // pos: a host value (a CPU tensor), checked here, or a tensor on q's
  // device that the kernel reads
  TORCH_CHECK_VALUE(pos.dim() == 0 && pos.scalar_type() == ScalarType::Long,
                    "pos must be a 0-dim int64 tensor, got ", pos.scalar_type(),
                    " of shape ", pos.sizes());
  const bool host_pos = pos.is_cpu();
  const int64_t pos_h = host_pos ? *pos.data_ptr<int64_t>() : 0;
  if (host_pos) {
    TORCH_CHECK_VALUE(0 <= pos_h && pos_h < L, "pos=", pos_h, " outside [0, ", L, ")");
  } else {
    TORCH_CHECK_VALUE(pos.device() == q3.device(), "pos is on ", pos.device(), ", q on ",
                      q3.device());
  }
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
  const std::vector<int64_t> sp = splits_for(L);
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
      static_cast<int>(dk), host_pos ? nullptr : pos.data_ptr<int64_t>(),
      static_cast<int>(pos_h), static_cast<int>(sp[1]),
      static_cast<int>(nsplit), dtype_code(q.scalar_type()),
      dtype_code(k_cache.scalar_type()), stream_of(q));
  check_launch(err, "paged_decode_attention");
  return q.dim() == 4 ? out.unsqueeze(2) : out;
}

std::vector<int64_t> paged_decode_splits(int64_t length) {
  TORCH_CHECK_VALUE(length >= 1, "paged_decode_splits takes a cache length >= 1, got ",
                    length);
  return splits_for(length);
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
  for (const Tensor* t : {&ks, &vs})  // copied 16 bytes at a time with K and V
    TORCH_CHECK_VALUE(T % 16 != 0 || reinterpret_cast<uintptr_t>(t->data_ptr()) % 16 == 0,
                      t == &ks ? "ks" : "vs", " must be 16-byte aligned");

  const c10::cuda::CUDAGuard guard(q.device());
  Tensor out = at::empty({S, H, dk}, q.options());
  const int err = int4_cross_attention_launch(
      q3.data_ptr(), k4.data_ptr(), ks.data_ptr(), v4.data_ptr(), vs.data_ptr(),
      out.data_ptr(), static_cast<int>(S), static_cast<int>(H), static_cast<int>(dk),
      static_cast<int>(T), dtype_code(q.scalar_type()), stream_of(q));
  check_launch(err, "int4_cross_attention");
  return q.dim() == 4 ? out.unsqueeze(2) : out;
}

// q (S, H, M, dk); k_q, v_q (S, H, L, dk) int8, the whole caches; k_s, v_s
// (S, H, L) fp32; bias (1, H, M, n) fp32, any strides; rows [0, n) with no
// position, [0, min(pos + 1, n)) with one
Tensor int8_decode_attention(const Tensor& q, const Tensor& k_q, const Tensor& k_s,
                             const Tensor& v_q, const Tensor& v_s, const OptTensor& bias,
                             int64_t n, const OptTensor& pos) {
  TORCH_CHECK_VALUE(q.dim() == 4, "q must be (S, H, M, dk), got ", q.sizes());
  const int64_t S = q.size(0), H = q.size(1), M = q.size(2), dk = q.size(3);
  check(q, "q", q, "q", {ScalarType::Float, ScalarType::BFloat16});
  TORCH_CHECK_VALUE(is_dk(dk), "dk=", dk, " not in (16, 32, 64, 128)");
  TORCH_CHECK_VALUE(1 <= M && M <= INT8_DECODE_MAX_M, "M=", M,
                    " query rows per head: the kernel takes 1 to ", INT8_DECODE_MAX_M);
  TORCH_CHECK_VALUE(k_q.dim() == 4, "k_q must be (S, H, L, dk), got ", k_q.sizes());
  const int64_t L = k_q.size(2);
  const std::vector<int64_t> vals{S, H, L, dk}, scales{S, H, L};
  check(k_q, "k_q", q, "q", {ScalarType::Char}, vals);
  check(v_q, "v_q", q, "q", {ScalarType::Char}, vals);
  check(k_s, "k_s", q, "q", {ScalarType::Float}, scales);
  check(v_s, "v_s", q, "q", {ScalarType::Float}, scales);
  for (const Tensor* t : {&k_q, &v_q})
    TORCH_CHECK_VALUE(reinterpret_cast<uintptr_t>(t->data_ptr()) % 16 == 0,
                      t == &k_q ? "k_q" : "v_q", " must be 16-byte aligned");
  TORCH_CHECK_VALUE(1 <= n && n <= L && n <= INT8_DECODE_MAX_ROWS, "n=", n,
                    ": the kernel reads 1 to min(L=", L, ", ", INT8_DECODE_MAX_ROWS,
                    ") rows");
  if (bias.has_value()) {  // any strides: the step's bias row is a transposed gather
    TORCH_CHECK_VALUE(bias->device() == q.device(), "bias is on ", bias->device(),
                      ", q on ", q.device());
    TORCH_CHECK_TYPE(bias->scalar_type() == ScalarType::Float, "bias has dtype ",
                     bias->scalar_type(), ", kernel takes (float)");
    const std::vector<int64_t> want{1, H, M, n};
    TORCH_CHECK_VALUE(bias->sizes() == c10::IntArrayRef(want), "bias has shape ",
                      bias->sizes(), ", expected ", c10::IntArrayRef(want));
  }
  // pos: none (every row), a host value (a CPU tensor), checked here, or a
  // tensor on q's device that the kernel reads
  int64_t pos_h = -1;
  const int64_t* pos_dev = nullptr;
  if (pos.has_value()) {
    TORCH_CHECK_VALUE(pos->dim() == 0 && pos->scalar_type() == ScalarType::Long,
                      "pos must be a 0-dim int64 tensor, got ", pos->scalar_type(),
                      " of shape ", pos->sizes());
    if (pos->is_cpu()) {
      pos_h = *pos->data_ptr<int64_t>();
      TORCH_CHECK_VALUE(0 <= pos_h && pos_h < n, "pos=", pos_h, " outside [0, ", n, ")");
    } else {
      TORCH_CHECK_VALUE(pos->device() == q.device(), "pos is on ", pos->device(),
                        ", q on ", q.device());
      pos_dev = pos->data_ptr<int64_t>();
    }
  }

  const c10::cuda::CUDAGuard guard(q.device());
  Tensor out = at::empty({S, H, M, dk}, q.options());
  const int err = int8_decode_attention_launch(
      q.data_ptr(), k_q.data_ptr(), k_s.data_ptr<float>(), v_q.data_ptr(),
      v_s.data_ptr<float>(), fptr(bias), bias.has_value() ? bias->stride(1) : 0,
      bias.has_value() ? bias->stride(2) : 0, bias.has_value() ? bias->stride(3) : 0,
      out.data_ptr(), static_cast<int>(S), static_cast<int>(H), static_cast<int>(M),
      static_cast<int>(L), static_cast<int>(dk), static_cast<int>(n), pos_dev,
      static_cast<int>(pos_h), dtype_code(q.scalar_type()), stream_of(q));
  check_launch(err, "int8_decode_attention");
  return out;
}

// window (n_fft,), twiddles (n_fft - R0, 2), bands (n_mels, 3) int32 and
// weights (nnz,): the layout of ops/fused_logmel.py:pack_bases
Tensor fused_logmel(const Tensor& audio, const Tensor& window, const Tensor& twiddles,
                    const Tensor& bands, const Tensor& weights, int64_t input_frames,
                    int64_t num_frames, int64_t hop_length, double log_offset, bool power2,
                    int64_t frames_per_cta) {
  TORCH_CHECK_VALUE(audio.dim() == 2 && audio.size(1) == input_frames, "audio must be (B, ",
                    input_frames, "), got ", audio.sizes());
  TORCH_CHECK_VALUE(window.dim() == 1, "window must be (n_fft,), got ", window.sizes());
  const int64_t n_fft = window.size(0);
  TORCH_CHECK_VALUE(LOGMEL_MIN_NFFT <= n_fft && n_fft <= LOGMEL_MAX_NFFT &&
                        (n_fft & (n_fft - 1)) == 0,
                    "n_fft=", n_fft, ": the kernel takes a power of two from ",
                    LOGMEL_MIN_NFFT, " to ", LOGMEL_MAX_NFFT);
  int log2n = 0;
  while ((int64_t{1} << log2n) < n_fft) ++log2n;
  const int64_t first_radix = int64_t{1} << (log2n % 3 == 0 ? 3 : log2n % 3);
  TORCH_CHECK_VALUE(bands.dim() == 2 && bands.size(1) == 3 && bands.size(0) >= 1,
                    "mel bands must be (n_mels, 3), got ", bands.sizes());
  TORCH_CHECK_VALUE(bands.size(0) <= LOGMEL_MAX_MELS, "n_mels=", bands.size(0),
                    ": the kernel takes up to ", LOGMEL_MAX_MELS);
  TORCH_CHECK_VALUE(weights.dim() == 1, "mel weights must be (nnz,), got ", weights.sizes());
  TORCH_CHECK_VALUE(num_frames >= 1 && hop_length >= 1,
                    "num_frames and hop_length must be >= 1, got ", num_frames, ", ",
                    hop_length);
  TORCH_CHECK_VALUE(frames_per_cta >= 2 && frames_per_cta % 2 == 0 &&
                        frames_per_cta <= LOGMEL_MAX_TILE,
                    "frames_per_cta=", frames_per_cta, ": the kernel takes an even tile in [2, ",
                    LOGMEL_MAX_TILE, "]");
  check(audio, "audio", audio, "audio", {ScalarType::Float});
  check(window, "window", audio, "audio", {ScalarType::Float});
  check(twiddles, "twiddles", audio, "audio", {ScalarType::Float},
        std::vector<int64_t>{n_fft - first_radix, 2});
  check(bands, "mel bands", audio, "audio", {ScalarType::Int});
  check(weights, "mel weights", audio, "audio", {ScalarType::Float});

  const c10::cuda::CUDAGuard guard(audio.device());
  const Tensor padded = at::reflection_pad1d(audio, {n_fft / 2, n_fft / 2}).contiguous();
  const int64_t B = audio.size(0), n_mels = bands.size(0);
  Tensor out = at::empty({B, num_frames, n_mels}, audio.options());
  const int err = fused_logmel_launch(
      padded.data_ptr(), window.data_ptr(), twiddles.data_ptr(), bands.data_ptr(),
      weights.data_ptr(), out.data_ptr(), static_cast<int>(B),
      static_cast<int>(padded.size(1)), static_cast<int>(num_frames),
      static_cast<int>(n_fft), static_cast<int>(hop_length), static_cast<int>(n_mels),
      static_cast<int>(weights.numel()), static_cast<float>(log_offset), power2 ? 1 : 0,
      static_cast<int>(frames_per_cta), stream_of(audio));
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
  m.def("paged_decode_attention(Tensor q, Tensor k_cache, Tensor v_cache, Tensor pos, "
        "Tensor? bias_row=None, Tensor? rel_table=None, Tensor? dist_buckets=None, "
        "Tensor? k_scale=None, Tensor? v_scale=None) -> Tensor");
  m.def("paged_decode_splits(int length) -> int[]",
        &paged_decode_splits);
  m.def("int4_cross_attention(Tensor q, Tensor k4, Tensor ks, Tensor v4, Tensor vs) "
        "-> Tensor");
  m.def("int8_decode_attention(Tensor q, Tensor k_q, Tensor k_s, Tensor v_q, Tensor v_s, "
        "Tensor? bias, int n, Tensor? pos) -> Tensor");
  m.def("fused_logmel(Tensor audio, Tensor window, Tensor twiddles, Tensor bands, "
        "Tensor weights, int input_frames, int num_frames, int hop_length, "
        "float log_offset, bool power2, int frames_per_cta) -> Tensor");
  m.def("launch_probe(Tensor x) -> Tensor");
}

// No gradients: the autograd keys fall through to the CUDA kernels, which
// spares each call the dispatcher's boxed autograd fallback.
TORCH_LIBRARY_IMPL(yourmt3_tpu_torch, Autograd, m) {
  for (const char* name : {"paged_decode_attention", "int4_cross_attention",
                           "int8_decode_attention", "fused_logmel", "launch_probe"})
    m.impl(name, torch::CppFunction::makeFallthrough());
}

TORCH_LIBRARY_IMPL(yourmt3_tpu_torch, CUDA, m) {
  m.impl("paged_decode_attention", &paged_decode_attention);
  m.impl("int4_cross_attention", &int4_cross_attention);
  m.impl("int8_decode_attention", &int8_decode_attention);
  m.impl("fused_logmel", &fused_logmel);
  m.impl("launch_probe", &launch_probe);
}
