// The nine fvt::* ops registered in C++ for the card: the op library that the
// native runner (csrc/native_runner.cpp) loads before an AOTInductor package of
// the serving program (evaluation/serving.py::export_serving_native), whose
// calls of K1 / K2 (bf16) and Q1 / Q2 (int8) stay extern calls of these ops.
//
// TORCH_LIBRARY defines the schemas of csrc/fvt_schemas.inc, the one source that
// ops/library.py parses too; TORCH_LIBRARY_IMPL gives each a CUDA
// implementation that does what its Python wrapper does before its ctypes
// call (ops/conv2plus1d.py::spatial_conv_cuda / temporal_conv_cuda,
// ops/int8_conv.py::conv3d_s8_cuda / quantize_s8_cuda): the checks, the
// 16-byte alignment clones, K2's one scratch allocation, the plan (csrc/plans.h,
// held equal to the Python plans by a CPU test), then the kernels' C entry
// points on the current CUDA stream. A non-zero return code raises. No CPU
// implementation is registered: the plain versions are Python's, so a CPU
// tensor that reaches an fvt op here gets the dispatcher's error.
//
// Each op adds one to its launch count where it launches its kernel
// (fvt_ops_launch_counts reads them, in the order of fvt_ops_counter_names:
// the Python wrappers' launch_counts keys). Built by ops/_build.py against the
// installed torch and linked with the kernel libraries it calls; it is loaded
// only into the runner: a process that has imported ops/library.py has fvt
// defined already, and a second TORCH_LIBRARY(fvt, ...) there fails.

#include <ATen/ATen.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <cuda_runtime_api.h>
#include <torch/library.h>

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <optional>
#include <string>
#include <tuple>

#include "plans.h"

extern "C" {
int fvt_spatial_conv_bf16(const void* x, const void* w, void* wk, void* y, void* ws,
                          long long n, int h, int wd, int cp, int cw, int cow, int k, int dx,
                          int bn, int stages, int splits, int smem_bytes, int device,
                          void* stream);
int fvt_temporal_conv_bf16(const void* x, const void* w, void* wk, void* xp, void* y, void* ws,
                           long long b, int t, int s, int cx, int cp, int cw, int cow, int k,
                           int dx, int bn, int stages, int splits, int smem_bytes, int device,
                           void* stream);
int fvt_conv3d_s8(const void* x, const void* wk, const void* mul, const void* add,
                  const void* s, void* y, void* y2, const void* res, const void* res_inv_f,
                  const void* res_s, const void* q_inv_f, const void* q_s, void* amax,
                  const void* amax_inv_f, long long n, int t, int h, int w, int cp, int to,
                  int ho, int wo, int kt, int kh, int kw, int st, int sh, int sw, int pt, int ph,
                  int pw, int co, int relu, int out, int ld, int res_kind, int res_ld, int bn,
                  int stages, int staged, int blocks, int smem_bytes, int device, void* stream);
int fvt_quantize_s8(const void* y, int in_f32, const void* inv_f, const void* s_in, void* amax,
                    void* s_out, void* q, long long rows, int c, int cp, int mode, int device,
                    void* stream);
}

namespace {

using at::Tensor;
using OptTensor = std::optional<Tensor>;

enum Counter { kSpatial, kTemporal, kConvS8, kQuantize, kQuantizeAmax, kCounters };
std::atomic<long long> g_counts[kCounters];

void count(Counter c) { g_counts[c].fetch_add(1, std::memory_order_relaxed); }

bool misaligned(const Tensor& t) { return reinterpret_cast<uintptr_t>(t.data_ptr()) % 16 != 0; }

// a view into a larger buffer: the kernels read 16 bytes at a time
Tensor aligned(const Tensor& t) { return misaligned(t) ? t.clone() : t; }

void* ptr(const OptTensor& t) { return t.has_value() ? t->data_ptr() : nullptr; }

int sm_count(int device) {
  static int sms[64] = {};
  TORCH_CHECK(device >= 0 && device < 64, "device index ", device);
  if (sms[device] == 0) {
    const cudaError_t err =
        cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount, device);
    TORCH_CHECK(err == cudaSuccess, "cudaDeviceGetAttribute failed: CUDA error ", int(err));
  }
  return sms[device];
}

void* stream_of(const Tensor& t) {
  return c10::cuda::getCurrentCUDAStream(t.device().index()).stream();
}

// ---------------------------------------------------------------------------
// K1 / K2 (ops/conv2plus1d.py: _check_kernel_tensors, _check_kernel_args,
// _k1_launch, _k2_launch)
// ---------------------------------------------------------------------------

void check_bf16(const Tensor& t, const char* name, const Tensor& first) {
  TORCH_CHECK_VALUE(t.is_cuda(), name, " must be a CUDA tensor, got ", t.device());
  TORCH_CHECK_VALUE(t.scalar_type() == at::kBFloat16, name, " must be bfloat16, got ",
                    t.scalar_type());
  TORCH_CHECK_VALUE(t.is_contiguous(), name, " must be contiguous");
  TORCH_CHECK_VALUE(t.device() == first.device(), "tensors on ", first.device(), " and ",
                    t.device());
}

void check_kernel_args(const Tensor& x, const Tensor& w, std::vector<int64_t> w_shape) {
  check_bf16(x, "x", x);
  check_bf16(w, "w", x);
  TORCH_CHECK_VALUE(x.dim() == 4, "x must have 4 dims, got ", x.sizes());
  TORCH_CHECK_VALUE(w.sizes() == at::IntArrayRef(w_shape), "w must be ", w_shape, ", got ",
                    w.sizes());
  TORCH_CHECK_VALUE(w_shape[0] % 2 == 1, "kernel size must be odd, got ", w_shape[0]);
}

Tensor spatial_conv(const Tensor& x_in, const Tensor& w_in) {
  TORCH_CHECK_VALUE(w_in.dim() == 4 && x_in.dim() == 4, "x (N, H, W, C) and w (k, k, C, Co), got ",
                    x_in.sizes(), " and ", w_in.sizes());
  const int64_t k = w_in.size(0);
  check_kernel_args(x_in, w_in, {k, k, x_in.size(3), w_in.size(3)});
  const c10::cuda::CUDAGuard guard(x_in.device());
  const int cw = static_cast<int>(w_in.size(2)), cow = static_cast<int>(w_in.size(3));
  Tensor x = x_in;
  const int64_t pad = (8 - x.size(3) % 8) % 8;  // the contraction in whole 16-byte chunks
  if (pad) x = at::constant_pad_nd(x, {0, pad});
  x = aligned(x);
  const Tensor w = aligned(w_in);
  const int64_t n = x.size(0), h = x.size(1), wd = x.size(2);
  const int cp = static_cast<int>(x.size(3));
  const int dev = x.device().index();
  const fvt::TapsPlan plan = fvt::spatial_plan(n, h, wd, cp, cow, static_cast<int>(k), sm_count(dev));
  const Tensor wk = at::empty({cow, k * k, cp}, x.options());
  Tensor y = at::empty({n, h, wd, cow}, x.options());
  Tensor ws;
  if (plan.splits > 1) ws = at::empty({plan.splits, n * h * wd, cow}, x.options().dtype(at::kFloat));
  const int rc = fvt_spatial_conv_bf16(
      x.data_ptr(), w.data_ptr(), wk.data_ptr(), y.data_ptr(),
      plan.splits > 1 ? ws.data_ptr() : nullptr, n, static_cast<int>(h), static_cast<int>(wd), cp,
      cw, cow, static_cast<int>(k), 0, plan.bn, plan.stages, plan.splits, plan.smem_bytes, dev,
      stream_of(x));
  TORCH_CHECK(rc == 0, "fvt_spatial_conv_bf16 launch failed: CUDA error ", rc);
  count(kSpatial);
  return y;
}

Tensor temporal_conv(const Tensor& x_in, const Tensor& w_in) {
  TORCH_CHECK_VALUE(w_in.dim() == 3 && x_in.dim() == 4, "x (B, T, S, C) and w (k, C, Co), got ",
                    x_in.sizes(), " and ", w_in.sizes());
  const int64_t k = w_in.size(0);
  check_kernel_args(x_in, w_in, {k, x_in.size(3), w_in.size(2)});
  const c10::cuda::CUDAGuard guard(x_in.device());
  const int cw = static_cast<int>(w_in.size(1)), cow = static_cast<int>(w_in.size(2));
  const Tensor x = aligned(x_in);
  const Tensor w = aligned(w_in);
  const int64_t b = x.size(0), t = x.size(1), s = x.size(2);
  const int cx = static_cast<int>(x.size(3));
  const int64_t rows = b * t * s;
  const int dev = x.device().index();
  const fvt::TapsPlan plan = fvt::temporal_plan(b, t, s, cx, cow, static_cast<int>(k), sm_count(dev));
  // one scratch: the K-major weight, the padded x where there is one, the
  // split's f32 partial sums, each 16-byte aligned (cp % 8 == 0)
  const int64_t n_wk = static_cast<int64_t>(cow) * k * plan.cp;
  const int64_t n_xp = cx % 8 ? rows * plan.cp : 0;
  const int64_t n_ws = plan.splits > 1 ? 2 * plan.splits * rows * cow : 0;
  const Tensor scratch = at::empty({n_wk + n_xp + n_ws}, x.options());
  Tensor y = at::empty({b, t, s, cow}, x.options());
  char* base = static_cast<char*>(scratch.data_ptr());
  const int rc = fvt_temporal_conv_bf16(
      x.data_ptr(), w.data_ptr(), base, n_xp ? base + 2 * n_wk : nullptr, y.data_ptr(),
      n_ws ? base + 2 * (n_wk + n_xp) : nullptr, b, static_cast<int>(t), static_cast<int>(s), cx,
      plan.cp, cw, cow, static_cast<int>(k), 0, plan.bn, plan.stages, plan.splits,
      plan.smem_bytes, dev, stream_of(x));
  TORCH_CHECK(rc == 0, "fvt_temporal_conv_bf16 launch failed: CUDA error ", rc);
  count(kTemporal);
  return y;
}

// ---------------------------------------------------------------------------
// Q1 (ops/int8_conv.py: _check_form, _check_q1, conv3d_s8_cuda)
// ---------------------------------------------------------------------------

enum Out { kOutBf16 = 0, kOutF32 = 1, kOutS8 = 2 };

struct Q1Result {
  Tensor y, y2;
};

void check_vector(const Tensor& t, const char* name, int64_t co) {
  TORCH_CHECK_VALUE(t.scalar_type() == at::kFloat && t.dim() == 1 && t.size(0) == co, name,
                    " must be f32 (", co, ",), got ", t.scalar_type(), " ", t.sizes());
}

void check_scalar(const Tensor& t, const char* name) {
  TORCH_CHECK_VALUE(t.scalar_type() == at::kFloat && t.numel() == 1, name,
                    " must be one f32 value, got ", t.scalar_type(), " ", t.sizes());
}

int64_t out_size(int64_t n, int64_t k, int64_t s, int64_t lo, int64_t hi) {
  return (n + lo + hi - k) / s + 1;
}

// The conv of every Q1 op: the residual (res_kind '' for none), the next
// site's static quantize (q_inv_f / q_s, keep_bf16) or dynamic amax
// (amax_inv_f / amax) in the epilogue.
Q1Result conv_s8(const Tensor& q_in, const Tensor& wk_in, at::IntArrayRef kernel_size,
                 const Tensor& mul, const Tensor& add, const Tensor& s, at::IntArrayRef strides,
                 at::IntArrayRef pads, bool relu, bool out_f32, c10::string_view res_kind,
                 OptTensor res, OptTensor res_inv_f, OptTensor res_s, const OptTensor& q_inv_f,
                 const OptTensor& q_s, bool keep_bf16, const OptTensor& amax_inv_f,
                 const OptTensor& amax) {
  if (res_kind.empty()) res = res_inv_f = res_s = std::nullopt;  // no residual
  TORCH_CHECK_VALUE(q_in.scalar_type() == at::kChar && wk_in.scalar_type() == at::kChar &&
                        q_in.dim() == 5 && wk_in.dim() == 3,
                    "q (N,T,H,W,cp) and wk (Co,taps,cp) must be int8, got ", q_in.scalar_type(),
                    " ", q_in.sizes(), " and ", wk_in.scalar_type(), " ", wk_in.sizes());
  TORCH_CHECK_VALUE(kernel_size.size() == 3, "kernel_size must be (kt, kh, kw), got ", kernel_size);
  const int64_t kt = kernel_size[0], kh = kernel_size[1], kw = kernel_size[2];
  const int64_t cp = q_in.size(4);
  TORCH_CHECK_VALUE(cp % fvt::kChannelAlign == 0 && wk_in.size(1) == kt * kh * kw &&
                        wk_in.size(2) == cp,
                    "q's channels ", cp, " must be a multiple of ", fvt::kChannelAlign,
                    " and wk (Co, ", kt * kh * kw, ", ", cp, "); got wk ", wk_in.sizes());
  const int64_t co = wk_in.size(0);
  const bool requant = q_inv_f.has_value();
  TORCH_CHECK_VALUE(!(requant && out_f32), "a requantized output is int8 (and bf16), not f32");
  TORCH_CHECK_VALUE(!(amax.has_value() && (out_f32 || requant)),
                    "the amax is reduced over a bf16 output, not an f32 or int8 one");
  check_vector(mul, "mul", co);
  check_vector(add, "add", co);
  check_scalar(s, "s");
  if (requant) {
    check_vector(*q_inv_f, "requant.inv_f", co);
    check_scalar(*q_s, "requant.s");
  }
  if (amax.has_value()) {
    check_vector(*amax_inv_f, "amax.inv_f", co);
    check_scalar(*amax, "amax.out");
  }
  int res_code = 0;
  if (!res_kind.empty()) {
    at::ScalarType want = at::kChar;
    if (res_kind == "dequant") res_code = 1;
    else if (res_kind == "f32") res_code = 2, want = at::kFloat;
    else if (res_kind == "bf16") res_code = 3, want = at::kBFloat16;
    else TORCH_CHECK_VALUE(false, "unknown residual kind '", std::string(res_kind), "'");
    TORCH_CHECK_VALUE(res.has_value(), "a ", std::string(res_kind), " residual needs res");
    const int64_t width = res_code == 1 ? fvt::padded_channels(static_cast<int>(co)) : co;
    TORCH_CHECK_VALUE(res->scalar_type() == want && res->dim() == 5 && res->size(4) == width, "a ",
                      std::string(res_kind), " residual is ", want, " (..., ", width, "), got ",
                      res->scalar_type(), " ", res->sizes());
    if (res_code == 1) {
      TORCH_CHECK_VALUE(res_inv_f.has_value() && res_s.has_value(),
                        "a dequant residual needs its inv_f and s");
      check_vector(*res_inv_f, "residual.inv_f", co);
      check_scalar(*res_s, "residual.s");
    }
  }
  TORCH_CHECK_VALUE(strides.size() == 3 && pads.size() == 6 &&
                        *std::min_element(strides.begin(), strides.end()) >= 1,
                    "bad strides ", strides, " or pads ", pads);
  const at::Device dev = q_in.device();
  TORCH_CHECK_VALUE(dev.is_cuda(), "q must be a CUDA tensor, got ", dev);
  const std::pair<const char*, const Tensor*> tensors[] = {
      {"q", &q_in}, {"wk", &wk_in}, {"mul", &mul}, {"add", &add}, {"s", &s},
      {"residual.t", res ? &*res : nullptr}, {"residual.inv_f", res_inv_f ? &*res_inv_f : nullptr},
      {"residual.s", res_s ? &*res_s : nullptr}, {"requant.inv_f", q_inv_f ? &*q_inv_f : nullptr},
      {"requant.s", q_s ? &*q_s : nullptr}, {"amax.inv_f", amax_inv_f ? &*amax_inv_f : nullptr},
      {"amax.out", amax ? &*amax : nullptr}};
  for (const auto& [name, t] : tensors)
    TORCH_CHECK_VALUE(t == nullptr || (t->device() == dev && t->is_contiguous()), name,
                      " must be contiguous on ", dev);
  const c10::cuda::CUDAGuard guard(dev);
  const int64_t n = q_in.size(0), t = q_in.size(1), h = q_in.size(2), w = q_in.size(3);
  const int64_t to = out_size(t, kt, strides[0], pads[0], pads[1]);
  const int64_t ho = out_size(h, kh, strides[1], pads[2], pads[3]);
  const int64_t wo = out_size(w, kw, strides[2], pads[4], pads[5]);
  const Tensor q = aligned(q_in);
  const Tensor wk = aligned(wk_in);
  Q1Result r;
  int64_t ld;
  int out;
  if (requant) {
    ld = fvt::padded_channels(static_cast<int>(co));
    out = kOutS8;
    r.y = at::empty({n, to, ho, wo, ld}, q.options().dtype(at::kChar));
    if (keep_bf16) r.y2 = at::empty({n, to, ho, wo, co}, q.options().dtype(at::kBFloat16));
  } else {
    ld = co;
    out = out_f32 ? kOutF32 : kOutBf16;
    r.y = at::empty({n, to, ho, wo, co}, q.options().dtype(out_f32 ? at::kFloat : at::kBFloat16));
  }
  const int es = static_cast<int>(r.y.element_size());
  const int64_t rows = n * to * ho * wo;
  fvt::ConvS8Plan plan;
  TORCH_CHECK_VALUE(fvt::conv_s8_plan(rows, static_cast<int>(co), static_cast<int>(kt * kh * kw),
                                      static_cast<int>(cp), es, ld * es,
                                      sm_count(dev.index()), &plan),
                    "Q1 has no plan for Co ", co, " with ", es, "-byte outputs");
  const int rc = fvt_conv3d_s8(
      q.data_ptr(), wk.data_ptr(), mul.data_ptr(), add.data_ptr(), s.data_ptr(), r.y.data_ptr(),
      r.y2.defined() ? r.y2.data_ptr() : nullptr, ptr(res), ptr(res_inv_f), ptr(res_s),
      ptr(q_inv_f), ptr(q_s), ptr(amax), ptr(amax_inv_f), n, static_cast<int>(t),
      static_cast<int>(h), static_cast<int>(w), static_cast<int>(cp), static_cast<int>(to),
      static_cast<int>(ho), static_cast<int>(wo), static_cast<int>(kt), static_cast<int>(kh),
      static_cast<int>(kw), static_cast<int>(strides[0]), static_cast<int>(strides[1]),
      static_cast<int>(strides[2]), static_cast<int>(pads[0]), static_cast<int>(pads[2]),
      static_cast<int>(pads[4]), static_cast<int>(co), relu ? 1 : 0, out, static_cast<int>(ld),
      res_code, res.has_value() ? static_cast<int>(res->size(-1)) : 0, plan.bn, plan.stages,
      plan.staged ? 1 : 0, plan.grid, plan.smem_bytes, dev.index(), stream_of(q));
  TORCH_CHECK(rc == 0, "fvt_conv3d_s8 launch failed: CUDA error ", rc);
  count(kConvS8);
  return r;
}

Tensor conv3d_s8(const Tensor& q, const Tensor& wk, at::IntArrayRef kernel_size, const Tensor& mul,
                 const Tensor& add, const Tensor& s, at::IntArrayRef strides, at::IntArrayRef pads,
                 bool relu, bool out_f32, c10::string_view res_kind, const OptTensor& res,
                 const OptTensor& res_inv_f, const OptTensor& res_s) {
  return conv_s8(q, wk, kernel_size, mul, add, s, strides, pads, relu, out_f32, res_kind, res,
                 res_inv_f, res_s, std::nullopt, std::nullopt, false, std::nullopt, std::nullopt)
      .y;
}

Tensor conv3d_s8_requant(const Tensor& q, const Tensor& wk, at::IntArrayRef kernel_size,
                         const Tensor& mul, const Tensor& add, const Tensor& s,
                         at::IntArrayRef strides, at::IntArrayRef pads, bool relu,
                         c10::string_view res_kind, const OptTensor& res,
                         const OptTensor& res_inv_f, const OptTensor& res_s, const Tensor& q_inv_f,
                         const Tensor& q_s) {
  return conv_s8(q, wk, kernel_size, mul, add, s, strides, pads, relu, false, res_kind, res,
                 res_inv_f, res_s, q_inv_f, q_s, false, std::nullopt, std::nullopt)
      .y;
}

std::tuple<Tensor, Tensor> conv3d_s8_requant_bf16(
    const Tensor& q, const Tensor& wk, at::IntArrayRef kernel_size, const Tensor& mul,
    const Tensor& add, const Tensor& s, at::IntArrayRef strides, at::IntArrayRef pads, bool relu,
    c10::string_view res_kind, const OptTensor& res, const OptTensor& res_inv_f,
    const OptTensor& res_s, const Tensor& q_inv_f, const Tensor& q_s) {
  Q1Result r = conv_s8(q, wk, kernel_size, mul, add, s, strides, pads, relu, false, res_kind, res,
                       res_inv_f, res_s, q_inv_f, q_s, true, std::nullopt, std::nullopt);
  return {r.y, r.y2};
}

Tensor conv3d_s8_amax(const Tensor& q, const Tensor& wk, at::IntArrayRef kernel_size,
                      const Tensor& mul, const Tensor& add, const Tensor& s,
                      at::IntArrayRef strides, at::IntArrayRef pads, bool relu,
                      c10::string_view res_kind, const OptTensor& res, const OptTensor& res_inv_f,
                      const OptTensor& res_s, const Tensor& amax_inv_f, const Tensor& amax) {
  return conv_s8(q, wk, kernel_size, mul, add, s, strides, pads, relu, false, res_kind, res,
                 res_inv_f, res_s, std::nullopt, std::nullopt, false, amax_inv_f, amax)
      .y;
}

// ---------------------------------------------------------------------------
// Q2 (ops/int8_conv.py: _check_q2, _check_scalar, quantize_s8_cuda)
// ---------------------------------------------------------------------------

enum Q2Mode { kQ2Static = 0, kQ2Dynamic = 1, kQ2Given = 2 };

void check_q2_scalar(const Tensor& t, const char* name, const at::Device& dev) {
  TORCH_CHECK_VALUE(t.scalar_type() == at::kFloat && t.numel() == 1 && t.device() == dev, name,
                    " must be one f32 value on ", dev);
}

// mode static: s; dynamic: the amax pass into amax, then the quantize pass,
// its scale into scale; given: the quantize pass from amax, its scale into scale
Tensor quantize(const Tensor& y_in, const Tensor& inv_f, Q2Mode mode, const Tensor& s,
                const Tensor& amax, const Tensor& scale) {
  TORCH_CHECK_VALUE(y_in.scalar_type() == at::kBFloat16 || y_in.scalar_type() == at::kFloat,
                    "y must be bf16 or f32, got ", y_in.scalar_type());
  TORCH_CHECK_VALUE(y_in.dim() >= 1 && inv_f.scalar_type() == at::kFloat && inv_f.dim() == 1 &&
                        inv_f.size(0) == y_in.size(-1),
                    "inv_f must be f32 (", y_in.size(-1), ",), got ", inv_f.scalar_type(), " ",
                    inv_f.sizes());
  const at::Device dev = y_in.device();
  TORCH_CHECK_VALUE(dev.is_cuda(), "y must be a CUDA tensor, got ", dev);
  const c10::cuda::CUDAGuard guard(dev);
  const Tensor y = y_in.contiguous();
  const int c = static_cast<int>(y.size(-1));
  const fvt::QuantizeSizes z = fvt::quantize_sizes(y.numel(), c);
  std::vector<int64_t> shape(y.sizes().begin(), y.sizes().end());
  shape.back() = z.cp;
  Tensor q = at::empty(shape, y.options().dtype(at::kChar));
  const void *s_in = nullptr;
  void *amax_ptr = nullptr, *s_out = nullptr;
  if (mode == kQ2Static) {
    check_q2_scalar(s, "s", dev);
    s_in = s.data_ptr();
  } else {
    check_q2_scalar(amax, mode == kQ2Dynamic ? "slot[0]" : "amax", dev);
    check_q2_scalar(scale, "slot[1]", dev);
    amax_ptr = amax.data_ptr();
    s_out = scale.data_ptr();
  }
  const Tensor f = inv_f.contiguous();
  const int rc = fvt_quantize_s8(y.data_ptr(), y.scalar_type() == at::kFloat ? 1 : 0,
                                 f.data_ptr(), s_in, amax_ptr, s_out, q.data_ptr(), z.rows, c,
                                 z.cp, mode, dev.index(), stream_of(y));
  TORCH_CHECK(rc == 0, "fvt_quantize_s8 launch failed: CUDA error ", rc);
  count(kQuantize);
  if (mode == kQ2Dynamic) count(kQuantizeAmax);
  return q;
}

Tensor quantize_s8(const Tensor& y, const Tensor& inv_f, const Tensor& s) {
  return quantize(y, inv_f, kQ2Static, s, Tensor(), Tensor());
}

Tensor quantize_s8_dynamic(const Tensor& y, const Tensor& inv_f, const Tensor& amax,
                           const Tensor& scale) {
  return quantize(y, inv_f, kQ2Dynamic, Tensor(), amax, scale);
}

Tensor quantize_s8_given(const Tensor& y, const Tensor& inv_f, const Tensor& amax,
                         const Tensor& scale) {
  return quantize(y, inv_f, kQ2Given, Tensor(), amax, scale);
}

}  // namespace

TORCH_LIBRARY(fvt, m) {
#define FVT_SCHEMA(schema) m.def(schema);
#include "fvt_schemas.inc"
#undef FVT_SCHEMA
}

TORCH_LIBRARY_IMPL(fvt, CUDA, m) {
  m.impl("spatial_conv", &spatial_conv);
  m.impl("temporal_conv", &temporal_conv);
  m.impl("conv3d_s8", &conv3d_s8);
  m.impl("conv3d_s8_requant", &conv3d_s8_requant);
  m.impl("conv3d_s8_requant_bf16", &conv3d_s8_requant_bf16);
  m.impl("conv3d_s8_amax", &conv3d_s8_amax);
  m.impl("quantize_s8", &quantize_s8);
  m.impl("quantize_s8_dynamic", &quantize_s8_dynamic);
  m.impl("quantize_s8_given", &quantize_s8_given);
}

extern "C" {

// The counters' names, comma-separated, in the order fvt_ops_launch_counts
// writes them.
const char* fvt_ops_counter_names() {
  return "spatial_conv,temporal_conv,conv3d_s8,quantize_s8,quantize_s8_amax";
}

// Writes up to n launch counts (since the library was loaded or last reset);
// returns how many there are.
int fvt_ops_launch_counts(long long* out, int n) {
  for (int i = 0; i < n && i < kCounters; ++i) out[i] = g_counts[i].load();
  return kCounters;
}

void fvt_ops_reset_launch_counts() {
  for (auto& c : g_counts) c.store(0);
}

}  // extern "C"
