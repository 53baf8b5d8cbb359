// The max pool's backward as a gather, with no atomics: the gradient of a
// max pool over (T, H, W) of an NTHWC tensor (ops/maxpool_grad.py, the
// 'sas' and 'sep' lowerings in train mode).
//
// Replaces no TPU kernel. The JAX package's backward is XLA's
// select_and_scatter (fastvideotagging_tpu/ops/maxpool_grad.py:206, one 3-D
// scatter for 'sas'; :221, a chain of 1-D ones for 'sep'), which gives the
// same result every run. F.max_pool3d's CUDA backward scatters with atomic
// adds, so where windows overlap (S3D's 3x3x3 stride-1 branch pool, the
// stem pools, I3D's, P3D's) the order of the adds, and the bits of the
// gradient, change from run to run. This kernel makes them repeatable.
//
// Design: one thread an input element (n, t, h, w, c), neighbouring threads
// on neighbouring channels. The thread walks the windows that cover its
// element in raster (t, h, w) order of the output, and adds the cotangent
// of each window whose first maximum, in raster (t, h, w) order over the
// window, is its element: x[i] == y[o] and no earlier element of the window
// equals y[o]. A 1-D pool of 'sep' is the 3-D pool with a window of 1 on
// the other dims, so "first" is first along its dim. That is the tie rule
// of select_and_scatter and of F.max_pool3d's index. The -inf pad is
// implicit: a window position outside [0, D) holds -inf. The sum is taken
// in f32 (f64 for f64 tensors) in that fixed order and rounded once; the
// plain version (ops/maxpool_grad.py::maxpool_grad_plain) makes the same
// adds in the same order, so the two agree bit for bit.
//
// Bound: bytes. Each element of x, the cotangent and dx once, y once; a
// thread reads its windows' y and the earlier elements of each window again,
// from L1 / L2. Simple and right first; no tiling yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;

template <typename T> struct Acc { using type = float; };
template <> struct Acc<double> { using type = double; };

template <typename T> __device__ __forceinline__ float to_f(T v) { return static_cast<float>(v); }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T, typename A> __device__ __forceinline__ T from_acc(A v) {
  return static_cast<T>(v);
}
template <> __device__ __forceinline__ __nv_bfloat16 from_acc<__nv_bfloat16, float>(float v) {
  return __float2bfloat16_rn(v);
}

// the value as compared: the storage type's value, exactly (bf16 widens to
// f32 exactly; f64 stays f64)
template <typename T> __device__ __forceinline__ typename Acc<T>::type val(T v) {
  return static_cast<typename Acc<T>::type>(to_f(v));
}
template <> __device__ __forceinline__ double val<double>(double v) { return v; }

struct Geometry {
  int d[3];  // input T, H, W
  int o[3];  // output T, H, W
  int k[3], s[3], p[3];  // window, stride, low pad
  int c;
};

template <typename A> __device__ __forceinline__ A neg_inf();
template <> __device__ __forceinline__ float neg_inf<float>() { return -__int_as_float(0x7f800000); }
template <> __device__ __forceinline__ double neg_inf<double>() {
  return -__longlong_as_double(0x7ff0000000000000LL);
}

// Is element i the first, in raster (t, h, w) order, of the window starting
// at w (input coordinates, pads included) that equals yv? Positions outside
// the input are the -inf pad.
template <typename T>
__device__ __forceinline__ bool first_max(const T* __restrict__ x, long long x_n, int ch,
                                          const Geometry& g, const int* w, const int* i,
                                          typename Acc<T>::type yv) {
  using A = typename Acc<T>::type;
  for (int e0 = w[0]; e0 < w[0] + g.k[0]; ++e0)
    for (int e1 = w[1]; e1 < w[1] + g.k[1]; ++e1)
      for (int e2 = w[2]; e2 < w[2] + g.k[2]; ++e2) {
        if (e0 == i[0] && e1 == i[1] && e2 == i[2]) return true;
        const bool inside = e0 >= 0 && e0 < g.d[0] && e1 >= 0 && e1 < g.d[1] && e2 >= 0 &&
                            e2 < g.d[2];
        const A ev = inside ? val(x[(((x_n + e0) * g.d[1] + e1) * g.d[2] + e2) * g.c + ch])
                            : neg_inf<A>();
        if (ev == yv) return false;
      }
  return true;  // not reached: i lies in every window walked
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
maxpool_grad_kernel(const T* __restrict__ x, const T* __restrict__ y, const T* __restrict__ ct,
                    T* __restrict__ dx, long long total, Geometry g) {
  using A = typename Acc<T>::type;
  const long long idx = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= total) return;
  const int ch = static_cast<int>(idx % g.c);
  long long r = idx / g.c;
  int i[3];
  i[2] = static_cast<int>(r % g.d[2]);
  r /= g.d[2];
  i[1] = static_cast<int>(r % g.d[1]);
  r /= g.d[1];
  i[0] = static_cast<int>(r % g.d[0]);
  const long long n = r / g.d[0];
  const A xv = val(x[idx]);
  // the windows that hold element i: o * s - p <= i < o * s - p + k
  int lo[3], hi[3];
  for (int a = 0; a < 3; ++a) {
    const int q = i[a] + g.p[a];
    const int first = q - g.k[a] + 1;
    lo[a] = first <= 0 ? 0 : (first + g.s[a] - 1) / g.s[a];
    hi[a] = min(q / g.s[a], g.o[a] - 1);
  }
  const long long x_n = n * g.d[0], y_n = n * g.o[0];
  A acc = A(0);
  for (int o0 = lo[0]; o0 <= hi[0]; ++o0)
    for (int o1 = lo[1]; o1 <= hi[1]; ++o1)
      for (int o2 = lo[2]; o2 <= hi[2]; ++o2) {
        const long long yi = (((y_n + o0) * g.o[1] + o1) * g.o[2] + o2) * g.c + ch;
        const A yv = val(y[yi]);
        if (!(xv == yv)) continue;
        const int w[3] = {o0 * g.s[0] - g.p[0], o1 * g.s[1] - g.p[1], o2 * g.s[2] - g.p[2]};
        if (first_max(x, x_n, ch, g, w, i, yv)) acc += val(ct[yi]);
      }
  dx[idx] = from_acc<T, A>(acc);
}

template <typename T>
cudaError_t launch(const void* x, const void* y, const void* ct, void* dx, long long total,
                   const Geometry& g, cudaStream_t st) {
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  maxpool_grad_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), static_cast<const T*>(ct),
      static_cast<T*>(dx), total, g);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dx (N, T, H, W, C) from x (N, T, H, W, C), y and the cotangent ct (N, OT,
// OH, OW, C), all of one type (dtype 0 bf16, 1 f32, 2 f64),
// contiguous, on `stream` of CUDA device `device`; returns
// cudaGetLastError() after the launch (0 on success). Window k, stride s and
// low pads p per dim (T, H, W); the output size is the caller's (the high
// pads follow from it). The device is set explicitly: this library carries
// its own CUDA runtime, whose current device is not the caller's.
int fvt_maxpool_grad(const void* x, const void* y, const void* ct, void* dx, long long n,
                     int t, int h, int w, int c, int ot, int oh, int ow, int kt, int kh, int kw,
                     int st, int sh, int sw, int pt, int ph, int pw, int dtype, int device,
                     void* stream) {
  const Geometry g{{t, h, w}, {ot, oh, ow}, {kt, kh, kw}, {st, sh, sw}, {pt, ph, pw}, c};
  for (int a = 0; a < 3; ++a)
    if (g.d[a] <= 0 || g.o[a] <= 0 || g.k[a] <= 0 || g.s[a] <= 0 || g.p[a] < 0 ||
        g.p[a] >= g.k[a] || (g.o[a] - 1) * g.s[a] - g.p[a] >= g.d[a])
      return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0 || c <= 0 || device < 0 || device >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long total = n * t * h * w * c;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return static_cast<int>(launch<__nv_bfloat16>(x, y, ct, dx, total, g, s));
    case 1: return static_cast<int>(launch<float>(x, y, ct, dx, total, g, s));
    case 2: return static_cast<int>(launch<double>(x, y, ct, dx, total, g, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
