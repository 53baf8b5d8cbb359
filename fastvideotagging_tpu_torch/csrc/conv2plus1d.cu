// Hand-written Hopper kernel for the temporal half of the factorized (2+1)D
// convolution (the spatial half, K1, is csrc/spatial_conv.cu).
//
//   K2 temporal_conv_kernel  replaces fastvideotagging_tpu/ops/conv2plus1d.py
//                            _temporal_kernel / _temporal_pallas (TPU Pallas):
//       y[b,t,s,co] = sum_{dt,c} x[b, t+dt-p, s, c] * W[dt,c,co]
//       x (B, T, S, C) bf16, W (k, C, Co) bf16 -> y (B, T, S, Co) bf16,
//       zero rows for t+dt-p outside [0, T).
//
// One implicit GEMM: output row m is an output pixel, the contraction runs
// over (tap, c), and a tap reads the input row m shifted by (da, db) along
// the two axes of the row index, or zero where the shifted row falls
// outside the frame. The TPU kernel packed the taps into the contraction
// dim inside VMEM; here a block gathers the shifted rows itself, so there
// is no halo, no padded copy and no tile that has to divide T. The tile
// routine (conv_taps_tile) takes kA x kB taps; K2 uses k x 1.
//
// Design (first, simple version): one block of 256 threads per
// (128 output rows x 64 output channels) tile. For every (tap, 32-channel
// slice) it stages the gathered A rows and the weight slice in shared
// memory (zero-filled at frame edges and at the ragged C / Co ends) and
// runs bf16 WMMA 16x16x16 products into f32 accumulators in registers; the
// next slice's global loads are issued into registers before the current
// slice's products, so one load is in flight per product. bf16 out.
// Channel rows are read 16 bytes at a time when C (for x) or Co (for W and
// y) is a multiple of 8 and the pointers allow it, else 2 bytes at a time:
// C = 45 (the stem's temporal conv) takes the scalar path.
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s): at the
// R(2+1)D-18 path shapes, bytes at stages 1-2 and operations at stages
// 3-4. This design reaches neither bound yet: WMMA through mma.sync peaks
// well below wgmma's rate, one shared stage with a barrier on each side of
// every 32-deep product leaves the tensor cores waiting on the store of the
// next slice, and every Co tile re-reads its A rows. wgmma with multi-stage
// rings and wider Co tiles (as K1 now has) are the next steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BM = 128;       // output rows per block
constexpr int BN = 64;        // output channels per block
constexpr int BK = 32;        // contraction slice (channels of one tap)
constexpr int THREADS = 256;  // 8 warps: 4 (rows) x 2 (channels), 32x32 each
constexpr int A_LD = BK + 8;  // bf16 elements per staged A row (80 B)
constexpr int B_LD = BN + 8;  // bf16 elements per staged W row (144 B)
constexpr int C_LD = BN + 4;  // f32 elements per staged output row

constexpr int A_BYTES = BM * A_LD * 2;
constexpr int B_BYTES = BK * B_LD * 2;
constexpr int C_BYTES = BM * C_LD * 4;
constexpr int SMEM_BYTES = (A_BYTES + B_BYTES) > C_BYTES ? (A_BYTES + B_BYTES) : C_BYTES;

// Scalar-path loads per thread.
constexpr int A_SCALARS = BM * BK / THREADS;  // 16
constexpr int B_SCALARS = BK * BN / THREADS;  // 8
// Vector-path (16-byte) loads per thread.
constexpr int A_VECS = BM * BK / 8 / THREADS;  // 2
constexpr int OUT_VECS = BM * BN / 8 / THREADS;  // 4
constexpr int OUT_SCALARS = BM * BN / THREADS;  // 32
static_assert(BK * BN / 8 == THREADS, "one 16-byte W load per thread");

constexpr int kOutside = -(1 << 28);  // row coordinate of a row past M

// Register staging of one (tap, channel slice) of A and W.
template <bool VA, bool VB>
struct Stage {
  uint4 av[VA ? A_VECS : 1];
  unsigned short as[VA ? 1 : A_SCALARS];
  uint4 bv;
  unsigned short bs[VB ? 1 : B_SCALARS];
};

// Output rows m = (outer * A + a) * Bd + b. A tap (da, db) reads input row
// m + da * Bd + db when 0 <= a + da < A and 0 <= b + db < Bd, else zero.
template <bool VA, bool VB>
__device__ __forceinline__ void load_stage(
    Stage<VA, VB>& st, const unsigned short* __restrict__ x,
    const unsigned short* __restrict__ w, const int* s_a, const int* s_b,
    int64_t m0, int n0, int it, int kc, int kB, int pA, int pB, int A, int Bd,
    int C, int Co) {
  const int tid = threadIdx.x;
  const int tap = it / kc;
  const int c0 = (it - tap * kc) * BK;
  const int da = tap / kB - pA;
  const int db = tap % kB - pB;
  const int64_t shift = (int64_t)da * Bd + db;
  if constexpr (VA) {
#pragma unroll
    for (int i = 0; i < A_VECS; ++i) {
      const int q = tid + i * THREADS;
      const int r = q / (BK / 8);
      const int cc = (q % (BK / 8)) * 8;
      const int a = s_a[r] + da, b = s_b[r] + db;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (a >= 0 && a < A && b >= 0 && b < Bd && c0 + cc < C) {
        v = *reinterpret_cast<const uint4*>(x + (m0 + r + shift) * C + c0 + cc);
      }
      st.av[i] = v;
    }
  } else {
#pragma unroll
    for (int i = 0; i < A_SCALARS; ++i) {
      const int e = tid + i * THREADS;
      const int r = e / BK;
      const int cc = e % BK;
      const int a = s_a[r] + da, b = s_b[r] + db;
      unsigned short v = 0;
      if (a >= 0 && a < A && b >= 0 && b < Bd && c0 + cc < C) {
        v = x[(m0 + r + shift) * C + c0 + cc];
      }
      st.as[i] = v;
    }
  }
  const unsigned short* wt = w + (int64_t)tap * C * Co;
  if constexpr (VB) {
    const int kr = tid / (BN / 8);
    const int nc = (tid % (BN / 8)) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (c0 + kr < C && n0 + nc < Co) {
      v = *reinterpret_cast<const uint4*>(wt + (int64_t)(c0 + kr) * Co + n0 + nc);
    }
    st.bv = v;
  } else {
#pragma unroll
    for (int i = 0; i < B_SCALARS; ++i) {
      const int e = tid + i * THREADS;
      const int kr = e / BN;
      const int nc = e % BN;
      unsigned short v = 0;
      if (c0 + kr < C && n0 + nc < Co) {
        v = wt[(int64_t)(c0 + kr) * Co + n0 + nc];
      }
      st.bs[i] = v;
    }
  }
}

template <bool VA, bool VB>
__device__ __forceinline__ void store_stage(const Stage<VA, VB>& st,
                                            unsigned short* As,
                                            unsigned short* Bs) {
  const int tid = threadIdx.x;
  if constexpr (VA) {
#pragma unroll
    for (int i = 0; i < A_VECS; ++i) {
      const int q = tid + i * THREADS;
      const int r = q / (BK / 8);
      const int cc = (q % (BK / 8)) * 8;
      *reinterpret_cast<uint4*>(As + r * A_LD + cc) = st.av[i];
    }
  } else {
#pragma unroll
    for (int i = 0; i < A_SCALARS; ++i) {
      const int e = tid + i * THREADS;
      As[(e / BK) * A_LD + e % BK] = st.as[i];
    }
  }
  if constexpr (VB) {
    const int kr = tid / (BN / 8);
    const int nc = (tid % (BN / 8)) * 8;
    *reinterpret_cast<uint4*>(Bs + kr * B_LD + nc) = st.bv;
  } else {
#pragma unroll
    for (int i = 0; i < B_SCALARS; ++i) {
      const int e = tid + i * THREADS;
      Bs[(e / BN) * B_LD + e % BN] = st.bs[i];
    }
  }
}

// One (BM x BN) output tile of the tap-gathered implicit GEMM.
// kA x kB taps, centred (pA = kA/2, pB = kB/2); W is (kA*kB, C, Co).
template <bool VA, bool VB>
__device__ __forceinline__ void conv_taps_tile(
    const unsigned short* __restrict__ x, const unsigned short* __restrict__ w,
    unsigned short* __restrict__ y, int64_t M, int A, int Bd, int kA, int kB,
    int C, int Co) {
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  __shared__ int s_a[BM];
  __shared__ int s_b[BM];
  unsigned short* As = reinterpret_cast<unsigned short*>(smem);
  unsigned short* Bs = reinterpret_cast<unsigned short*>(smem + A_BYTES);
  float* Cs = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int64_t m0 = (int64_t)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  if (tid < BM) {
    const int64_t m = m0 + tid;
    if (m < M) {
      s_b[tid] = (int)(m % Bd);
      s_a[tid] = (int)((m / Bd) % A);
    } else {
      s_a[tid] = kOutside;
      s_b[tid] = kOutside;
    }
  }
  __syncthreads();

  const int warp = tid / 32;
  const int wm = warp % 4;  // 32-row slab of the tile
  const int wn = warp / 4;  // 32-channel slab of the tile
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int kc = (C + BK - 1) / BK;
  const int iters = kA * kB * kc;
  const int pA = kA / 2, pB = kB / 2;
  Stage<VA, VB> st;
  load_stage<VA, VB>(st, x, w, s_a, s_b, m0, n0, 0, kc, kB, pA, pB, A, Bd, C, Co);
  for (int it = 0; it < iters; ++it) {
    store_stage<VA, VB>(st, As, Bs);
    __syncthreads();
    if (it + 1 < iters) {
      load_stage<VA, VB>(st, x, w, s_a, s_b, m0, n0, it + 1, kc, kB, pA, pB,
                         A, Bd, C, Co);
    }
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        wmma::load_matrix_sync(
            fa[i],
            reinterpret_cast<const __nv_bfloat16*>(As + (wm * 32 + i * 16) * A_LD + kk),
            A_LD);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::load_matrix_sync(
            fb[j],
            reinterpret_cast<const __nv_bfloat16*>(Bs + kk * B_LD + wn * 32 + j * 16),
            B_LD);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

  // Epilogue: f32 tile through shared memory (aliasing the A/W stage, free
  // after the loop's last barrier), rounded to bf16, masked at the M and Co
  // edges.
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * C_LD + wn * 32 + j * 16,
                              acc[i][j], C_LD, wmma::mem_row_major);
  __syncthreads();
  if constexpr (VB) {
#pragma unroll
    for (int i = 0; i < OUT_VECS; ++i) {
      const int q = tid + i * THREADS;
      const int r = q / (BN / 8);
      const int nc = (q % (BN / 8)) * 8;
      if (m0 + r < M && n0 + nc < Co) {
        const float* src = Cs + r * C_LD + nc;
        __nv_bfloat162 h[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) h[u] = __floats2bfloat162_rn(src[2 * u], src[2 * u + 1]);
        *reinterpret_cast<uint4*>(y + (m0 + r) * Co + n0 + nc) =
            *reinterpret_cast<const uint4*>(h);
      }
    }
  } else {
#pragma unroll 4
    for (int i = 0; i < OUT_SCALARS; ++i) {
      const int e = tid + i * THREADS;
      const int r = e / BN;
      const int nc = e % BN;
      if (m0 + r < M && n0 + nc < Co) {
        __nv_bfloat16 h = __float2bfloat16_rn(Cs[r * C_LD + nc]);
        y[(m0 + r) * Co + n0 + nc] = *reinterpret_cast<const unsigned short*>(&h);
      }
    }
  }
}

// K2: rows m = (b*T + t)*S + s; k taps shift t only.
template <bool VA, bool VB>
__global__ void __launch_bounds__(THREADS)
temporal_conv_kernel(const unsigned short* __restrict__ x,
                     const unsigned short* __restrict__ w,
                     unsigned short* __restrict__ y, int64_t M, int T, int S,
                     int C, int Co, int k) {
  conv_taps_tile<VA, VB>(x, w, y, M, T, S, k, 1, C, Co);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

extern "C" {

// Each entry point launches on `stream` of CUDA device `device` and returns
// cudaGetLastError() after the launch (0 on success). Shapes are validated
// here as well as in the Python wrapper. The device is set explicitly: this
// library carries its own CUDA runtime, whose current device is not the
// caller's.
int fvt_temporal_conv_bf16(const void* x, const void* w, void* y, long long b,
                           int t, int s_len, int c, int co, int k, int device,
                           void* stream) {
  if (b <= 0 || t <= 0 || s_len <= 0 || c <= 0 || co <= 0 || k <= 0 || (k % 2) == 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int64_t M = (int64_t)b * t * s_len;
  const dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((co + BN - 1) / BN));
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const bool va = (c % 8) == 0 && aligned16(x);
  const bool vb = (co % 8) == 0 && aligned16(w) && aligned16(y);
  auto xs = static_cast<const unsigned short*>(x);
  auto ws = static_cast<const unsigned short*>(w);
  auto ys = static_cast<unsigned short*>(y);
  if (va && vb)
    temporal_conv_kernel<true, true><<<grid, THREADS, 0, s>>>(xs, ws, ys, M, t, s_len, c, co, k);
  else if (va)
    temporal_conv_kernel<true, false><<<grid, THREADS, 0, s>>>(xs, ws, ys, M, t, s_len, c, co, k);
  else if (vb)
    temporal_conv_kernel<false, true><<<grid, THREADS, 0, s>>>(xs, ws, ys, M, t, s_len, c, co, k);
  else
    temporal_conv_kernel<false, false><<<grid, THREADS, 0, s>>>(xs, ws, ys, M, t, s_len, c, co, k);
  return (int)cudaGetLastError();
}

}  // extern "C"
