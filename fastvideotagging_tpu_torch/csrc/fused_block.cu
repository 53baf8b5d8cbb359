// K4: the fused (2+1)D inference block on Hopper.
//
//   fused_block_kernel  replaces fastvideotagging_tpu/ops/fused_block.py
//                       _kernel / _fused_pallas (TPU Pallas):
//       mid[b,t,s,m] = bf16(max(0, (sum_{dh,dw,c} x[b,t,h+dh-p,w+dw-p,c]
//                                   * Wsp[dh,dw,c,m]) * scale[m] + bias[m]))
//       y[b,t,s,co]  = bf16(sum_{dt,m} mid[b,t+dt-p,s,m] * Wtmp[dt,m,co])
//       x (B,T,H,W,C) bf16, Wsp (k,k,C,M) bf16, scale/bias (M,) f32 (the
//       folded BatchNorm), Wtmp (k,M,Co) bf16 -> y (B,T,H,W,Co) bf16;
//       zeros outside the frame for the spatial taps and, for the temporal
//       taps, zero mid frames outside [0,T) (zero, not ReLU(bias): the
//       boundary applies after the affine and ReLU). Stride 1, odd k.
//
// The point of the kernel is that mid (the widest tensor of the network,
// e.g. 8x16x56x56x144 bf16 = 115.6 MB at stage 1) never reaches device
// memory. Design (first, simple version): one block of 256 threads owns a
// tile of BM output pixels of one clip's H x W plane and walks T. For each
// input frame it runs the spatial GEMM (BM x k*k*C) . (k*k*C x M) in passes
// of 64 mid channels, gathering the shifted x rows itself (as K1 does: no
// halo copy) into bf16 WMMA 16x16x16 products with f32 accumulators; the
// epilogue applies scale/bias and ReLU to the f32 accumulator and writes
// bf16 mid rows into a shared-memory ring that holds the last k frames of
// mid, all M channels. One frame later (p = k/2) the temporal GEMM
// (BM x k*M) . (k*M x Co) reads the ring as its A operand, skipping the taps
// whose frame lies outside [0,T), and writes bf16 y. Since the temporal
// conv is 1x1 in space, a block never needs a neighbour's mid pixels.
//
// Shared memory: the per-row pixel coordinates, the ring, k * BM * (M
// rounded up to 32, + 8) bf16, and one staging area for the x / weight
// slices and the f32 accumulator tile. The tile plan has one source, the
// wrapper (ops/fused_block.py): it compiles this file with the tile
// constants as -D flags (FVT_NT, FVT_BK, FVT_PAD, FVT_PAD_F32), and each
// launch passes the ring's width and the bytes of shared memory it sized;
// the launch refuses a plan that does not fit the device. fused_plan picks
// BM in {128, 64, 32} so that the plan fits the 227 KB a block may use: at
// r2plus1d_18's
// stage 4 (M = 1152) only BM = 32 fits (226 KB). Where a stage's pixel
// tiles are too few to fill the card (stages 3-4: 14 x 14 and 7 x 7
// planes), the wrapper splits Co over blocks and each block recomputes mid
// for its pixels (grid z): the spatial GEMM is then done once per Co group.
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s): operations
// at every r2plus1d_18 site (stage 1, clip_batch 8: 86.3 GFLOP of taps
// inside the frame against 103 MB of x, y and weights -> 87.2 us). This
// design reaches far from it:
// WMMA through mma.sync, one shared stage with a barrier on each side of
// every 32-deep product, mid passes of 64 columns computed for M = 144
// (192 columns, a third wasted), the Co-split recompute and one block per
// SM at stage 1 (165 KB). wgmma with TMA-fed rings comes later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

#if !defined(FVT_NT) || !defined(FVT_BK) || !defined(FVT_PAD) || !defined(FVT_PAD_F32)
#error "build through ops/_build.py, which passes ops/fused_block.py's tile plan"
#endif

constexpr int THREADS = 256;        // 8 warps
constexpr int NT = FVT_NT;          // columns of one GEMM pass (mid or output channels)
constexpr int BK = FVT_BK;          // contraction slice
constexpr int PAD = FVT_PAD;        // bf16 padding per shared row
constexpr int A_LD = BK + PAD;      // bf16 elements per staged x row
constexpr int B_LD = NT + PAD;      // bf16 elements per staged weight row
constexpr int C_LD = NT + FVT_PAD_F32;  // f32 elements per staged accumulator row
constexpr int B_SCALARS = BK * NT / THREADS;  // 8
static_assert(BK * NT / 8 == THREADS, "one 16-byte weight load per thread");

constexpr int kOutside = -(1 << 28);  // pixel coordinate of a row past H*W

// BM rows: warps are WM (16 rows each) x WN, each warp FN 16-col fragments.
template <int BM>
struct Plan {
  static constexpr int WM = BM / 16;
  static constexpr int WN = 8 / WM;
  static constexpr int FN = NT / 16 / WN;
  static constexpr int A_BYTES = BM * A_LD * 2;  // x slice; the weight slice follows
  static constexpr int A_SCALARS = BM * BK / THREADS;
  static constexpr int A_VEC_TOTAL = BM * BK / 8;
  static constexpr int A_VECS = (A_VEC_TOTAL + THREADS - 1) / THREADS;
  static_assert(WM * WN == 8 && FN * 16 * WN == NT, "warp layout");
};

// Register staging of one x slice and one weight slice.
template <int BM, bool V>
struct Regs {
  uint4 av[V ? Plan<BM>::A_VECS : 1];
  unsigned short as[V ? 1 : Plan<BM>::A_SCALARS];
  uint4 bv;
  unsigned short bs[V ? 1 : B_SCALARS];
};

// Weight slice rows [r0, r0+BK) x cols [n0, n0+NT) of a (rows, cols)
// row-major matrix, zero past its edges.
template <int BM, bool V>
__device__ __forceinline__ void load_w(Regs<BM, V>& st,
                                       const unsigned short* __restrict__ wt,
                                       int r0, int rows, int n0, int cols) {
  const int tid = threadIdx.x;
  if constexpr (V) {
    const int kr = tid / (NT / 8);
    const int nc = (tid % (NT / 8)) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r0 + kr < rows && n0 + nc < cols) {
      v = *reinterpret_cast<const uint4*>(wt + (int64_t)(r0 + kr) * cols + n0 + nc);
    }
    st.bv = v;
  } else {
#pragma unroll
    for (int i = 0; i < B_SCALARS; ++i) {
      const int e = tid + i * THREADS;
      const int kr = e / NT;
      const int nc = e % NT;
      unsigned short v = 0;
      if (r0 + kr < rows && n0 + nc < cols) v = wt[(int64_t)(r0 + kr) * cols + n0 + nc];
      st.bs[i] = v;
    }
  }
}

// x slice of spatial iteration `it`: tap (dh, dw), channels [c0, c0+BK) of
// the BM pixels, gathered from one frame (H, W, C), zero outside it.
template <int BM, bool V>
__device__ __forceinline__ void load_x(Regs<BM, V>& st,
                                       const unsigned short* __restrict__ xf,
                                       const int* s_h, const int* s_w, int dh, int dw,
                                       int c0, int H, int W, int C) {
  using P = Plan<BM>;
  const int tid = threadIdx.x;
  if constexpr (V) {
#pragma unroll
    for (int i = 0; i < P::A_VECS; ++i) {
      const int q = tid + i * THREADS;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (q < P::A_VEC_TOTAL) {
        const int r = q / (BK / 8);
        const int cc = (q % (BK / 8)) * 8;
        const int hh = s_h[r] + dh, ww = s_w[r] + dw;
        if (hh >= 0 && hh < H && ww >= 0 && ww < W && c0 + cc < C) {
          v = *reinterpret_cast<const uint4*>(xf + ((int64_t)hh * W + ww) * C + c0 + cc);
        }
      }
      st.av[i] = v;
    }
  } else {
#pragma unroll
    for (int i = 0; i < P::A_SCALARS; ++i) {
      const int e = tid + i * THREADS;
      const int r = e / BK;
      const int cc = e % BK;
      const int hh = s_h[r] + dh, ww = s_w[r] + dw;
      unsigned short v = 0;
      if (hh >= 0 && hh < H && ww >= 0 && ww < W && c0 + cc < C) {
        v = xf[((int64_t)hh * W + ww) * C + c0 + cc];
      }
      st.as[i] = v;
    }
  }
}

template <int BM, bool V>
__device__ __forceinline__ void store_x(const Regs<BM, V>& st, unsigned short* As) {
  using P = Plan<BM>;
  const int tid = threadIdx.x;
  if constexpr (V) {
#pragma unroll
    for (int i = 0; i < P::A_VECS; ++i) {
      const int q = tid + i * THREADS;
      if (q < P::A_VEC_TOTAL) {
        *reinterpret_cast<uint4*>(As + (q / (BK / 8)) * A_LD + (q % (BK / 8)) * 8) = st.av[i];
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < P::A_SCALARS; ++i) {
      const int e = tid + i * THREADS;
      As[(e / BK) * A_LD + e % BK] = st.as[i];
    }
  }
}

template <int BM, bool V>
__device__ __forceinline__ void store_w(const Regs<BM, V>& st, unsigned short* Bs) {
  const int tid = threadIdx.x;
  if constexpr (V) {
    *reinterpret_cast<uint4*>(Bs + (tid / (NT / 8)) * B_LD + (tid % (NT / 8)) * 8) = st.bv;
  } else {
#pragma unroll
    for (int i = 0; i < B_SCALARS; ++i) {
      const int e = tid + i * THREADS;
      Bs[(e / NT) * B_LD + e % NT] = st.bs[i];
    }
  }
}

// acc[j] += A (this warp's 16 rows, BK deep, leading dim lda) . Bs
template <int BM>
__device__ __forceinline__ void mma_slice(
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> (&acc)[Plan<BM>::FN],
    const unsigned short* A, int lda, const unsigned short* Bs, int wc) {
  using P = Plan<BM>;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
    wmma::load_matrix_sync(fa, reinterpret_cast<const __nv_bfloat16*>(A + kk), lda);
#pragma unroll
    for (int j = 0; j < P::FN; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
      wmma::load_matrix_sync(
          fb, reinterpret_cast<const __nv_bfloat16*>(Bs + kk * B_LD + (wc * P::FN + j) * 16),
          B_LD);
      wmma::mma_sync(acc[j], fa, fb, acc[j]);
    }
  }
}

template <int BM>
__device__ __forceinline__ void store_acc(
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> (&acc)[Plan<BM>::FN],
    float* Cs, int wr, int wc) {
  using P = Plan<BM>;
#pragma unroll
  for (int j = 0; j < P::FN; ++j) {
    wmma::store_matrix_sync(Cs + (wr * 16) * C_LD + (wc * P::FN + j) * 16, acc[j], C_LD,
                            wmma::mem_row_major);
  }
}

template <int BM, bool V>
__global__ void __launch_bounds__(THREADS)
fused_block_kernel(const unsigned short* __restrict__ x,
                   const unsigned short* __restrict__ w_sp,
                   const float* __restrict__ scale, const float* __restrict__ bias,
                   const unsigned short* __restrict__ w_tmp,
                   unsigned short* __restrict__ y, int T, int H, int W, int C, int M,
                   int Co, int k, int co_tiles_per_group, int MR) {
  using P = Plan<BM>;
  // [s_h, s_w: BM ints each | ring: k * BM * LDR bf16 | staging area]
  extern __shared__ __align__(128) unsigned char smem[];
  int* s_h = reinterpret_cast<int*>(smem);
  int* s_w = s_h + BM;
  const int LDR = MR + PAD;
  unsigned short* ring = reinterpret_cast<unsigned short*>(smem + 2 * BM * sizeof(int));
  unsigned char* stage = reinterpret_cast<unsigned char*>(ring) + (size_t)k * BM * LDR * 2;
  unsigned short* As = reinterpret_cast<unsigned short*>(stage);
  unsigned short* Bs = reinterpret_cast<unsigned short*>(stage + P::A_BYTES);
  float* Cs = reinterpret_cast<float*>(stage);

  const int tid = threadIdx.x;
  const int HW = H * W;
  const int s0 = blockIdx.x * BM;
  const int b = blockIdx.y;
  const int n_co_tiles = (Co + NT - 1) / NT;
  const int ct_begin = blockIdx.z * co_tiles_per_group;
  const int ct_end = min(ct_begin + co_tiles_per_group, n_co_tiles);
  if (tid < BM) {
    const int s = s0 + tid;
    s_h[tid] = s < HW ? s / W : kOutside;
    s_w[tid] = s < HW ? s % W : kOutside;
  }
  __syncthreads();

  const int warp = tid / 32;
  const int wr = warp % P::WM;  // 16-row slab
  const int wc = warp / P::WM;  // column slab of FN fragments
  const int p = k / 2;
  const int kc = (C + BK - 1) / BK;
  const int kcm = MR / BK;
  const int64_t frame_x = (int64_t)HW * C;
  const int64_t frame_y = (int64_t)HW * Co;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[P::FN];
  Regs<BM, V> st;

  for (int t_in = 0; t_in < T + p; ++t_in) {
    // 1) mid of frame t_in -> ring slot t_in % k, in passes of NT channels.
    if (t_in < T) {
      unsigned short* slot = ring + (size_t)(t_in % k) * BM * LDR;
      const unsigned short* xf = x + ((int64_t)b * T + t_in) * frame_x;
      const int iters = k * k * kc;
      for (int m0 = 0; m0 < MR; m0 += NT) {
#pragma unroll
        for (int j = 0; j < P::FN; ++j) wmma::fill_fragment(acc[j], 0.0f);
        load_x<BM, V>(st, xf, s_h, s_w, -p, -p, 0, H, W, C);
        load_w<BM, V>(st, w_sp, 0, C, m0, M);
        for (int it = 0; it < iters; ++it) {
          store_x<BM, V>(st, As);
          store_w<BM, V>(st, Bs);
          __syncthreads();
          if (it + 1 < iters) {
            const int tap = (it + 1) / kc;
            const int c0 = ((it + 1) - tap * kc) * BK;
            load_x<BM, V>(st, xf, s_h, s_w, tap / k - p, tap % k - p, c0, H, W, C);
            load_w<BM, V>(st, w_sp + (int64_t)tap * C * M, c0, C, m0, M);
          }
          mma_slice<BM>(acc, As + (wr * 16) * A_LD, A_LD, Bs, wc);
          __syncthreads();
        }
        store_acc<BM>(acc, Cs, wr, wc);
        __syncthreads();
        // epilogue on the f32 accumulator: folded BN, ReLU, bf16; columns
        // in [M, MR) are zero so the temporal GEMM may read whole slices
        for (int e = tid; e < BM * NT; e += THREADS) {
          const int r = e / NT;
          const int m = m0 + e % NT;
          if (m < MR) {
            float v = 0.0f;
            if (m < M) {
              v = fmaxf(__fadd_rn(__fmul_rn(Cs[r * C_LD + e % NT], scale[m]), bias[m]), 0.0f);
            }
            slot[r * LDR + m] = __bfloat16_as_ushort(__float2bfloat16_rn(v));
          }
        }
        __syncthreads();
      }
    }
    // 2) y of frame t_out from the ring: taps whose frame lies outside
    // [0, T) are skipped (they contribute zero).
    const int t_out = t_in - p;
    if (t_out < 0) continue;
    const int dt0 = max(0, p - t_out);
    const int dt1 = min(k - 1, T - 1 - t_out + p);
    const int iters = (dt1 - dt0 + 1) * kcm;
    unsigned short* yf = y + ((int64_t)b * T + t_out) * frame_y;
    for (int ct = ct_begin; ct < ct_end; ++ct) {
      const int co0 = ct * NT;
#pragma unroll
      for (int j = 0; j < P::FN; ++j) wmma::fill_fragment(acc[j], 0.0f);
      load_w<BM, V>(st, w_tmp + (int64_t)dt0 * M * Co, 0, M, co0, Co);
      for (int it = 0; it < iters; ++it) {
        store_w<BM, V>(st, Bs);
        __syncthreads();
        const int dt = dt0 + it / kcm;
        const int mb = (it % kcm) * BK;
        if (it + 1 < iters) {
          const int dtn = dt0 + (it + 1) / kcm;
          load_w<BM, V>(st, w_tmp + (int64_t)dtn * M * Co, ((it + 1) % kcm) * BK, M, co0, Co);
        }
        const int f = t_out + dt - p;
        const unsigned short* a =
            ring + (size_t)(f % k) * BM * LDR + (size_t)(wr * 16) * LDR + mb;
        mma_slice<BM>(acc, a, LDR, Bs, wc);
        __syncthreads();
      }
      store_acc<BM>(acc, Cs, wr, wc);
      __syncthreads();
      if constexpr (V) {
        for (int q = tid; q < BM * NT / 8; q += THREADS) {
          const int r = q / (NT / 8);
          const int nc = (q % (NT / 8)) * 8;
          if (s0 + r < HW && co0 + nc < Co) {
            const float* src = Cs + r * C_LD + nc;
            __nv_bfloat162 h[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) h[u] = __floats2bfloat162_rn(src[2 * u], src[2 * u + 1]);
            *reinterpret_cast<uint4*>(yf + (int64_t)(s0 + r) * Co + co0 + nc) =
                *reinterpret_cast<const uint4*>(h);
          }
        }
      } else {
        for (int e = tid; e < BM * NT; e += THREADS) {
          const int r = e / NT;
          const int nc = e % NT;
          if (s0 + r < HW && co0 + nc < Co) {
            yf[(int64_t)(s0 + r) * Co + co0 + nc] =
                __bfloat16_as_ushort(__float2bfloat16_rn(Cs[r * C_LD + nc]));
          }
        }
      }
      __syncthreads();
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <int BM, bool V>
int launch(const void* x, const void* w_sp, const void* scale, const void* bias,
           const void* w_tmp, void* y, long long b, int t, int h, int w, int c, int m,
           int co, int k, int co_tiles_per_group, int mr, int smem, cudaStream_t s) {
  auto kern = fused_block_kernel<BM, V>;
  // a plan larger than the device's opt-in shared memory is refused here
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_co_tiles = (co + NT - 1) / NT;
  const dim3 grid((unsigned)((h * w + BM - 1) / BM), (unsigned)b,
                  (unsigned)((n_co_tiles + co_tiles_per_group - 1) / co_tiles_per_group));
  kern<<<grid, THREADS, smem, s>>>(
      static_cast<const unsigned short*>(x), static_cast<const unsigned short*>(w_sp),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<const unsigned short*>(w_tmp), static_cast<unsigned short*>(y), t, h, w, c,
      m, co, k, co_tiles_per_group, mr);
  return (int)cudaGetLastError();
}

template <int BM>
int launch_bm(bool v, const void* x, const void* w_sp, const void* scale, const void* bias,
              const void* w_tmp, void* y, long long b, int t, int h, int w, int c, int m,
              int co, int k, int per, int mr, int smem, cudaStream_t s) {
  return v ? launch<BM, true>(x, w_sp, scale, bias, w_tmp, y, b, t, h, w, c, m, co, k, per,
                              mr, smem, s)
           : launch<BM, false>(x, w_sp, scale, bias, w_tmp, y, b, t, h, w, c, m, co, k, per,
                               mr, smem, s);
}

}  // namespace

extern "C" {

// Launches K4 on `stream` of CUDA device `device`; returns cudaGetLastError()
// after the launch (0 on success). The plan is the wrapper's
// (ops/fused_block.py): `bm` (pixel rows per block: 32, 64 or 128),
// `co_tiles_per_group` (NT-wide Co tiles per block), `mr` (mid channels a
// ring row holds, M rounded up to BK) and `smem` (the block's bytes of
// shared memory), which must fit the device.
int fvt_fused_block_bf16(const void* x, const void* w_sp, const void* scale,
                         const void* bias, const void* w_tmp, void* y, long long b,
                         int t, int h, int w, int c, int m, int co, int k, int bm,
                         int co_tiles_per_group, int mr, int smem, int device,
                         void* stream) {
  if (b <= 0 || b > 65535 || t <= 0 || h <= 0 || w <= 0 || c <= 0 || m <= 0 || co <= 0 ||
      k <= 0 || (k % 2) == 0 || co_tiles_per_group <= 0 || mr < m || mr % BK != 0 || smem <= 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const bool v = (c % 8) == 0 && (m % 8) == 0 && (co % 8) == 0 && aligned16(x) &&
                 aligned16(w_sp) && aligned16(w_tmp) && aligned16(y);
  switch (bm) {
    case 32:
      return launch_bm<32>(v, x, w_sp, scale, bias, w_tmp, y, b, t, h, w, c, m, co, k,
                           co_tiles_per_group, mr, smem, s);
    case 64:
      return launch_bm<64>(v, x, w_sp, scale, bias, w_tmp, y, b, t, h, w, c, m, co, k,
                           co_tiles_per_group, mr, smem, s);
    case 128:
      return launch_bm<128>(v, x, w_sp, scale, bias, w_tmp, y, b, t, h, w, c, m, co, k,
                            co_tiles_per_group, mr, smem, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
