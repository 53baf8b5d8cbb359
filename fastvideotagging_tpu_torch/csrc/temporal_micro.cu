// Hand-written Hopper kernels for the temporal-conv micro-benchmark
// (fastvideotagging_tpu_torch/benchmarks/kernel_micro.py): five designs of
// the temporal k x 1 x 1 conv, each the counterpart of one Pallas kernel in
// the JAX package's benchmarks/kernel_micro.py.
//
//   y[b,t,s,co]  = sum_{dt,c} x[b, t+dt-p, s, c] * w[dt,c,co]   (zero frames
//                  outside [0, T), p = k/2, odd k)
//   dw[dt,c,co]  = sum_{b,t,s} x[b, t+dt-p, s, c] * g[b,t,s,co]
//   x (B, T, S, C), w (k, C, Co), g (B, T, S, Co) bf16; y bf16, dw f32.
//
//   K5 v2   (pallas_temporal_v2, :91)      micro_pad_kernel pads x on T (the
//           counterpart of jnp.pad), then micro_fwd_kernel<kV2> reads the
//           halo'd slab: every tap of every row lies inside the padded x.
//   K6 v3   (pallas_temporal_v3, :155)     micro_fwd_kernel<kV3>: no pad; the
//           centre tap first, then each other tap over the rows of the tile
//           whose shifted frame lies in [0, T) (the range clipped per tap; a
//           tap whose range misses the tile is skipped, and a warp whose
//           rows miss it skips its products). The dx is this kernel on the
//           flipped, io-transposed weight (made by the Python wrapper).
//   K8 v3p  (pallas_temporal_v3p, :241)    micro_fwd_kernel<kV3P>: one
//           contraction over kappa = dt*C + c, k*C deep, in 32-deep slices
//           that may straddle taps; the A loader writes zeros for rows whose
//           frame lies outside [0, T).
//   K7 dw_v3 (pallas_temporal_dw_v3, :200) micro_dw_kernel<kDwV3>: per tap,
//           x^T g over the rows whose shifted frame lies in [0, T).
//   K9 dw_v2 (pallas_temporal_dw, :297)    micro_pad_kernel, then
//           micro_dw_kernel<kDwV2> over every row of the padded x.
//
// The forward kernels share one GEMM core and differ only in how A is
// addressed; so do the two dw kernels. Rows are taken as the TPU grid cut
// them: a slab is one clip b and one s-tile j of tile_s columns, its T *
// tile_s rows t-major (row r = t * tile_s + s_local), and the tile_s rule is
// the variant's (v2: halved from 512 until it divides S; v3: the largest
// divisor of S up to max_tile). A forward block owns BM = 128 rows of one
// slab and BN = 64 output channels. A dw block owns one tap and a 64 x 64
// (C, Co) tile and walks a chunk of (b, s-tile) slabs, 32 rows a slice. The
// TPU dw kernels add into one output block over a grid that runs in order;
// here each chunk writes an f32 partial and micro_reduce_kernel adds the
// partials in chunk order (no atomics: two launches are bitwise equal).
//
// The core is the first, simple one: bf16 WMMA 16x16x16 products into f32
// accumulators in registers, one shared stage, the next slice's global
// loads held in registers while the current slice's products run. Channel
// rows are read 16 bytes at a time where C (for x), Co (for w, g and y) is a
// multiple of 8 and the pointers are 16-byte aligned, else 2 bytes at a time
// (ragged widths are masked).
//
// What bounds them on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s): bytes, at
// every benchmark shape (tpu1: x and y 822 MB against 158 GFLOP, 0.245 ms).
// This design reaches neither bound: WMMA peaks well below wgmma, one
// stage leaves the loads exposed, each 64-wide Co tile re-reads its A rows
// (each tap re-reads the frames), and K5 / K9 move x twice more through the
// pad pass. Making them fast (wgmma, a cp.async or TMA ring) is not this
// source's aim: the benchmark compares the designs' addressing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <algorithm>

using namespace nvcuda;

namespace {

enum Forward { kV2 = 0, kV3 = 1, kV3P = 2 };
enum Grad { kDwV3 = 0, kDwV2 = 1 };

constexpr int kOutside = -(1 << 28);  // frame of a row past the slab

// ---------------------------------------------------------------------------
// Forward core: a BM x BN tile of y, the contraction in BK-deep slices
// ---------------------------------------------------------------------------

constexpr int BM = 128;       // output rows per block (of one slab)
constexpr int BN = 64;        // output channels per block
constexpr int BK = 32;        // contraction slice
constexpr int THREADS = 256;  // 8 warps: 4 (rows) x 2 (channels), 32 x 32 each
constexpr int A_LD = BK + 8;  // bf16 a staged A row (80 B)
constexpr int B_LD = BN + 8;  // bf16 a staged W row (144 B)
constexpr int C_LD = BN + 4;  // f32 a staged output row
constexpr int A_BYTES = BM * A_LD * 2;
constexpr int B_BYTES = BK * B_LD * 2;
constexpr int C_BYTES = BM * C_LD * 4;
constexpr int SMEM_BYTES = (A_BYTES + B_BYTES) > C_BYTES ? (A_BYTES + B_BYTES) : C_BYTES;
constexpr int A_SCALARS = BM * BK / THREADS;     // 16
constexpr int A_VECS = BM * BK / 8 / THREADS;    // 2
constexpr int B_SCALARS = BK * BN / THREADS;     // 8
constexpr int OUT_VECS = BM * BN / 8 / THREADS;  // 4
constexpr int OUT_SCALARS = BM * BN / THREADS;   // 32
static_assert(BK * BN / 8 == THREADS, "one 16-byte W load per thread");

// One slice of the contraction: kappa = tap * C + c in [kbase, kbase + BK),
// valid below klimit. W as (k * C, Co) has row kappa. For v2 / v3 a slice
// lies in one tap (klimit = its end); for v3p it runs over k * C.
struct Slice {
  int kbase;
  int klimit;
  int lo, hi;  // v3: the tile's rows [lo, hi) that the slice's tap reaches
};

template <bool VA, bool VB>
struct Stage {
  uint4 av[VA ? A_VECS : 1];
  unsigned short as[VA ? 1 : A_SCALARS];
  uint4 bv;
  unsigned short bs[VB ? 1 : B_SCALARS];
};

// The x element offset of A's (row r, kappa), or -1 where it is zero: a row
// past the slab, kappa past the slice, or (v3, v3p) a frame outside [0, T).
// v2 reads the padded x, whose frames t + dt all exist.
template <int V>
__device__ __forceinline__ int64_t a_offset(const int* s_t, const int64_t* s_x, int r,
                                            int kappa, int klimit, int T, int S, int C,
                                            int p) {
  const int t = s_t[r];
  if (t < 0 || kappa >= klimit) return -1;
  const int tap = kappa / C;
  const int c = kappa - tap * C;
  const int frame = V == kV2 ? t + tap : t + tap - p;
  if (V != kV2 && (frame < 0 || frame >= T)) return -1;
  return (s_x[r] + (int64_t)frame * S) * C + c;
}

template <int V, bool VA, bool VB>
__device__ __forceinline__ void load_stage(Stage<VA, VB>& st, const unsigned short* __restrict__ x,
                                           const unsigned short* __restrict__ w, const int* s_t,
                                           const int64_t* s_x, const Slice& sl, int n0, int T,
                                           int S, int C, int Co, int p) {
  const int tid = threadIdx.x;
  if constexpr (VA) {
#pragma unroll
    for (int i = 0; i < A_VECS; ++i) {
      const int q = tid + i * THREADS;
      const int r = q / (BK / 8);
      const int cc = (q % (BK / 8)) * 8;
      const int64_t off = a_offset<V>(s_t, s_x, r, sl.kbase + cc, sl.klimit, T, S, C, p);
      st.av[i] = off >= 0 ? *reinterpret_cast<const uint4*>(x + off) : make_uint4(0, 0, 0, 0);
    }
  } else {
#pragma unroll
    for (int i = 0; i < A_SCALARS; ++i) {
      const int e = tid + i * THREADS;
      const int64_t off = a_offset<V>(s_t, s_x, e / BK, sl.kbase + e % BK, sl.klimit, T, S, C, p);
      st.as[i] = off >= 0 ? x[off] : (unsigned short)0;
    }
  }
  if constexpr (VB) {
    const int kr = tid / (BN / 8);
    const int nc = (tid % (BN / 8)) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (sl.kbase + kr < sl.klimit && n0 + nc < Co) {
      v = *reinterpret_cast<const uint4*>(w + (int64_t)(sl.kbase + kr) * Co + n0 + nc);
    }
    st.bv = v;
  } else {
#pragma unroll
    for (int i = 0; i < B_SCALARS; ++i) {
      const int e = tid + i * THREADS;
      const int kr = e / BN;
      const int nc = e % BN;
      unsigned short v = 0;
      if (sl.kbase + kr < sl.klimit && n0 + nc < Co) {
        v = w[(int64_t)(sl.kbase + kr) * Co + n0 + nc];
      }
      st.bs[i] = v;
    }
  }
}

template <bool VA, bool VB>
__device__ __forceinline__ void store_stage(const Stage<VA, VB>& st, unsigned short* As,
                                            unsigned short* Bs) {
  const int tid = threadIdx.x;
  if constexpr (VA) {
#pragma unroll
    for (int i = 0; i < A_VECS; ++i) {
      const int q = tid + i * THREADS;
      *reinterpret_cast<uint4*>(As + (q / (BK / 8)) * A_LD + (q % (BK / 8)) * 8) = st.av[i];
    }
  } else {
#pragma unroll
    for (int i = 0; i < A_SCALARS; ++i) {
      const int e = tid + i * THREADS;
      As[(e / BK) * A_LD + e % BK] = st.as[i];
    }
  }
  if constexpr (VB) {
    *reinterpret_cast<uint4*>(Bs + (tid / (BN / 8)) * B_LD + (tid % (BN / 8)) * 8) = st.bv;
  } else {
#pragma unroll
    for (int i = 0; i < B_SCALARS; ++i) {
      const int e = tid + i * THREADS;
      Bs[(e / BN) * B_LD + e % BN] = st.bs[i];
    }
  }
}

// The tap of v3's q-th position: the centre first, then the others in order.
__device__ __forceinline__ int v3_tap(int q, int p) { return q == 0 ? p : (q - 1 < p ? q - 1 : q); }

// The forward kernels. x is the padded x (Tx = T + 2p frames) for v2, else
// x (Tx = T). Block x: slab * row_tiles + row tile; block y: Co tile.
template <int V, bool VA, bool VB>
__global__ void __launch_bounds__(THREADS)
micro_fwd_kernel(const unsigned short* __restrict__ x, const unsigned short* __restrict__ w,
                 unsigned short* __restrict__ y, int T, int Tx, int S, int C, int Co, int k,
                 int tile_s, int row_tiles) {
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  __shared__ int s_t[BM];
  __shared__ int64_t s_x[BM];  // x row of (b, frame 0, s)
  __shared__ int64_t s_y[BM];  // y row of (b, t, s)
  unsigned short* As = reinterpret_cast<unsigned short*>(smem);
  unsigned short* Bs = reinterpret_cast<unsigned short*>(smem + A_BYTES);
  float* Cs = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int slab = blockIdx.x / row_tiles;
  const int r0 = (blockIdx.x % row_tiles) * BM;
  const int nj = S / tile_s;
  const int bb = slab / nj;
  const int s0 = (slab % nj) * tile_s;
  const int R = T * tile_s;  // rows of the slab
  const int n0 = blockIdx.y * BN;
  const int p = k / 2;
  if (tid < BM) {
    const int r = r0 + tid;
    if (r < R) {
      const int t = r / tile_s;
      const int s = s0 + r % tile_s;
      s_t[tid] = t;
      s_x[tid] = (int64_t)bb * Tx * S + s;
      s_y[tid] = ((int64_t)bb * T + t) * S + s;
    } else {
      s_t[tid] = kOutside;
    }
  }
  __syncthreads();

  // The slices: v2 k taps x kc, v3 the same in v3_tap's order less the
  // taps whose rows miss the tile, v3p ceil(k * C / BK) over kappa.
  const int kc = (C + BK - 1) / BK;
  const int n_slices = V == kV3P ? (k * C + BK - 1) / BK : k * kc;
  const int rows_end = min(R - r0, BM);
  auto tap_rows = [&](int tap, int& lo, int& hi) {  // the tile's rows the tap reaches
    const int off = tap - p;
    lo = max(max(0, -off) * tile_s - r0, 0);
    hi = min((T - max(0, off)) * tile_s - r0, rows_end);
  };
  auto slice_at = [&](int i) {
    Slice sl{0, 0, 0, BM};
    if constexpr (V == kV3P) {
      sl.kbase = i * BK;
      sl.klimit = k * C;
    } else {
      const int tap = V == kV3 ? v3_tap(i / kc, p) : i / kc;
      sl.kbase = tap * C + (i % kc) * BK;
      sl.klimit = tap * C + C;
      if constexpr (V == kV3) tap_rows(tap, sl.lo, sl.hi);
    }
    return sl;
  };
  auto next_slice = [&](int i) {  // the slice after i (v3: skipping taps that miss the tile)
    ++i;
    if constexpr (V == kV3) {
      while (i < n_slices) {
        int lo, hi;
        tap_rows(v3_tap(i / kc, p), lo, hi);
        if (lo < hi) break;
        i = (i / kc + 1) * kc;
      }
    }
    return i;
  };

  const int warp = tid / 32;
  const int wm = warp % 4;  // 32-row slab of the tile
  const int wn = warp / 4;  // 32-channel slab of the tile
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  Stage<VA, VB> st;
  int it = next_slice(-1);
  Slice cur = slice_at(it < n_slices ? it : 0);
  if (it < n_slices) load_stage<V, VA, VB>(st, x, w, s_t, s_x, cur, n0, T, S, C, Co, p);
  while (it < n_slices) {
    store_stage<VA, VB>(st, As, Bs);
    __syncthreads();
    const int nxt = next_slice(it);
    const Slice sl = cur;
    if (nxt < n_slices) {
      cur = slice_at(nxt);
      load_stage<V, VA, VB>(st, x, w, s_t, s_x, cur, n0, T, S, C, Co, p);
    }
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::load_matrix_sync(
            fb[j], reinterpret_cast<const __nv_bfloat16*>(Bs + kk * B_LD + wn * 32 + j * 16), B_LD);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = wm * 32 + i * 16;
        if (row + 16 <= sl.lo || row >= sl.hi) continue;  // rows the tap does not reach
        wmma::load_matrix_sync(
            fa[i], reinterpret_cast<const __nv_bfloat16*>(As + row * A_LD + kk), A_LD);
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
    }
    __syncthreads();
    it = nxt;
  }

  // Epilogue: the f32 tile through shared memory (aliasing the stage, free
  // after the loop's last barrier), rounded to bf16, masked at the slab's
  // end and at Co.
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * C_LD + wn * 32 + j * 16, acc[i][j], C_LD,
                              wmma::mem_row_major);
  __syncthreads();
  if constexpr (VB) {
#pragma unroll
    for (int i = 0; i < OUT_VECS; ++i) {
      const int q = tid + i * THREADS;
      const int r = q / (BN / 8);
      const int nc = (q % (BN / 8)) * 8;
      if (s_t[r] >= 0 && n0 + nc < Co) {
        const float* src = Cs + r * C_LD + nc;
        __nv_bfloat162 h[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) h[u] = __floats2bfloat162_rn(src[2 * u], src[2 * u + 1]);
        *reinterpret_cast<uint4*>(y + s_y[r] * Co + n0 + nc) = *reinterpret_cast<const uint4*>(h);
      }
    }
  } else {
#pragma unroll 4
    for (int i = 0; i < OUT_SCALARS; ++i) {
      const int e = tid + i * THREADS;
      const int r = e / BN;
      const int nc = e % BN;
      if (s_t[r] >= 0 && n0 + nc < Co) {
        __nv_bfloat16 h = __float2bfloat16_rn(Cs[r * C_LD + nc]);
        y[s_y[r] * Co + n0 + nc] = *reinterpret_cast<const unsigned short*>(&h);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// dw core: one tap's DM x DN tile of dw over a chunk of slabs, DK rows a slice
// ---------------------------------------------------------------------------

constexpr int DM = 64;         // input channels per block
constexpr int DN = 64;         // output channels per block
constexpr int DK = 32;         // rows per slice
constexpr int DTHREADS = 128;  // 4 warps: 2 (C) x 2 (Co), 32 x 32 each
constexpr int X_LD = DM + 8;
constexpr int G_LD = DN + 8;
constexpr int D_LD = DN + 4;
constexpr int X_BYTES = DK * X_LD * 2;
constexpr int G_BYTES = DK * G_LD * 2;
constexpr int D_BYTES = DM * D_LD * 4;
constexpr int DSMEM_BYTES = (X_BYTES + G_BYTES) > D_BYTES ? (X_BYTES + G_BYTES) : D_BYTES;
constexpr int D_SCALARS = DK * DM / DTHREADS;    // 16 (DM == DN)
constexpr int D_VECS = DK * DM / 8 / DTHREADS;   // 2
constexpr int DOUT_SCALARS = DM * DN / DTHREADS; // 32
static_assert(DM == DN, "x and g slices share their load counts");

template <bool VX, bool VG>
struct DwStage {
  uint4 xv[VX ? D_VECS : 1];
  unsigned short xs[VX ? 1 : D_SCALARS];
  uint4 gv[VG ? D_VECS : 1];
  unsigned short gs[VG ? 1 : D_SCALARS];
};

// One slice: rows [r, r + DK) of slab `step`, below hi.
template <int V, bool VX, bool VG>
__device__ __forceinline__ void load_dw_stage(DwStage<VX, VG>& st,
                                              const unsigned short* __restrict__ x,
                                              const unsigned short* __restrict__ g, int step,
                                              int r, int hi, int tap, int c0, int n0, int T,
                                              int Tx, int S, int C, int Co, int tile_s, int p) {
  const int tid = threadIdx.x;
  const int nj = S / tile_s;
  const int64_t bb = step / nj;
  const int s0 = (step % nj) * tile_s;
  // the g row and the x row of slice row rr, or -1 past hi
  auto rows = [&](int rr, int64_t& grow, int64_t& xrow) {
    const int row = r + rr;
    if (row >= hi) {
      grow = xrow = -1;
      return;
    }
    const int t = row / tile_s;
    const int s = s0 + row % tile_s;
    grow = (bb * T + t) * S + s;
    xrow = (bb * Tx + (V == kDwV2 ? t + tap : t + tap - p)) * S + s;
  };
  if constexpr (VX && VG) {
#pragma unroll
    for (int i = 0; i < D_VECS; ++i) {
      const int q = tid + i * DTHREADS;
      const int rr = q / (DM / 8);
      const int cc = (q % (DM / 8)) * 8;
      int64_t grow, xrow;
      rows(rr, grow, xrow);
      st.xv[i] = xrow >= 0 && c0 + cc < C ? *reinterpret_cast<const uint4*>(x + xrow * C + c0 + cc)
                                          : make_uint4(0, 0, 0, 0);
      st.gv[i] = grow >= 0 && n0 + cc < Co
                     ? *reinterpret_cast<const uint4*>(g + grow * Co + n0 + cc)
                     : make_uint4(0, 0, 0, 0);
    }
  } else {
    if constexpr (VX) {
#pragma unroll
      for (int i = 0; i < D_VECS; ++i) {
        const int q = tid + i * DTHREADS;
        const int cc = (q % (DM / 8)) * 8;
        int64_t grow, xrow;
        rows(q / (DM / 8), grow, xrow);
        st.xv[i] = xrow >= 0 && c0 + cc < C
                       ? *reinterpret_cast<const uint4*>(x + xrow * C + c0 + cc)
                       : make_uint4(0, 0, 0, 0);
      }
    } else {
#pragma unroll
      for (int i = 0; i < D_SCALARS; ++i) {
        const int e = tid + i * DTHREADS;
        const int cc = e % DM;
        int64_t grow, xrow;
        rows(e / DM, grow, xrow);
        st.xs[i] = xrow >= 0 && c0 + cc < C ? x[xrow * C + c0 + cc] : (unsigned short)0;
      }
    }
    if constexpr (VG) {
#pragma unroll
      for (int i = 0; i < D_VECS; ++i) {
        const int q = tid + i * DTHREADS;
        const int nc = (q % (DN / 8)) * 8;
        int64_t grow, xrow;
        rows(q / (DN / 8), grow, xrow);
        st.gv[i] = grow >= 0 && n0 + nc < Co
                       ? *reinterpret_cast<const uint4*>(g + grow * Co + n0 + nc)
                       : make_uint4(0, 0, 0, 0);
      }
    } else {
#pragma unroll
      for (int i = 0; i < D_SCALARS; ++i) {
        const int e = tid + i * DTHREADS;
        const int nc = e % DN;
        int64_t grow, xrow;
        rows(e / DN, grow, xrow);
        st.gs[i] = grow >= 0 && n0 + nc < Co ? g[grow * Co + n0 + nc] : (unsigned short)0;
      }
    }
  }
}

template <bool VX, bool VG>
__device__ __forceinline__ void store_dw_stage(const DwStage<VX, VG>& st, unsigned short* Xs,
                                               unsigned short* Gs) {
  const int tid = threadIdx.x;
  if constexpr (VX) {
#pragma unroll
    for (int i = 0; i < D_VECS; ++i) {
      const int q = tid + i * DTHREADS;
      *reinterpret_cast<uint4*>(Xs + (q / (DM / 8)) * X_LD + (q % (DM / 8)) * 8) = st.xv[i];
    }
  } else {
#pragma unroll
    for (int i = 0; i < D_SCALARS; ++i) {
      const int e = tid + i * DTHREADS;
      Xs[(e / DM) * X_LD + e % DM] = st.xs[i];
    }
  }
  if constexpr (VG) {
#pragma unroll
    for (int i = 0; i < D_VECS; ++i) {
      const int q = tid + i * DTHREADS;
      *reinterpret_cast<uint4*>(Gs + (q / (DN / 8)) * G_LD + (q % (DN / 8)) * 8) = st.gv[i];
    }
  } else {
#pragma unroll
    for (int i = 0; i < D_SCALARS; ++i) {
      const int e = tid + i * DTHREADS;
      Gs[(e / DN) * G_LD + e % DN] = st.gs[i];
    }
  }
}

// The dw kernels. x is the padded x (Tx = T + 2p frames) for dw_v2, else x
// (Tx = T). Block x: (tap * c_tiles + C tile) * co_tiles + Co tile; block y:
// chunk. Writes its tile of part[chunk] (k, C, Co), zero where no row
// reaches it.
template <int V, bool VX, bool VG>
__global__ void __launch_bounds__(DTHREADS)
micro_dw_kernel(const unsigned short* __restrict__ x, const unsigned short* __restrict__ g,
                float* __restrict__ part, int T, int Tx, int S, int C, int Co, int k, int tile_s,
                int steps, int steps_per_chunk) {
  __shared__ __align__(128) unsigned char smem[DSMEM_BYTES];
  unsigned short* Xs = reinterpret_cast<unsigned short*>(smem);
  unsigned short* Gs = reinterpret_cast<unsigned short*>(smem + X_BYTES);
  float* Ds = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int c_tiles = (C + DM - 1) / DM;
  const int co_tiles = (Co + DN - 1) / DN;
  const int tap = blockIdx.x / (c_tiles * co_tiles);
  const int c0 = (blockIdx.x / co_tiles % c_tiles) * DM;
  const int n0 = (blockIdx.x % co_tiles) * DN;
  const int p = k / 2;
  const int off = tap - p;
  // the slab rows [lo, hi) whose g row meets an x row of this tap
  const int lo = V == kDwV2 ? 0 : max(0, -off) * tile_s;
  const int hi = V == kDwV2 ? T * tile_s : (T - max(0, off)) * tile_s;
  const int per_step = hi > lo ? (hi - lo + DK - 1) / DK : 0;
  const int first = blockIdx.y * steps_per_chunk;
  const int n_slices = (min(first + steps_per_chunk, steps) - first) * per_step;

  const int warp = tid / 32;
  const int wm = warp % 2;  // 32 input channels of the tile
  const int wn = warp / 2;  // 32 output channels of the tile
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  DwStage<VX, VG> st;
  if (n_slices > 0) {
    load_dw_stage<V, VX, VG>(st, x, g, first, lo, hi, tap, c0, n0, T, Tx, S, C, Co, tile_s, p);
  }
  for (int it = 0; it < n_slices; ++it) {
    store_dw_stage<VX, VG>(st, Xs, Gs);
    __syncthreads();
    if (it + 1 < n_slices) {
      const int step = first + (it + 1) / per_step;
      const int r = lo + (it + 1) % per_step * DK;
      load_dw_stage<V, VX, VG>(st, x, g, step, r, hi, tap, c0, n0, T, Tx, S, C, Co, tile_s, p);
    }
#pragma unroll
    for (int kk = 0; kk < DK; kk += 16) {
      // A = x^T: (C, rows), column-major over the staged (rows, C) slice
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        wmma::load_matrix_sync(
            fa[i], reinterpret_cast<const __nv_bfloat16*>(Xs + kk * X_LD + wm * 32 + i * 16), X_LD);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::load_matrix_sync(
            fb[j], reinterpret_cast<const __nv_bfloat16*>(Gs + kk * G_LD + wn * 32 + j * 16), G_LD);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Ds + (wm * 32 + i * 16) * D_LD + wn * 32 + j * 16, acc[i][j], D_LD,
                              wmma::mem_row_major);
  __syncthreads();
  float* out = part + ((int64_t)blockIdx.y * k + tap) * C * Co;
#pragma unroll 4
  for (int i = 0; i < DOUT_SCALARS; ++i) {
    const int e = tid + i * DTHREADS;
    const int cl = e / DN;
    const int nl = e % DN;
    if (c0 + cl < C && n0 + nl < Co) out[(int64_t)(c0 + cl) * Co + n0 + nl] = Ds[cl * D_LD + nl];
  }
}

// dw = part[0] + part[1] + ... in chunk order.
__global__ void micro_reduce_kernel(const float* __restrict__ part, float* __restrict__ dw,
                                    int64_t n, int chunks) {
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (int64_t)gridDim.x * blockDim.x) {
    float s = part[e];
    for (int c = 1; c < chunks; ++c) s += part[c * n + e];
    dw[e] = s;
  }
}

// xp (B, T + 2p, S, C) = x with p zero frames on each side of T, in units of
// U (uint4 or 2 bytes); a frame is `units` units. Block y walks frames.
template <typename U>
__global__ void micro_pad_kernel(const U* __restrict__ x, U* __restrict__ xp, int64_t frames,
                                 int64_t units, int T, int p) {
  const int Tx = T + 2 * p;
  for (int64_t f = blockIdx.y; f < frames; f += gridDim.y) {
    const int64_t bb = f / Tx;
    const int t = (int)(f % Tx) - p;
    U* dst = xp + f * units;
    const int64_t start = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    if (t >= 0 && t < T) {
      const U* src = x + (bb * T + t) * units;
      for (int64_t e = start; e < units; e += stride) dst[e] = src[e];
    } else {
      for (int64_t e = start; e < units; e += stride) dst[e] = U{};
    }
  }
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }

bool valid_shape(int b, int t, int s, int c, int co, int k, int tile_s) {
  return b > 0 && t > 0 && s > 0 && c > 0 && co > 0 && k > 0 && (k % 2) == 1 && tile_s > 0 &&
         s % tile_s == 0;
}

cudaError_t launch_pad(const void* x, void* xp, int b, int t, int s, int c, int k,
                       cudaStream_t stream) {
  const int p = k / 2;
  const int64_t frames = (int64_t)b * (t + 2 * p);
  const int64_t elems = (int64_t)s * c;
  const dim3 block(256);
  if (elems % 8 == 0 && aligned16(x) && aligned16(xp)) {
    const int64_t units = elems / 8;
    const dim3 grid((unsigned)std::min<int64_t>((units + 255) / 256, 64),
                    (unsigned)std::min<int64_t>(frames, 65535));
    micro_pad_kernel<uint4><<<grid, block, 0, stream>>>(
        static_cast<const uint4*>(x), static_cast<uint4*>(xp), frames, units, t, p);
  } else {
    const dim3 grid((unsigned)std::min<int64_t>((elems + 255) / 256, 64),
                    (unsigned)std::min<int64_t>(frames, 65535));
    micro_pad_kernel<unsigned short><<<grid, block, 0, stream>>>(
        static_cast<const unsigned short*>(x), static_cast<unsigned short*>(xp), frames, elems, t,
        p);
  }
  return cudaGetLastError();
}

template <int V>
int launch_fwd(const void* x, const void* w, void* y, int b, int t, int tx, int s, int c, int co,
               int k, int tile_s, cudaStream_t stream) {
  const int nj = s / tile_s;
  const int row_tiles = (t * tile_s + BM - 1) / BM;
  const int64_t blocks = (int64_t)b * nj * row_tiles;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, (unsigned)((co + BN - 1) / BN));
  const bool va = (c % 8) == 0 && aligned16(x);
  const bool vb = (co % 8) == 0 && aligned16(w) && aligned16(y);
  auto xs = static_cast<const unsigned short*>(x);
  auto ws = static_cast<const unsigned short*>(w);
  auto ys = static_cast<unsigned short*>(y);
#define FVT_FWD(VA, VB)                                                                       \
  micro_fwd_kernel<V, VA, VB><<<grid, THREADS, 0, stream>>>(xs, ws, ys, t, tx, s, c, co, k, \
                                                              tile_s, row_tiles)
  if (va && vb) FVT_FWD(true, true);
  else if (va) FVT_FWD(true, false);
  else if (vb) FVT_FWD(false, true);
  else FVT_FWD(false, false);
#undef FVT_FWD
  return (int)cudaGetLastError();
}

template <int V>
int launch_dw(const void* x, const void* g, void* ws, void* dw, int b, int t, int tx, int s,
              int c, int co, int k, int tile_s, int chunks, int steps_per_chunk,
              cudaStream_t stream) {
  const int steps = b * (s / tile_s);
  if (chunks <= 0 || steps_per_chunk <= 0 || (int64_t)chunks * steps_per_chunk < steps ||
      (int64_t)(chunks - 1) * steps_per_chunk >= steps || chunks > 65535 ||
      (chunks > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  const int64_t tiles = (int64_t)k * ((c + DM - 1) / DM) * ((co + DN - 1) / DN);
  if (tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, (unsigned)chunks);
  const bool vx = (c % 8) == 0 && aligned16(x);
  const bool vg = (co % 8) == 0 && aligned16(g);
  auto xs = static_cast<const unsigned short*>(x);
  auto gs = static_cast<const unsigned short*>(g);
  float* part = static_cast<float*>(chunks > 1 ? ws : dw);
#define FVT_DW(VX, VG)                                                                          \
  micro_dw_kernel<V, VX, VG><<<grid, DTHREADS, 0, stream>>>(xs, gs, part, t, tx, s, c, co, k, \
                                                             tile_s, steps, steps_per_chunk)
  if (vx && vg) FVT_DW(true, true);
  else if (vx) FVT_DW(true, false);
  else if (vg) FVT_DW(false, true);
  else FVT_DW(false, false);
#undef FVT_DW
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || chunks == 1) return (int)err;
  const int64_t n = (int64_t)k * c * co;
  micro_reduce_kernel<<<(unsigned)std::min<int64_t>((n + 255) / 256, 4096), 256, 0, stream>>>(
      static_cast<const float*>(ws), static_cast<float*>(dw), n, chunks);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` of CUDA device `device` and returns
// cudaGetLastError() after its launches (0 on success). Shapes are checked
// here as well as in the Python wrappers (ops/temporal_micro.py), which
// allocate every output and scratch tensor: xp (B, T + 2p, S, C) bf16 for
// the padded x, ws (chunks, k, C, Co) f32 for the partials (unused, and may
// be null, with one chunk).

int fvt_micro_v2_bf16(const void* x, const void* w, void* xp, void* y, int b, int t, int s, int c,
                      int co, int k, int tile_s, int device, void* stream) {
  if (!valid_shape(b, t, s, c, co, k, tile_s) || xp == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  err = launch_pad(x, xp, b, t, s, c, k, st);
  if (err != cudaSuccess) return (int)err;
  return launch_fwd<kV2>(xp, w, y, b, t, t + 2 * (k / 2), s, c, co, k, tile_s, st);
}

int fvt_micro_v3_bf16(const void* x, const void* w, void* y, int b, int t, int s, int c, int co,
                      int k, int tile_s, int device, void* stream) {
  if (!valid_shape(b, t, s, c, co, k, tile_s)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return launch_fwd<kV3>(x, w, y, b, t, t, s, c, co, k, tile_s,
                         reinterpret_cast<cudaStream_t>(stream));
}

int fvt_micro_v3p_bf16(const void* x, const void* w, void* y, int b, int t, int s, int c, int co,
                       int k, int tile_s, int device, void* stream) {
  if (!valid_shape(b, t, s, c, co, k, tile_s)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return launch_fwd<kV3P>(x, w, y, b, t, t, s, c, co, k, tile_s,
                          reinterpret_cast<cudaStream_t>(stream));
}

int fvt_micro_dw_v3_bf16(const void* x, const void* g, void* ws, void* dw, int b, int t, int s,
                         int c, int co, int k, int tile_s, int chunks, int steps_per_chunk,
                         int device, void* stream) {
  if (!valid_shape(b, t, s, c, co, k, tile_s)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return launch_dw<kDwV3>(x, g, ws, dw, b, t, t, s, c, co, k, tile_s, chunks, steps_per_chunk,
                          reinterpret_cast<cudaStream_t>(stream));
}

int fvt_micro_dw_v2_bf16(const void* x, const void* g, void* xp, void* ws, void* dw, int b, int t,
                         int s, int c, int co, int k, int tile_s, int chunks, int steps_per_chunk,
                         int device, void* stream) {
  if (!valid_shape(b, t, s, c, co, k, tile_s) || xp == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  err = launch_pad(x, xp, b, t, s, c, k, st);
  if (err != cudaSuccess) return (int)err;
  return launch_dw<kDwV2>(xp, g, ws, dw, b, t, t + 2 * (k / 2), s, c, co, k, tile_s, chunks,
                          steps_per_chunk, st);
}

}  // extern "C"
