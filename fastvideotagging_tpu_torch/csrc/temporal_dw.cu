// Hand-written Hopper kernel for the weight gradient of the temporal
// k x 1 x 1 conv.
//
//   K3 temporal_dw_kernel  replaces fastvideotagging_tpu/ops/conv2plus1d.py
//                          _temporal_dw_kernel / _temporal_dw (TPU Pallas):
//       dw[dt,c,co] = sum_{b,t,s} x[b, t+dt-p, s, c] * g[b, t, s, co]
//       over the rows where both exist (p = k/2, stride 1);
//       x (B, T, S, C) bf16, g (B, T, S, Co) bf16 -> dw (k, C, Co) f32.
//
// Per tap it is a GEMM x^T g with a small output (C x Co) and a very long
// contraction (the B*T*S rows). The TPU kernel walked its grid in order and
// added every step's product into one resident f32 output block. Blocks on
// an SM run in no order, so here the contraction is split instead: block
// (tile, chunk) computes one (64 c x 64 co) tile of one tap over one chunk
// of rows and writes an f32 partial; a second kernel adds the chunks'
// partials in chunk order. No atomics: the same inputs give the same bits.
// With one chunk the partial is the result and the second kernel is not
// launched. The caller picks the chunk count (enough blocks to fill the
// card when C x Co is small, one or few chunks when it is large) and owns
// the workspace.
//
// Rows are x's rows m = (b*T + t)*S + s. Tap dt pairs x row m with g row
// m - (dt-p)*S when t - (dt-p) lies in [0, T); other rows are staged as
// zeros. A block walks its chunk in slabs of 32 rows: each thread owns one
// row of the slab (tracking its t and s incrementally, no division in the
// loop) and 16 channels of both the x tile and the g tile. The next slab's
// global loads go into registers before the current slab's
// products. The product reads x^T straight from the row-major shared tile
// as a col_major WMMA matrix_a fragment: no transposed copy. bf16 WMMA
// 16x16x16, f32 accumulators; 4 warps, each a 32x32 quarter of the tile.
// Channel rows are read 16 bytes at a time when C (for x) or Co (for g) is
// a multiple of 8 and the pointer allows it, else 2 bytes at a time
// (C = 45, the stem). Ragged C / Co are zero-filled on load and masked on
// store.
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s): bytes at the
// stem and stages 1-2 (stage 1 at 8 clips: 22.2 GFLOP, 167 MB -> 50 us),
// operations at stages 3-4. This first design does not reach either: every
// (c tile, co tile, tap) re-reads its rows of x and g (from L2 when the
// neighbouring blocks run together: the tap is the fastest grid index),
// WMMA through mma.sync peaks far below wgmma, and a 64 x 64 tile with one
// shared stage does few products per byte staged. Tiles that cover all of
// C x Co for all taps (x and g read once), wgmma and TMA are the next steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BM = 64;        // C columns of dw per block
constexpr int BN = 64;        // Co columns of dw per block
constexpr int BK = 32;        // rows (contraction) per slab
constexpr int THREADS = 128;  // 4 warps: 2 (c) x 2 (co), 32x32 each
constexpr int X_LD = BM + 8;  // bf16 elements per staged x row (144 B)
constexpr int G_LD = BN + 8;  // bf16 elements per staged g row (144 B)
constexpr int C_LD = BN + 4;  // f32 elements per staged output row
constexpr int COLS = 16;      // channels of each tile per thread
static_assert(THREADS == BK * (BM / COLS), "one slab row and 16 channels per thread");
static_assert(BM == BN, "x and g tiles share the thread-to-column map");

constexpr int STAGE_BYTES = BK * (X_LD + G_LD) * 2;
constexpr int C_BYTES = BM * C_LD * 4;
constexpr int SMEM_BYTES = STAGE_BYTES > C_BYTES ? STAGE_BYTES : C_BYTES;

// One thread's share of a slab: 16 channels of its x row and of its g row.
template <bool V>
struct Cols {
  uint4 v[V ? 2 : 1];
  unsigned short s[V ? 1 : COLS];
};

// Thread `q` (0..3) of a row: vector loads take channels (q + 4*i)*8 .. +8
// (neighbouring threads on neighbouring 16 bytes), scalar loads channels
// q*16 .. +16.
template <bool V>
__device__ __forceinline__ void load_cols(Cols<V>& r, const unsigned short* __restrict__ row,
                                          bool valid, int q, int col0, int width) {
  if constexpr (V) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int cc = (q + 4 * i) * 8;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (valid && col0 + cc < width) v = *reinterpret_cast<const uint4*>(row + col0 + cc);
      r.v[i] = v;
    }
  } else {
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      const int cc = q * COLS + j;
      unsigned short v = 0;
      if (valid && col0 + cc < width) v = row[col0 + cc];
      r.s[j] = v;
    }
  }
}

template <bool V>
__device__ __forceinline__ void store_cols(const Cols<V>& r, unsigned short* srow, int q) {
  if constexpr (V) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<uint4*>(srow + (q + 4 * i) * 8) = r.v[i];
  } else {
#pragma unroll
    for (int j = 0; j < COLS; ++j) srow[q * COLS + j] = r.s[j];
  }
}

// part[(chunk*k + tap), c, co] = sum over the chunk's rows of x^T g.
template <bool VX, bool VG>
__global__ void __launch_bounds__(THREADS)
temporal_dw_kernel(const unsigned short* __restrict__ x,
                   const unsigned short* __restrict__ g, float* __restrict__ part,
                   int64_t M, int T, int S, int C, int Co, int k,
                   int64_t rows_per_chunk) {
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  unsigned short* Xs = reinterpret_cast<unsigned short*>(smem);
  unsigned short* Gs = Xs + BK * X_LD;
  float* Cs = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int n_ct = (C + BM - 1) / BM;
  // The tap is the fastest tile index: the k blocks that read the same
  // rows of x and g are neighbours in launch order.
  const int tap = blockIdx.x % k;
  const int ct = (blockIdx.x / k) % n_ct;
  const int cot = blockIdx.x / (k * n_ct);
  const int off = tap - k / 2;
  const int c0 = ct * BM;
  const int n0 = cot * BN;
  const int64_t chunk = blockIdx.y;
  const int64_t m_begin = chunk * rows_per_chunk;
  const int64_t m_end = (m_begin + rows_per_chunk < M) ? m_begin + rows_per_chunk : M;

  // This thread's row of the current slab, and its (t, s).
  const int r = tid / (BM / COLS);
  const int q = tid % (BM / COLS);
  int64_t m = m_begin + r;
  int s = (int)(m % S);
  int t = (int)((m / S) % T);
  const int64_t g_shift = (int64_t)off * S;

  const int warp = tid / 32;
  const int wm = warp % 2;  // 32-wide c slab
  const int wn = warp / 2;  // 32-wide co slab
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  Cols<VX> xr;
  Cols<VG> gr;
  auto load = [&]() {
    const int tg = t - off;
    const bool valid = m < m_end && tg >= 0 && tg < T;
    load_cols<VX>(xr, x + m * C, valid, q, c0, C);
    load_cols<VG>(gr, g + (m - g_shift) * Co, valid, q, n0, Co);
  };
  if (m_begin < m_end) load();
  for (int64_t m0 = m_begin; m0 < m_end; m0 += BK) {
    store_cols<VX>(xr, Xs + r * X_LD, q);
    store_cols<VG>(gr, Gs + r * G_LD, q);
    __syncthreads();
    if (m0 + BK < m_end) {
      m += BK;
      s += BK;
      while (s >= S) {
        s -= S;
        t = (t + 1 == T) ? 0 : t + 1;
      }
      load();
    }
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      // x^T: element (c, row) of the (c x rows) operand lies at
      // Xs[row * X_LD + c], i.e. col_major with leading dimension X_LD.
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(
            fa[i], reinterpret_cast<const __nv_bfloat16*>(Xs + kk * X_LD + wm * 32 + i * 16),
            X_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(
            fb[j], reinterpret_cast<const __nv_bfloat16*>(Gs + kk * G_LD + wn * 32 + j * 16),
            G_LD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

  // Epilogue: the f32 tile through shared memory (aliasing the stage, free
  // after the loop's last barrier), masked at the C and Co edges.
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * C_LD + wn * 32 + j * 16,
                              acc[i][j], C_LD, wmma::mem_row_major);
  __syncthreads();
  float* dst = part + (chunk * k + tap) * (int64_t)C * Co;
#pragma unroll 4
  for (int i = 0; i < BM * BN / THREADS; ++i) {
    const int e = tid + i * THREADS;
    const int rr = e / BN;
    const int cc = e % BN;
    if (c0 + rr < C && n0 + cc < Co) dst[(int64_t)(c0 + rr) * Co + n0 + cc] = Cs[rr * C_LD + cc];
  }
}

// out[i] = part[0][i] + part[1][i] + ... in chunk order.
__global__ void __launch_bounds__(256)
temporal_dw_reduce_kernel(const float* __restrict__ part, float* __restrict__ out,
                          int64_t n, int chunks) {
  const int64_t i = (int64_t)blockIdx.x * 256 + threadIdx.x;
  if (i >= n) return;
  float a = 0.0f;
  for (int ch = 0; ch < chunks; ++ch) a += part[(int64_t)ch * n + i];
  out[i] = a;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

extern "C" {

// dw (k, C, Co) f32 from x (B, T, S, C) and g (B, T, S, Co), both bf16.
// The contraction is split into `chunks` chunks of `rows_per_chunk` rows (a
// multiple of 32 covering B*T*S); `ws` holds chunks*k*C*Co floats and is
// not read when chunks == 1. Launches on `stream` of CUDA device `device`
// and returns cudaGetLastError() after the launches (0 on success). The
// device is set explicitly: this library carries its own CUDA runtime,
// whose current device is not the caller's.
int fvt_temporal_dw_bf16(const void* x, const void* g, void* dw, void* ws,
                         long long b, int t, int s_len, int c, int co, int k,
                         int chunks, long long rows_per_chunk, int device,
                         void* stream) {
  if (b <= 0 || t <= 0 || s_len <= 0 || c <= 0 || co <= 0 || k <= 0 || (k % 2) == 0)
    return (int)cudaErrorInvalidValue;
  const int64_t M = (int64_t)b * t * s_len;
  if (chunks <= 0 || chunks > 65535 || rows_per_chunk <= 0 || (rows_per_chunk % BK) != 0 ||
      (int64_t)chunks * rows_per_chunk < M || (int64_t)(chunks - 1) * rows_per_chunk >= M)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int64_t tiles = (int64_t)k * ((c + BM - 1) / BM) * ((co + BN - 1) / BN);
  if (tiles > 2147483647LL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, (unsigned)chunks);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const bool vx = (c % 8) == 0 && aligned16(x);
  const bool vg = (co % 8) == 0 && aligned16(g);
  auto xs = static_cast<const unsigned short*>(x);
  auto gs = static_cast<const unsigned short*>(g);
  float* part = static_cast<float*>(chunks == 1 ? dw : ws);
  if (vx && vg)
    temporal_dw_kernel<true, true><<<grid, THREADS, 0, st>>>(xs, gs, part, M, t, s_len, c, co, k, rows_per_chunk);
  else if (vx)
    temporal_dw_kernel<true, false><<<grid, THREADS, 0, st>>>(xs, gs, part, M, t, s_len, c, co, k, rows_per_chunk);
  else if (vg)
    temporal_dw_kernel<false, true><<<grid, THREADS, 0, st>>>(xs, gs, part, M, t, s_len, c, co, k, rows_per_chunk);
  else
    temporal_dw_kernel<false, false><<<grid, THREADS, 0, st>>>(xs, gs, part, M, t, s_len, c, co, k, rows_per_chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess || chunks == 1) return (int)err;
  const int64_t n = (int64_t)k * c * co;
  temporal_dw_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      part, static_cast<float*>(dw), n, chunks);
  return (int)cudaGetLastError();
}

}  // extern "C"
