// K1 and K2: the spatial 1 x k x k and the temporal k x 1 x 1 conv on
// Hopper, forward and dx, as one implicit GEMM over a general row geometry.
//
//   spatial_conv_hopper_kernel  (K1) replaces fastvideotagging_tpu/ops/conv2plus1d.py
//                               _spatial_kernel / _spatial_pallas (TPU Pallas):
//       y[n,h,w,co] = sum_{dh,dw,c} x[n, h+dh-p, w+dw-p, c] * W[dh,dw,c,co]
//       x (N, H, W, C) bf16 -> y (N, H, W, Co) bf16.
//   temporal_conv_hopper_kernel (K2) replaces fastvideotagging_tpu/ops/conv2plus1d.py
//                               _temporal_kernel / _temporal_pallas (:200-248):
//       y[b,t,s,co] = sum_{dt,c} x[b, t+dt-p, s, c] * W[dt,c,co]
//       x (B, T, S, C) bf16 -> y (B, T, S, Co) bf16.
//   Both: f32 accumulation, zeros outside the frame, p = k/2 (stride 1, odd
//   k). dx is the same kernel on the incoming gradient with the taps read in
//   reverse and the channels transposed (``flip``, below).
//
// Rows are m = (outer*A + a)*Bd + b with kA x kB taps; tap (da, db) reads
// row m + (da-pA)*Bd + (db-pB), zero outside [0, A) x [0, Bd). K1 is
// (A, Bd, kA, kB) = (H, W, k, k), K2 is (T, S, k, 1). Columns are output
// channels, and the contraction runs over kappa = tap*cp + c, tap = da*kB +
// db. A first small kernel (*_weight_kernel) lays the forward weight out
// K-major, wk[co][tap][c] with c zero-padded to cp, a multiple of 8; for dx
// straight from the forward weight, the main kernel reading the taps in
// reverse. A 16-byte chunk of A (8 channels) then lies inside one tap: each
// chunk works out its own (tap, c) and source row. Slices of BK = 64 run
// over kappa straight through, with no per-tap rounding; only the last slice
// of the whole contraction is ragged. Where the grid of tiles cannot fill
// the card, the contraction is split over blocks into f32 partial sums that
// *_reduce_kernel adds in a fixed order.
//
// Tile and ring. One block of 256 threads (two warpgroups) owns BM = 128
// output rows and BN output channels, BN in {64, 128, 144}: the plan
// (ops/conv2plus1d.py::spatial_plan / temporal_plan, one rule) takes BN to
// cover Co or to divide it, so that A is gathered as few times as the grid
// allows. Loads are 16-byte cp.async.cg into a ring of STAGES = 3 slices
// (compiled in from the plan), two of them in flight while the tensor cores
// work on the third; a row outside the frame or past M, a slice past the
// contraction and a weight row past Co load with src-size 0, so the
// hardware writes zeros with no branch around the store. A and W slices are
// K-major, 128 bytes a row, in the 128-byte swizzle (chunk ^ row % 8) that a
// wgmma shared-memory descriptor names; the stages are 1024-byte aligned.
// At BN = 144 a block takes 103 KB and at most 128 registers a thread, so
// two blocks share an SM (three at BN = 64): one block's prologue, epilogue
// and waits overlap the other's products. The geometry changes only the
// global addresses of the loads: the shared layout and the descriptors are
// K1's for every (kA, kB).
//
// The product: each warpgroup owns 64 of the 128 rows and issues
// wgmma.mma_async.m64nBNk16 (bf16 x bf16 -> f32) with A and B both read from
// the swizzled slices through shared-memory descriptors: fence, the four k16
// steps of a slice, commit, issue the next load, wait. The epilogue rounds
// the f32 accumulators to bf16 in registers, stages them in shared memory
// once every load has landed and every product is done, and stores 16 bytes
// at a time, masked at the M and Co edges. Where Co is not a multiple of 8
// and one column tile covers it (the dx of K2's stem, Co = 45), the output
// tile is one contiguous span of 128 * Co values, 16-byte aligned because m0
// is a multiple of 128: it is staged packed and stored 16 bytes at a time.
//
// Rows of C % 8 != 0 channels (K2's stem, C = 45: 90-byte rows that
// cp.async cannot read 16 bytes at a time) are first copied, zero-padded to
// a multiple of 8, into a scratch tensor by temporal_conv_pad_kernel: on an
// H100 that beat reading each tap's 128 rows as one contiguous span and
// repacking it in shared memory, and F.pad before the launch.
//
// What bounds them on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s), counting
// the taps inside the input and each input and output byte once, at
// r2plus1d_18's sites at clip_batch 8: K1, operations at every site: stage 1
// (8x16x56x56, 64 -> 144) 65.7 us, stage 2 32.1, stage 3 15.3, stage 4 6.9
// (x 4 / 3 / 3 / 3 a forward: 0.426 ms); dx the same with C and Co swapped.
// K2: bytes at the stem (8x16x3136, 45 -> 64) 26.1 us, stage 1 (144 -> 64)
// 49.9 and stage 2 (8x8x784, 288 -> 128) 12.5; operations at stage 3
// (8x4x196, 576 -> 256) 4.7 and stage 4 (8x2x49, 1152 -> 512) 1.9 (x 1 / 4 /
// 3 / 3 / 3 a forward: 0.283 ms).
//
// What K2's design does about its first version (the WMMA tile, in the
// history of csrc/conv2plus1d.cu), item by item: (1) WMMA 16x16x16 through
// mma.sync -> wgmma; (2) one register-staged shared stage with a barrier on
// each side of every slice -> the cp.async ring, two slices loading, two or
// three blocks per SM; (3) BN = 64 fixed -> BN covers or divides Co (A
// gathered once at Co <= 144, was 2x at 128, 4x at 256, 8x at 512; the dx
// at Co = 144 in one tile, was 3 tiles and 192 columns), and the contraction
// split over blocks where the tiles cannot fill the card (stage 4 at 8
// clips: 7 x 4 tiles, 5 chunks); (4) BK = 32 rounded up per tap -> kappa straight
// through; (5) 2-byte scalar paths at C = 45 / Co = 45 -> the pad pass and
// the packed 16-byte store; (6) an f32 epilogue through shared memory ->
// bf16 rounded in registers; (7) every x row read k times, once per tap ->
// still so: the tile re-reads a frame's rows once per tap, mostly from L2.
// A walk over t that read each frame once (all taps' weights resident, a
// ring of frames, one or two blocks an SM) was slower at stage 1 and is in
// the history of this file.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

#if !defined(FVT_K1_STAGES)
#error "build through ops/_build.py, which passes ops/conv2plus1d.py's tile plan"
#endif

constexpr int BM = 128;                 // output rows per block
constexpr int BK = 64;                  // contraction slice: 64 bf16 = 128 bytes a row
constexpr int THREADS = 256;            // 8 warps
constexpr int STAGES = FVT_K1_STAGES;   // slices in the ring
constexpr int A_STAGE = BM * BK * 2;    // bytes of one A slice
constexpr int ALIGN = 1024;             // the 128-byte swizzle repeats every 8 rows
constexpr int kOutside = -(1 << 28);    // pixel coordinate of a row past M
static_assert(STAGES >= 2, "a ring needs two stages");

template <int BN>
struct Tile {
  static constexpr int B_STAGE = BN * BK * 2;
  static constexpr int STAGE = A_STAGE + B_STAGE;  // a multiple of ALIGN (BN % 8 == 0)
  static constexpr int RING = STAGES * STAGE;
  static constexpr int SMEM = RING + ALIGN;  // + slack to align the base
  static constexpr int LDS = BN + 8;    // bf16 per row of the epilogue's staging tile
  static_assert(BN % 16 == 0 && STAGE % ALIGN == 0, "BN must be a multiple of 16");
  static_assert(BM * LDS * 2 <= RING, "the staging tile fits the ring");
};

// One launch: x (M, cp) rows, wk (Co, kA*kB, cp) K-major, y (M, Co); see
// conv_taps_tile.
struct TapsArgs {
  const __nv_bfloat16* x;
  const __nv_bfloat16* wk;
  __nv_bfloat16* y;
  float* ws;
  int64_t M;
  int A, Bd, kA, kB;  // row geometry and taps
  int cp;             // channels of an x row, the contraction width of a tap
  int co, flip, n_tiles, splits;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk j of row r in a K-major tile of 128-byte
// rows, 128-byte swizzled.
__device__ __forceinline__ uint32_t swz(int r, int j) {
  return static_cast<uint32_t>(r * 128 + ((j ^ (r & 7)) << 4));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// The async proxy (wgmma) reads what cp.async wrote through the generic
// proxy: each thread fences its own writes before the barrier.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across a
// wgmma fence or wait.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// Shared-memory matrix descriptor of a K-major tile in the 128-byte
// swizzle: start address >> 4, leading offset 1 (unused for this layout),
// 1024 bytes between 8-row groups, layout type 1 (128B swizzle). Moving 16
// bf16 along K within the 128-byte row is +32 bytes on the start address.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

// wgmma.mma_async m64nNk16, bf16 x bf16 -> f32, A and B both K-major in
// shared memory; d += A B.
__device__ __forceinline__ void wgmma_64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_144(float (&d)[72], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %74, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n144k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71"
      "}, %72, %73, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71])
      : "l"(da), "l"(db), "r"(1));
}


template <int BN>
__device__ __forceinline__ void wgmma_tile(float (&d)[BN / 2], uint64_t da, uint64_t db) {
  if constexpr (BN == 64) wgmma_64(d, da, db);
  else if constexpr (BN == 128) wgmma_128(d, da, db);
  else wgmma_144(d, da, db);
}

// Block b computes kappa chunk b % splits of column tile (b / splits) %
// n_tiles of row tile b / (splits * n_tiles): the chunks and column tiles
// of one row tile run side by side and share its A rows in L2. With one
// chunk the block writes bf16 y; with more it writes its f32 partial sums
// to ws (splits, M, Co), which the reduce kernel adds up in chunk order.
// SPLIT is splits > 1, so that the common case carries none of its code;
// SQUARE is K1's kA x kA taps (K2's are kA x 1), fixed at compile time: a
// runtime kB made K1's widest tiles measurably slower on the card.
template <int BN, bool SPLIT, bool SQUARE>
__device__ __forceinline__ void conv_taps_tile(const TapsArgs& args) {
  using T = Tile<BN>;
  const __nv_bfloat16* __restrict__ x = args.x;
  const __nv_bfloat16* __restrict__ wk = args.wk;
  const int64_t M = args.M;
  const int A = args.A, Bd = args.Bd, kB = SQUARE ? args.kA : 1, C = args.cp;
  const int Co = args.co, n_tiles = args.n_tiles, splits = args.splits;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + ALIGN - 1) & ~static_cast<uint32_t>(ALIGN - 1);
  unsigned char* smem = smem_raw + (base - raw);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int split = SPLIT ? blockIdx.x % splits : 0;
  const int tile = SPLIT ? blockIdx.x / splits : blockIdx.x;
  const int64_t m0 = static_cast<int64_t>(tile / n_tiles) * BM;
  const int n0 = (tile % n_tiles) * BN;
  const int kk = args.kA * kB, pA = args.kA / 2, pB = SQUARE ? pA : 0;
  const int K = kk * C;
  const int KT = (K + BK - 1) / BK;
  // this block's slices of the contraction: [kt0, kt0 + NK)
  const int kt0 = SPLIT ? static_cast<int>(static_cast<int64_t>(split) * KT / splits) : 0;
  const int NK =
      SPLIT ? static_cast<int>(static_cast<int64_t>(split + 1) * KT / splits) - kt0 : KT;

  // Loader: thread tid moves chunk j = tid % 8 of rows tid / 8 + 32 q, in
  // A (4 rows) and in the weight slice (BN / 32 rows, rounded up). (pa,
  // pb): the row's coordinates along the two axes of the geometry.
  const int j = tid & 7;
  const int r0 = tid >> 3;
  int pa[4], pb[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int64_t m = m0 + r0 + 32 * q;
    if (m < M) {
      pb[q] = static_cast<int>(m % Bd);
      pa[q] = static_cast<int>((m / Bd) % A);
    } else {
      pa[q] = pb[q] = kOutside;
    }
  }
  const __nv_bfloat16* xrow = x + (m0 + r0) * C;         // row r0's pixel
  const __nv_bfloat16* wrow = wk + static_cast<int64_t>(n0 + r0) * K;

  // The loads walk kappa in order, one slice a call: this thread's chunk
  // starts at kappa = kt0 * BK + j * 8 and moves on by BK, its (tap, c) and
  // the tap's (da, db) carried along instead of divided out again.
  const int kap0 = kt0 * BK + j * 8;
  int ld_tap = kap0 / C;
  int ld_c = kap0 - ld_tap * C;
  int ld_da = ld_tap / kB, ld_db = ld_tap % kB;
  auto load = [&](int s) {
    const bool kin = ld_tap < kk;
    const int da = ld_da - pA, db = ld_db - pB;
    const uint32_t sa = base + s * T::STAGE;
    const int64_t shift = (static_cast<int64_t>(da) * Bd + db) * C + ld_c;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int aa = pa[q] + da, bb = pb[q] + db;
      const bool ok = kin && aa >= 0 && aa < A && bb >= 0 && bb < Bd;
      const __nv_bfloat16* src = ok ? xrow + static_cast<int64_t>(32 * q) * C + shift : x;
      cp_async16(sa + swz(r0 + 32 * q, j), src, ok);
    }
    const int wcol = (args.flip ? kk - 1 - ld_tap : ld_tap) * C + ld_c;
    const uint32_t sb = sa + A_STAGE;
#pragma unroll
    for (int q = 0; q < (BN + 31) / 32; ++q) {
      const int n = r0 + 32 * q;
      if (n < BN) {
        const bool ok = kin && n0 + n < Co;
        const __nv_bfloat16* src = ok ? wrow + static_cast<int64_t>(32 * q) * K + wcol : wk;
        cp_async16(sb + swz(n, j), src, ok);
      }
    }
    for (ld_c += BK; ld_c >= C; ld_c -= C) {
      ++ld_tap;
      if (++ld_db == kB) {
        ld_db = 0;
        ++ld_da;
      }
    }
  };

  // Product: warpgroup wg owns rows 64 wg .. +63 and all BN columns; its
  // accumulator is BN / 2 f32 a thread.
  const int wg = warp >> 2;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;

  auto compute = [&](int s) {
    const uint32_t sa = base + s * T::STAGE + wg * 64 * 128;
    const uint32_t sb = base + s * T::STAGE + A_STAGE;
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks)
      wgmma_tile<BN>(acc, smem_desc(sa + ks * 32), smem_desc(sb + ks * 32));
    wgmma_commit();
    fence_acc(acc);
  };

  // The ring: STAGES-1 slices of loads in flight. Slice kt's product is
  // issued as one wgmma group, then the load of slice kt + STAGES-1 into
  // the stage that slice kt-1 used (both warpgroups waited for its group
  // before the barrier), then the warpgroup waits for its group. The other
  // block on the SM keeps the tensor cores busy over that wait and over
  // this block's prologue and epilogue. An empty commit keeps the cp.async
  // group count steady at the tail.
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < NK) load(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < NK; ++kt) {
    cp_async_wait<STAGES - 2>();
    fence_proxy_async();
    __syncthreads();
    compute(kt % STAGES);
    const int nk = kt + STAGES - 1;
    if (nk < NK) load(nk % STAGES);
    cp_async_commit();
    wgmma_wait<0>();
    fence_acc(acc);
  }
  cp_async_wait<0>();
  __syncthreads();  // every load has landed and every product is done: the ring is free

  // Epilogue. Warp w of the warpgroup holds rows 16 (w % 4) .. +15 of the
  // group's 64: n8 block j in acc[4j .. 4j+3], rows lane/4 and lane/4 + 8.
  const int row = wg * 64 + (warp & 3) * 16 + (lane >> 2);
  __nv_bfloat16* __restrict__ y = args.y;
  if constexpr (SPLIT) {  // f32 partial sums, 8 bytes a store, straight from registers
    float* out = args.ws + static_cast<int64_t>(split) * M * Co;
#pragma unroll
    for (int jn = 0; jn < BN / 8; ++jn) {
      const int col = n0 + jn * 8 + (lane & 3) * 2;
#pragma unroll
      for (int h8 = 0; h8 < 2; ++h8) {
        const int64_t m = m0 + row + 8 * h8;
        if (m >= M || col >= Co) continue;
        const float v0 = acc[4 * jn + 2 * h8], v1 = acc[4 * jn + 2 * h8 + 1];
        if ((Co & 1) == 0) {
          *reinterpret_cast<float2*>(out + m * Co + col) = make_float2(v0, v1);
        } else {
          out[m * Co + col] = v0;
          if (col + 1 < Co) out[m * Co + col + 1] = v1;
        }
      }
    }
  } else if (BN == 64 && Co % 8 != 0 && n_tiles == 1) {
    // One 64-wide column tile covers a ragged Co (K2's stem dx, Co = 45):
    // rows m0.. of y are one span of rows * Co values, 16-byte aligned (m0 *
    // Co * 2 is a multiple of 256). The wider instances carry none of it.
    __nv_bfloat16* st = reinterpret_cast<__nv_bfloat16*>(smem);
#pragma unroll
    for (int jn = 0; jn < BN / 8; ++jn) {
      const int col = jn * 8 + (lane & 3) * 2;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int c = col + (u & 1), r = row + 8 * (u >> 1);
        if (c < Co) st[r * Co + c] = __float2bfloat16_rn(acc[4 * jn + u]);
      }
    }
    __syncthreads();
    const int64_t left = M - m0;
    const int n = static_cast<int>(left < BM ? left : BM) * Co;
    __nv_bfloat16* out = y + m0 * Co;
    for (int i = tid; i < n / 8; i += THREADS)
      reinterpret_cast<uint4*>(out)[i] = reinterpret_cast<const uint4*>(st)[i];
    for (int i = (n / 8) * 8 + tid; i < n; i += THREADS) out[i] = st[i];
  } else {  // bf16 in registers -> staging tile -> 16-byte stores
    __nv_bfloat16* st = reinterpret_cast<__nv_bfloat16*>(smem);
#pragma unroll
    for (int jn = 0; jn < BN / 8; ++jn) {
      const int col = jn * 8 + (lane & 3) * 2;
      *reinterpret_cast<__nv_bfloat162*>(st + row * T::LDS + col) =
          __floats2bfloat162_rn(acc[4 * jn], acc[4 * jn + 1]);
      *reinterpret_cast<__nv_bfloat162*>(st + (row + 8) * T::LDS + col) =
          __floats2bfloat162_rn(acc[4 * jn + 2], acc[4 * jn + 3]);
    }
    __syncthreads();
    if (Co % 8 == 0) {
      for (int e = tid; e < BM * (BN / 8); e += THREADS) {
        const int r = e / (BN / 8);
        const int cc = (e % (BN / 8)) * 8;
        if (m0 + r < M && n0 + cc < Co)
          *reinterpret_cast<uint4*>(y + (m0 + r) * Co + n0 + cc) =
              *reinterpret_cast<const uint4*>(st + r * T::LDS + cc);
      }
    } else {
      for (int e = tid; e < BM * BN; e += THREADS) {
        const int r = e / BN;
        const int cc = e % BN;
        if (m0 + r < M && n0 + cc < Co) y[(m0 + r) * Co + n0 + cc] = st[r * T::LDS + cc];
      }
    }
  }
}

// At BN = 64 a block fits 80 registers a thread and three blocks an SM.
template <int BN, bool SPLIT>
__global__ void __launch_bounds__(THREADS, (BN <= 64 ? 3 : 2))
spatial_conv_hopper_kernel(const TapsArgs args) {
  conv_taps_tile<BN, SPLIT, true>(args);
}

template <int BN, bool SPLIT>
__global__ void __launch_bounds__(THREADS, (BN <= 64 ? 3 : 2))
temporal_conv_hopper_kernel(const TapsArgs args) {
  conv_taps_tile<BN, SPLIT, false>(args);
}

// y = bf16(sum over s of ws[s]), s in order: the same sums, bit for bit,
// on every launch (no atomics). total = M * Co.
__device__ __forceinline__ void reduce_partials(const float* __restrict__ ws,
                                                __nv_bfloat16* __restrict__ y, int64_t total,
                                                int splits) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * THREADS;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if ((total & 3) == 0) {
    for (int64_t i = first; i < total / 4; i += stride) {
      float4 a = reinterpret_cast<const float4*>(ws)[i];
      for (int s = 1; s < splits; ++s) {
        const float4 b = reinterpret_cast<const float4*>(ws + s * total)[i];
        a.x += b.x;
        a.y += b.y;
        a.z += b.z;
        a.w += b.w;
      }
      reinterpret_cast<__nv_bfloat162*>(y)[2 * i] = __floats2bfloat162_rn(a.x, a.y);
      reinterpret_cast<__nv_bfloat162*>(y)[2 * i + 1] = __floats2bfloat162_rn(a.z, a.w);
    }
  } else {
    for (int64_t i = first; i < total; i += stride) {
      float a = ws[i];
      for (int s = 1; s < splits; ++s) a += ws[s * total + i];
      y[i] = __float2bfloat16_rn(a);
    }
  }
}

__global__ void __launch_bounds__(THREADS)
spatial_conv_reduce_kernel(const float* __restrict__ ws, __nv_bfloat16* __restrict__ y,
                           int64_t total, int splits) {
  reduce_partials(ws, y, total, splits);
}

__global__ void __launch_bounds__(THREADS)
temporal_conv_reduce_kernel(const float* __restrict__ ws, __nv_bfloat16* __restrict__ y,
                            int64_t total, int splits) {
  reduce_partials(ws, y, total, splits);
}

// The weight layout, K-major with the contraction's channels zero-padded
// to cp: wk[a][t][b], a < A out channels, t < kk taps, b < cp, from the
// forward weight w (kk, cw, cow).
//   forward (dx = 0): A = cow, wk[a][t][b] = b < cw ? w[t][b][a] : 0, a
//     transpose of each tap, through a 32 x 32 shared tile so that both
//     sides move whole rows;
//   dx (dx = 1): A = cw, wk[a][t][b] = b < cow ? w[t][a][b] : 0, rows
//     copied as they are (the main kernel reads the taps in reverse), 16
//     bytes a thread where cp == cow.
// Grid (cp / 32, A / 32, kk) rounded up, 32 x 8 threads.
__device__ __forceinline__ void weight_layout(const unsigned short* __restrict__ w,
                                              unsigned short* __restrict__ wk, int kk, int cw,
                                              int cow, int cp, int dx) {
  __shared__ unsigned short tile[32][33];
  const int t = blockIdx.z;
  const int b0 = blockIdx.x * 32, a0 = blockIdx.y * 32;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int A = dx ? cw : cow;
  const unsigned short* wt = w + static_cast<int64_t>(t) * cw * cow;
  if (dx) {  // a row copy: thread i of the grid moves element (or 16-byte chunk) i
    const int64_t threads = static_cast<int64_t>(gridDim.x) * gridDim.y * gridDim.z * 256;
    const int64_t first =
        ((static_cast<int64_t>(blockIdx.z) * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x) *
            256 + threadIdx.x;
    const int vec = cp == cow ? 8 : 1;  // cp is a multiple of 8
    const int per_row = cp / vec;
    for (int64_t i = first; i < static_cast<int64_t>(A) * kk * per_row; i += threads) {
      const int64_t row = i / per_row;  // (a, t) of wk
      const int b = static_cast<int>(i - row * per_row) * vec;
      const int a = static_cast<int>(row / kk), tt = static_cast<int>(row % kk);
      const int64_t src = (static_cast<int64_t>(tt) * cw + a) * cow + b;
      if (vec == 8)
        *reinterpret_cast<uint4*>(wk + row * cp + b) = *reinterpret_cast<const uint4*>(w + src);
      else
        wk[row * cp + b] = b < cow ? w[src] : 0;
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < 32; i += 8) {  // read rows b of w[t] (cow contiguous)
    const int b = b0 + ty + i, a = a0 + tx;
    tile[ty + i][tx] = (b < cw && a < cow) ? wt[static_cast<int64_t>(b) * cow + a] : 0;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 32; i += 8) {  // write rows a of wk (cp contiguous)
    const int a = a0 + ty + i, b = b0 + tx;
    if (a < A && b < cp) wk[(static_cast<int64_t>(a) * kk + t) * cp + b] = tile[tx][ty + i];
  }
}

__global__ void __launch_bounds__(256)
spatial_conv_weight_kernel(const unsigned short* __restrict__ w, unsigned short* __restrict__ wk,
                           int kk, int cw, int cow, int cp, int dx) {
  weight_layout(w, wk, kk, cw, cow, cp, dx);
}

__global__ void __launch_bounds__(256)
temporal_conv_weight_kernel(const unsigned short* __restrict__ w, unsigned short* __restrict__ wk,
                            int kk, int cw, int cow, int cp, int dx) {
  weight_layout(w, wk, kk, cw, cow, cp, dx);
}

// x (rows, c) -> xp (rows, cp), channels c..cp-1 zero: one 16-byte store
// a thread: how K2 takes rows of C % 8 != 0 channels (the stem's 45).
__global__ void __launch_bounds__(THREADS)
temporal_conv_pad_kernel(const unsigned short* __restrict__ x, unsigned short* __restrict__ xp,
                         int64_t rows, int c, int cp) {
  const int per_row = cp / 8;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * THREADS;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
       i < rows * per_row; i += stride) {
    const int64_t r = i / per_row;
    const int c0 = static_cast<int>(i - r * per_row) * 8;
    uint32_t v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const uint32_t lo = c0 + 2 * u < c ? x[r * c + c0 + 2 * u] : 0u;
      const uint32_t hi = c0 + 2 * u + 1 < c ? x[r * c + c0 + 2 * u + 1] : 0u;
      v[u] = lo | (hi << 16);
    }
    reinterpret_cast<uint4*>(xp)[i] = make_uint4(v[0], v[1], v[2], v[3]);
  }
}

constexpr int kMaxDevices = 64;
enum Kind { kSpatial, kTemporal };

// Opts the instance in to its shared memory once per device and size (a
// host call, not free), then launches it.
template <Kind KIND, int BN, bool SPLIT>
cudaError_t start(unsigned blocks, int smem_bytes, int device, cudaStream_t s,
                  const TapsArgs& args) {
  auto kern = KIND == kSpatial ? spatial_conv_hopper_kernel<BN, SPLIT>
                               : temporal_conv_hopper_kernel<BN, SPLIT>;
  static int opted_in[kMaxDevices] = {};
  if (opted_in[device] < smem_bytes) {
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return err;
    opted_in[device] = smem_bytes;
  }
  kern<<<blocks, THREADS, smem_bytes, s>>>(args);
  return cudaGetLastError();
}

template <Kind KIND, int BN>
int launch(const TapsArgs& args, int smem_bytes, int device, cudaStream_t s) {
  if (smem_bytes < Tile<BN>::SMEM) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (args.M + BM - 1) / BM * args.n_tiles * args.splits;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  const unsigned nb = static_cast<unsigned>(blocks);
  cudaError_t err = args.splits > 1 ? start<KIND, BN, true>(nb, smem_bytes, device, s, args)
                                    : start<KIND, BN, false>(nb, smem_bytes, device, s, args);
  if (err != cudaSuccess || args.splits == 1) return static_cast<int>(err);
  const int64_t total = args.M * args.co;
  const int64_t items = (total & 3) == 0 ? total / 4 : total;  // float4s or floats
  const int64_t want = (items + THREADS - 1) / THREADS;
  const int reduce_blocks = static_cast<int>(want < 4096 ? want : 4096);
  auto reduce = KIND == kSpatial ? spatial_conv_reduce_kernel : temporal_conv_reduce_kernel;
  reduce<<<reduce_blocks, THREADS, 0, s>>>(args.ws, args.y, total, args.splits);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// The weight layout into wk, then the implicit GEMM (and the reduce) with
// the plan's column tile; args.wk is wk, args.co the output channels.
template <Kind KIND>
int run(const void* w, TapsArgs args, int cw, int cow, int dx, int bn, int smem_bytes,
        int device, cudaStream_t s) {
  if (device < 0 || device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidValue);
  const int kk = args.kA * args.kB;
  const dim3 wgrid((args.cp + 31) / 32, (args.co + 31) / 32, kk);
  auto layout = KIND == kSpatial ? spatial_conv_weight_kernel : temporal_conv_weight_kernel;
  layout<<<wgrid, 256, 0, s>>>(static_cast<const unsigned short*>(w),
                               reinterpret_cast<unsigned short*>(
                                   const_cast<__nv_bfloat16*>(args.wk)),
                               kk, cw, cow, args.cp, dx);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  args.n_tiles = (args.co + bn - 1) / bn;
  switch (bn) {
    case 64: return launch<KIND, 64>(args, smem_bytes, device, s);
    case 128: return launch<KIND, 128>(args, smem_bytes, device, s);
    case 144: return launch<KIND, 144>(args, smem_bytes, device, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Launches K1 on `stream` of CUDA device `device`: the weight layout into
// wk, the implicit GEMM, and with splits > 1 the reduce; returns
// cudaGetLastError() after the launches (0 on success). w (k, k, cw, cow)
// is the forward weight. dx = 0: y = conv(x, w), x (n, h, wd, cp) with cw
// channels zero-padded to cp, y (n, h, wd, cow). dx = 1: y = dx of that
// conv, x the incoming gradient (n, h, wd, cp) with cow channels padded,
// y (n, h, wd, cw). wk (out channels, k*k, cp) bf16 scratch; ws (splits,
// n*h*wd, out channels) f32 scratch when splits > 1, else unused. All
// 16-byte aligned. The plan (bn, stages, splits, smem_bytes) comes from
// ops/conv2plus1d.py::spatial_plan; the launch refuses one it was not
// built for or that does not fit. The device is set explicitly: this
// library carries its own CUDA runtime, whose current device is not the
// caller's.
int fvt_spatial_conv_bf16(const void* x, const void* w, void* wk, void* y, void* ws,
                          long long n, int h, int wd, int cp, int cw, int cow, int k, int dx,
                          int bn, int stages, int splits, int smem_bytes, int device,
                          void* stream) {
  const int c_in = dx ? cow : cw, co = dx ? cw : cow;
  if (n <= 0 || h <= 0 || wd <= 0 || cw <= 0 || cow <= 0 || k <= 0 || (k % 2) == 0 ||
      (cp % 8) != 0 || cp < c_in || cp >= c_in + 8 || stages != STAGES || splits < 1 ||
      (splits > 1 && !aligned16(ws)) || !aligned16(x) || !aligned16(w) || !aligned16(wk) ||
      !aligned16(y))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const TapsArgs args{static_cast<const __nv_bfloat16*>(x),
                      static_cast<const __nv_bfloat16*>(wk),
                      static_cast<__nv_bfloat16*>(y), static_cast<float*>(ws),
                      static_cast<int64_t>(n) * h * wd, h, wd, k, k, cp, co, dx, 1, splits};
  return run<kSpatial>(w, args, cw, cow, dx, bn, smem_bytes, device,
                       reinterpret_cast<cudaStream_t>(stream));
}

// Launches K2 the same way: w (k, cw, cow) the forward weight; dx = 0: y =
// conv(x, w), x (b, t, s, cx) with cw channels (cx = cw, or cw zero-padded
// to a multiple of 8), y (b, t, s, cow); dx = 1: x the incoming gradient
// with cow channels, y (b, t, s, cw). cp = cx rounded up to 8 is the
// contraction width of a tap; where cx % 8 != 0, xp is a (b*t*s, cp)
// scratch that the pad kernel copies x into first (else null). wk (out
// channels, k, cp) bf16 scratch; ws as for K1. The plan (bn, stages,
// splits, smem_bytes) comes from ops/conv2plus1d.py::temporal_plan.
int fvt_temporal_conv_bf16(const void* x, const void* w, void* wk, void* xp, void* y, void* ws,
                           long long b, int t, int s, int cx, int cp, int cw, int cow, int k,
                           int dx, int bn, int stages, int splits, int smem_bytes, int device,
                           void* stream) {
  const int c_in = dx ? cow : cw, co = dx ? cw : cow;
  const bool ragged = cx % 8 != 0;
  if (b <= 0 || t <= 0 || s <= 0 || cw <= 0 || cow <= 0 || k <= 0 || (k % 2) == 0 ||
      cx < c_in || cx >= c_in + 8 || cp != (cx + 7) / 8 * 8 || ragged != (xp != nullptr) ||
      stages != STAGES || splits < 1 || (splits > 1 && !aligned16(ws)) || !aligned16(x) ||
      !aligned16(w) || !aligned16(wk) || !aligned16(y) || !aligned16(xp))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int64_t M = static_cast<int64_t>(b) * t * s;
  if (ragged) {
    const int64_t want = (M * (cp / 8) + THREADS - 1) / THREADS;
    temporal_conv_pad_kernel<<<static_cast<int>(want < 8192 ? want : 8192), THREADS, 0, st>>>(
        static_cast<const unsigned short*>(x), static_cast<unsigned short*>(xp), M, cx, cp);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const TapsArgs args{static_cast<const __nv_bfloat16*>(ragged ? xp : x),
                      static_cast<const __nv_bfloat16*>(wk), static_cast<__nv_bfloat16*>(y),
                      static_cast<float*>(ws), M, t, s, k, 1, cp, co, dx, 1, splits};
  return run<kTemporal>(w, args, cw, cow, dx, bn, smem_bytes, device, st);
}

}  // extern "C"
