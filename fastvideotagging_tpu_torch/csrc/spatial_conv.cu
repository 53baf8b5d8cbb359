// K1: the spatial 1 x k x k conv on Hopper, forward and dx.
//
//   spatial_conv_hopper_kernel  replaces fastvideotagging_tpu/ops/conv2plus1d.py
//                               _spatial_kernel / _spatial_pallas (TPU Pallas):
//       y[n,h,w,co] = sum_{dh,dw,c} x[n, h+dh-p, w+dw-p, c] * W[dh,dw,c,co]
//       x (N, H, W, C) bf16 -> y (N, H, W, Co) bf16, f32 accumulation,
//       zeros outside the frame, p = k/2 (stride 1, odd k). dx is the same
//       kernel on the incoming gradient with the taps flipped and the
//       channels transposed (``flip``, below).
//
// One implicit GEMM. Rows are output pixels m = (n*H + h)*W + w, columns
// output channels, and the contraction runs over kappa = tap*C + c with
// tap = dh*k + dw. A first small kernel (spatial_conv_weight_kernel) lays
// the forward weight out K-major, wk[co][tap][c], for dx straight from the
// forward weight with the tap order reversed in the main kernel, and C is
// zero-padded to a multiple of 8 (the wrapper pads x, this kernel wk), so a
// 16-byte chunk of A (8 channels) lies inside one tap: each chunk works out
// its own (tap, c) and source row m + (dh-p)*W + (dw-p). Slices of BK = 64
// run over kappa straight through, with no per-tap rounding; only the last
// slice of the whole contraction is ragged. Where the grid of tiles cannot
// fill the card, the contraction is split over blocks into f32 partial
// sums that spatial_conv_reduce_kernel adds in a fixed order.
//
// Tile and ring. One block of 256 threads (two warpgroups) owns BM = 128
// output rows and BN output channels, BN in {64, 128, 144}: the plan
// (ops/conv2plus1d.py::spatial_plan) takes BN to cover Co or to divide it,
// so that A is gathered as few times as the grid allows. Loads are 16-byte
// cp.async.cg into a ring of STAGES = 3 slices (compiled in from the
// plan), two of them in flight while the tensor cores work on the third;
// a row outside the frame or past M, a slice past the contraction and a
// weight row past Co load with src-size 0, so the hardware writes zeros
// with no branch around the store. A and W slices are K-major, 128 bytes a
// row, in the 128-byte swizzle (chunk ^ row % 8) that a wgmma shared-memory
// descriptor names; the stages are 1024-byte aligned. At BN = 144 a block
// takes 103 KB and at most 128 registers a thread, so two blocks share an
// SM (three at BN = 64): one block's prologue, epilogue and waits overlap
// the other's products. On the card this beat a 4- or 5-slice ring with
// one block per SM and one product group left running across slices.
//
// The product (rung 2, wgmma): each warpgroup owns 64 of the 128 rows and
// issues wgmma.mma_async.m64nBNk16 (bf16 x bf16 -> f32) with A and B both
// read from the swizzled slices through shared-memory descriptors: fence,
// the four k16 steps of a slice, commit, issue the next load, wait. The
// epilogue rounds the f32 accumulators to bf16 in registers, stages them
// in shared memory once every load has landed and every product is done,
// and stores 16 bytes at a time (2 where Co % 8 != 0), masked at the M and
// Co edges.
//
// What the redesign does about the first K1 (the WMMA tile that K2 keeps
// in csrc/conv2plus1d.cu), item by item: (1) WMMA 16x16x16 through
// mma.sync -> wgmma, the only way to Hopper's full tensor-core rate; (2)
// one register-staged shared stage with a barrier on each side of every
// slice -> a cp.async ring with two slices loading and two blocks per SM;
// (3) 128 x 64 tiles -> BN covers Co = 144 in one tile (was 3 tiles, 192
// columns computed) and 1152 in 8 (was 18), so A is gathered once or a
// few times; (4) 32-deep slices rounded up per tap -> kappa runs straight
// through (dx at C = 144 computed 160 channels a tap); (5) an f32 epilogue
// aliasing the stage -> bf16 rounded in registers, staged in the ring only
// after the last product. Rung 1 of the same design (ldmatrix + mma.sync
// m16n8k16 on the same ring and layout, 8 warps of 32 x BN/2) is in the
// history of this file; wgmma replaced only its inner product.
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s): operations,
// at every r2plus1d_18 site, forward and dx. At clip_batch 8, counting the
// taps that fall inside the frame: stage 1 (8x16x56x56, 64 -> 144) 65.0
// GFLOP -> 65.7 us; stage 2 (28x28, 128 -> 288) 31.7 GFLOP -> 32.1 us;
// stage 3 (14x14, 256 -> 576) 15.1 GFLOP -> 15.3 us; stage 4 (7x7, 512 ->
// 1152) 6.8 GFLOP -> 6.9 us (x 4 / 3 / 3 / 3 launches a forward: 0.426 ms);
// dx the same operations with C and Co swapped. The kernel also computes
// the taps that fall into the zero padding (2.4 % more at stage 1, 22 % at
// stage 4).

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
  static constexpr int SMEM = STAGES * STAGE + ALIGN;  // + slack to align the base
  static constexpr int LDS = BN + 8;    // bf16 per row of the epilogue's staging tile
  static_assert(BN % 16 == 0 && STAGE % ALIGN == 0, "BN must be a multiple of 16");
  static_assert(BM * LDS * 2 <= STAGES * STAGE, "the staging tile fits the ring");
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
// proxy: each thread fences its own copies before the barrier.
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

// x (M, C) rows of pixels, wk (Co, k*k, C) K-major; y (M, Co). Block b
// computes kappa chunk b % splits of column tile (b / splits) % n_tiles of
// row tile b / (splits * n_tiles): the chunks and column tiles of one row
// tile run side by side and share its A rows in L2. With one chunk the
// block writes bf16 y; with more it writes its f32 partial sums to ws
// (splits, M, Co), which spatial_conv_reduce_kernel adds up in chunk order.
// SPLIT is splits > 1, so that the common case carries none of its code.
// At BN = 64 the block fits 80 registers a thread and three blocks an SM.
template <int BN, bool SPLIT>
__global__ void __launch_bounds__(THREADS, (BN <= 64 ? 3 : 2))
spatial_conv_hopper_kernel(const __nv_bfloat16* __restrict__ x,
                           const __nv_bfloat16* __restrict__ wk,
                           __nv_bfloat16* __restrict__ y, float* __restrict__ ws, int64_t M,
                           int H, int W, int C, int Co, int k, int flip, int n_tiles,
                           int splits) {
  using T = Tile<BN>;
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
  const int kk = k * k, p = k / 2;
  const int K = kk * C;
  const int KT = (K + BK - 1) / BK;
  // this block's slices of the contraction: [kt0, kt0 + NK)
  const int kt0 = SPLIT ? static_cast<int>(static_cast<int64_t>(split) * KT / splits) : 0;
  const int NK =
      SPLIT ? static_cast<int>(static_cast<int64_t>(split + 1) * KT / splits) - kt0 : KT;

  // Loader: thread tid moves chunk j = tid % 8 of rows tid / 8 + 32 q, in
  // A (4 rows) and in the weight slice (BN / 32 rows, rounded up).
  const int j = tid & 7;
  const int r0 = tid >> 3;
  int ph[4], pw[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int64_t m = m0 + r0 + 32 * q;
    if (m < M) {
      pw[q] = static_cast<int>(m % W);
      ph[q] = static_cast<int>((m / W) % H);
    } else {
      ph[q] = pw[q] = kOutside;
    }
  }
  const __nv_bfloat16* xrow = x + (m0 + r0) * C;        // row r0's pixel
  const __nv_bfloat16* wrow = wk + static_cast<int64_t>(n0 + r0) * K;

  // The loads walk kappa in order, one slice a call: this thread's chunk
  // starts at kappa = kt0 * BK + j * 8 and moves on by BK, its (tap, c) and
  // the tap's (dh, dw) carried along instead of divided out again.
  const int kap0 = kt0 * BK + j * 8;
  int ld_tap = kap0 / C;
  int ld_c = kap0 - ld_tap * C;
  int ld_dh = ld_tap / k, ld_dw = ld_tap % k;
  auto load = [&](int s) {
    const bool kin = ld_tap < kk;
    const int dh = ld_dh - p, dw = ld_dw - p;
    const int64_t shift = (static_cast<int64_t>(dh) * W + dw) * C + ld_c;
    const uint32_t sa = base + s * T::STAGE;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int hh = ph[q] + dh, ww = pw[q] + dw;
      const bool ok = kin && hh >= 0 && hh < H && ww >= 0 && ww < W;
      const __nv_bfloat16* src = ok ? xrow + static_cast<int64_t>(32 * q) * C + shift : x;
      cp_async16(sa + swz(r0 + 32 * q, j), src, ok);
    }
    const int wcol = (flip ? kk - 1 - ld_tap : ld_tap) * C + ld_c;
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
      if (++ld_dw == k) {
        ld_dw = 0;
        ++ld_dh;
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
  if constexpr (SPLIT) {  // f32 partial sums, 8 bytes a store, straight from registers
    float* out = ws + static_cast<int64_t>(split) * M * Co;
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

// y = bf16(sum over s of ws[s]), s in order: the same sums, bit for bit,
// on every launch (no atomics). total = M * Co.
__global__ void __launch_bounds__(THREADS)
spatial_conv_reduce_kernel(const float* __restrict__ ws, __nv_bfloat16* __restrict__ y,
                           int64_t total, int splits) {
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

// K1's weight layout, K-major with the contraction's channels zero-padded
// to cp: wk[a][t][b], a < A out channels, t < k*k taps, b < cp, from the
// forward weight w (k*k, cw, cow).
//   forward (dx = 0): A = cow, wk[a][t][b] = b < cw ? w[t][b][a] : 0, a
//     transpose of each tap, through a 32 x 32 shared tile so that both
//     sides move whole rows;
//   dx (dx = 1): A = cw, wk[a][t][b] = b < cow ? w[t][a][b] : 0, rows
//     copied as they are (the kernel reads the taps in reverse), 16 bytes
//     a thread where cow % 8 == 0.
// Grid (cp / 32, A / 32, k*k) rounded up, 32 x 8 threads.
__global__ void __launch_bounds__(256)
spatial_conv_weight_kernel(const unsigned short* __restrict__ w,
                           unsigned short* __restrict__ wk, int kk, int cw, int cow, int cp,
                           int dx) {
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
    const int vec = cow % 8 == 0 ? 8 : 1;  // then cp == cow
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

constexpr int kMaxDevices = 64;

// Opts the instance in to its shared memory once per device and size (a
// host call, not free), then launches it.
template <int BN, bool SPLIT>
cudaError_t start(unsigned blocks, int smem_bytes, int device, cudaStream_t s,
                  const void* x, const void* w, void* y, void* ws, int64_t M, int h, int wd,
                  int c, int co, int k, int flip, int n_tiles, int splits) {
  auto kern = spatial_conv_hopper_kernel<BN, SPLIT>;
  static int opted_in[kMaxDevices] = {};
  if (opted_in[device] < smem_bytes) {
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return err;
    opted_in[device] = smem_bytes;
  }
  kern<<<blocks, THREADS, smem_bytes, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<__nv_bfloat16*>(y), static_cast<float*>(ws), M, h, wd, c, co, k, flip,
      n_tiles, splits);
  return cudaGetLastError();
}

template <int BN>
int launch(const void* x, const void* w, void* y, void* ws, int64_t M, int h, int wd, int c,
           int co, int k, int flip, int splits, int smem_bytes, int device, cudaStream_t s) {
  if (smem_bytes < Tile<BN>::SMEM || device < 0 || device >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_tiles = (co + BN - 1) / BN;
  const int64_t blocks = (M + BM - 1) / BM * n_tiles * splits;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  const unsigned nb = static_cast<unsigned>(blocks);
  cudaError_t err =
      splits > 1 ? start<BN, true>(nb, smem_bytes, device, s, x, w, y, ws, M, h, wd, c, co, k,
                                   flip, n_tiles, splits)
                 : start<BN, false>(nb, smem_bytes, device, s, x, w, y, ws, M, h, wd, c, co,
                                    k, flip, n_tiles, splits);
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const int64_t total = M * co;
  const int64_t items = (total & 3) == 0 ? total / 4 : total;  // float4s or floats
  const int64_t want = (items + THREADS - 1) / THREADS;
  const int reduce_blocks = static_cast<int>(want < 4096 ? want : 4096);
  spatial_conv_reduce_kernel<<<reduce_blocks, THREADS, 0, s>>>(
      static_cast<const float*>(ws), static_cast<__nv_bfloat16*>(y), total, splits);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

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
  const int64_t M = static_cast<int64_t>(n) * h * wd;
  const int c = cp, flip = dx;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const dim3 wgrid((cp + 31) / 32, (co + 31) / 32, k * k);
  spatial_conv_weight_kernel<<<wgrid, 256, 0, s>>>(static_cast<const unsigned short*>(w),
                                                  static_cast<unsigned short*>(wk), k * k, cw,
                                                  cow, cp, dx);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (bn) {
    case 64:
      return launch<64>(x, wk, y, ws, M, h, wd, c, co, k, flip, splits, smem_bytes, device, s);
    case 128:
      return launch<128>(x, wk, y, ws, M, h, wd, c, co, k, flip, splits, smem_bytes, device, s);
    case 144:
      return launch<144>(x, wk, y, ws, M, h, wd, c, co, k, flip, splits, smem_bytes, device, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
