// K4: the fused (2+1)D inference block on Hopper.
//
//   fused_block_hopper_kernel  replaces fastvideotagging_tpu/ops/fused_block.py
//                              _kernel / _fused_pallas (TPU Pallas):
//       mid[b,t,s,m] = bf16(max(0, (sum_{dh,dw,c} x[b,t,h+dh-p,w+dw-p,c]
//                                   * Wsp[dh,dw,c,m]) * scale[m] + bias[m]))
//       y[b,t,s,co]  = bf16(sum_{dt,m} mid[b,t+dt-p,s,m] * Wtmp[dt,m,co])
//       x (B,T,H,W,C) bf16, Wsp (k,k,C,M) bf16, scale/bias (M,) f32 (the
//       folded BatchNorm), Wtmp (k,M,Co) bf16 -> y (B,T,H,W,Co) bf16; f32
//       accumulation, zeros outside the frame for the spatial taps, and the
//       temporal taps whose frame lies outside [0,T) skipped (zero, not
//       ReLU(bias): the boundary applies after the affine and ReLU). Stride
//       1, odd k.
//
// The point of the kernel is that mid (the widest tensor of the network,
// e.g. 8x16x56x56x144 bf16 = 115.6 MB at stage 1) never reaches device
// memory. Design:
//
// Rows and groups. Rows are the pixels of the flattened B*H*W plane (a
// row knows its (b, h, w)), so tiles cross clips and a 7 x 7 plane of 8
// clips fills 7 tiles of 64 rows. A block owns BM rows and one group of MG
// mid channels (the grid is row tiles x groups, the groups of a row tile
// side by side so that they share its x rows in L2), and walks t = 0 ..
// T-1+p. For each frame it computes mid for its group only, over the
// whole contraction k*k*C, so no block recomputes another block's mid; BN
// and ReLU are per channel and stay local. The temporal GEMM then
// contracts over the group's channels only: with one group (stage 1) the
// block writes bf16 y; with G > 1 groups each block writes an f32 partial
// of y to a workspace and fused_block_reduce_kernel adds the G partials in
// group order and rounds once (no atomics: two launches are bitwise
// equal).
//
// The spatial GEMM is K1's (csrc/spatial_conv.cu) with another epilogue:
// an implicit GEMM over kappa = tap*Cp + c (x's channels zero-padded to Cp,
// a multiple of 8, by the wrapper), 16-byte cp.async with src-size 0 for
// the zero fill, BK = 64 slices of 128-byte rows in the 128-byte swizzle,
// and wgmma.mma_async m64nMGk16 with A and B both K-major from shared-memory
// descriptors, a warpgroup per 64 rows. The weights are laid out K-major
// per call by fused_block_weight_kernel (K1's forward layout: Wsp as (M,
// k*k, Cp), Wtmp as (Co, k, Mp), Mp = M rounded up to 8, zero-padded).
//
// Epilogue 1 goes straight from the accumulators into the ring: the thread
// that holds an f32 accumulator applies scale and bias (__fmul_rn then
// __fadd_rn, as the plain version rounds), ReLU, rounds to bf16 and writes
// its slot of the ring, which holds the last k frames of the group's mid,
// BM rows of MG channels. Channels past M are written as 0. The ring is
// K-major in the no-swizzle ("interleave") layout that a wgmma descriptor
// names: core matrices of 8 rows x 8 channels (128 contiguous bytes), so
// MG = 144 takes exactly 144 channels (the 128-byte swizzle would round a
// row up to 192) and the epilogue's stores are conflict-free.
//
// The temporal GEMM (rung 2) is wgmma m64nCTk16 too, A from the ring and
// B, Wtmp's rows of the group for a tile of CT <= 256 output channels,
// from the same cp.async ring of slices that feeds the spatial GEMM: its
// contraction, the taps whose frame lies in [0, T) times the group's MG
// channels, runs in slices of as many 64-channel atoms as a stage holds.
// Co = 512 takes two passes over the ring. The spatial and temporal
// accumulators are never live at the same time. All slices of a block,
// spatial and temporal, form one stream that the loads walk one slice
// ahead of the products, with one group of products left in flight. (Rung 1, the temporal GEMM on ldmatrix +
// mma.sync from a padded ring, is in the history of this file.)
//
// The plan (BM, MG, groups, CT, ring depth, shared memory) has one
// source, ops/fused_block.py::fused_plan; the ring's depth is compiled in
// from it.
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s): operations
// at every r2plus1d_18 site (stage 1, clip_batch 8: 86.3 GFLOP of taps
// inside the frame against 103 MB of x, y and weights -> 87.2 us). The
// spatial GEMM holds three quarters of the operations. The redesign
// against the first K4 (WMMA through registers into one staged slice with
// a barrier on each side, a Co split that recomputed mid 2x at stage 3 and
// 8x at stage 4, 32-row tiles that never crossed clips, mid passes of 64
// columns for M = 144, f32 tiles staged in shared memory for both
// epilogues): wgmma on a cp.async ring, mid-channel groups, rows over the
// flattened plane, the group's width as the GEMM's N, and epilogues from
// registers.
//
// On an NVIDIA H100 80GB HBM3 at a 700 W limit it is still far from that
// bound (chip_smoke.py phase 3c: 3.7-3.8 ms per r2plus1d_18 forward at 8
// clips, 6.7x the bound):
// a ring step costs about 0.2 us plus its bytes at the ~26 GB/s one SM
// draws from L2, and the steps of a block run one after another (loads,
// products, epilogues). Two producer warps or a producer warpgroup on
// mbarriers did not change that. What to cut next are bytes: the x rows
// gathered once per tap, and the weights read again by every row tile and
// frame.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

#if !defined(FVT_K4_STAGES)
#error "build through ops/_build.py, which passes ops/fused_block.py's tile plan"
#endif

constexpr int BK = 64;                 // contraction slice: 64 bf16 = 128 bytes a row
constexpr int STAGES = FVT_K4_STAGES;  // slices in the cp.async ring
constexpr int ALIGN = 1024;            // the 128-byte swizzle repeats every 8 rows
constexpr int kOutside = -(1 << 28);   // pixel coordinate of a row past B*H*W
constexpr int kMaxDevices = 64;
static_assert(STAGES == 3, "the ring's schedule is written for three stages");

// BM rows (a warpgroup per 64), MG mid channels a group, CT output
// channels a temporal pass.
template <int BM, int MG, int CT>
struct Tile {
  static constexpr int THREADS = 2 * BM;
  static constexpr int RPP = THREADS / 8;        // rows one loader pass covers (BM / 4)
  static constexpr int A_STAGE = BM * 128;       // x slice
  static constexpr int SP_STAGE = A_STAGE + MG * 128;  // x slice + Wsp slice
  static constexpr int TM_ATOM = CT * 128;       // Wtmp rows of 64 channels
  static constexpr int STAGE = SP_STAGE > TM_ATOM ? SP_STAGE : TM_ATOM;
  static constexpr int TA = STAGE / TM_ATOM;     // 64-channel atoms of a Wtmp slice
  static constexpr int KCHUNK = BM * 16;         // bytes of a ring frame's 8 channels
  static constexpr int SLOT = MG / 8 * KCHUNK;   // bytes of one ring frame
  static_assert(BM == 64 || BM == 128, "a warpgroup per 64 rows");
  static_assert(MG % 16 == 0 && MG <= 256 && STAGE % ALIGN == 0, "wgmma's N");
  static_assert(CT % RPP == 0 && (CT == 64 || CT == 128 || CT == 256), "temporal tile");
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

// Descriptor of a K-major operand in the no-swizzle ("interleave") layout:
// core matrices of 8 rows x 16 bytes stored as 128 contiguous bytes;
// leading offset = the bytes between core matrices along K, stride offset
// = the bytes between 8-row groups along M (here 128: rows are 16 bytes
// apart within a K chunk), layout type 0.
__device__ __forceinline__ uint64_t smem_desc_interleave(uint32_t addr, uint32_t k_stride) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(k_stride >> 4) << 16) | (static_cast<uint64_t>(128 >> 4) << 32);
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

__device__ __forceinline__ void wgmma_256(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
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
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_tile(float (&d)[N / 2], uint64_t da, uint64_t db) {
  if constexpr (N == 64) wgmma_64(d, da, db);
  else if constexpr (N == 128) wgmma_128(d, da, db);
  else if constexpr (N == 144) wgmma_144(d, da, db);
  else wgmma_256(d, da, db);
}

// A position in a block's stream of slices. For t_in = 0 .. T-1+p: the
// KT spatial slices of frame t_in (if t_in < T), then, for t_out = t_in -
// p >= 0, npass temporal passes of n slices each, n covering the taps
// whose frame lies in [0, T) times MG channels in slices of TK channels.
// n == 0: past the end.
struct Cursor {
  int t_in, kind, pass, kt, n, dt0, ntaps;  // kind 0: spatial, 1: temporal
};

struct Walk {
  int T, p, k, KT, npass, MG, TK;

  __device__ __forceinline__ void settle(Cursor& c) const {
    for (;;) {
      if (c.t_in >= T + p) {
        c.n = 0;
        return;
      }
      if (c.kind == 0) {
        if (c.t_in < T) {
          c.n = KT;
          return;
        }
        c.kind = 1;
        c.pass = 0;
        continue;
      }
      const int t_out = c.t_in - p;
      if (t_out >= 0 && c.pass < npass) {
        c.dt0 = max(0, p - t_out);
        c.ntaps = min(k - 1, T - 1 - t_out + p) - c.dt0 + 1;
        c.n = (c.ntaps * MG + TK - 1) / TK;
        return;
      }
      ++c.t_in;
      c.kind = 0;
      c.pass = 0;
    }
  }

  __device__ __forceinline__ void begin(Cursor& c) const {
    c.t_in = c.kind = c.pass = c.kt = 0;
    settle(c);
  }

  __device__ __forceinline__ void next(Cursor& c) const {
    if (c.n == 0 || ++c.kt < c.n) return;
    c.kt = 0;
    if (c.kind == 0) {
      c.kind = 1;
      c.pass = 0;
    } else {
      ++c.pass;
    }
    settle(c);
  }
};

// x (B, T, H, W, Cp), wsp (M, k*k, Cp), wt (Co, k, Mp), all K-major; R =
// B*H*W rows. Block b computes group b % groups of row tile b / groups.
// With one group it writes bf16 y; with more it writes its f32 partial of
// y to ws (groups, B*T*H*W, Co), which fused_block_reduce_kernel adds up.
template <int BM, int MG, int CT>
__global__ void __launch_bounds__(2 * BM, (BM == 64 ? 2 : 1))
fused_block_hopper_kernel(const __nv_bfloat16* __restrict__ x,
                          const __nv_bfloat16* __restrict__ wsp,
                          const float* __restrict__ scale, const float* __restrict__ bias,
                          const __nv_bfloat16* __restrict__ wt,
                          __nv_bfloat16* __restrict__ y, float* __restrict__ ws, int R, int T,
                          int H, int W, int Cp, int M, int Mp, int Co, int k, int groups) {
  using Tl = Tile<BM, MG, CT>;
  constexpr int TK = Tl::TA * BK;  // channels of a temporal slice
  // [STAGES slices (1024-aligned) | ring: k frames of BM x MG bf16 |
  //  the group's scale, bias: MG f32 each]
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + ALIGN - 1) & ~static_cast<uint32_t>(ALIGN - 1);
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t ring = base + STAGES * Tl::STAGE;
  unsigned char* ring_p = smem + STAGES * Tl::STAGE;
  // per channel pair: {scale[2i], scale[2i+1], bias[2i], bias[2i+1]}
  float4* s_affine = reinterpret_cast<float4*>(ring_p + k * Tl::SLOT);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wg = warp >> 2;
  const int group = blockIdx.x % groups;
  const int n0 = (blockIdx.x / groups) * BM;
  const int g0 = group * MG;
  const int HW = H * W, kk = k * k, p = k / 2;
  const int K = kk * Cp;
  const Walk walk{T, p, k, (K + BK - 1) / BK, (Co + CT - 1) / CT, MG, TK};
  const int mv = min(MG, M - g0);  // channels of the group that exist
  for (int i = tid; i < MG / 2; i += Tl::THREADS) {  // visible after the first barrier
    const int c0 = 2 * i, c1 = 2 * i + 1;
    s_affine[i] = make_float4(c0 < mv ? scale[g0 + c0] : 0.0f, c1 < mv ? scale[g0 + c1] : 0.0f,
                              c0 < mv ? bias[g0 + c0] : 0.0f, c1 < mv ? bias[g0 + c1] : 0.0f);
  }

  // Loader: thread tid moves chunk j = tid % 8 of rows tid / 8 + RPP q: x
  // (4 rows), Wsp (MG / RPP rows, rounded up) or Wtmp (CT / RPP rows of
  // each of the slice's TA atoms).
  const int j = tid & 7;
  const int r0 = tid >> 3;
  int ph[4], pw[4];
  int64_t abase[4];  // row's pixel at t = 0, in elements of x
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int n = n0 + r0 + Tl::RPP * q;
    if (n < R) {
      const int b = n / HW, s = n - b * HW;
      ph[q] = s / W;
      pw[q] = s - ph[q] * W;
      abase[q] = (static_cast<int64_t>(b) * T * HW + s) * Cp;
    } else {
      ph[q] = pw[q] = kOutside;
      abase[q] = 0;
    }
  }
  const int64_t frame_x = static_cast<int64_t>(HW) * Cp;

  auto load = [&](const Cursor& cu, int s) {
    const uint32_t st = base + s * Tl::STAGE;
    if (cu.kind == 0) {
      const int kap = cu.kt * BK + j * 8;
      const int tap = kap / Cp;
      const int c = kap - tap * Cp;
      const bool kin = tap < kk;
      const int dh = tap / k - p, dw = tap % k - p;
      const int64_t shift =
          cu.t_in * frame_x + (static_cast<int64_t>(dh) * W + dw) * Cp + c;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int hh = ph[q] + dh, ww = pw[q] + dw;
        const bool ok = kin && hh >= 0 && hh < H && ww >= 0 && ww < W;
        cp_async16(st + swz(r0 + Tl::RPP * q, j), ok ? x + abase[q] + shift : x, ok);
      }
      const uint32_t sb = st + Tl::A_STAGE;
#pragma unroll
      for (int q = 0; q < (MG + Tl::RPP - 1) / Tl::RPP; ++q) {
        const int n = r0 + Tl::RPP * q;
        if (n < MG) {
          const bool ok = kin && g0 + n < M;
          const __nv_bfloat16* src = ok ? wsp + static_cast<int64_t>(g0 + n) * K + kap : wsp;
          cp_async16(sb + swz(n, j), src, ok);
        }
      }
    } else {
      const int co0 = cu.pass * CT;
#pragma unroll
      for (int a = 0; a < Tl::TA; ++a) {
        const int kap = cu.kt * TK + a * BK + j * 8;
        const int dtt = kap / MG;
        const int m = kap - dtt * MG;
        const bool kin = kap < cu.ntaps * MG && g0 + m < Mp;
        const int dt = cu.dt0 + dtt;
#pragma unroll
        for (int q = 0; q < CT / Tl::RPP; ++q) {
          const int n = r0 + Tl::RPP * q;
          const bool ok = kin && co0 + n < Co;
          const __nv_bfloat16* src =
              ok ? wt + (static_cast<int64_t>(co0 + n) * k + dt) * Mp + g0 + m : wt;
          cp_async16(st + a * Tl::TM_ATOM + swz(n, j), src, ok);
        }
      }
    }
  };

  // Spatial product: warpgroup wg owns rows 64 wg .. +63 and the group's MG
  // channels; its accumulator is MG / 2 f32 a thread.
  auto compute_sp = [&](int s, float (&acc)[MG / 2]) {
    const uint32_t sa = base + s * Tl::STAGE + wg * 64 * 128;
    const uint32_t sb = base + s * Tl::STAGE + Tl::A_STAGE;
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks)
      wgmma_tile<MG>(acc, smem_desc(sa + ks * 32), smem_desc(sb + ks * 32));
    wgmma_commit();
    fence_acc(acc);
  };

  // Epilogue 1: warp w of the warpgroup holds rows 16 (w % 4) .. +15 of
  // the group's 64, n8 block jn in acc[4jn .. 4jn+3] (columns lane % 4 * 2,
  // +1; rows lane / 4 and lane / 4 + 8) -> scale, bias, ReLU, bf16 into the
  // ring slot, 4 bytes a store: the 8 rows x 4 lanes of a store cover one
  // 128-byte core-matrix column, conflict-free.
  auto to_ring = [&](const float (&acc)[MG / 2], int slot) {
    unsigned char* sl = ring_p + slot * Tl::SLOT;
    const int row = wg * 64 + (warp & 3) * 16 + (lane >> 2);
#pragma unroll
    for (int jn = 0; jn < MG / 8; ++jn) {
      const int col = jn * 8 + (lane & 3) * 2;
      const float4 af = s_affine[col / 2];
#pragma unroll
      for (int h8 = 0; h8 < 2; ++h8) {
        float v0 = fmaxf(__fadd_rn(__fmul_rn(acc[4 * jn + 2 * h8], af.x), af.z), 0.0f);
        float v1 = fmaxf(__fadd_rn(__fmul_rn(acc[4 * jn + 2 * h8 + 1], af.y), af.w), 0.0f);
        if (col >= mv) v0 = 0.0f;
        if (col + 1 >= mv) v1 = 0.0f;
        *reinterpret_cast<__nv_bfloat162*>(sl + jn * Tl::KCHUNK + (row + 8 * h8) * 16 +
                                           (lane & 3) * 4) = __floats2bfloat162_rn(v0, v1);
      }
    }
  };

  // Temporal product (rung 2, wgmma): warpgroup wg owns rows 64 wg .. +63
  // and the pass's CT columns; A is the ring slot of frame t_out + dt - p
  // (K-major, interleave layout: k16 step m starts at chunk m / 8), B the
  // Wtmp slice (TA atoms of CT rows x 64 channels, K-major, 128-byte
  // swizzle). Only the k16 steps inside the pass's contraction are issued.
  auto compute_tm = [&](int s, int kt, int t_out, int dt0, int ntaps, float (&acc)[CT / 2]) {
    const int kv = min(TK / 16, (ntaps * MG - kt * TK) / 16);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kq = 0; kq < TK / 16; ++kq) {
      if (kq < kv) {
        const uint32_t sb = base + s * Tl::STAGE + (kq / (BK / 16)) * Tl::TM_ATOM +
                            (kq % (BK / 16)) * 32;
        const int kap = kt * TK + kq * 16;
        const int dtt = kap / MG;
        const int m = kap - dtt * MG;
        const int f = t_out + dt0 + dtt - p;  // in [0, T)
        const uint32_t sa = ring + (f % k) * Tl::SLOT + (m / 8) * Tl::KCHUNK + wg * 64 * 16;
        wgmma_tile<CT>(acc, smem_desc_interleave(sa, Tl::KCHUNK), smem_desc(sb));
      }
    }
    wgmma_commit();
    fence_acc(acc);
  };

  // Epilogue 2: the accumulators (warp w of the warpgroup: rows 16 (w % 4)
  // + lane / 4, +8; n8 block jn in acc[4jn .. 4jn+3], columns lane % 4 * 2,
  // +1) straight from registers to y (bf16) or to this group's f32 partial,
  // masked at the row and Co edges.
  int64_t orow[2];  // y row of (b, 0, s), or -1 past B*H*W
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int n = n0 + wg * 64 + (warp & 3) * 16 + 8 * i + (lane >> 2);
    const int b = n / HW;
    orow[i] = n < R ? static_cast<int64_t>(b) * T * HW + (n - b * HW) : -1;
  }
  const int64_t total = static_cast<int64_t>(R) * T * Co;
  auto store_y = [&](const float (&acc)[CT / 2], int t_out, int co0) {
#pragma unroll
    for (int h8 = 0; h8 < 2; ++h8) {
      const int64_t o = orow[h8];
      if (o < 0) continue;
      const int64_t at = (o + static_cast<int64_t>(t_out) * HW) * Co;
#pragma unroll
      for (int jn = 0; jn < CT / 8; ++jn) {
        const int col = co0 + jn * 8 + (lane & 3) * 2;
        if (col >= Co) continue;
        const float v0 = acc[4 * jn + 2 * h8], v1 = acc[4 * jn + 2 * h8 + 1];
        if (groups == 1) {
          if ((Co & 1) == 0) {
            *reinterpret_cast<__nv_bfloat162*>(y + at + col) = __floats2bfloat162_rn(v0, v1);
          } else {
            y[at + col] = __float2bfloat16_rn(v0);
            if (col + 1 < Co) y[at + col + 1] = __float2bfloat16_rn(v1);
          }
        } else {
          float* out = ws + group * total + at + col;
          if ((Co & 1) == 0) {
            *reinterpret_cast<float2*>(out) = make_float2(v0, v1);
          } else {
            out[0] = v0;
            if (col + 1 < Co) out[1] = v1;
          }
        }
      }
    }
  };

  // The ring of slices (three stages): one wgmma group stays in flight
  // across slices, so the tensor cores are not drained at every slice.
  // Slice i: wait for its loads and one barrier (every warpgroup has waited
  // for the products of slice i-2), the load of slice i+1 into the stage
  // slice i-2 used, the product of slice i, and a wait that leaves it in
  // flight (slice i-1's products are done). The last slice of a frame or a
  // pass waits for all before its epilogue.
  Cursor ld;
  walk.begin(ld);
  if (ld.n != 0) load(ld, 0);
  cp_async_commit();
  walk.next(ld);
  int cs = 0, ls = 1;  // stages of the next product and the next load
  auto begin_slice = [&]() {
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();
    if (ld.n != 0) load(ld, ls);
    cp_async_commit();
    walk.next(ld);
  };
  auto end_slice = [&]() {
    if (++ls == STAGES) ls = 0;
    if (++cs == STAGES) cs = 0;
  };

  for (int t_in = 0; t_in < T + p; ++t_in) {
    if (t_in < T) {
      float acc[MG / 2];
#pragma unroll
      for (int i = 0; i < MG / 2; ++i) acc[i] = 0.0f;
      for (int kt = 0; kt < walk.KT; ++kt) {
        begin_slice();
        compute_sp(cs, acc);
        wgmma_wait<1>();
        fence_acc(acc);
        end_slice();
      }
      wgmma_wait<0>();
      fence_acc(acc);
      to_ring(acc, t_in % k);  // read after the next barrier
    }
    const int t_out = t_in - p;
    if (t_out < 0) continue;
    const int dt0 = max(0, p - t_out);
    const int ntaps = min(k - 1, T - 1 - t_out + p) - dt0 + 1;
    const int nts = (ntaps * MG + TK - 1) / TK;
    for (int pass = 0; pass < walk.npass; ++pass) {
      float acc[CT / 2];
#pragma unroll
      for (int i = 0; i < CT / 2; ++i) acc[i] = 0.0f;
      for (int kt = 0; kt < nts; ++kt) {
        begin_slice();
        compute_tm(cs, kt, t_out, dt0, ntaps, acc);
        wgmma_wait<1>();
        fence_acc(acc);
        end_slice();
      }
      wgmma_wait<0>();
      fence_acc(acc);
      store_y(acc, t_out, pass * CT);
    }
  }
  cp_async_wait<0>();
}

// y = bf16(sum over g of ws[g]), g in order: the same sums, bit for bit,
// on every launch (no atomics). total = B*T*H*W*Co.
__global__ void __launch_bounds__(256)
fused_block_reduce_kernel(const float* __restrict__ ws, __nv_bfloat16* __restrict__ y,
                          int64_t total, int groups) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * 256;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x;
  if ((total & 3) == 0) {
    for (int64_t i = first; i < total / 4; i += stride) {
      float4 a = reinterpret_cast<const float4*>(ws)[i];
      for (int g = 1; g < groups; ++g) {
        const float4 b = reinterpret_cast<const float4*>(ws + g * total)[i];
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
      for (int g = 1; g < groups; ++g) a += ws[g * total + i];
      y[i] = __float2bfloat16_rn(a);
    }
  }
}

// A weight K-major with its contraction's channels zero-padded to cp:
// wk[a][t][b] = b < cw ? w[t][b][a] : 0, a < cow, t < taps, b < cp, from w
// (taps, cw, cow) — a transpose of each tap through a 32 x 32 shared tile,
// so that both sides move whole rows (K1's forward layout). Wsp (k*k, C, M)
// -> (M, k*k, Cp); Wtmp (k, M, Co) -> (Co, k, Mp). Grid (cp / 32, cow /
// 32, taps) rounded up, 32 x 8 threads.
__global__ void __launch_bounds__(256)
fused_block_weight_kernel(const unsigned short* __restrict__ w, unsigned short* __restrict__ wk,
                          int taps, int cw, int cow, int cp) {
  __shared__ unsigned short tile[32][33];
  const int t = blockIdx.z;
  const int b0 = blockIdx.x * 32, a0 = blockIdx.y * 32;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const unsigned short* wt = w + static_cast<int64_t>(t) * cw * cow;
#pragma unroll
  for (int i = 0; i < 32; i += 8) {  // read rows b of w[t] (cow contiguous)
    const int b = b0 + ty + i, a = a0 + tx;
    tile[ty + i][tx] = (b < cw && a < cow) ? wt[static_cast<int64_t>(b) * cow + a] : 0;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 32; i += 8) {  // write rows a of wk (cp contiguous)
    const int a = a0 + ty + i, b = b0 + tx;
    if (a < cow && b < cp) wk[(static_cast<int64_t>(a) * taps + t) * cp + b] = tile[tx][ty + i];
  }
}

cudaError_t layout(const void* w, void* wk, int taps, int cw, int cow, int cp, cudaStream_t s) {
  const dim3 grid((cp + 31) / 32, (cow + 31) / 32, taps);
  fused_block_weight_kernel<<<grid, 256, 0, s>>>(static_cast<const unsigned short*>(w),
                                                 static_cast<unsigned short*>(wk), taps, cw,
                                                 cow, cp);
  return cudaGetLastError();
}

struct Args {
  const __nv_bfloat16 *x, *wsp;
  const float *scale, *bias;
  const __nv_bfloat16* wt;
  __nv_bfloat16* y;
  float* ws;
  int R, T, H, W, Cp, M, Mp, Co, k, groups;
  unsigned blocks;
  int smem_bytes, device;
  cudaStream_t stream;
};

// Bytes of shared memory an instance needs (the wrapper's fused_plan
// computes the same).
template <int BM, int MG, int CT>
int smem_needed(int k) {
  using Tl = Tile<BM, MG, CT>;
  return STAGES * Tl::STAGE + k * Tl::SLOT + 2 * MG * 4 + ALIGN;
}

// Opts the instance in to its shared memory once per device and size (a
// host call, not free), then launches it.
template <int BM, int MG, int CT>
cudaError_t start(const Args& a) {
  if (a.smem_bytes < smem_needed<BM, MG, CT>(a.k)) return cudaErrorInvalidValue;
  auto kern = fused_block_hopper_kernel<BM, MG, CT>;
  static int opted_in[kMaxDevices] = {};
  if (opted_in[a.device] < a.smem_bytes) {
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem_bytes);
    if (err != cudaSuccess) return err;
    opted_in[a.device] = a.smem_bytes;
  }
  kern<<<a.blocks, 2 * BM, a.smem_bytes, a.stream>>>(a.x, a.wsp, a.scale, a.bias, a.wt, a.y,
                                                      a.ws, a.R, a.T, a.H, a.W, a.Cp, a.M,
                                                      a.Mp, a.Co, a.k, a.groups);
  return cudaGetLastError();
}

template <int BM, int MG>
cudaError_t start_ct(int ct, const Args& a) {
  switch (ct) {
    case 64: return start<BM, MG, 64>(a);
    case 128: return start<BM, MG, 128>(a);
    case 256: return start<BM, MG, 256>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <int BM>
cudaError_t start_mg(int mg, int ct, const Args& a) {
  switch (mg) {
    case 64: return start_ct<BM, 64>(ct, a);
    case 144: return start_ct<BM, 144>(ct, a);
    default: return cudaErrorInvalidValue;
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

extern "C" {

// Launches K4 on `stream` of CUDA device `device`: the two weight layouts
// (w_sp into wsp_k (m, k*k, cp), w_tmp into wt_k (co, k, m rounded up to
// 8), bf16 scratch), the fused kernel and, with groups > 1, the reduce;
// returns cudaGetLastError() after the launches (0 on success). x (b, t,
// h, w, cp) bf16 with its c channels zero-padded to cp; scale, bias (m,)
// f32; y (b, t, h, w, co) bf16; ws (groups, b*t*h*w, co) f32 scratch when
// groups > 1, else unused. x, the scratch and y 16-byte aligned. The plan
// (bm, mg, groups, ct, stages, smem_bytes) comes from
// ops/fused_block.py::fused_plan; the launch refuses one it was not built
// for or that does not fit. The device is set explicitly: this library
// carries its own CUDA runtime, whose current device is not the caller's.
int fvt_fused_block_bf16(const void* x, const void* w_sp, const void* scale,
                         const void* bias, const void* w_tmp, void* wsp_k, void* wt_k, void* y,
                         void* ws, long long b, int t, int h, int w, int cp, int c, int m,
                         int co, int k, int bm, int mg, int groups, int ct, int stages,
                         int smem_bytes, int device, void* stream) {
  const int64_t rows = static_cast<int64_t>(b) * h * w;
  if (b <= 0 || t <= 0 || h <= 0 || w <= 0 || c <= 0 || m <= 0 || co <= 0 || k <= 0 ||
      (k % 2) == 0 || (cp % 8) != 0 || cp < c || cp >= c + 8 || mg <= 0 ||
      groups != (m + mg - 1) / mg || stages != STAGES || smem_bytes > 232448 || device < 0 ||
      device >= kMaxDevices || rows * t > INT_MAX || !aligned16(x) || !aligned16(wsp_k) ||
      !aligned16(wt_k) || !aligned16(y) || (groups > 1 && (ws == nullptr || !aligned16(ws))))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (rows + bm - 1) / bm * groups;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int mp = (m + 7) / 8 * 8;
  if ((err = layout(w_sp, wsp_k, k * k, c, m, cp, s)) != cudaSuccess ||
      (err = layout(w_tmp, wt_k, k, m, co, mp, s)) != cudaSuccess)
    return static_cast<int>(err);
  const Args a{static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(wsp_k),
               static_cast<const float*>(scale), static_cast<const float*>(bias),
               static_cast<const __nv_bfloat16*>(wt_k), static_cast<__nv_bfloat16*>(y),
               static_cast<float*>(ws), static_cast<int>(rows), t, h, w, cp, m, mp, co, k,
               groups, static_cast<unsigned>(blocks), smem_bytes, device, s};
  switch (bm) {
    case 64: err = start_mg<64>(mg, ct, a); break;
    case 128: err = start_mg<128>(mg, ct, a); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess || groups == 1) return static_cast<int>(err);
  const int64_t total = rows * t * co;
  const int64_t items = (total & 3) == 0 ? total / 4 : total;  // float4s or floats
  const int64_t want = (items + 255) / 256;
  fused_block_reduce_kernel<<<static_cast<unsigned>(want < 4096 ? want : 4096), 256, 0, s>>>(
      static_cast<const float*>(ws), static_cast<__nv_bfloat16*>(y), total, groups);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
