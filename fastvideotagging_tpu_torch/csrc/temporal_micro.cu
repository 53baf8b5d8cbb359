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
//   K5 v2   (pallas_temporal_v2, :91)      micro_ring_kernel<kV2>: the walk
//           runs over the padded frames [-p, T + p); every output frame
//           takes all k taps over the halo'd slab, with no branch.
//   K6 v3   (pallas_temporal_v3, :155)     micro_ring_kernel<kV3>: the walk
//           runs over [0, T); the centre tap's first product starts the
//           accumulator and each other tap is issued only where its input
//           frame lies in [0, T) (v3's clipped ranges, at frame
//           granularity). The dx is this kernel on the flipped,
//           io-transposed weight (made by the Python wrapper).
//   K8 v3p  (pallas_temporal_v3p, :241)    micro_ring_kernel<kV3P>: the
//           packed contraction over kappa = dt*C + c, k*C deep. Its walk is
//           K5's, and shares K5's code path: the padded frames [-p, T + p),
//           every output frame all k taps, the k16 steps issued in kappa
//           order as one accumulator chain (each tap's steps stop at C, where
//           the box and the weights are zero: the packed operand's steps
//           that straddle two taps add the same products); the zero rows of
//           the packed operand are the halo frames' zero fill, and the tap
//           weights the resident (k*C, Co) K-major operand.
//   K9 dw_v2 (pallas_temporal_dw, :297)    micro_dw_ring_kernel<kDwV2>: a
//           TMA ring of x and g frames (below); every row of the padded x,
//           its halo frames the box's zero fill: no pad pass.
//   K7 dw_v3 (pallas_temporal_dw_v3, :200) micro_dw_ring_kernel<kDwV3>: K9's
//           ring on the clipped walk: x frames in [0, T) only, and each tap
//           issued only for the output frames whose x frame lies there.
//
// What bounds them on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s): bytes, at
// every benchmark shape (tpu1: x and y 822 MB against 158 GFLOP, 0.245 ms).
//
// K5, K6 and K8: the frame ring. The Pallas v2 kernel streams a halo'd (T +
// 2p, tile_s, C) slab into VMEM and runs all k taps on it (v3p packs them
// into one operand); v3 holds all T frames of a tile and shifts rows inside
// the block. All read x once. Their first
// CUDA versions (WMMA, one shared stage; in the history of this file)
// gathered A once per tap and once per 64-wide Co tile, and K5 padded x in a
// separate pass that cost what it moved (0.29 of its 1.98 ms at tpu1). Here
// a work item is one clip b, 64 columns of S (one wgmma m64 row block a
// frame), one Co tile of BN channels and one group of input channels, and
// it walks T frame by frame:
//   - A producer warp loads each input frame of the item once, 64 columns x
//     the group's channels, with TMA (cp.async.bulk.tensor on a tensor map
//     of x as (B, T, S, C), 64-channel boxes in the 128-byte swizzle) into a
//     ring of frame slots with a full and an empty mbarrier each. The box
//     is per clip: columns past S, channels past C and (K5) the halo frames
//     t < 0 and t >= T are filled with zeros by the hardware, so K5's pad
//     exists only in shared memory and moves no byte.
//   - Two consumer warpgroups take the output frames in turn (ping-pong):
//     output frame t is k taps x ceil(C / 16) wgmma.mma_async k16 steps, A
//     the ring slot of input frame t + dt - p and B tap dt's weight, both
//     through shared-memory descriptors; the f32 accumulator (64 x BN)
//     stays in registers. A warpgroup releases a frame once its next output
//     frame no longer reads it, then rounds its accumulator to bf16 while
//     the other warpgroup's products run: into a staging tile in the
//     128-byte swizzle that one thread writes out with TMA stores (whole
//     lines, clipped at S and Co; BN = 144 only where it covers Co, as its
//     third box spills 48 channels past the tile), or, where the plan has
//     no room for the tiles (or Co % 8 != 0, or C or the taps are split),
//     straight from registers, 4 bytes a thread, which costs about what the
//     loads cost again.
//   - The weights of the item's Co tile, channel group and tap group (all
//     k taps but where k >= 15, K-major, in the 128-byte swizzle of
//     csrc/spatial_conv.cu's descriptors, zero past C and Co) stay
//     resident: blocks are persistent, one an SM, and a block walks items
//     of one (groups, Co tile) only, items of neighbouring blocks sharing
//     their columns in L2.
// Bytes: x once per Co tile, y once, w once per block. BN covers Co or
// divides it; where the k taps' weights and k + 1 frame slots do not fit
// the 227 KB of shared memory, the plan (ops/temporal_micro.py::ring_plan)
// takes a narrower BN, then splits C into groups, then (k >= 15 at one
// 64-channel box) the taps into groups, each reading x once more: their
// f32 partial sums micro_ring_reduce_kernel adds in group order. Rows of C % 8 != 0 channels
// (and a misaligned x) are first copied, channels zero-padded to a multiple
// of 8, by micro_ring_pad_kernel: TMA needs 16-byte global strides. At C =
// 256 (tpu2) the taps' weights of a 64-wide Co tile take 96 KB and a frame
// 32 KB: k + 1 slots and no staging fit, so one frame loads while the two
// output frames compute, x goes through L2 twice (two Co tiles) and the
// m64n64 products run at about half the tensor rate (their A and B reads
// fill the shared-memory bandwidth): that shape stays near 0.4 of its
// bound.

// K9 and K7: the dw ring. K9's Pallas kernel streams a halo'd (T + 2p,
// tile_s, C) slab of the padded x and the (T, tile_s, Co) slab of g into
// VMEM and adds every tap's x^T g into one (k, C, Co) block over a grid
// that runs in order (K7's clips each tap's rows to [0, T) instead). Here
// a block owns one output tile, a tap group (up to three taps, one
// consumer warpgroup each) x a C tile of BN channels (wgmma's N, 64, 128
// or 144) x a 64-wide Co tile (wgmma's M), and one chunk of the (clip,
// 64-column) items; it walks each item over T:
//   - A producer warp loads each g frame of the item once (one 64-channel x
//     64-column box of the Co tile) and each x frame its taps read (the C
//     tile's boxes), with TMA on tensor maps of x (B, T, S, C) and g (B, T,
//     S, Co) in the 128-byte swizzle, into two rings of frame slots with a
//     full and an empty mbarrier each. The x walk runs over the padded
//     frames [d0 - p, T + d1 - 1 - p) of taps [d0, d1): the halo frames,
//     columns past S and channels past C and Co are the box's zero fill, so
//     there is no pad pass and no padded copy. K7's walk (kDwV3, v3's
//     clipped ranges at frame granularity) loads only the x frames
//     [max(0, d0 - p), min(T, T + d1 - 1 - p)) and the g frames some tap
//     of the group reads; a group that reads none loads nothing.
//   - Consumer warpgroup dt, for every output frame t, issues four
//     wgmma.mma_async m64nBNk16 (the item's 64 rows of the frame) with g
//     frame t as A and x frame t + dt - p as B, both MN-major in shared
//     memory (both transpose bits; the descriptors of csrc/temporal_dw.cu:
//     one 64-channel box between atoms along M / N, 1024 bytes between
//     8-row groups along K, a k16 step 16 rows = 2048 bytes). K9 multiplies
//     every row, the halo's zeros included, with no branch; K7's warpgroup
//     issues only the output frames [max(0, p - dt), min(T, T + p - dt))
//     of its tap, worked out once per tap, and passes the item's other g
//     frames (waits for each to land and releases it) in loops of their
//     own, outside the wgmma loop; a tap with no frame adds nothing and
//     writes zeros. The f32 tile dw^T[dt] (64 x BN) stays in registers
//     across all items of the chunk. Every consumer warp releases every
//     frame the producer loaded, in walk order: a g frame after its step
//     (or once it landed, where its tap skips it) and an x frame once its
//     next step no longer reads it (waiting first for a frame it never
//     read, another tap's, to land). Keeping one step's products in flight
//     (issuing step t's before waiting for step t - 1's) was no faster on
//     the card.
//   - At the end each block writes its tile into the chunk's f32 partial
//     (k, C, Co), or into dw where the plan has one chunk;
//     micro_dw_ring_reduce_kernel adds the partials in a fixed order (no
//     atomics: two launches are bitwise equal).
// Bytes: g once per C tile and tap group, x once per Co tile and tap
// group (the tiles of a chunk are neighbouring blocks that walk the same
// columns at about the same time, so the re-reads come mostly from L2), the
// partials once written and once read. The plan (ops/temporal_micro.py::
// dw_ring_plan) takes the fewest C tiles, then the narrowest, and as many
// chunks as fill the SMs. Rows of C or Co % 8 != 0 channels (and a
// misaligned x or g) are first copied, channels zero-padded to a multiple
// of 8, by micro_ring_pad_kernel: TMA needs 16-byte global strides.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

enum Forward { kV2 = 0, kV3 = 1, kV3P = 2 };
enum Grad { kDwV3 = 0, kDwV2 = 1 };

// The tap of v3's q-th position: the centre first, then the others in order.
__device__ __forceinline__ int v3_tap(int q, int p) { return q == 0 ? p : (q - 1 < p ? q - 1 : q); }

// ---------------------------------------------------------------------------
// K5, K6 and K8: the frame ring (see the top of this file)
// ---------------------------------------------------------------------------

constexpr int RING_COLS = 64;                        // S columns of an item
constexpr int RING_CH = 64;                          // channels of a TMA box (128 bytes)
constexpr int RING_BOX = RING_COLS * RING_CH * 2;    // bytes of one box
constexpr int RING_CONSUMERS = 2;                    // warpgroups, one output frame each
constexpr int RING_PRODUCER = RING_CONSUMERS * 4;    // warp index of the producer
constexpr int RING_THREADS = (RING_PRODUCER + 1) * 32;
constexpr int RING_ALIGN = 1024;                     // the 128-byte swizzle repeats every 8 rows
constexpr int RING_SMEM_MAX = 232448;                // an H100 block's dynamic shared memory
constexpr int kMaxDevices = 64;

struct RingArgs {
  const unsigned short* w;  // (k, C, Co)
  unsigned short* y;        // (B, T, S, Co) bf16, groups == 1
  float* ws;                // (groups * tgroups, B, T, S, Co) f32 partial sums, else null
  int T, S, C, Co, k;
  int co_tiles, groups, chunks, slots;  // chunks: 64-channel boxes of a channel group
  int taps, tgroups;                    // taps of a tap group, tap groups (1: all k taps)
  int stage;                            // y staging bytes a warpgroup (0: direct stores)
  int cols_per_clip;                    // ceil(S / RING_COLS)
  long long items;                      // B * cols_per_clip * co_tiles * groups * tgroups
  long long rows;                       // B * T * S (a partial's rows)
};

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// Byte offset of 16-byte chunk j of row r in a K-major tile of 128-byte
// rows, 128-byte swizzled (what TMA's CU_TENSOR_MAP_SWIZZLE_128B writes).
__device__ __forceinline__ uint32_t swz(int r, int j) {
  return static_cast<uint32_t>(r * 128 + ((j ^ (r & 7)) << 4));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// Waits for the phase of parity `parity` to complete. The spin loop is in
// the PTX, so that the code around a wait stays warp-uniform to the
// compiler (a data-dependent C++ loop there serializes the wgmmas). A wait
// that lasts seconds means a lost arrival or load: it traps (the launch
// fails) rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .u64 t0, t1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "mov.u64 t0, %%globaltimer;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "mov.u64 t1, %%globaltimer;\n"
      "sub.u64 t1, t1, t0;\n"
      "setp.lt.u64 p, t1, 4000000000;\n"
      "@p bra WAIT;\n"
      "trap;\n"
      "DONE:\n}\n"
      :: "r"(bar), "r"(parity) : "memory");
}

// Arrives on `bar` from lane 0 of the warp only, predicated in the PTX (no
// branch around it).
__device__ __forceinline__ void mbar_arrive_lane0(uint32_t bar, int lane) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.eq.u32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n"
      :: "r"(bar), "r"(lane) : "memory");
}

// One 64-channel x 64-column box of frame t of clip b into shared memory;
// its bytes complete the transaction count of barrier `bar`.
__device__ __forceinline__ void tma_load_box(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                             int c, int s, int t, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c), "r"(s), "r"(t),
         "r"(b)
      : "memory");
}

// One 64-channel x 64-row box of the y staging tile to frame t of clip b
// (the box's parts past S and Co are not written), issued by the thread
// whose `issuer` is set; predicated in the PTX, as are the bulk-group
// commit and waits below.
__device__ __forceinline__ void tma_store_box(const CUtensorMap* map, uint32_t src, int c, int s,
                                              int t, int b, bool issuer) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "@p cp.async.bulk.tensor.4d.global.shared::cta.tile.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n}\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c), "r"(s), "r"(t), "r"(b),
         "r"(static_cast<int>(issuer))
      : "memory");
}

__device__ __forceinline__ void bulk_commit(bool issuer) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %0, 0;\n@p cp.async.bulk.commit_group;\n}\n"
               :: "r"(static_cast<int>(issuer)) : "memory");
}

// The thread's stores have read their shared memory (READ) or are done.
template <bool READ>
__device__ __forceinline__ void bulk_wait(bool issuer) {
  if constexpr (READ)
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %0, 0;\n@p cp.async.bulk.wait_group.read 0;\n}\n"
                 :: "r"(static_cast<int>(issuer)) : "memory");
  else
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %0, 0;\n@p cp.async.bulk.wait_group 0;\n}\n"
                 :: "r"(static_cast<int>(issuer)) : "memory");
}

// One consumer warpgroup's barrier (named barriers 2 and 3, 128 threads).
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(2 + wg) : "memory");
}

// The consumer warpgroups' own barrier (named barrier 1, 256 threads).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(RING_CONSUMERS * 128) : "memory");
}

// The async proxy (wgmma) reads what the generic proxy wrote: each thread
// fences its own writes before the barrier.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving accumulator reads or writes across a
// wgmma fence or wait.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// Shared-memory matrix descriptor of a K-major tile in the 128-byte
// swizzle (as csrc/spatial_conv.cu's): start address >> 4, leading offset 1
// (unused), 1024 bytes between 8-row groups, layout type 1. Moving 16 bf16
// along K within the 128-byte row is +32 bytes on the start address.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

// wgmma.mma_async m64nNk16, bf16 x bf16 -> f32, A and B K-major in shared
// memory: d = A B + (acc ? d : 0).
#define FVT_WGMMA_OUT8(i)                                                                   \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

__device__ __forceinline__ void wgmma_64(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : FVT_WGMMA_OUT8(0), FVT_WGMMA_OUT8(8), FVT_WGMMA_OUT8(16), FVT_WGMMA_OUT8(24)
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_128(float (&d)[64], uint64_t da, uint64_t db, int acc) {
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
      : FVT_WGMMA_OUT8(0), FVT_WGMMA_OUT8(8), FVT_WGMMA_OUT8(16), FVT_WGMMA_OUT8(24),
        FVT_WGMMA_OUT8(32), FVT_WGMMA_OUT8(40), FVT_WGMMA_OUT8(48), FVT_WGMMA_OUT8(56)
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_144(float (&d)[72], uint64_t da, uint64_t db, int acc) {
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
      : FVT_WGMMA_OUT8(0), FVT_WGMMA_OUT8(8), FVT_WGMMA_OUT8(16), FVT_WGMMA_OUT8(24),
        FVT_WGMMA_OUT8(32), FVT_WGMMA_OUT8(40), FVT_WGMMA_OUT8(48), FVT_WGMMA_OUT8(56),
        FVT_WGMMA_OUT8(64)
      : "l"(da), "l"(db), "r"(acc));
}
#undef FVT_WGMMA_OUT8

template <int BN_>
__device__ __forceinline__ void wgmma_tile(float (&d)[BN_ / 2], uint64_t da, uint64_t db,
                                           int acc) {
  if constexpr (BN_ == 64) wgmma_64(d, da, db, acc);
  else if constexpr (BN_ == 128) wgmma_128(d, da, db, acc);
  else wgmma_144(d, da, db, acc);
}

// The weights of taps [d0, d0 + taps) of one Co tile (n0) and channel
// group (c0) into shared memory at `wts` (a generic pointer to it): tap
// d0 + i, box ch is a K-major (BN_ rows of Co, 64 channels) tile in the
// 128-byte swizzle, zero past C and Co. Thread i of the consumers moves 8 output channels of one
// input channel: consecutive threads take consecutive channels, so their
// 2-byte shared stores fall in different banks.
template <int BN_>
__device__ __forceinline__ void ring_weights(unsigned char* wts,
                                             const unsigned short* __restrict__ w, int d0,
                                             int taps, int C, int Co, int c0, int chunks, int n0,
                                             bool vec) {
  const int kc = chunks * RING_CH;
  const int runs = BN_ / 8;
  const int total = taps * kc * runs;
  for (int e = threadIdx.x; e < total; e += RING_CONSUMERS * 128) {
    const int cl = e % kc;
    const int rest = e / kc;
    const int n8 = rest % runs;
    const int dt = rest / runs;  // of the group
    const int c = c0 + cl;
    const int n = n0 + n8 * 8;
    unsigned short v[8];
    const unsigned short* src = w + ((int64_t)(d0 + dt) * C + c) * Co + n;
    if (vec && c < C && n < Co) {
      const uint4 u = *reinterpret_cast<const uint4*>(src);
      const unsigned short* h = reinterpret_cast<const unsigned short*>(&u);
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = h[i];
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = (c < C && n + i < Co) ? src[i] : (unsigned short)0;
    }
    unsigned char* tile = wts + (int64_t)(dt * chunks + cl / RING_CH) * (BN_ * 128);
    const int col = cl % RING_CH;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      *reinterpret_cast<unsigned short*>(tile + swz(n8 * 8 + i, col / 8) + (col % 8) * 2) = v[i];
  }
}

// K5 (V = kV2), K8 (V = kV3P: K5's walk) and K6 (V = kV3). Shared memory:
// the weights (taps * chunks tiles of BN_ x 128 bytes), `slots` frame
// slots of `chunks` boxes, the two consumer warpgroups' y staging tiles
// (a.stage bytes each, or none), then a full and an empty mbarrier per
// slot. Item q of a.items is (column tile
// q / W, weights q % W), W = co_tiles * groups * tgroups, the weights
// index (channel group, tap group, Co tile): a block takes items
// blockIdx.x + i * gridDim.x, so where gridDim.x is a multiple of W its
// weights never change, and blocks next to each other read the same
// columns (each once per Co tile and tap group) at about the same time.
// An item of taps [d0, d1) walks the frames its output frames read: K5 and
// K8 [d0 - p, T + d1 - 1 - p), K6 the same clipped to [0, T). TG: the taps
// are split (a.tgroups > 1); without it the tap-group arithmetic folds
// away, so that the common plans' code is the same as with no groups.
template <int V, int BN_, bool TG>
__global__ void __launch_bounds__(RING_THREADS, 1)
micro_ring_kernel(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap ymap, const RingArgs a) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + RING_ALIGN - 1) & ~static_cast<uint32_t>(RING_ALIGN - 1);
  unsigned char* smem = smem_raw + (base - raw);
  const int T = a.T, k = a.k, p = k / 2, chunks = a.chunks, NS = a.slots;
  const uint32_t tap_bytes = chunks * BN_ * 128;  // one tap's weights
  const uint32_t slot_bytes = chunks * RING_BOX;
  const uint32_t ring = base + a.taps * tap_bytes;
  const uint32_t staging = ring + NS * slot_bytes;  // a.stage bytes a consumer warpgroup
  const uint32_t bars = staging + RING_CONSUMERS * a.stage;
  const int W = a.co_tiles * a.groups * a.tgroups;
  // Item q's weights: its partial g (channel group g / tgroups, tap group
  // g % tgroups), its Co tile, its taps [d0, d1) and the walk's frames
  // [f_lo, f_hi).
  struct Item {
    int g, n0, c0, d0, d1, f_lo, f_hi;
  };
  auto item = [&](long long q) {
    Item it;
    const int wi = static_cast<int>(q % W);
    it.g = wi / a.co_tiles;
    it.n0 = (wi % a.co_tiles) * BN_;
    if constexpr (TG) {
      it.c0 = (it.g / a.tgroups) * chunks * RING_CH;
      it.d0 = (it.g % a.tgroups) * a.taps;
      it.d1 = min(k, it.d0 + a.taps);
      it.f_lo = it.d0 - p;
      it.f_hi = T + it.d1 - 1 - p;
      if (V == kV3) {
        it.f_lo = max(it.f_lo, 0);
        it.f_hi = max(min(it.f_hi, T), it.f_lo);
      }
    } else {
      it.c0 = it.g * chunks * RING_CH;
      it.d0 = 0;
      it.d1 = k;
      it.f_lo = V != kV3 ? -p : 0;  // K5 and K8: the padded frames
      it.f_hi = V != kV3 ? T + p : T;
    }
    return it;
  };
  // the warp index broadcast from lane 0, so that the compiler knows the
  // roles below (and the output frames a warpgroup takes) are warp-uniform
  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);

  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(bars + 8 * s, 1);                                  // full: the producer's
      mbar_init(bars + 8 * (NS + s), RING_CONSUMERS * 4);          // empty: each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == RING_PRODUCER) {  // one thread issues every load, in the consumers' order
    if (lane == 0) {
      int seq = 0;
      for (long long q = blockIdx.x; q < a.items; q += gridDim.x) {
        const long long col = q / W;
        const Item it = item(q);
        const int bb = static_cast<int>(col / a.cols_per_clip);
        const int s0 = static_cast<int>(col % a.cols_per_clip) * RING_COLS;
        for (int f = it.f_lo; f < it.f_hi; ++f, ++seq) {
          const int slot = seq % NS;
          mbar_wait(bars + 8 * (NS + slot), ((seq / NS) & 1) ^ 1);
          mbar_expect_tx(bars + 8 * slot, slot_bytes);
          for (int ch = 0; ch < chunks; ++ch)
            tma_load_box(ring + slot * slot_bytes + ch * RING_BOX, &xmap, bars + 8 * slot,
                         it.c0 + ch * RING_CH, s0, f, bb);
        }
      }
    }
    return;
  }

  const int wg = warp >> 2;  // consumer warpgroup: output frames t = wg, wg + 2, ...
  const bool issuer = (tid & 127) == 0;  // the warpgroup's thread that issues its y stores
  const uint32_t stage = staging + wg * a.stage;
  const bool vec_w = (a.Co % 8) == 0 && (reinterpret_cast<uintptr_t>(a.w) & 15) == 0;
  const bool even = (a.Co & 1) == 0;
  const int row = (warp & 3) * 16 + (lane >> 2);  // this thread's rows: row, row + 8
  float acc[BN_ / 2];
  int loaded = -1;  // the weights index whose weights are in shared memory
  int seq0 = 0;     // ring sequence number of the item's first frame
  for (long long q = blockIdx.x; q < a.items; q += gridDim.x) {
    const long long col = q / W;
    const int wi = static_cast<int>(q % W);
    const Item it = item(q);
    const int g = it.g, n0 = it.n0, c0 = it.c0, d0 = it.d0, d1 = it.d1;
    const int f_lo = it.f_lo, f_hi = it.f_hi;
    const int bb = static_cast<int>(col / a.cols_per_clip);
    const int s0 = static_cast<int>(col % a.cols_per_clip) * RING_COLS;
    const int ksteps = (min(a.C - c0, chunks * RING_CH) + 15) / 16;
    if (wi != loaded) {
      consumers_sync();  // both warpgroups are done with the old weights
      ring_weights<BN_>(smem, a.w, d0, d1 - d0, a.C, a.Co, c0, chunks, n0, vec_w);
      fence_proxy_async();
      consumers_sync();
      loaded = wi;
    }
    // Each consumer warp arrives once on a frame's empty barrier, in walk
    // order, when its warpgroup is done with the frame. It first waits for
    // the frame to have landed, so that a frame it never read (outside its
    // output frames' taps) is not released into its slot's previous round.
    int rel = f_lo;  // frames below rel: released by this warp
    auto release = [&](int upto) {
      for (; rel < upto; ++rel) {
        const int s = seq0 + rel - f_lo;
        mbar_wait(bars + 8 * (s % NS), (s / NS) & 1);
        mbar_arrive_lane0(bars + 8 * (NS + s % NS), lane);
      }
    };
    for (int t = wg; t < T; t += RING_CONSUMERS) {
      int first = 1;
      fence_acc(acc);
      wgmma_fence();
      for (int i = 0; i < k; ++i) {
        const int dt = V == kV3 ? v3_tap(i, p) : i;  // K6: the centre tap first
        if (TG && (dt < d0 || dt >= d1)) continue;   // another tap group's
        const int f = t + dt - p;
        if (V == kV3 && (f < 0 || f >= T)) continue;  // K6: a tap outside [0, T) adds nothing
        const int s = seq0 + f - f_lo;
        const int slot = s % NS;
        mbar_wait(bars + 8 * slot, (s / NS) & 1);
        const uint32_t xa = ring + slot * slot_bytes;
        const uint32_t wb = base + (dt - d0) * tap_bytes;
        for (int ks = 0; ks < ksteps; ++ks) {
          const uint32_t box = ks >> 2, sub = (ks & 3) * 32;
          wgmma_tile<BN_>(acc, smem_desc(xa + box * RING_BOX + sub),
                          smem_desc(wb + box * (BN_ * 128) + sub), first ? 0 : 1);
          first = 0;
        }
      }
      wgmma_commit();
      wgmma_wait0();
      fence_acc(acc);
      if (TG && V == kV3 && first) {  // K6: no tap of the group reaches [0, T) from t
#pragma unroll
        for (int i = 0; i < BN_ / 2; ++i) acc[i] = 0.f;
      }
      // this warpgroup's next output frame, t + 2, reads from t + 2 + d0 - p on
      release(min(t + RING_CONSUMERS + (TG ? d0 : 0) - p, f_hi));

      // Epilogue from registers: n8 block j in acc[4j .. 4j + 3], rows row
      // and row + 8, columns 8j + 2 (lane % 4) and + 1.
      if (a.stage) {
        // Through the staging tile (ceil(BN / 64) swizzled 64-channel boxes)
        // and TMA stores, which write whole lines and clip at S and Co.
        bulk_wait<true>(issuer);  // the last frame's stores have read the tile
        warpgroup_sync(wg);
        unsigned char* tile = smem + (stage - base);
#pragma unroll
        for (int j = 0; j < BN_ / 8; ++j) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const __nv_bfloat162 v =
                __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
            *reinterpret_cast<__nv_bfloat162*>(tile + (j / 8) * RING_BOX + swz(row + 8 * h, j % 8) +
                                              (lane & 3) * 4) = v;
          }
        }
        fence_proxy_async();
        warpgroup_sync(wg);
#pragma unroll
        for (int i = 0; i < (BN_ + RING_CH - 1) / RING_CH; ++i)
          tma_store_box(&ymap, stage + i * RING_BOX, n0 + i * RING_CH, s0, t, bb, issuer);
        bulk_commit(issuer);
      } else {  // masked at S and Co
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int s = s0 + row + 8 * h;
          if (s >= a.S) continue;
          const long long yrow = ((static_cast<long long>(bb) * T + t) * a.S + s) * a.Co + n0;
          if (!TG && a.groups == 1) {  // one partial: y itself
            unsigned short* out = a.y + yrow;
#pragma unroll
            for (int j = 0; j < BN_ / 8; ++j) {
              const int c = j * 8 + (lane & 3) * 2;
              if (n0 + c >= a.Co) continue;
              const __nv_bfloat162 v =
                  __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
              if (even) {
                *reinterpret_cast<__nv_bfloat162*>(out + c) = v;
              } else {
                out[c] = *reinterpret_cast<const unsigned short*>(&v.x);
                if (n0 + c + 1 < a.Co) out[c + 1] = *reinterpret_cast<const unsigned short*>(&v.y);
              }
            }
          } else {
            float* out = a.ws + g * a.rows * a.Co + yrow;
#pragma unroll
            for (int j = 0; j < BN_ / 8; ++j) {
              const int c = j * 8 + (lane & 3) * 2;
              if (n0 + c >= a.Co) continue;
              if (even) {
                *reinterpret_cast<float2*>(out + c) =
                    make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
              } else {
                out[c] = acc[4 * j + 2 * h];
                if (n0 + c + 1 < a.Co) out[c + 1] = acc[4 * j + 2 * h + 1];
              }
            }
          }
        }
      }
    }
    release(f_hi);  // the item's frames this warpgroup has not released yet
    seq0 += f_hi - f_lo;
  }
  bulk_wait<false>(issuer);  // the tile stays allocated until its stores are done
}

// y = bf16(ws[0] + ws[1] + ...), the channel and tap groups' partial sums
// in group order (no atomics: two launches are bitwise equal). n = B * T * S * Co.
__global__ void micro_ring_reduce_kernel(const float* __restrict__ ws,
                                         unsigned short* __restrict__ y, int64_t n, int groups) {
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (int64_t)gridDim.x * blockDim.x) {
    float s = ws[e];
    for (int g = 1; g < groups; ++g) s += ws[g * n + e];
    const __nv_bfloat16 h = __float2bfloat16_rn(s);
    y[e] = *reinterpret_cast<const unsigned short*>(&h);
  }
}

// dw = the K9 or K7 chunks' partials (chunks, n) added in a fixed order:
// group j of DW_REDUCE_GROUPS adds chunks j, j + G, j + 2G, ... in order,
// then the group sums are added in group order (no atomics: two launches are
// bitwise equal). A block takes 32 elements, a warp a group: the chunk
// loop is cut G ways, so that enough loads are in flight where n is small
// beside the chunk count (faithful1: 27,648 elements x 131 chunks).
constexpr int DW_REDUCE_GROUPS = 8;

__global__ void __launch_bounds__(32 * DW_REDUCE_GROUPS)
micro_dw_ring_reduce_kernel(const float* __restrict__ part, float* __restrict__ dw, int64_t n,
                            int chunks) {
  __shared__ float sums[DW_REDUCE_GROUPS][32];
  const int64_t e = static_cast<int64_t>(blockIdx.x) * 32 + threadIdx.x;
  const int j = threadIdx.y;
  float s = 0.f;
  if (e < n)
    for (int c = j; c < chunks; c += DW_REDUCE_GROUPS) s += part[static_cast<int64_t>(c) * n + e];
  sums[j][threadIdx.x] = s;
  __syncthreads();
  if (j == 0 && e < n) {
    float total = sums[0][threadIdx.x];
#pragma unroll
    for (int q = 1; q < DW_REDUCE_GROUPS; ++q) total += sums[q][threadIdx.x];
    dw[e] = total;
  }
}

// x (rows, c) -> xs (rows, cp), channels c..cp-1 zero, one 16-byte store a
// thread: how the ring takes rows that TMA cannot (C % 8 != 0, or x not
// 16-byte aligned; then cp = C rounded up to 8).
__global__ void micro_ring_pad_kernel(const unsigned short* __restrict__ x,
                                      unsigned short* __restrict__ xs, int64_t rows, int c,
                                      int cp) {
  const int per_row = cp / 8;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < rows * per_row;
       i += stride) {
    const int64_t r = i / per_row;
    const int c0 = static_cast<int>(i - r * per_row) * 8;
    uint32_t v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const uint32_t lo = c0 + 2 * u < c ? x[r * c + c0 + 2 * u] : 0u;
      const uint32_t hi = c0 + 2 * u + 1 < c ? x[r * c + c0 + 2 * u + 1] : 0u;
      v[u] = lo | (hi << 16);
    }
    reinterpret_cast<uint4*>(xs)[i] = make_uint4(v[0], v[1], v[2], v[3]);
  }
}

// ---------------------------------------------------------------------------
// K9 and K7: the dw ring (see the top of this file)
// ---------------------------------------------------------------------------

constexpr int DW_RING_TAPS = 3;                          // consumer warpgroups, one tap each
constexpr int DW_RING_PRODUCER = DW_RING_TAPS * 4;       // warp index of the producer
constexpr int DW_RING_THREADS = (DW_RING_PRODUCER + 1) * 32;
constexpr int DW_RING_M = 64;                            // Co tile: wgmma's M, one g box

struct DwRingArgs {
  float* out;                  // the chunks' partials (chunks, k, C, Co), or dw (one chunk)
  int T, S, C, Co, k;
  int taps;                    // taps of a tap group (the last group may have fewer)
  int c_tiles, co_tiles;       // BN-wide C tiles, 64-wide Co tiles
  int boxes;                   // 64-channel x boxes of a C tile
  int xslots, gslots;          // frame slots of the x and g rings
  int cols_per_clip;           // ceil(S / RING_COLS)
  int cols, cols_per_chunk;    // items (B * cols_per_clip), items of a chunk
};

// Shared-memory matrix descriptor of an MN-major operand of 64-channel
// boxes in the 128-byte swizzle (as csrc/temporal_dw.cu's): start address
// >> 4; leading offset one box (64 rows x 128 bytes, the stride between
// 64-channel atoms along M or N); stride offset 1024 bytes (between 8-row
// groups along K); layout type 1. A k16 step is 16 rows: +2048 bytes.
__device__ __forceinline__ uint64_t smem_desc_mn(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(RING_BOX >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

// wgmma.mma_async m64nNk16, bf16 x bf16 -> f32, A and B both MN-major in
// shared memory (both transpose bits set): d += A B (scale-d a predicate
// that is always set).
#define FVT_WGMMA_OUT8(i)                                                                   \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

__device__ __forceinline__ void wgmma_mn_64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 1, 1;\n}\n"
      : FVT_WGMMA_OUT8(0), FVT_WGMMA_OUT8(8), FVT_WGMMA_OUT8(16), FVT_WGMMA_OUT8(24)
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_mn_128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 1, 1;\n}\n"
      : FVT_WGMMA_OUT8(0), FVT_WGMMA_OUT8(8), FVT_WGMMA_OUT8(16), FVT_WGMMA_OUT8(24),
        FVT_WGMMA_OUT8(32), FVT_WGMMA_OUT8(40), FVT_WGMMA_OUT8(48), FVT_WGMMA_OUT8(56)
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_mn_144(float (&d)[72], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %74, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n144k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71"
      "}, %72, %73, p, 1, 1, 1, 1;\n}\n"
      : FVT_WGMMA_OUT8(0), FVT_WGMMA_OUT8(8), FVT_WGMMA_OUT8(16), FVT_WGMMA_OUT8(24),
        FVT_WGMMA_OUT8(32), FVT_WGMMA_OUT8(40), FVT_WGMMA_OUT8(48), FVT_WGMMA_OUT8(56),
        FVT_WGMMA_OUT8(64)
      : "l"(da), "l"(db), "r"(1));
}
#undef FVT_WGMMA_OUT8

template <int BN_>
__device__ __forceinline__ void wgmma_mn_tile(float (&d)[BN_ / 2], uint64_t da, uint64_t db) {
  if constexpr (BN_ == 64) wgmma_mn_64(d, da, db);
  else if constexpr (BN_ == 128) wgmma_mn_128(d, da, db);
  else wgmma_mn_144(d, da, db);
}

// K9 (V = kDwV2: every row of the padded x, no branch) and K7 (V = kDwV3:
// the clipped walk, each tap issued over its own output frames only).
// Block i is tile i % W of chunk i / W, W = tap groups * c_tiles *
// co_tiles, the tile (tap group, C tile, Co tile): the tiles of a chunk are
// neighbouring blocks that walk the chunk's items, columns [chunk *
// cols_per_chunk, ...) of all clips, in the same order. Shared memory:
// the x ring (xslots slots of `boxes` boxes), the g ring (gslots slots of
// one box), then a full and an empty mbarrier per slot, x's first.
template <int V, int BN_>
__global__ void __launch_bounds__(DW_RING_THREADS, 1)
micro_dw_ring_kernel(const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap gmap, const DwRingArgs a) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + RING_ALIGN - 1) & ~static_cast<uint32_t>(RING_ALIGN - 1);
  const int T = a.T, k = a.k, p = k / 2, NX = a.xslots, NG = a.gslots;
  const uint32_t xslot_bytes = a.boxes * RING_BOX;
  const uint32_t xring = base;
  const uint32_t gring = xring + NX * xslot_bytes;
  const uint32_t xfull = gring + NG * RING_BOX, xempty = xfull + 8 * NX;
  const uint32_t gfull = xempty + 8 * NX, gempty = gfull + 8 * NG;
  const int W = ((k + a.taps - 1) / a.taps) * a.c_tiles * a.co_tiles;
  const int tile = static_cast<int>(blockIdx.x) % W;
  const int chunk = static_cast<int>(blockIdx.x) / W;
  const int n0 = (tile % a.co_tiles) * DW_RING_M;
  const int c0 = (tile / a.co_tiles % a.c_tiles) * BN_;
  const int d0 = tile / (a.co_tiles * a.c_tiles) * a.taps;
  const int d1 = min(k, d0 + a.taps);
  // The walk of an item: the g frames [g_lo, g_hi) that some tap of the
  // group reads and the x frames [f_lo, f_hi) they read (K9: every output
  // frame, the halo's x frames included; K7: clipped to [0, T), both empty
  // where no tap of the group reaches [0, T)).
  const int g_lo = V == kDwV3 ? max(0, p - d1 + 1) : 0;
  const int g_hi = V == kDwV3 ? max(g_lo, min(T, T + p - d0)) : T;
  const int f_lo = V == kDwV3 ? max(0, d0 - p) : d0 - p;
  const int f_hi = V == kDwV3 ? max(f_lo, min(T, T + d1 - 1 - p)) : T + d1 - 1 - p;
  const int col0 = chunk * a.cols_per_chunk;
  const int col1 = min(a.cols, col0 + a.cols_per_chunk);
  // the warp index broadcast from lane 0, so that the compiler knows the
  // roles below (and a warpgroup's tap) are warp-uniform
  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);

  if (tid == 0) {
    const int arrivals = (d1 - d0) * 4;  // each consumer warp of the tile's taps
    for (int s = 0; s < NX; ++s) {
      mbar_init(xfull + 8 * s, 1);
      mbar_init(xempty + 8 * s, arrivals);
    }
    for (int s = 0; s < NG; ++s) {
      mbar_init(gfull + 8 * s, 1);
      mbar_init(gempty + 8 * s, arrivals);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == DW_RING_PRODUCER) {  // one thread issues every load, in the consumers' order
    if (lane == 0) {
      int xs = 0, gs = 0;
      for (int col = col0; col < col1; ++col) {
        const int bb = col / a.cols_per_clip;
        const int s0 = (col % a.cols_per_clip) * RING_COLS;
        int f = f_lo;  // the next x frame
        for (int t = g_lo; t < g_hi; ++t, ++gs) {
          // the x frames step t reads: up to t + d1 - 1 - p
          for (const int need = min(f_hi, t + d1 - p); f < need; ++f, ++xs) {
            const int slot = xs % NX;
            mbar_wait(xempty + 8 * slot, ((xs / NX) & 1) ^ 1);
            mbar_expect_tx(xfull + 8 * slot, xslot_bytes);
            for (int i = 0; i < a.boxes; ++i)
              tma_load_box(xring + slot * xslot_bytes + i * RING_BOX, &xmap, xfull + 8 * slot,
                           c0 + i * RING_CH, s0, f, bb);
          }
          const int slot = gs % NG;
          mbar_wait(gempty + 8 * slot, ((gs / NG) & 1) ^ 1);
          mbar_expect_tx(gfull + 8 * slot, RING_BOX);
          tma_load_box(gring + slot * RING_BOX, &gmap, gfull + 8 * slot, n0, s0, t, bb);
        }
      }
    }
    return;
  }

  const int dt = d0 + (warp >> 2);  // this warpgroup's tap
  if (dt >= d1) return;             // the last tap group may have fewer taps
  // The output frames [t_lo, t_hi) whose x frame t + dt - p this tap reads
  // (K9: all T; K7: those inside [0, T), none where |dt - p| >= T), and the
  // first x frame it reads (f_hi: none).
  const int t_lo = V == kDwV3 ? min(max(g_lo, p - dt), g_hi) : 0;
  const int t_hi = V == kDwV3 ? max(t_lo, min(g_hi, T + p - dt)) : T;
  const int first = t_lo < t_hi ? t_lo + dt - p : f_hi;
  float acc[BN_ / 2];
#pragma unroll
  for (int i = 0; i < BN_ / 2; ++i) acc[i] = 0.f;
  int xs0 = 0;  // x ring sequence number of the item's first frame
  int gs = 0;
  for (int col = col0; col < col1; ++col) {
    // Each consumer warp arrives once on every x frame's empty barrier, in
    // walk order, once its next step no longer reads the frame; it first
    // waits for a frame it never read (another tap's) to have landed, so
    // that it does not release the slot's previous round.
    int rel = f_lo;  // frames below rel: released by this warp
    auto release = [&](int upto) {
      for (; rel < upto; ++rel) {
        const int s = xs0 + rel - f_lo;
        mbar_wait(xfull + 8 * (s % NX), (s / NX) & 1);
        mbar_arrive_lane0(xempty + 8 * (s % NX), lane);
      }
    };
    // K7: a g frame outside the tap's output frames is waited for and
    // released with no product, and so are the x frames loaded before it
    // that the tap does not read from then on (below `upto`): the producer
    // needs their slots while the tap passes frames.
    auto pass = [&](int t, int upto) {
      const int slot = gs % NG;
      mbar_wait(gfull + 8 * slot, (gs / NG) & 1);
      mbar_arrive_lane0(gempty + 8 * slot, lane);
      release(min(t + d1 - p, upto));
    };
    int t = g_lo;
    if constexpr (V == kDwV3)
      for (; t < t_lo; ++t, ++gs) pass(t, first);
    for (; t < t_hi; ++t, ++gs) {
      const int gslot = gs % NG;
      const int s = xs0 + t + dt - p - f_lo;
      const int xslot = s % NX;
      mbar_wait(gfull + 8 * gslot, (gs / NG) & 1);
      mbar_wait(xfull + 8 * xslot, (s / NX) & 1);
      const uint32_t ga = gring + gslot * RING_BOX;
      const uint32_t xa = xring + xslot * xslot_bytes;
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < RING_COLS / 16; ++ks)
        wgmma_mn_tile<BN_>(acc, smem_desc_mn(ga + ks * 2048), smem_desc_mn(xa + ks * 2048));
      wgmma_commit();
      wgmma_wait0();
      fence_acc(acc);
      mbar_arrive_lane0(gempty + 8 * gslot, lane);
      release(t + 1 + dt - p);  // the next step reads from t + 1 + dt - p on
    }
    if constexpr (V == kDwV3)
      for (; t < g_hi; ++t, ++gs) pass(t, f_hi);
    release(f_hi);  // the item's frames this warp has not released yet
    xs0 += f_hi - f_lo;
  }

  // Epilogue: dw^T[dt] from registers into out[chunk] (k, C, Co). Warp w of
  // the warpgroup holds output channels n0 + 16 (w % 4) + lane / 4 (and + 8),
  // input channels c0 + 8 j + 2 (lane % 4) (and + 1) in acc[4j .. 4j + 3].
  float* dst = a.out + (static_cast<int64_t>(chunk) * k + dt) * a.C * a.Co;
  const int o = n0 + (warp & 3) * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < BN_ / 8; ++j) {
    const int c = c0 + j * 8 + (lane & 3) * 2;
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int cc = c + (h & 1), oo = o + (h >> 1) * 8;
      if (cc < a.C && oo < a.Co) dst[static_cast<int64_t>(cc) * a.Co + oo] = acc[4 * j + h];
    }
  }
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }

// The channel-pad copies launched so far (micro_ring_pad_kernel, for x of
// K5, K6 and K8 and for x and g of K9 and K7), counted for the tests that
// check which inputs take one.
long long channel_pad_launches = 0;

cudaError_t channel_pad(const void* src, void* dst, int64_t rows, int c, int cp,
                        cudaStream_t stream) {
  const int64_t want = (rows * (cp / 8) + 255) / 256;
  ++channel_pad_launches;
  micro_ring_pad_kernel<<<(unsigned)std::min<int64_t>(want, 8192), 256, 0, stream>>>(
      static_cast<const unsigned short*>(src), static_cast<unsigned short*>(dst), rows, c, cp);
  return cudaGetLastError();
}

// cuTensorMapEncodeTiled through the runtime's driver entry point, so that
// the library links no libcuda of its own.
PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault,
                                              &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(ptr);
  }
  return fn;
}

// Opts the instance in to the block's whole dynamic shared memory, once per
// instantiation and device (a host call, not free), then launches it.
template <int V, int BN_, bool TG>
cudaError_t ring_start(const CUtensorMap& xmap, const CUtensorMap& ymap, const RingArgs& args,
                       int blocks, int smem_bytes, int device, cudaStream_t stream) {
  static bool opted_in[kMaxDevices] = {};
  if (!opted_in[device]) {
    cudaError_t err = cudaFuncSetAttribute(micro_ring_kernel<V, BN_, TG>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           RING_SMEM_MAX);
    if (err != cudaSuccess) return err;
    opted_in[device] = true;
  }
  micro_ring_kernel<V, BN_, TG><<<blocks, RING_THREADS, smem_bytes, stream>>>(xmap, ymap, args);
  return cudaGetLastError();
}

// A tensor map of a bf16 (b, t, s, c) tensor, innermost first, whose
// boxes are 64 channels x 64 columns of one frame of one clip in the
// 128-byte swizzle, zero-filled (loads) or clipped (stores) outside it.
bool frame_map(CUtensorMap* map, const void* ptr, int b, int t, int s, int c) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)c, (cuuint64_t)s, (cuuint64_t)t, (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)c * 2, (cuuint64_t)s * c * 2,
                                 (cuuint64_t)t * s * c * 2};
  const cuuint32_t box[4] = {RING_CH, RING_COLS, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// K5 / K6 / K8 with the plan of ops/temporal_micro.py::ring_plan (bn, slots,
// groups, taps, stage, blocks, smem_bytes), checked here against the
// shape: x (b, t, s, c) bf16; xs a (b*t*s, cp) scratch where TMA cannot
// read x (c % 8 != 0 or x not 16-byte aligned), else null; ws (groups *
// tap groups, b*t*s, co) f32 where that is more than one, else null; y (b,
// t, s, co), written through a staging tile of `stage` bytes a warpgroup
// and TMA stores where stage > 0 (one partial, co % 8 == 0, and its
// 64-channel store boxes inside the Co tile: bn % 64 == 0 or bn >= co),
// else by the threads.
template <int V>
int launch_ring(const void* x, const void* w, void* xs, void* ws, void* y, int b, int t, int s,
                int c, int co, int k, int bn, int slots, int groups, int taps, int stage,
                int blocks, int smem_bytes, int device, cudaStream_t stream) {
  const bool padded = (c % 8) != 0 || !aligned16(x);  // TMA cannot read x: copy it
  const int cp = (c + 7) / 8 * 8;
  const int boxes = (c + RING_CH - 1) / RING_CH;
  const int chunks = (boxes + groups - 1) / std::max(groups, 1);
  const int tgroups = (k + std::max(taps, 1) - 1) / std::max(taps, 1);
  const int partials = groups * tgroups;
  const int64_t rows = (int64_t)b * t * s;
  if (b <= 0 || t <= 0 || s <= 0 || c <= 0 || co <= 0 || k <= 0 || (k % 2) == 0 ||
      (bn != 64 && bn != 128 && bn != 144) || groups < 1 ||
      (int64_t)(groups - 1) * chunks >= boxes || taps < 1 || taps > k ||
      (tgroups - 1) * taps >= k || slots < taps + 1 || blocks < 1 ||
      padded != (xs != nullptr) || (xs != nullptr && !aligned16(xs)) ||
      (partials > 1) != (ws != nullptr) || !aligned16(y) || (ws != nullptr && !aligned16(ws)) ||
      (stage != 0 && (stage != (bn + RING_CH - 1) / RING_CH * RING_BOX || partials > 1 ||
                      co % 8 != 0 || (bn % RING_CH != 0 && co > bn))) ||
      device < 0 || device >= kMaxDevices)
    return (int)cudaErrorInvalidValue;
  const int64_t need = RING_ALIGN + (int64_t)taps * chunks * bn * 128 +
                       (int64_t)slots * (chunks * RING_BOX + 16) + RING_CONSUMERS * stage;
  if (smem_bytes < need || smem_bytes > RING_SMEM_MAX) return (int)cudaErrorInvalidValue;
  const int cols = (s + RING_COLS - 1) / RING_COLS;
  const int co_tiles = (co + bn - 1) / bn;
  RingArgs args{static_cast<const unsigned short*>(w), static_cast<unsigned short*>(y),
                static_cast<float*>(ws), t, s, c, co, k, co_tiles, groups, chunks, slots, taps,
                tgroups, stage, cols, (long long)b * cols * co_tiles * partials, rows};
  // the ring's sequence numbers are ints: a block's frames must fit
  if ((args.items / blocks + 1) * (t + 2 * (k / 2)) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (tensor_map_encoder() == nullptr) return (int)cudaErrorNotSupported;
  const void* src = x;
  const int cx = padded ? cp : c;
  if (padded) {
    err = channel_pad(x, xs, rows, c, cp, stream);
    if (err != cudaSuccess) return (int)err;
    src = xs;
  }
  CUtensorMap xmap, ymap = {};
  if (!frame_map(&xmap, src, b, t, s, cx) || (stage != 0 && !frame_map(&ymap, y, b, t, s, co)))
    return (int)cudaErrorInvalidValue;
#define FVT_RING(BN_)                                                                      \
  (tgroups > 1 ? ring_start<V, BN_, true>(xmap, ymap, args, blocks, smem_bytes, device, stream) \
               : ring_start<V, BN_, false>(xmap, ymap, args, blocks, smem_bytes, device, stream))
  switch (bn) {
    case 64: err = FVT_RING(64); break;
    case 128: err = FVT_RING(128); break;
    default: err = FVT_RING(144); break;
  }
#undef FVT_RING
  if (err != cudaSuccess || partials == 1) return (int)err;
  const int64_t n = rows * co;
  micro_ring_reduce_kernel<<<(unsigned)std::min<int64_t>((n + 255) / 256, 4096), 256, 0, stream>>>(
      static_cast<const float*>(ws), static_cast<unsigned short*>(y), n, partials);
  return (int)cudaGetLastError();
}

// Opts the instance in to the block's whole dynamic shared memory, once per
// device (a host call, not free), then launches it.
template <int V, int BN_>
cudaError_t dw_ring_start(const CUtensorMap& xmap, const CUtensorMap& gmap,
                          const DwRingArgs& args, int blocks, int smem_bytes, int device,
                          cudaStream_t stream) {
  static bool opted_in[kMaxDevices] = {};
  if (!opted_in[device]) {
    cudaError_t err = cudaFuncSetAttribute(micro_dw_ring_kernel<V, BN_>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           RING_SMEM_MAX);
    if (err != cudaSuccess) return err;
    opted_in[device] = true;
  }
  micro_dw_ring_kernel<V, BN_><<<blocks, DW_RING_THREADS, smem_bytes, stream>>>(xmap, gmap, args);
  return cudaGetLastError();
}

// K9 (V = kDwV2) or K7 (V = kDwV3) with the plan of ops/temporal_micro.py::
// dw_ring_plan (bn, taps, xslots, gslots, chunks, cols_per_chunk,
// smem_bytes), checked here against the shape: x (b, t, s, c) and g (b,
// t, s, co) bf16; xs / gs a (b*t*s, c or co rounded up to 8) scratch where
// TMA cannot read x / g (c or co % 8 != 0, or not 16-byte aligned), else
// null; ws (chunks, k, c, co) f32 where chunks > 1, else null; dw (k, c,
// co) f32. Blocks: tap groups x C tiles x Co tiles x chunks.
template <int V>
int launch_dw_ring(const void* x, const void* g, void* xs, void* gs, void* ws, void* dw, int b,
                   int t, int s, int c, int co, int k, int bn, int taps, int xslots, int gslots,
                   int chunks, int cols_per_chunk, int smem_bytes, int device,
                   cudaStream_t stream) {
  const bool pad_x = (c % 8) != 0 || !aligned16(x);  // TMA cannot read them: copy them
  const bool pad_g = (co % 8) != 0 || !aligned16(g);
  const int cp = (c + 7) / 8 * 8, cop = (co + 7) / 8 * 8;
  const int boxes = (bn + RING_CH - 1) / RING_CH;
  const int cols_per_clip = (s + RING_COLS - 1) / RING_COLS;
  const int64_t cols = (int64_t)b * cols_per_clip;
  const int64_t rows = (int64_t)b * t * s;
  if (b <= 0 || t <= 0 || s <= 0 || c <= 0 || co <= 0 || k <= 0 || (k % 2) == 0 ||
      (bn != 64 && bn != 128 && bn != 144) || taps < 1 || taps > DW_RING_TAPS || taps > k ||
      xslots < taps + 1 || gslots < 2 || chunks < 1 || cols_per_chunk < 1 ||
      cols > 0x7fffffffLL || (int64_t)chunks * cols_per_chunk < cols ||
      (int64_t)(chunks - 1) * cols_per_chunk >= cols || pad_x != (xs != nullptr) ||
      pad_g != (gs != nullptr) || (xs != nullptr && !aligned16(xs)) ||
      (gs != nullptr && !aligned16(gs)) || (chunks > 1) != (ws != nullptr) ||
      (ws != nullptr && !aligned16(ws)) || !aligned16(dw) || device < 0 ||
      device >= kMaxDevices)
    return (int)cudaErrorInvalidValue;
  const int64_t need = RING_ALIGN + ((int64_t)xslots * boxes + gslots) * RING_BOX +
                       (int64_t)(xslots + gslots) * 16;
  if (smem_bytes < need || smem_bytes > RING_SMEM_MAX) return (int)cudaErrorInvalidValue;
  const int c_tiles = (c + bn - 1) / bn, co_tiles = (co + DW_RING_M - 1) / DW_RING_M;
  const int64_t blocks = (int64_t)((k + taps - 1) / taps) * c_tiles * co_tiles * chunks;
  // the rings' sequence numbers are ints: a block's frames must fit
  if (blocks > 0x7fffffffLL || (int64_t)cols_per_chunk * (t + k) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (tensor_map_encoder() == nullptr) return (int)cudaErrorNotSupported;
  if (pad_x && (err = channel_pad(x, xs, rows, c, cp, stream)) != cudaSuccess) return (int)err;
  if (pad_g && (err = channel_pad(g, gs, rows, co, cop, stream)) != cudaSuccess) return (int)err;
  CUtensorMap xmap, gmap;
  if (!frame_map(&xmap, pad_x ? xs : x, b, t, s, pad_x ? cp : c) ||
      !frame_map(&gmap, pad_g ? gs : g, b, t, s, pad_g ? cop : co))
    return (int)cudaErrorInvalidValue;
  DwRingArgs args{static_cast<float*>(chunks > 1 ? ws : dw), t, s, c, co, k, taps, c_tiles,
                  co_tiles, boxes, xslots, gslots, cols_per_clip, (int)cols, cols_per_chunk};
  const int nb = (int)blocks;
  switch (bn) {
    case 64: err = dw_ring_start<V, 64>(xmap, gmap, args, nb, smem_bytes, device, stream); break;
    case 128: err = dw_ring_start<V, 128>(xmap, gmap, args, nb, smem_bytes, device, stream); break;
    default: err = dw_ring_start<V, 144>(xmap, gmap, args, nb, smem_bytes, device, stream); break;
  }
  if (err != cudaSuccess || chunks == 1) return (int)err;
  const int64_t n = (int64_t)k * c * co;
  if ((n + 31) / 32 > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  micro_dw_ring_reduce_kernel<<<(unsigned)((n + 31) / 32), dim3(32, DW_REDUCE_GROUPS), 0,
                                stream>>>(static_cast<const float*>(ws), static_cast<float*>(dw),
                                          n, chunks);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` of CUDA device `device` and returns
// cudaGetLastError() after its launches (0 on success). Shapes are checked
// here as well as in the Python wrappers (ops/temporal_micro.py), which
// allocate every output and scratch tensor: for K5, K6 and K8 xs and ws as
// launch_ring says, for K9 and K7 xs, gs and ws as launch_dw_ring says.

int fvt_micro_v2_bf16(const void* x, const void* w, void* xs, void* ws, void* y, int b, int t,
                      int s, int c, int co, int k, int bn, int slots, int groups, int taps,
                      int stage, int blocks, int smem_bytes, int device, void* stream) {
  return launch_ring<kV2>(x, w, xs, ws, y, b, t, s, c, co, k, bn, slots, groups, taps, stage,
                          blocks, smem_bytes, device, reinterpret_cast<cudaStream_t>(stream));
}

int fvt_micro_v3_bf16(const void* x, const void* w, void* xs, void* ws, void* y, int b, int t,
                      int s, int c, int co, int k, int bn, int slots, int groups, int taps,
                      int stage, int blocks, int smem_bytes, int device, void* stream) {
  return launch_ring<kV3>(x, w, xs, ws, y, b, t, s, c, co, k, bn, slots, groups, taps, stage,
                          blocks, smem_bytes, device, reinterpret_cast<cudaStream_t>(stream));
}

int fvt_micro_v3p_bf16(const void* x, const void* w, void* xs, void* ws, void* y, int b, int t,
                       int s, int c, int co, int k, int bn, int slots, int groups, int taps,
                       int stage, int blocks, int smem_bytes, int device, void* stream) {
  return launch_ring<kV3P>(x, w, xs, ws, y, b, t, s, c, co, k, bn, slots, groups, taps, stage,
                           blocks, smem_bytes, device, reinterpret_cast<cudaStream_t>(stream));
}

int fvt_micro_dw_v3_bf16(const void* x, const void* g, void* xs, void* gs, void* ws, void* dw,
                         int b, int t, int s, int c, int co, int k, int bn, int taps, int xslots,
                         int gslots, int chunks, int cols_per_chunk, int smem_bytes, int device,
                         void* stream) {
  return launch_dw_ring<kDwV3>(x, g, xs, gs, ws, dw, b, t, s, c, co, k, bn, taps, xslots, gslots,
                               chunks, cols_per_chunk, smem_bytes, device,
                               reinterpret_cast<cudaStream_t>(stream));
}

int fvt_micro_dw_v2_bf16(const void* x, const void* g, void* xs, void* gs, void* ws, void* dw,
                         int b, int t, int s, int c, int co, int k, int bn, int taps, int xslots,
                         int gslots, int chunks, int cols_per_chunk, int smem_bytes, int device,
                         void* stream) {
  return launch_dw_ring<kDwV2>(x, g, xs, gs, ws, dw, b, t, s, c, co, k, bn, taps, xslots, gslots,
                               chunks, cols_per_chunk, smem_bytes, device,
                               reinterpret_cast<cudaStream_t>(stream));
}

// The channel-pad copies launched so far (K5, K6 and K8: x where C % 8 !=
// 0 or x is misaligned; K9 and K7: x and g likewise).
long long fvt_micro_channel_pad_launches(void) { return channel_pad_launches; }

}  // extern "C"
