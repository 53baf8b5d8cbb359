// Q1 and Q2: the int8 serving engine's convolution and its quantize pass
// on Hopper. Neither replaces a TPU kernel: the JAX engine
// (fastvideotagging_tpu/ops/int8_infer.py) leaves both to XLA
// (``_conv_i8`` :112, ``lax.conv_general_dilated`` on int8 with int32
// accumulation, and the quantize of :144 ``_dyn_quant`` / :543). PyTorch has
// no int8 conv3d on CUDA, and ``torch._int_mm`` would need an im2col that
// writes taps x the activation bytes, so the port's are written by hand.
//
//   conv3d_s8_hopper_kernel (Q1):
//       acc[o, co] = sum_{tap, c} q[src(o, tap), c] * W[co, tap, c]   (int32, exact)
//       v[o, co]   = fma(f32(acc), mul[co] * s, add[co])
//     then one of the engine's epilogue forms, each the chain of separate
//     steps it replaces, rounding for rounding:
//       (a) relu?(v), stored as bf16 or f32;
//       (b) relu?(v) rounded to bf16, then quantized for the next site as Q2's
//           static pass does: q = clamp(rint(f32(bf16) * (inv_f[c] / s_next)),
//           -127, 127), stored int8 at the next site's padded width, the
//           channels Co..cp-1 zero (the layout the next Q1 reads);
//       (c) a block's tail on its main chain's last conv: v plus the residual
//           (the dequantized block input fma(f32(q_in), s_in / inv_f_in[c], v),
//           the downsample conv's f32 output, or the bf16 block input), ReLU,
//           bf16, and then (b)'s quantize and/or the bf16 store.
//     A bf16 store (form (a), or (c) without the quantize) can also reduce
//     the next site's dynamic amax, max |f32(bf16 y) * inv_f_next[c]| over
//     the live rows and the channels below Co (Q2's amax pass on the value
//     it would read, exact: a max rounds nothing): in registers over the
//     block's tiles, then across the warp and the warpgroup, then one
//     atomicMax on the float's bits a warpgroup. That instance is its own
//     (a template parameter), so that the bf16 calls without it run the
//     code they ran before.
//     q (N, T, H, W, cp) int8, channels zero-padded to cp, a multiple of 16;
//     W (Co, kt*kh*kw, cp) int8 K-major (laid out once per qpack); a general
//     3-D tap set with per-dimension strides and low pads (the high pads are
//     implied by the output size: symmetric k//2 or TF-SAME). s, s_next and
//     s_in are read from device memory (static scales, or the one Q2's
//     dynamic pass wrote), so no scale crosses to the host. The multiply-adds
//     are single roundings (__fmaf_rn), as XLA contracts the JAX engine's
//     ``acc * (mul * s) + add`` and its dequant residual, and as the plain
//     versions' addcmul computes them.
//   quantize_s8_kernel (Q2) and its dynamic amax pass quantize_amax_kernel:
//       static:  q = clamp(rint(f32(y) * (inv_f[c] / s)), -127, 127)
//       dynamic: xs = f32(y) * inv_f[c]; s = max(amax|xs|, 1e-12) * f32(1/127);
//                q = clamp(rint(xs / s), -127, 127)
//     (the JAX source divides by 127; XLA multiplies by the f32 reciprocal,
//     which rounds differently in some cases, and the port does as XLA)
//     y (rows, C) bf16 or f32 -> q (rows, cp) int8, channels C..cp-1 zero (the
//     padding Q1 takes). The two orders round differently and are kept
//     apart; rounding is to nearest even, as torch.round and jnp.round do.
//     The dynamic amax comes from the epilogue of the Q1 call that produced
//     y, so the quantize pass runs alone (one read of y, one write of q);
//     the amax pass (an on-device reduction, atomicMax on the bits of a
//     non-negative float) runs first only where no Q1 call alone produced
//     y: the network's input, after a pool, at a value several sites read.
//     In the static mode Q2 runs at the network's input only: every other
//     static quantize is form (b) or (c) of the conv before it. Both passes
//     are bound by bytes: each thread keeps one 16-channel chunk (its
//     factors in registers, no index division) over a stride of rows, two
//     rows in flight, on a grid that fills every SM; the dynamic quotient
//     is a multiply by RN(1 / s) where that rounds to the same int8 as the
//     division, and the division elsewhere (quant16).
//
// Q1's design: a persistent implicit GEMM, one block of 384 or 512 threads
// an SM, warp-specialized. Tile i = (128 output rows, BN output channels),
// BN in {64, 128, 144} (valid N of wgmma's .s8 shapes, m64nNk32); the
// blocks walk the tiles i = blockIdx.x, + gridDim.x, ..., the column tiles
// of a row tile next to each other (they share its A rows in L2). The
// contraction kappa = tap*cp + c runs without gaps in slices of BK = 128
// int8 (128 bytes a row, the 128-byte swizzle), through a ring of 4-6
// stages with a full and an empty mbarrier each. An instance is (BN, the
// output's form: bf16, f32 or int8, and for bf16 the amax or not), so that
// its unrolled epilogue holds its own work only (with all three forms in
// one, it ran slower).
//   - The producer, two warpgroups (one at BN = 144, where the consumers'
//     72 accumulators a thread need more than the 128 registers a thread of
//     512 gets), setmaxnreg down to 40, loads each stage; twice the
//     producer threads keep twice the copies in flight, and the activation
//     loads bound the main loop. The weight slice (BN x 128 of the dense
//     (Co, taps*cp) matrix) comes by TMA, a tiled 2-D box in the 128-byte
//     swizzle; rows past Co and columns past the contraction are the box's
//     zero fill. The activation slice cannot be a box: a 128-byte slice may
//     span two taps, and a box of one tap's channels would waste 2-8x the
//     work at this engine's widths (cp 16, 48, 64, 144). So each producer
//     thread issues 16-byte cp.async chunks (a chunk of 16 channels lies in
//     one tap and works out its source row from a table of the tile's rows
//     in shared memory; zero filled outside the input and past M), then
//     arrives on the stage's full barrier with
//     cp.async.mbarrier.arrive.noinc, which counts once its copies have
//     landed.
//   - Two consumer warpgroups (setmaxnreg up to the rest of the register
//     file), 64 rows each, wait on a stage's full barrier, fence the async
//     proxy (wgmma reads what cp.async wrote), issue its four k32 wgmmas and
//     release the stage one slice later (one group in flight), a lane of
//     each warp on the empty barrier.
//   - The epilogue goes from the int32 accumulators through passes in
//     registers (the column factors from a table in shared memory, filled
//     where the block's column tile changes; the residual's loads clamped
//     inside the tensor and free of branches, so that they are in flight
//     together), then through a staging tile in shared memory (boxes of 16
//     bytes x 64 rows, for f32 64 bytes in the 64-byte swizzle, written
//     without bank conflicts) to TMA stores of the warpgroup's 64 rows,
//     which clip at M and at the row's length; where a row's bytes are not
//     a multiple of 16 (bf16 at Co = 45, 230, 460) the threads store from
//     registers. A second (bf16) output goes through the threads. A tile's
//     stores overlap the next tile's main loop, and the producer runs ahead
//     into the next tile while the consumers finish this one.
// Tried on the way and measured slower at r2plus1d_18's sites (PERF.md's
// findings): the weights resident in shared memory with each consumer
// walking its own 64-row items (the narrower tiles their size forced read A
// more often), the consumers' main loops taking turns, the activations by
// TMA boxes of one tap's channels (32-128 bytes; the stem's strided 32-byte
// boxes were the slowest), a producer that arrives after
// cp.async.wait_group instead of with cp.async.mbarrier.arrive, and
// L1-cached (.ca) copies.

// What bounds them on an H100 SXM (1,979 TOPS int8, 3.35 TB/s): Q1 at
// r2plus1d_18's int8 sites, stages 1-3, is bound by bytes at its narrow
// sites (the stem's 16-padded C = 3, the 1x1x1 downsamples) and by
// operations at the rest; Q2 by bytes everywhere (a read of y, a write of
// int8). Forms (b) and (c) move the int8 q (and the residual's read) where
// the unfused chain moved a bf16 or f32 y through HBM three or four times;
// the amax in the epilogue saves Q2's second read of y.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;                // output rows of a tile (64 a consumer warpgroup)
constexpr int BK = 128;                // contraction slice: 128 int8 = 128 bytes a row
constexpr int CONSUMERS = 2;           // consumer warpgroups
constexpr int A_STAGE = BM * BK;       // bytes of one A slice
constexpr int ALIGN = 1024;            // the 128-byte swizzle repeats every 8 rows
constexpr int MIN_STAGES = 4;
constexpr int MAX_STAGES = 6;
constexpr int ROWS_TABLE = BM * 16;    // the tile's rows: {n * T, ti0, hi0, wi0}
constexpr int SMEM_LIMIT = 232448;     // bytes of shared memory one block may use
constexpr int PRODUCER_REGS = 40;

// The producer has two warpgroups (twice the copies in flight, the
// activation loads' limit) where the consumers' accumulators fit in the 128
// registers a thread of 512 gets; at BN = 144 (72 a thread) ptxas spilled,
// and one warpgroup is faster.
template <int BN>
struct Shape {
  static constexpr int PRODUCERS = BN > 128 ? 1 : 2;
  static constexpr int LOADERS = 128 * PRODUCERS;  // producer threads
  static constexpr int THREADS = 128 * (CONSUMERS + PRODUCERS);
  // the rest of the register file, in setmaxnreg's steps of 8
  static constexpr int CONSUMER_REGS = (65536 - LOADERS * PRODUCER_REGS) / (128 * CONSUMERS) / 8 * 8;
  static_assert(128 * 8 % LOADERS == 0, "the producer threads share a slice's chunks evenly");
};
constexpr int kOutside = -(1 << 28);   // frame coordinate of a row past M

enum Out { kOutBf16 = 0, kOutF32 = 1, kOutS8 = 2 };

// Bytes of a staging box's row (64 rows a box): 16, or for f32 64 in the
// 64-byte swizzle (a quarter of the TMA stores; its writes stay free of bank
// conflicts).
template <int OUT>
__host__ __device__ constexpr int out_box() { return OUT == kOutF32 ? 64 : 16; }
enum Res { kResNone = 0, kResDequant = 1, kResF32 = 2, kResBf16 = 3 };

// One launch of Q1 (see the top of the file). The weights and, where the
// output is staged, the output come through the kernel's tensor maps.
struct ConvArgs {
  const int8_t* x;          // (N, T, H, W, cp)
  const float* mul;         // (Co)
  const float* add;         // (Co)
  const float* s;           // scalar
  void* y;                  // (M, ld): bf16, f32 or int8 (out)
  __nv_bfloat16* y2;        // a second output (M, Co) bf16, or null
  const void* res;          // (M, res_ld): int8 q_in, f32 or bf16 (res_kind)
  const float* res_inv_f;   // dequant: (Co) inv_f of q_in's site
  const float* res_s;       // dequant: q_in's scale
  const float* q_inv_f;     // int8 out: (Co) the next site's inv_f
  const float* q_s;         // int8 out: the next site's scale
  unsigned* amax;           // bf16 out: the next site's dynamic amax (f32 bits), or null
  const float* amax_inv_f;  // bf16 out: (Co) the next site's inv_f
  int64_t M;                // N * To * Ho * Wo output rows
  int T, H, W;              // input frames, rows, columns
  int To, Ho, Wo;           // output geometry
  int kt, kh, kw;           // taps
  int st, sh, sw;           // strides
  int pt, ph, pw;           // low pads
  int cp, co, K;            // padded input channels, output channels, taps * cp
  int n_tiles, tiles;       // column tiles (BN wide), all tiles
  int relu, ld, res_kind, res_ld, stages, staged;  // the output's form: a template parameter
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk j of row r in a K-major tile of 128-byte
// rows, 128-byte swizzled (what TMA's CU_TENSOR_MAP_SWIZZLE_128B writes).
__device__ __forceinline__ uint32_t swz(int r, int j) {
  return static_cast<uint32_t>(r * 128 + ((j ^ (r & 7)) << 4));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0));
}

// The mbarrier counts one arrival once this thread's cp.asyncs so far have
// landed (noinc: the arrival is one of those the barrier was set up for).
__device__ __forceinline__ void cp_async_mbar_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" :: "r"(bar) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The helpers below are those of csrc/temporal_micro.cu's rings.
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// Waits for the phase of parity `parity` to complete. The spin loop is in
// the PTX, so that the code around a wait stays warp-uniform to the
// compiler. A wait that lasts seconds means a lost arrival or load: it traps
// (the launch fails) rather than hang the card.
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

// Arrives on `bar` from lane 0 of the warp only, predicated in the PTX.
__device__ __forceinline__ void mbar_arrive_lane0(uint32_t bar, int lane) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.eq.u32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n"
      :: "r"(bar), "r"(lane) : "memory");
}

// Box (c0, c1) of a 2-D tensor map into shared memory; its bytes complete
// the transaction count of barrier `bar`.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// One staging box to (c0, c1) of a 2-D tensor map (the parts past the
// tensor are not written), issued by the thread whose `issuer` is set;
// predicated in the PTX, as are the bulk-group commit and waits below.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             bool issuer) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %4, 0;\n"
      "@p cp.async.bulk.tensor.2d.global.shared::cta.tile.bulk_group [%0, {%2, %3}], [%1];\n}\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1),
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

// Named barriers: 1 + c the consumer warpgroup c, 1 + CONSUMERS the producer
// warpgroup.
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
}

template <int LOADERS>
__device__ __forceinline__ void producer_sync() {
  asm volatile("bar.sync %0, %1;\n" :: "n"(1 + CONSUMERS), "n"(LOADERS) : "memory");
}

// The async proxy (wgmma, TMA stores) reads what the generic proxy wrote.
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
__device__ __forceinline__ void fence_acc(int32_t (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

// Shared-memory matrix descriptor of a K-major tile in the 128-byte
// swizzle: start address >> 4, leading offset 1 (unused for this layout),
// 1024 bytes between 8-row groups, layout type 1 (128B swizzle). Moving 32
// int8 along K within the 128-byte row is +32 bytes on the start address.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

// wgmma.mma_async m64nNk32, s8 x s8 -> s32, A and B both K-major in shared
// memory (the only form the 8-bit types take); d += A B.
__device__ __forceinline__ void wgmma_s8_64(int32_t (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_s8_128(int32_t (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_s8_144(int32_t (&d)[72], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %74, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n144k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71"
      "}, %72, %73, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
        "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71])
      : "l"(da), "l"(db), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_tile(int32_t (&d)[BN / 2], uint64_t da, uint64_t db) {
  if constexpr (BN == 64) wgmma_s8_64(d, da, db);
  else if constexpr (BN == 128) wgmma_s8_128(d, da, db);
  else wgmma_s8_144(d, da, db);
}

// The epilogue's residual pass on accumulators that hold f32 bits: element
// (row, col) of `res` (its rows res_ld apart) added to each, as one
// multiply-add with the column's s_in / inv_f (cf[.].w) for the dequantized
// block input. The loads are clamped inside the tensor (the values of rows
// past M and columns past Co are not stored) and free of branches, so that
// they can all be in flight at once. `row`: this thread's first row.
template <int KIND, int BN>
__device__ __forceinline__ void add_residual(int32_t (&acc)[BN / 2], const void* res, int res_ld,
                                             const float4* cf, int n0, int co, int row,
                                             int64_t M, int lane) {
  const int last_row = static_cast<int>(M) - 1;
#pragma unroll
  for (int jn = 0; jn < BN / 8; ++jn) {
    const int c = jn * 8 + (lane & 3) * 2;
    const int c0 = min(n0 + c, co - 1), c1 = min(n0 + c + 1, co - 1);
    const float rs0 = cf[c].w, rs1 = cf[c + 1].w;
#pragma unroll
    for (int h8 = 0; h8 < 2; ++h8) {
      const int64_t rb = static_cast<int64_t>(min(row + 8 * h8, last_row)) * res_ld;
      int32_t* d = acc + 4 * jn + 2 * h8;
      float v0 = __int_as_float(d[0]), v1 = __int_as_float(d[1]);
      if constexpr (KIND == kResDequant) {
        const int8_t* r = static_cast<const int8_t*>(res) + rb;
        v0 = __fmaf_rn(static_cast<float>(r[c0]), rs0, v0);
        v1 = __fmaf_rn(static_cast<float>(r[c1]), rs1, v1);
      } else if constexpr (KIND == kResF32) {
        const float* r = static_cast<const float*>(res) + rb;
        v0 = __fadd_rn(v0, r[c0]);
        v1 = __fadd_rn(v1, r[c1]);
      } else {
        const __nv_bfloat16* r = static_cast<const __nv_bfloat16*>(res) + rb;
        v0 = __fadd_rn(v0, __bfloat162float(r[c0]));
        v1 = __fadd_rn(v1, __bfloat162float(r[c1]));
      }
      d[0] = __float_as_int(v0);
      d[1] = __float_as_int(v1);
    }
  }
}

// clamp(rint(t), -127, 127) in the low byte, as the low clamp and one
// conversion that rounds to nearest even and saturates at 127 (the same
// value for every input).
__device__ __forceinline__ uint32_t s8_bits(float t) {
  uint32_t q;
  asm("cvt.rni.sat.s8.f32 %0, %1;\n" : "=r"(q) : "f"(fmaxf(t, -127.0f)));
  return q;
}

// Q2's static quantize of a bf16-rounded value: s8(f32(bf16) * qf).
__device__ __forceinline__ uint32_t quant(__nv_bfloat16 b, float qf) {
  return s8_bits(__fmul_rn(__bfloat162float(b), qf));
}

template <int BN, int OUT, bool AMAX>
__global__ void __launch_bounds__(Shape<BN>::THREADS, 1)
conv3d_s8_hopper_kernel(const __grid_constant__ CUtensorMap wmap,
                        const __grid_constant__ CUtensorMap ymap, const ConvArgs a) {
  static_assert(!AMAX || OUT == kOutBf16, "the amax is reduced over a bf16 output");
  constexpr int STAGE = A_STAGE + BN * BK;  // a multiple of ALIGN (BN % 8 == 0)
  constexpr int LOADERS = Shape<BN>::LOADERS;
  static_assert(BN % 16 == 0 && STAGE % ALIGN == 0, "BN must be a multiple of 16");
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + ALIGN - 1) & ~static_cast<uint32_t>(ALIGN - 1);
  unsigned char* smem = smem_raw + (base - raw);
  const int NS = a.stages;
  constexpr int es = OUT == kOutF32 ? 4 : (OUT == kOutBf16 ? 2 : 1);  // output bytes
  constexpr int BOX = out_box<OUT>();
  // shared memory: the ring, the consumers' staging tiles, the row table,
  // the consumers' column tables, the barriers
  const uint32_t wg_stage = a.staged ? 64 * BN * es : 0;
  const uint32_t staging = base + NS * STAGE;
  const uint32_t table = staging + CONSUMERS * wg_stage;
  const uint32_t colf = table + ROWS_TABLE;
  const uint32_t full = colf + CONSUMERS * BN * 16, empty = full + 8 * NS;
  const int KT = (a.K + BK - 1) / BK;
  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);

  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(full + 8 * s, LOADERS + 1);      // the producer threads' copies + the TMA's bytes
      mbar_init(empty + 8 * s, CONSUMERS * 4);   // each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * CONSUMERS) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(PRODUCER_REGS));
    const int pt = tid - 128 * CONSUMERS;
    const int j = pt & 7;   // this thread's 16-byte chunk of a row
    const int r0 = pt >> 3; // and its rows r0 + LOADERS / 8 q
    const int C = a.cp, taps = a.kt * a.kh * a.kw;
    int4* rows = reinterpret_cast<int4*>(smem + (table - base));
    int seq = 0;
    for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
      const int m0 = (tile / a.n_tiles) * BM;
      const int n0 = (tile % a.n_tiles) * BN;
      producer_sync<LOADERS>();  // the last tile's loads have read the table
      for (int r = pt; r < BM; r += LOADERS) {
        const int m = m0 + r;  // a row past M: coordinates no tap brings inside
        int4 rc = make_int4(0, kOutside, kOutside, kOutside);
        if (m < a.M) {
          const int wo = m % a.Wo;
          int rest = m / a.Wo;
          const int ho = rest % a.Ho;
          rest /= a.Ho;
          const int to = rest % a.To;
          rc = make_int4(rest / a.To * a.T, to * a.st - a.pt, ho * a.sh - a.ph, wo * a.sw - a.pw);
        }
        rows[r] = rc;
      }
      producer_sync<LOADERS>();
      // The loads walk kappa in order: this thread's chunk starts at kappa =
      // j * 16 and moves on by BK a slice, its (tap, c) and the tap's (dt,
      // dh, dw) carried along instead of divided out again.
      int ld_tap = (j * 16) / C;
      int ld_c = j * 16 - ld_tap * C;
      int ld_dt = ld_tap / (a.kh * a.kw);
      int ld_dh = (ld_tap / a.kw) % a.kh;
      int ld_dw = ld_tap % a.kw;
      for (int kt = 0; kt < KT; ++kt, ++seq) {
        const int slot = seq % NS;
        mbar_wait(empty + 8 * slot, ((seq / NS) & 1) ^ 1);
        const uint32_t sa = base + slot * STAGE;
        if (pt == 0) {
          mbar_expect_tx(full + 8 * slot, BN * BK);
          tma_load_2d(sa + A_STAGE, &wmap, full + 8 * slot, kt * BK, n0);
        }
        const bool kin = ld_tap < taps;
#pragma unroll
        for (int q = 0; q < BM * 8 / LOADERS; ++q) {
          const int4 rc = rows[r0 + LOADERS / 8 * q];
          const int ti = rc.y + ld_dt, hi = rc.z + ld_dh, wi = rc.w + ld_dw;
          const bool ok = kin && static_cast<unsigned>(ti) < static_cast<unsigned>(a.T) &&
                          static_cast<unsigned>(hi) < static_cast<unsigned>(a.H) &&
                          static_cast<unsigned>(wi) < static_cast<unsigned>(a.W);
          const int8_t* src =
              ok ? a.x + ((static_cast<int64_t>(rc.x + ti) * a.H + hi) * a.W + wi) * C + ld_c
                 : a.x;
          cp_async16(sa + swz(r0 + LOADERS / 8 * q, j), src, ok);
        }
        cp_async_mbar_arrive(full + 8 * slot);
        for (ld_c += BK; ld_c >= C; ld_c -= C) {
          ++ld_tap;
          if (++ld_dw == a.kw) {
            ld_dw = 0;
            if (++ld_dh == a.kh) {
              ld_dh = 0;
              ++ld_dt;
            }
          }
        }
      }
    }
    cp_async_wait_all();
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(Shape<BN>::CONSUMER_REGS));
  const int wg = warp >> 2;  // rows 64 wg .. +63 of each tile
  const int wtid = tid & 127;
  const bool issuer = wtid == 0;  // the warpgroup's thread that issues its stores
  const uint32_t stage_out = staging + wg * wg_stage;
  float4* cf = reinterpret_cast<float4*>(smem + (colf - base)) + wg * BN;
  // Warp w of the warpgroup holds rows 16 (w % 4) .. +15 of its 64: n8
  // block jn in acc[4 jn .. 4 jn + 3], rows lane/4 and lane/4 + 8, columns
  // (lane % 4) * 2 and + 1.
  const int wrow = (warp & 3) * 16 + (lane >> 2);  // in the warpgroup's 64 rows
  const float s = *a.s;
  const float q_s = OUT == kOutS8 ? *a.q_s : 1.0f;
  const float res_s = a.res_kind == kResDequant ? *a.res_s : 1.0f;
  int32_t acc[BN / 2];
  float amax = 0.0f;  // AMAX: this thread's max |f32(bf16 y) * inv_f| over its tiles
  int seq = 0;
  int table_n0 = -1;  // the column tile whose factors the table holds
  for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
    const int m0 = (tile / a.n_tiles) * BM;
    const int n0 = (tile % a.n_tiles) * BN;
    // The column tile's factors (mul * s, add, the next site's inv_f / s,
    // or its inv_f for the amax, the residual's s_in / inv_f): a thread a
    // column, into this warpgroup's table, where the block's column tile
    // changes (a block walks one column tile where their count divides the
    // grid).
    if (n0 != table_n0) {
      warpgroup_sync(wg);  // the last tile's epilogue has read the table
      for (int i = wtid; i < BN; i += 128) {
        const int col = n0 + i;
        float4 f = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (col < a.co) {
          f.x = __fmul_rn(a.mul[col], s);
          f.y = a.add[col];
          if (OUT == kOutS8) f.z = __fdiv_rn(a.q_inv_f[col], q_s);
          if (AMAX) f.z = a.amax_inv_f[col];
          if (a.res_kind == kResDequant) f.w = __fdiv_rn(res_s, a.res_inv_f[col]);
        }
        cf[i] = f;
      }
      table_n0 = n0;
    }
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    for (int kt = 0; kt < KT; ++kt, ++seq) {
      const int slot = seq % NS;
      mbar_wait(full + 8 * slot, (seq / NS) & 1);
      fence_proxy_async();  // wgmma reads what cp.async wrote
      const uint32_t sa = base + slot * STAGE + wg * 64 * 128;
      const uint32_t sb = base + slot * STAGE + A_STAGE;
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < BK / 32; ++ks)
        wgmma_tile<BN>(acc, smem_desc(sa + ks * 32), smem_desc(sb + ks * 32));
      wgmma_commit();
      fence_acc(acc);
      wgmma_wait<1>();  // the slice before this one is done: release its stage
      fence_acc(acc);
      if (kt > 0) mbar_arrive_lane0(empty + 8 * ((seq - 1) % NS), lane);
    }
    wgmma_wait<0>();
    fence_acc(acc);
    mbar_arrive_lane0(empty + 8 * ((seq - 1) % NS), lane);

    // Epilogue, in passes over the accumulators, which hold f32 bits from
    // the first on: (1) the requant multiply-add; (2) the residual, its
    // loads clamped inside the tensor and free of branches, so that they
    // are issued together; (3) ReLU, bf16, the quantize and the stores.
    if (a.staged) bulk_wait<true>(issuer);  // the last tile's stores have read the staging tile
    warpgroup_sync(wg);                      // and the column table is written
    const int mw = m0 + wg * 64;  // the warpgroup's first row
#pragma unroll
    for (int jn = 0; jn < BN / 8; ++jn) {
      const int c = jn * 8 + (lane & 3) * 2;
      const float4 f0 = cf[c], f1 = cf[c + 1];
#pragma unroll
      for (int h8 = 0; h8 < 2; ++h8) {
        int32_t* d = acc + 4 * jn + 2 * h8;
        d[0] = __float_as_int(__fmaf_rn(__int2float_rn(d[0]), f0.x, f0.y));
        d[1] = __float_as_int(__fmaf_rn(__int2float_rn(d[1]), f1.x, f1.y));
      }
    }
    if (a.res_kind == kResDequant)
      add_residual<kResDequant, BN>(acc, a.res, a.res_ld, cf, n0, a.co, mw + wrow, a.M, lane);
    else if (a.res_kind == kResF32)
      add_residual<kResF32, BN>(acc, a.res, a.res_ld, cf, n0, a.co, mw + wrow, a.M, lane);
    else if (a.res_kind == kResBf16)
      add_residual<kResBf16, BN>(acc, a.res, a.res_ld, cf, n0, a.co, mw + wrow, a.M, lane);
#pragma unroll
    for (int jn = 0; jn < BN / 8; ++jn) {
      const int c = jn * 8 + (lane & 3) * 2;  // in the tile
      const int col = n0 + c;
      const bool in0 = col < a.co, in1 = col + 1 < a.co;
      const float qf0 = cf[c].z, qf1 = cf[c + 1].z;
#pragma unroll
      for (int h8 = 0; h8 < 2; ++h8) {
        const int r = wrow + 8 * h8;
        const int m = mw + r;
        const bool live = m < a.M;
        float v0 = __int_as_float(acc[4 * jn + 2 * h8]);
        float v1 = __int_as_float(acc[4 * jn + 2 * h8 + 1]);
        if (a.relu) {
          v0 = fmaxf(v0, 0.0f);
          v1 = fmaxf(v1, 0.0f);
        }
        const __nv_bfloat162 b = __floats2bfloat162_rn(v0, v1);
        if constexpr (AMAX) {  // the columns past Co have a factor of 0
          const float m = fmaxf(fabsf(__fmul_rn(__bfloat162float(b.x), qf0)),
                                fabsf(__fmul_rn(__bfloat162float(b.y), qf1)));
          amax = live ? fmaxf(amax, m) : amax;
        }
        if (a.y2 != nullptr && live) {
          __nv_bfloat16* y2 = a.y2 + static_cast<int64_t>(m) * a.co + col;
          if (in0) y2[0] = b.x;
          if (in1) y2[1] = b.y;
        }
        if (a.staged) {
          // byte c * es of the row: box (c * es) / BOX, row r of the box; in
          // a 64-byte box the 16-byte chunk k of row r lies at k ^ (r / 2 % 4)
          const int at_row = (c * es) & (BOX - 1);
          const int chunk = BOX == 64 ? ((at_row >> 4) ^ ((r >> 1) & 3)) : 0;
          unsigned char* at = smem + (stage_out - base) + (c * es / BOX) * (64 * BOX) +
                              r * BOX + chunk * 16 + (at_row & 15);
          if constexpr (OUT == kOutF32) {
            *reinterpret_cast<float2*>(at) = make_float2(v0, v1);
          } else if constexpr (OUT == kOutBf16) {
            *reinterpret_cast<__nv_bfloat162*>(at) = b;
          } else {  // the next site's channels past Co are zero
            const uint32_t q0 = in0 ? quant(b.x, qf0) : 0u, q1 = in1 ? quant(b.y, qf1) : 0u;
            *reinterpret_cast<uint16_t*>(at) = static_cast<uint16_t>(__byte_perm(q0, q1, 0x40));
          }
        } else if (live) {  // masked at M and at the row's length
          const int64_t at = static_cast<int64_t>(m) * a.ld + col;
          const bool w0 = col < a.ld, w1 = col + 1 < a.ld;
          if constexpr (OUT == kOutF32) {
            float* y = static_cast<float*>(a.y) + at;
            if (w0) y[0] = v0;
            if (w1) y[1] = v1;
          } else if constexpr (OUT == kOutBf16) {
            __nv_bfloat16* y = static_cast<__nv_bfloat16*>(a.y) + at;
            if (w0) y[0] = b.x;
            if (w1) y[1] = b.y;
          } else {
            int8_t* y = static_cast<int8_t*>(a.y) + at;
            if (w0) y[0] = static_cast<int8_t>(in0 ? quant(b.x, qf0) : 0u);
            if (w1) y[1] = static_cast<int8_t>(in1 ? quant(b.y, qf1) : 0u);
          }
        }
      }
    }
    if (a.staged) {
      fence_proxy_async();
      warpgroup_sync(wg);
#pragma unroll 1
      for (int bx = 0; bx < BN * es / BOX; ++bx)  // a box's row holds BOX / es outputs
        tma_store_2d(&ymap, stage_out + bx * 64 * BOX, n0 + bx * (BOX / es), mw, issuer);
      bulk_commit(issuer);
    }
  }
  if (a.staged) bulk_wait<false>(issuer);
  if constexpr (AMAX) {
    // The bits of a non-negative float order as unsigned integers: the
    // warp's max, then the warpgroup's through its column table (its
    // epilogue is done with it), then one atomic a warpgroup.
    const unsigned bits = __reduce_max_sync(0xffffffffu, __float_as_uint(amax));
    unsigned* part = reinterpret_cast<unsigned*>(cf);
    warpgroup_sync(wg);
    if (lane == 0) part[warp & 3] = bits;
    warpgroup_sync(wg);
    if (issuer) atomicMax(a.amax, max(max(part[0], part[1]), max(part[2], part[3])));
  }
}

// ---------------------------------------------------------------------------
// Q2: the quantize pass
// ---------------------------------------------------------------------------

// Q2's modes: static (the scale given), dynamic (the amax pass, then the
// quantize pass) and dynamic from an amax already reduced (a Q1 epilogue's).
enum Q2Mode { kQ2Static = 0, kQ2Dynamic = 1, kQ2Given = 2 };

constexpr int Q2_THREADS = 256;  // a block

// Q2's thread layout. A row's cp / 16 chunks of 16 channels go to `lanes` =
// min(cp / 16, blockDim.x) neighbouring threads: thread t keeps chunk t %
// lanes (and every lanes-th after it, where a row has more chunks than a
// block has threads), so that the chunk's 16 factors stay in registers and
// no thread divides an index. A block takes blockDim.x / lanes rows a step
// (the threads past a whole number of rows idle) and its threads walk the
// rows two steps at a time: two chunks of 16-byte loads in flight a thread.
struct Q2Walk {
  int lanes, chunk, chunks;
  int64_t row, stride;
  bool active;
  __device__ __forceinline__ explicit Q2Walk(int cp) {
    chunks = cp / 16;
    lanes = min(chunks, static_cast<int>(blockDim.x));
    const int step_rows = blockDim.x / lanes;
    active = static_cast<int>(threadIdx.x) < step_rows * lanes;
    chunk = threadIdx.x % lanes;
    row = static_cast<int64_t>(blockIdx.x) * step_rows + threadIdx.x / lanes;
    stride = static_cast<int64_t>(gridDim.x) * step_rows;
  }
};

// 16 channels c0.. of row r of y (rows, C) as f32; channels past C read 0.
// vec: C % 16 == 0 and y 16-byte aligned, so the chunk is whole and aligned.
__device__ __forceinline__ void load_chunk(const __nv_bfloat16* __restrict__ y, int64_t r, int c0,
                                           int C, bool vec, float (&v)[16]) {
  const __nv_bfloat16* p = y + r * C + c0;
  if (vec) {
    const uint4 a = reinterpret_cast<const uint4*>(p)[0];
    const uint4 b = reinterpret_cast<const uint4*>(p)[1];
    const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int u = 0; u < 8; ++u) {  // bf16 -> f32 is the 16 bits moved up
      v[2 * u] = __uint_as_float(w[u] << 16);
      v[2 * u + 1] = __uint_as_float(w[u] & 0xFFFF0000u);
    }
  } else {
#pragma unroll
    for (int u = 0; u < 16; ++u) v[u] = c0 + u < C ? __bfloat162float(p[u]) : 0.0f;
  }
}

__device__ __forceinline__ void load_chunk(const float* __restrict__ y, int64_t r, int c0, int C,
                                           bool vec, float (&v)[16]) {
  const float* p = y + r * C + c0;
  if (vec) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float4 a = reinterpret_cast<const float4*>(p)[u];
      v[4 * u] = a.x;
      v[4 * u + 1] = a.y;
      v[4 * u + 2] = a.z;
      v[4 * u + 3] = a.w;
    }
  } else {
#pragma unroll
    for (int u = 0; u < 16; ++u) v[u] = c0 + u < C ? p[u] : 0.0f;
  }
}

// A chunk's 16 factors, 0 past C: static inv_f / s (one division a
// channel, the JAX engine's order), dynamic inv_f.
template <bool DYN>
__device__ __forceinline__ void chunk_factors(const float* __restrict__ inv_f, int c0, int C,
                                              float s, float (&f)[16]) {
#pragma unroll
  for (int u = 0; u < 16; ++u)
    f[u] = c0 + u < C ? (DYN ? inv_f[c0 + u] : __fdiv_rn(inv_f[c0 + u], s)) : 0.0f;
}

// 16 values quantized, four to a word: static q = s8(f32(y) * (inv_f /
// s)), dynamic q = s8((f32(y) * inv_f) / s); the two orders round
// differently and are kept apart. Channels past C are 0 * 0.
//
// The dynamic quotient without a division a value: t0 = x * inv_s, inv_s =
// RN(1 / s) (the thread's, rounded once), is within 2.5 ulp of RN(x / s),
// at most 2^-14 for |x / s| < 128 (|x| <= amax, so |x / s| <= 127 and a
// little). rint (and so q) of t0 and of RN(x / s) can differ only where a
// half-integer lies within that distance of t0; where one does for any of
// the chunk's 16 values, the chunk takes RN(x / s) itself (__fdiv_rn, about
// one chunk in 500). The division's slow path, which a zero dividend takes,
// is kept off that path by dividing s by itself there (the product with a
// mask gives 0 / s = 0; a select made the compiler branch around the
// division, which diverges on a ReLU's zeros).
template <bool DYN>
__device__ __forceinline__ uint4 quant16(const float (&v)[16], const float (&f)[16], float s,
                                         float inv_s) {
  float t[16];
  bool near = false;
#pragma unroll
  for (int u = 0; u < 16; ++u) {
    t[u] = __fmul_rn(v[u], f[u]);
    if (DYN) {
      t[u] = __fmul_rn(t[u], inv_s);
      near |= fabsf(__fsub_rn(__fsub_rn(t[u], floorf(t[u])), 0.5f)) <= 0x1p-14f;
    }
  }
  if (DYN && near) {
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      const float x = __fmul_rn(v[u], f[u]);
      const bool zero = x == 0.0f;
      float d = zero ? s : x;
      asm("" : "+f"(d));
      t[u] = __fmul_rn(__fdiv_rn(d, s), zero ? 0.0f : 1.0f);
    }
  }
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    w[k] = __byte_perm(__byte_perm(s8_bits(t[4 * k]), s8_bits(t[4 * k + 1]), 0x40),
                       __byte_perm(s8_bits(t[4 * k + 2]), s8_bits(t[4 * k + 3]), 0x40), 0x5410);
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Quantizes y into q, one 16-byte store a chunk. DYN takes s from the
// amax (the amax pass's, or a Q1 epilogue's) and block 0 writes it to s_out.
// CK > 0: C is CK (the network's RGB input, C = 3, cp = 16), known to the
// compiler, which then keeps the 13 padding channels out of registers: at 22
// bytes a row the pass needs the occupancy that the general instance's
// registers leave no room for.
template <typename In, bool DYN, int CK>
__global__ void __launch_bounds__(Q2_THREADS)
quantize_s8_kernel(const In* __restrict__ y, const float* __restrict__ inv_f,
                   const float* __restrict__ s_in, const unsigned* __restrict__ amax,
                   float* __restrict__ s_out, int8_t* __restrict__ q, int64_t rows, int c, int cp,
                   int load_vec) {
  const int C = CK > 0 ? CK : c;
  const bool vec = CK == 0 && load_vec != 0;  // CK: C < 16
  // 1.0f / 127.0f is the f32 reciprocal, rounded once at compile time
  const float s = DYN ? __fmul_rn(fmaxf(__uint_as_float(*amax), 1e-12f), 1.0f / 127.0f) : *s_in;
  const float inv_s = DYN ? __frcp_rn(s) : 0.0f;  // RN(1 / s)
  if (DYN && blockIdx.x == 0 && threadIdx.x == 0) *s_out = s;
  const Q2Walk w(CK > 0 ? 16 : cp);
  if (!w.active) return;
  uint4* out = reinterpret_cast<uint4*>(q);
  for (int j = w.chunk; j < w.chunks; j += w.lanes) {
    const int c0 = CK > 0 ? 0 : j * 16;
    float f[16];
    chunk_factors<DYN>(inv_f, c0, C, s, f);
    int64_t r = w.row;
    for (; r + w.stride < rows; r += 2 * w.stride) {
      float v0[16], v1[16];
      load_chunk(y, r, c0, C, vec, v0);
      load_chunk(y, r + w.stride, c0, C, vec, v1);
      out[r * w.chunks + j] = quant16<DYN>(v0, f, s, inv_s);
      out[(r + w.stride) * w.chunks + j] = quant16<DYN>(v1, f, s, inv_s);
    }
    if (r < rows) {
      float v0[16];
      load_chunk(y, r, c0, C, vec, v0);
      out[r * w.chunks + j] = quant16<DYN>(v0, f, s, inv_s);
    }
  }
}

// max |f32(y) * inv_f[c]| over y (rows, C) into *amax (the bits of a
// non-negative float order as unsigned integers), one atomic a block: the
// dynamic mode's first pass where no Q1 epilogue reduced the amax. CK as
// quantize_s8_kernel's.
template <typename In, int CK>
__global__ void __launch_bounds__(Q2_THREADS)
quantize_amax_kernel(const In* __restrict__ y, const float* __restrict__ inv_f,
                     unsigned* __restrict__ amax, int64_t rows, int c, int cp, int load_vec) {
  const int C = CK > 0 ? CK : c;
  const bool vec = CK == 0 && load_vec != 0;  // CK: C < 16
  const Q2Walk w(CK > 0 ? 16 : cp);
  float m = 0.0f;
  for (int j = w.chunk; w.active && j < w.chunks; j += w.lanes) {
    const int c0 = CK > 0 ? 0 : j * 16;
    float f[16];
    chunk_factors<true>(inv_f, c0, C, 1.0f, f);
    int64_t r = w.row;
    for (; r + w.stride < rows; r += 2 * w.stride) {
      float v0[16], v1[16];
      load_chunk(y, r, c0, C, vec, v0);
      load_chunk(y, r + w.stride, c0, C, vec, v1);
#pragma unroll
      for (int u = 0; u < 16; ++u)
        m = fmaxf(m, fmaxf(fabsf(__fmul_rn(v0[u], f[u])), fabsf(__fmul_rn(v1[u], f[u]))));
    }
    if (r < rows) {
      float v0[16];
      load_chunk(y, r, c0, C, vec, v0);
#pragma unroll
      for (int u = 0; u < 16; ++u) m = fmaxf(m, fabsf(__fmul_rn(v0[u], f[u])));
    }
  }
  const unsigned bits = __reduce_max_sync(0xffffffffu, __float_as_uint(m));
  __shared__ unsigned part[Q2_THREADS / 32];
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = bits;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned b = part[0];
#pragma unroll
    for (int i = 1; i < Q2_THREADS / 32; ++i) b = max(b, part[i]);
    atomicMax(amax, b);
  }
}

constexpr int kMaxDevices = 64;

bool aligned(const void* p, uintptr_t n) { return (reinterpret_cast<uintptr_t>(p) & (n - 1)) == 0; }

// cuTensorMapEncodeTiled through the runtime's driver entry point, so that
// the library links no libcuda of its own (as csrc/temporal_micro.cu).
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

// A 2-D tensor map of a (rows, cols) row-major tensor, cols innermost.
bool map_2d(CUtensorMap* map, const void* ptr, CUtensorMapDataType type, int es, int64_t rows,
            int64_t cols, int box_cols, int box_rows, CUtensorMapSwizzle swizzle) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * es};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The shared memory of a plan (ops/int8_conv.py::conv_s8_plan computes the
// same): the ring, the staging tiles, the row table, the column tables, the
// barriers.
int conv_smem(int bn, int stages, int es, int staged) {
  return ALIGN + stages * (A_STAGE + bn * BK) + (staged ? CONSUMERS * 64 * bn * es : 0) +
         ROWS_TABLE + CONSUMERS * bn * 16 + 16 * stages;
}

// Opts the instance in to the block's whole shared memory once per device (a
// host call, not free), then launches it.
template <int BN, int OUT, bool AMAX = false>
int launch_conv(const CUtensorMap& wmap, const CUtensorMap& ymap, const ConvArgs& args,
                int blocks, int smem_bytes, int device, cudaStream_t s) {
  static bool opted_in[kMaxDevices] = {};
  if (!opted_in[device]) {
    cudaError_t err = cudaFuncSetAttribute(conv3d_s8_hopper_kernel<BN, OUT, AMAX>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           SMEM_LIMIT);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in[device] = true;
  }
  conv3d_s8_hopper_kernel<BN, OUT, AMAX><<<blocks, Shape<BN>::THREADS, smem_bytes, s>>>(
      wmap, ymap, args);
  return static_cast<int>(cudaGetLastError());
}

// The instance for (bn, out, amax): its column tile, its output's form and
// the amax reduction are template parameters, so that each epilogue holds
// only its own work (the bf16 calls without an amax run the same code as
// before the amax was added).
template <int BN>
int launch_by_out(int out, const CUtensorMap& wmap, const CUtensorMap& ymap,
                  const ConvArgs& args, int blocks, int smem_bytes, int device, cudaStream_t s) {
  switch (out) {
    case kOutBf16:
      if (args.amax != nullptr)
        return launch_conv<BN, kOutBf16, true>(wmap, ymap, args, blocks, smem_bytes, device, s);
      return launch_conv<BN, kOutBf16>(wmap, ymap, args, blocks, smem_bytes, device, s);
    case kOutF32: return launch_conv<BN, kOutF32>(wmap, ymap, args, blocks, smem_bytes, device, s);
    default: return launch_conv<BN, kOutS8>(wmap, ymap, args, blocks, smem_bytes, device, s);
  }
}

int launch_by_bn(int bn, int out, const CUtensorMap& wmap, const CUtensorMap& ymap,
                 const ConvArgs& args, int blocks, int smem_bytes, int device, cudaStream_t s) {
  switch (bn) {
    case 64: return launch_by_out<64>(out, wmap, ymap, args, blocks, smem_bytes, device, s);
    case 128: return launch_by_out<128>(out, wmap, ymap, args, blocks, smem_bytes, device, s);
    case 144: return launch_by_out<144>(out, wmap, ymap, args, blocks, smem_bytes, device, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Q2's grid: as many blocks of Q2_THREADS as fill every SM at the kernel's
// occupancy (asked once a kernel, into *per_sm), or fewer where the rows run
// out (a block takes Q2_THREADS / lanes rows a step; see Q2Walk).
template <typename Kernel>
int q2_blocks(Kernel kernel, int* per_sm, int64_t rows, int cp, int sms) {
  if (*per_sm == 0 &&
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, Q2_THREADS, 0) != cudaSuccess)
    *per_sm = 0;
  const int64_t full = static_cast<int64_t>(sms) * (*per_sm > 0 ? *per_sm : 1);
  const int step_rows = Q2_THREADS / (cp / 16 < Q2_THREADS ? cp / 16 : Q2_THREADS);
  const int64_t want = (rows + step_rows - 1) / step_rows;
  return static_cast<int>(want < full ? want : full);
}

// Q2's launches on y (rows, c): the quantize pass, after the amax pass in
// the dynamic mode; CK as the kernels'.
template <typename In, int CK>
int launch_quantize_ck(const In* y, const float* inv_f, const float* s_in, unsigned* amax,
                       float* s_out, int8_t* q, int64_t rows, int c, int cp, int mode, int sms,
                       cudaStream_t st) {
  const int vec = (c % 16 == 0 && aligned(y, 16)) ? 1 : 0;
  static int per_sm[3] = {};  // the static, amax and dynamic kernels' blocks an SM
  if (mode == kQ2Static) {
    const int blocks = q2_blocks(quantize_s8_kernel<In, false, CK>, &per_sm[0], rows, cp, sms);
    quantize_s8_kernel<In, false, CK><<<blocks, Q2_THREADS, 0, st>>>(y, inv_f, s_in, nullptr,
                                                                     nullptr, q, rows, c, cp, vec);
    return static_cast<int>(cudaGetLastError());
  }
  if (mode == kQ2Dynamic) {
    const int blocks = q2_blocks(quantize_amax_kernel<In, CK>, &per_sm[1], rows, cp, sms);
    quantize_amax_kernel<In, CK><<<blocks, Q2_THREADS, 0, st>>>(y, inv_f, amax, rows, c, cp, vec);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = q2_blocks(quantize_s8_kernel<In, true, CK>, &per_sm[2], rows, cp, sms);
  quantize_s8_kernel<In, true, CK><<<blocks, Q2_THREADS, 0, st>>>(y, inv_f, nullptr, amax, s_out,
                                                                  q, rows, c, cp, vec);
  return static_cast<int>(cudaGetLastError());
}

// The instance for y's channels: the RGB input's own (C = 3), or the general one.
template <typename In>
int launch_quantize(const In* y, const float* inv_f, const float* s_in, unsigned* amax,
                    float* s_out, int8_t* q, int64_t rows, int c, int cp, int mode, int sms,
                    cudaStream_t st) {
  if (c == 3)
    return launch_quantize_ck<In, 3>(y, inv_f, s_in, amax, s_out, q, rows, c, cp, mode, sms, st);
  return launch_quantize_ck<In, 0>(y, inv_f, s_in, amax, s_out, q, rows, c, cp, mode, sms, st);
}

}  // namespace

extern "C" {

// Launches Q1 on `stream` of CUDA device `device`; returns cudaGetLastError()
// after the launch (0 on success). x (n, t, h, w, cp) int8, cp a multiple of
// 16; wk (co, kt*kh*kw, cp) int8; mul, add (co) f32; s one f32. The output y
// is (n*to*ho*wo, ld): out 0 bf16 or 1 f32 (ld = co), or 2 int8 for the next
// site (ld = cp_next, a multiple of 16, q_inv_f (co) and q_s its scale).
// y2, if not null, also takes the bf16 values (ld co). amax, if not null
// (out 0 only), takes the next site's dynamic amax max |f32(bf16 y) *
// amax_inv_f[c]| over the output by atomicMax on its bits: it holds 0 or
// an earlier partial max of the same site. res_kind 1-3 adds a
// residual before the ReLU: 1 res int8 (ld res_ld) times s_in / inv_f_in
// (res_s, res_inv_f), 2 res f32 (ld co), 3 res bf16 (ld co). Pads are the
// low pads; the output size carries the high ones. The plan (bn, stages,
// staged, blocks, smem_bytes) comes from ops/int8_conv.py::conv_s8_plan; the
// launch refuses one it was not built for or that does not fit. The device
// is set explicitly: this library carries its own CUDA runtime, whose
// current device is not the caller's.
int fvt_conv3d_s8(const void* x, const void* wk, const void* mul, const void* add,
                  const void* s, void* y, void* y2, const void* res, const void* res_inv_f,
                  const void* res_s, const void* q_inv_f, const void* q_s, void* amax,
                  const void* amax_inv_f, long long n, int t, int h, int w, int cp, int to,
                  int ho, int wo, int kt, int kh, int kw, int st, int sh, int sw, int pt, int ph,
                  int pw, int co, int relu, int out, int ld, int res_kind, int res_ld, int bn,
                  int stages, int staged, int blocks, int smem_bytes, int device, void* stream) {
  const int es = out == kOutF32 ? 4 : (out == kOutBf16 ? 2 : 1);
  const int64_t m = static_cast<int64_t>(n) * to * ho * wo;
  if (n <= 0 || t <= 0 || h <= 0 || w <= 0 || to <= 0 || ho <= 0 || wo <= 0 || kt <= 0 ||
      kh <= 0 || kw <= 0 || st <= 0 || sh <= 0 || sw <= 0 || pt < 0 || ph < 0 || pw < 0 ||
      co <= 0 || cp <= 0 || (cp % 16) != 0 || device < 0 || device >= kMaxDevices ||
      out < kOutBf16 || out > kOutS8 || res_kind < kResNone || res_kind > kResBf16 ||
      (out == kOutS8 ? (ld < co || ld % 16 != 0 || q_inv_f == nullptr || q_s == nullptr)
                     : ld != co) ||
      (res_kind != kResNone && (res == nullptr || res_ld < co)) ||
      (res_kind == kResDequant && (res_inv_f == nullptr || res_s == nullptr)) ||
      (amax != nullptr && (out != kOutBf16 || amax_inv_f == nullptr || !aligned(amax, 4) ||
                           !aligned(amax_inv_f, 4))) ||
      stages < MIN_STAGES || stages > MAX_STAGES || blocks <= 0 ||
      smem_bytes != conv_smem(bn, stages, es, staged) || smem_bytes > SMEM_LIMIT ||
      m > 0x7fffffffLL || (staged && ((static_cast<int64_t>(ld) * es) % 16 != 0 ||
                                      !aligned(y, 16))) ||
      !aligned(x, 16) || !aligned(wk, 16) || !aligned(y, es) || !aligned(mul, 4) ||
      !aligned(add, 4) || !aligned(s, 4))
    return static_cast<int>(cudaErrorInvalidValue);
  if (tensor_map_encoder() == nullptr) return static_cast<int>(cudaErrorNotSupported);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int K = kt * kh * kw * cp;
  CUtensorMap wmap, ymap = {};
  if (!map_2d(&wmap, wk, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, co, K, BK, bn,
              CU_TENSOR_MAP_SWIZZLE_128B))
    return static_cast<int>(cudaErrorInvalidValue);
  if (staged) {
    const CUtensorMapDataType type = out == kOutF32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                     : out == kOutBf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                                       : CU_TENSOR_MAP_DATA_TYPE_UINT8;
    const int box = out == kOutF32 ? out_box<kOutF32>() : out_box<kOutS8>();
    if (!map_2d(&ymap, y, type, es, m, ld, box / es, 64,
                box == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_NONE))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_tiles = (co + bn - 1) / bn;
  const int64_t tiles = (m + BM - 1) / BM * n_tiles;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  ConvArgs args{static_cast<const int8_t*>(x), static_cast<const float*>(mul),
                static_cast<const float*>(add), static_cast<const float*>(s), y,
                static_cast<__nv_bfloat16*>(y2), res, static_cast<const float*>(res_inv_f),
                static_cast<const float*>(res_s), static_cast<const float*>(q_inv_f),
                static_cast<const float*>(q_s), static_cast<unsigned*>(amax),
                static_cast<const float*>(amax_inv_f), m, t, h, w, to, ho, wo, kt, kh, kw, st,
                sh, sw, pt, ph, pw, cp, co, K, n_tiles, static_cast<int>(tiles), relu, ld,
                res_kind, res_ld, stages, staged};
  const int grid = static_cast<int>(tiles < blocks ? tiles : blocks);
  cudaStream_t s_ = reinterpret_cast<cudaStream_t>(stream);
  return launch_by_bn(bn, out, wmap, ymap, args, grid, smem_bytes, device, s_);
}

// Launches Q2: y (rows, c) bf16 (or f32 with in_f32) -> q (rows, cp) int8,
// cp a multiple of 16 and at least c, channels c..cp-1 zero. mode 0
// (static): s_in is the scale. mode 1 (dynamic): the amax pass reduces max
// |f32(y) * inv_f| into amax (one unsigned that holds 0: the caller zeroes
// it), then the quantize pass writes its scale to s_out. mode 2 (dynamic,
// the amax given, e.g. by a Q1 epilogue): the quantize pass alone, which
// writes its scale to s_out. Returns cudaGetLastError() after the launches.
int fvt_quantize_s8(const void* y, int in_f32, const void* inv_f, const void* s_in, void* amax,
                    void* s_out, void* q, long long rows, int c, int cp, int mode, int device,
                    void* stream) {
  if (rows <= 0 || c <= 0 || cp < c || (cp % 16) != 0 || cp >= c + 16 || device < 0 ||
      device >= kMaxDevices || mode < kQ2Static || mode > kQ2Given || !aligned(q, 16) ||
      !aligned(inv_f, 4) || (mode == kQ2Static && (s_in == nullptr || !aligned(s_in, 4))) ||
      (mode != kQ2Static && (amax == nullptr || s_out == nullptr || !aligned(amax, 4) ||
                             !aligned(s_out, 4))))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  static int sms[kMaxDevices] = {};
  if (sms[device] == 0) {
    err = cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const float* f = static_cast<const float*>(inv_f);
  const float* si = static_cast<const float*>(s_in);
  unsigned* am = static_cast<unsigned*>(amax);
  float* so = static_cast<float*>(s_out);
  int8_t* qq = static_cast<int8_t*>(q);
  if (in_f32)
    return launch_quantize(static_cast<const float*>(y), f, si, am, so, qq, rows, c, cp, mode,
                           sms[device], st);
  return launch_quantize(static_cast<const __nv_bfloat16*>(y), f, si, am, so, qq, rows, c, cp,
                         mode, sms[device], st);
}

}  // extern "C"
