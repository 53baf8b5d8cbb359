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
//       y[o, co]   = relu?( fma(f32(acc), mul[co] * s, add[co]) )     (bf16 or f32)
//     q (N, T, H, W, cp) int8, channels zero-padded to cp, a multiple of 16;
//     W (Co, kt*kh*kw, cp) int8 K-major (laid out once per qpack); a general
//     3-D tap set with per-dimension strides and low pads (the high pads are
//     implied by the output size: symmetric k//2 or TF-SAME). s is read from
//     device memory (a static scale, or the one Q2's dynamic pass wrote), so
//     no scale crosses to the host. The epilogue is the JAX engine's
//     acc * (mul * s) + add with the multiply-add fused, one rounding
//     (__fmaf_rn), as XLA contracts it; the plain version's addcmul too.
//   quantize_s8_kernel (Q2) and its dynamic amax pass quantize_amax_kernel:
//       static:  q = clamp(rint(f32(y) * (inv_f[c] / s)), -127, 127)
//       dynamic: xs = f32(y) * inv_f[c]; s = max(amax|xs|, 1e-12) * f32(1/127);
//                q = clamp(rint(xs / s), -127, 127)
//     (the JAX source divides by 127; XLA multiplies by the f32 reciprocal,
//     which rounds differently in some cases, and the port does as XLA)
//     y (rows, C) bf16 or f32 -> q (rows, cp) int8, channels C..cp-1 zero (the
//     padding Q1 takes). The two orders round differently and are kept
//     apart. rintf rounds half to even, as torch.round and jnp.round do.
//     The amax is an on-device reduction (atomicMax on the bits of a
//     non-negative float), Q2's first launch in the dynamic mode.
//
// Q1's design is K1's implicit GEMM (csrc/spatial_conv.cu) at 8 bits: one
// block of 256 threads (two warpgroups) owns BM = 128 output rows and BN
// output channels, BN in {64, 128, 144} (each a valid N of wgmma's .s8
// shapes, m64nNk32); the contraction kappa = tap*cp + c runs in slices of
// BK = 128 int8 (128 bytes a row, the same 128-byte swizzle and shared-memory
// descriptors as K1), loaded by 16-byte cp.async into a ring of 3 slices,
// zero-filled (src-size 0) outside the input, past M, past Co and past the
// contraction. wgmma .s8 takes A and B K-major only, which is how both are
// laid out; a k32 step is 32 bytes, as K1's k16 bf16 step. A 16-byte chunk
// is 16 channels, which is why cp is a multiple of 16: a chunk then lies in
// one tap and works out its own source row. The accumulators are int32 in
// registers (BN / 2 a thread); the epilogue stores from registers, masked at
// the M and Co edges. A simple kernel first: no split of the contraction, no
// TMA, no staging of the output.
//
// What bounds them on an H100 SXM (1,979 TOPS int8, 3.35 TB/s): Q1 at
// r2plus1d_18's int8 sites, stages 1-3, is bound by bytes at its narrow
// sites (the stem's 16-padded C = 3, the 1x1x1 downsamples) and by
// operations at the rest; Q2 by bytes everywhere (a read of y, a write of
// int8).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;                // output rows per block
constexpr int BK = 128;                // contraction slice: 128 int8 = 128 bytes a row
constexpr int THREADS = 256;           // 8 warps, two warpgroups
constexpr int STAGES = 3;              // slices in the cp.async ring
constexpr int A_STAGE = BM * BK;       // bytes of one A slice
constexpr int ALIGN = 1024;            // the 128-byte swizzle repeats every 8 rows
constexpr int kOutside = -(1 << 28);   // frame coordinate of a row past M

template <int BN>
struct Tile {
  static constexpr int B_STAGE = BN * BK;
  static constexpr int STAGE = A_STAGE + B_STAGE;  // a multiple of ALIGN (BN % 8 == 0)
  static constexpr int SMEM = STAGES * STAGE + ALIGN;
  static_assert(BN % 16 == 0 && STAGE % ALIGN == 0, "BN must be a multiple of 16");
};

// One launch of Q1 (see the top of the file).
struct ConvArgs {
  const int8_t* x;     // (N, T, H, W, cp)
  const int8_t* wk;    // (Co, taps, cp)
  const float* mul;    // (Co)
  const float* add;    // (Co)
  const float* s;      // scalar
  void* y;             // (M, Co) bf16 or f32
  int64_t M;           // N * To * Ho * Wo output rows
  int T, H, W;         // input frames, rows, columns
  int To, Ho, Wo;      // output geometry
  int kt, kh, kw;      // taps
  int st, sh, sw;      // strides
  int pt, ph, pw;      // low pads
  int cp, co, n_tiles, relu, out_f32;
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

// Block b computes column tile b % n_tiles of row tile b / n_tiles: the
// column tiles of one row tile run side by side and share its A rows in L2.
template <int BN>
__global__ void __launch_bounds__(THREADS, 2) conv3d_s8_hopper_kernel(const ConvArgs args) {
  using Tl = Tile<BN>;
  const int8_t* __restrict__ x = args.x;
  const int8_t* __restrict__ wk = args.wk;
  const int64_t M = args.M;
  const int T = args.T, H = args.H, W = args.W, C = args.cp, Co = args.co;
  const int kh = args.kh, kw = args.kw;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + ALIGN - 1) & ~static_cast<uint32_t>(ALIGN - 1);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x / args.n_tiles) * BM;
  const int n0 = (blockIdx.x % args.n_tiles) * BN;
  const int taps = args.kt * kh * kw;
  const int K = taps * C;
  const int KT = (K + BK - 1) / BK;

  // Loader: thread tid moves chunk j = tid % 8 (16 channels) of rows tid / 8
  // + 32 q, in A (4 rows) and in the weight slice (BN / 32 rows, rounded
  // up). A row's first tap reads frame (ti0, hi0, wi0) of clip n (frame
  // base rb = n * T); a row past M gets coordinates no tap brings inside.
  const int j = tid & 7;
  const int r0 = tid >> 3;
  int ti0[4], hi0[4], wi0[4];
  int64_t rb[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int64_t m = m0 + r0 + 32 * q;
    if (m < M) {
      const int wo = static_cast<int>(m % args.Wo);
      int64_t rest = m / args.Wo;
      const int ho = static_cast<int>(rest % args.Ho);
      rest /= args.Ho;
      const int to = static_cast<int>(rest % args.To);
      rb[q] = (rest / args.To) * T;
      ti0[q] = to * args.st - args.pt;
      hi0[q] = ho * args.sh - args.ph;
      wi0[q] = wo * args.sw - args.pw;
    } else {
      rb[q] = 0;
      ti0[q] = hi0[q] = wi0[q] = kOutside;
    }
  }
  const int8_t* wrow = wk + static_cast<int64_t>(n0 + r0) * K;

  // The loads walk kappa in order, one slice a call: this thread's chunk
  // starts at kappa = j * 16 and moves on by BK, its (tap, c) and the tap's
  // (dt, dh, dw) carried along instead of divided out again.
  int ld_tap = (j * 16) / C;
  int ld_c = j * 16 - ld_tap * C;
  int ld_dt = ld_tap / (kh * kw);
  int ld_dh = (ld_tap / kw) % kh;
  int ld_dw = ld_tap % kw;
  auto load = [&](int s) {
    const bool kin = ld_tap < taps;
    const uint32_t sa = base + s * Tl::STAGE;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int ti = ti0[q] + ld_dt, hi = hi0[q] + ld_dh, wi = wi0[q] + ld_dw;
      const bool ok = kin && static_cast<unsigned>(ti) < static_cast<unsigned>(T) &&
                      static_cast<unsigned>(hi) < static_cast<unsigned>(H) &&
                      static_cast<unsigned>(wi) < static_cast<unsigned>(W);
      const int8_t* src =
          ok ? x + (((rb[q] + ti) * H + hi) * static_cast<int64_t>(W) + wi) * C + ld_c : x;
      cp_async16(sa + swz(r0 + 32 * q, j), src, ok);
    }
    const int wcol = ld_tap * C + ld_c;
    const uint32_t sb = sa + A_STAGE;
#pragma unroll
    for (int q = 0; q < (BN + 31) / 32; ++q) {
      const int n = r0 + 32 * q;
      if (n < BN) {
        const bool ok = kin && n0 + n < Co;
        const int8_t* src = ok ? wrow + static_cast<int64_t>(32 * q) * K + wcol : wk;
        cp_async16(sb + swz(n, j), src, ok);
      }
    }
    for (ld_c += BK; ld_c >= C; ld_c -= C) {
      ++ld_tap;
      if (++ld_dw == kw) {
        ld_dw = 0;
        if (++ld_dh == kh) {
          ld_dh = 0;
          ++ld_dt;
        }
      }
    }
  };

  // Product: warpgroup wg owns rows 64 wg .. +63 and all BN columns.
  const int wg = warp >> 2;
  int32_t acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;

  auto compute = [&](int s) {
    const uint32_t sa = base + s * Tl::STAGE + wg * 64 * 128;
    const uint32_t sb = base + s * Tl::STAGE + A_STAGE;
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks)
      wgmma_tile<BN>(acc, smem_desc(sa + ks * 32), smem_desc(sb + ks * 32));
    wgmma_commit();
    fence_acc(acc);
  };

  // The ring, as K1's: STAGES-1 slices of loads in flight; slice kt's
  // products, then the load of slice kt + STAGES-1 into the stage slice kt-1
  // used, then the wait for the products. An empty commit keeps the
  // cp.async group count steady at the tail.
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();
    fence_proxy_async();
    __syncthreads();
    compute(kt % STAGES);
    const int nk = kt + STAGES - 1;
    if (nk < KT) load(nk % STAGES);
    cp_async_commit();
    wgmma_wait<0>();
    fence_acc(acc);
  }
  cp_async_wait<0>();

  // Epilogue. Warp w of the warpgroup holds rows 16 (w % 4) .. +15 of the
  // group's 64: n8 block jn in acc[4 jn .. 4 jn + 3], rows lane/4 and
  // lane/4 + 8, columns (lane % 4) * 2 and + 1.
  const float s = *args.s;
  const int row = wg * 64 + (warp & 3) * 16 + (lane >> 2);
  const bool pairs = (Co & 1) == 0;
#pragma unroll
  for (int jn = 0; jn < BN / 8; ++jn) {
    const int col = n0 + jn * 8 + (lane & 3) * 2;
    if (col >= Co) continue;
    const bool two = col + 1 < Co;
    const float ms0 = __fmul_rn(args.mul[col], s), ad0 = args.add[col];
    const float ms1 = two ? __fmul_rn(args.mul[col + 1], s) : 0.0f;
    const float ad1 = two ? args.add[col + 1] : 0.0f;
#pragma unroll
    for (int h8 = 0; h8 < 2; ++h8) {
      const int64_t m = m0 + row + 8 * h8;
      if (m >= M) continue;
      float v0 = __fmaf_rn(__int2float_rn(acc[4 * jn + 2 * h8]), ms0, ad0);
      float v1 = __fmaf_rn(__int2float_rn(acc[4 * jn + 2 * h8 + 1]), ms1, ad1);
      if (args.relu) {
        v0 = fmaxf(v0, 0.0f);
        v1 = fmaxf(v1, 0.0f);
      }
      const int64_t at = m * Co + col;
      if (args.out_f32) {
        float* y = static_cast<float*>(args.y);
        if (pairs) {
          *reinterpret_cast<float2*>(y + at) = make_float2(v0, v1);
        } else {
          y[at] = v0;
          if (two) y[at + 1] = v1;
        }
      } else {
        __nv_bfloat16* y = static_cast<__nv_bfloat16*>(args.y);
        if (pairs) {
          *reinterpret_cast<__nv_bfloat162*>(y + at) = __floats2bfloat162_rn(v0, v1);
        } else {
          y[at] = __float2bfloat16_rn(v0);
          if (two) y[at + 1] = __float2bfloat16_rn(v1);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Q2: the quantize pass
// ---------------------------------------------------------------------------

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

// Thread i of the grid (striding) quantizes 16-channel chunk i of q: row i /
// (cp / 16), one 16-byte store. DYN takes s from the amax pass.
template <typename In, bool DYN>
__global__ void __launch_bounds__(THREADS)
quantize_s8_kernel(const In* __restrict__ y, const float* __restrict__ inv_f,
                   const float* __restrict__ s_in, const unsigned* __restrict__ amax,
                   float* __restrict__ s_out, int8_t* __restrict__ q, int64_t rows, int C, int cp,
                   int vec) {
  // 1.0f / 127.0f is the f32 reciprocal, rounded once at compile time
  const float s = DYN ? __fmul_rn(fmaxf(__uint_as_float(*amax), 1e-12f), 1.0f / 127.0f) : *s_in;
  if (DYN && blockIdx.x == 0 && threadIdx.x == 0) *s_out = s;
  const int per_row = cp / 16;
  const int64_t total = rows * per_row;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * THREADS;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x; i < total;
       i += stride) {
    const int64_t r = i / per_row;
    const int c0 = static_cast<int>(i - r * per_row) * 16;
    float v[16];
    load_chunk(y, r, c0, C, vec != 0, v);
    uint32_t packed[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      const int c = c0 + u;
      int qv = 0;
      if (c < C) {
        float t = DYN ? __fdiv_rn(__fmul_rn(v[u], inv_f[c]), s)
                      : __fmul_rn(v[u], __fdiv_rn(inv_f[c], s));
        t = fminf(fmaxf(rintf(t), -127.0f), 127.0f);
        qv = static_cast<int>(t);
      }
      packed[u >> 2] |= static_cast<uint32_t>(qv & 0xFF) << (8 * (u & 3));
    }
    reinterpret_cast<uint4*>(q)[i] = make_uint4(packed[0], packed[1], packed[2], packed[3]);
  }
}

// max |f32(y) * inv_f[c]| over y (rows, C) into *amax (the bits of a
// non-negative float order as unsigned integers), one atomic a block.
template <typename In>
__global__ void __launch_bounds__(THREADS)
quantize_amax_kernel(const In* __restrict__ y, const float* __restrict__ inv_f,
                     unsigned* __restrict__ amax, int64_t rows, int C, int vec) {
  const int per_row = (C + 15) / 16;
  const int64_t total = rows * per_row;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * THREADS;
  float m = 0.0f;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x; i < total;
       i += stride) {
    const int64_t r = i / per_row;
    const int c0 = static_cast<int>(i - r * per_row) * 16;
    float v[16];
    load_chunk(y, r, c0, C, vec != 0, v);
#pragma unroll
    for (int u = 0; u < 16; ++u)
      if (c0 + u < C) m = fmaxf(m, fabsf(__fmul_rn(v[u], inv_f[c0 + u])));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xFFFFFFFFu, m, off));
  __shared__ float part[THREADS / 32];
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    float b = part[0];
#pragma unroll
    for (int w = 1; w < THREADS / 32; ++w) b = fmaxf(b, part[w]);
    atomicMax(amax, __float_as_uint(b));
  }
}

constexpr int kMaxDevices = 64;

bool aligned(const void* p, uintptr_t n) { return (reinterpret_cast<uintptr_t>(p) & (n - 1)) == 0; }

// Opts the instance in to its shared memory once per device and size (a
// host call, not free), then launches it.
template <int BN>
int launch_conv(const ConvArgs& args, int smem_bytes, int device, cudaStream_t s) {
  if (smem_bytes < Tile<BN>::SMEM) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (args.M + BM - 1) / BM * args.n_tiles;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  static int opted_in[kMaxDevices] = {};
  if (opted_in[device] < smem_bytes) {
    cudaError_t err = cudaFuncSetAttribute(conv3d_s8_hopper_kernel<BN>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in[device] = smem_bytes;
  }
  conv3d_s8_hopper_kernel<BN><<<static_cast<unsigned>(blocks), THREADS, smem_bytes, s>>>(args);
  return static_cast<int>(cudaGetLastError());
}

template <typename In>
int launch_quantize(const In* y, const float* inv_f, const float* s_in, unsigned* amax,
                    float* s_out, int8_t* q, int64_t rows, int c, int cp, cudaStream_t st) {
  const int vec = (c % 16 == 0 && aligned(y, 16)) ? 1 : 0;
  const int64_t chunks = rows * (cp / 16);
  const int64_t want = (chunks + THREADS - 1) / THREADS;
  const int blocks = static_cast<int>(want < 132 * 16 ? (want > 0 ? want : 1) : 132 * 16);
  if (amax == nullptr) {
    quantize_s8_kernel<In, false><<<blocks, THREADS, 0, st>>>(y, inv_f, s_in, nullptr, nullptr,
                                                              q, rows, c, cp, vec);
    return static_cast<int>(cudaGetLastError());
  }
  cudaError_t err = cudaMemsetAsync(amax, 0, sizeof(unsigned), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  quantize_amax_kernel<In><<<blocks, THREADS, 0, st>>>(y, inv_f, amax, rows, c, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  quantize_s8_kernel<In, true><<<blocks, THREADS, 0, st>>>(y, inv_f, nullptr, amax, s_out, q,
                                                           rows, c, cp, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches Q1 on `stream` of CUDA device `device`; returns cudaGetLastError()
// after the launch (0 on success). x (n, t, h, w, cp) int8, cp a multiple of
// 16; wk (co, kt*kh*kw, cp) int8; mul, add (co) f32; s one f32; y (n, to, ho,
// wo, co) bf16, or f32 with out_f32. Pads are the low pads; the output size
// carries the high ones. The plan (bn, smem_bytes) comes from
// ops/int8_conv.py::conv_s8_plan; the launch refuses one it was not built
// for or that does not fit. The device is set explicitly: this library
// carries its own CUDA runtime, whose current device is not the caller's.
int fvt_conv3d_s8(const void* x, const void* wk, const void* mul, const void* add,
                  const void* s, void* y, long long n, int t, int h, int w, int cp, int to,
                  int ho, int wo, int kt, int kh, int kw, int st, int sh, int sw, int pt, int ph,
                  int pw, int co, int relu, int out_f32, int bn, int smem_bytes, int device,
                  void* stream) {
  if (n <= 0 || t <= 0 || h <= 0 || w <= 0 || to <= 0 || ho <= 0 || wo <= 0 || kt <= 0 ||
      kh <= 0 || kw <= 0 || st <= 0 || sh <= 0 || sw <= 0 || pt < 0 || ph < 0 || pw < 0 ||
      co <= 0 || cp <= 0 || (cp % 16) != 0 || device < 0 || device >= kMaxDevices ||
      !aligned(x, 16) || !aligned(wk, 16) || !aligned(y, out_f32 ? 8 : 4) || !aligned(mul, 4) ||
      !aligned(add, 4) || !aligned(s, 4))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  ConvArgs args{static_cast<const int8_t*>(x), static_cast<const int8_t*>(wk),
                static_cast<const float*>(mul), static_cast<const float*>(add),
                static_cast<const float*>(s), y, static_cast<int64_t>(n) * to * ho * wo,
                t, h, w, to, ho, wo, kt, kh, kw, st, sh, sw, pt, ph, pw, cp, co,
                (co + bn - 1) / bn, relu, out_f32};
  cudaStream_t s_ = reinterpret_cast<cudaStream_t>(stream);
  switch (bn) {
    case 64: return launch_conv<64>(args, smem_bytes, device, s_);
    case 128: return launch_conv<128>(args, smem_bytes, device, s_);
    case 144: return launch_conv<144>(args, smem_bytes, device, s_);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Launches Q2: y (rows, c) bf16 (or f32 with in_f32) -> q (rows, cp) int8,
// cp a multiple of 16 and at least c, channels c..cp-1 zero. Static with
// amax == null: s_in is the scale. Dynamic otherwise: amax (one unsigned,
// scratch) is zeroed, the amax pass runs, and the quantize pass writes its
// scale to s_out. Returns cudaGetLastError() after the launches.
int fvt_quantize_s8(const void* y, int in_f32, const void* inv_f, const void* s_in, void* amax,
                    void* s_out, void* q, long long rows, int c, int cp, int device,
                    void* stream) {
  if (rows <= 0 || c <= 0 || cp < c || (cp % 16) != 0 || cp >= c + 16 || device < 0 ||
      device >= kMaxDevices || !aligned(q, 16) || !aligned(inv_f, 4) ||
      (amax == nullptr && (s_in == nullptr || !aligned(s_in, 4))) ||
      (amax != nullptr && (s_out == nullptr || !aligned(amax, 4) || !aligned(s_out, 4))))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const float* f = static_cast<const float*>(inv_f);
  const float* si = static_cast<const float*>(s_in);
  unsigned* am = static_cast<unsigned*>(amax);
  float* so = static_cast<float*>(s_out);
  int8_t* qq = static_cast<int8_t*>(q);
  if (in_f32)
    return launch_quantize(static_cast<const float*>(y), f, si, am, so, qq, rows, c, cp, st);
  return launch_quantize(static_cast<const __nv_bfloat16*>(y), f, si, am, so, qq, rows, c, cp,
                         st);
}

}  // extern "C"
