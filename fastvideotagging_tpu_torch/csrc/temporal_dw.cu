// K3: the weight gradient of the temporal k x 1 x 1 conv, on Hopper.
//
//   temporal_dw_hopper_kernel  replaces fastvideotagging_tpu/ops/conv2plus1d.py
//                              _temporal_dw_kernel / _temporal_dw (TPU Pallas):
//       dw[dt,c,co] = sum_{b,t,s} x[b, t+dt-p, s, c] * g[b, t, s, co]
//       over the rows where both exist (p = k/2, stride 1);
//       x (B, T, S, C) bf16, g (B, T, S, Co) bf16 -> dw (k, C, Co) f32.
//
// Schedule: the TPU kernel's order (one (T, tile_s) block walking t), for
// blocks that run side by side. A block owns one output tile of up to
// TAPS = 3 taps, dw[taps][BN input channels][64 output channels], one
// warpgroup per tap, and one chunk of the contraction. The contraction is
// cut into slabs of ROWS (b, s) pairs taken in order over the flattened
// b * S + s (a "column"; no ragged s tile at S = 196 or 49), and a column
// is walked over t = 0..T-1: a "step" is one (column, t), and the steps of
// all columns form one stream that chunks cut at any step. Step i stages
// the g slab g[t] and one new x slab into rings: x[t + hi] joins the x
// ring, which holds x[t + lo .. t + hi] for the block's tap offsets
// lo..hi, so every x and g row is read once per (input tile, output tile),
// with no halo copy. Warpgroup dt then adds dw^T[dt] += g[t]^T x[t+dt-p],
// only where t+dt-p lies in [0, T): no zero rows are multiplied. Taps of
// a k > 3 conv are cut into groups of three over blocks.
//
// Operands: dw^T (64 output channels = wgmma's M, the input tile = N),
// whose both operands are MN-major in shared memory: a slab row holds
// channels contiguously, as x and g hold them in device memory. Loads are
// 16-byte cp.async.cg (src-size 0 writes zeros past the last (b, s) and
// the channels' end) into 64-channel atoms of ROWS rows x 128 bytes in
// the 128-byte swizzle (chunk ^ row % 8), 1024-byte aligned; the
// descriptors give 1024 bytes between 8-row groups along K and one atom
// between atoms along M / N, and a k16 step is 16 rows (+2048 bytes).
// Rows that 16-byte copies cannot read (the stem's C = 45: 90-byte rows;
// a tensor that is not 16-byte aligned) are first copied zero-padded to a
// multiple of 8 channels by temporal_dw_pad_kernel (on the card a 2-byte
// register path into the same layout was slower: every barrier waits for
// a thread's outstanding loads).
// AHEAD steps of loads are in flight (x ring AHEAD + 3 slabs, g ring
// AHEAD + 1). Each step: wait for its loads, one barrier, each active
// warpgroup issues ROWS / 16 wgmma.mma_async m64nBNk16 with both
// transpose bits set, the loads of step i + AHEAD are issued, the
// warpgroup waits for its products.
//
// Split: with few tiles (stage 1 has one), the steps are cut into chunks,
// enough blocks to fill the card; each block writes its f32 tile as a
// partial (staged in the drained ring, 16-byte stores in (k, C, Co)
// order), and temporal_dw_reduce_kernel adds the partials in chunk order:
// no atomics, two launches are bitwise equal. With one chunk the block
// writes dw itself. The plan (tiles, chunks, shared memory) has one
// source, ops/conv2plus1d.py::temporal_dw_plan; ROWS and AHEAD are
// compiled in from it.
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s), at
// r2plus1d_18's sites: bytes at the stem and stages 1-2 (x and g read
// once; stage 1 at 32 clips: 668 MB -> 199 us), operations at stages 3-4
// (18.5 / 7.4 GFLOP over the taps inside [0, T) -> 19 / 7.5 us). The ring
// keeps 3 steps of loads in flight per SM (78 KB at BN = 144); stage 1
// runs near the card's streaming rate. The tile (3 taps x 64 x 144 f32 is
// 72 registers a thread) is what the register file allows, so stages 2-4
// re-read x once per 64 output channels and g once per 144 input channels
// (from L2); there a step takes about as long as its loads and its
// products together. On the card, 2 or 4 steps ahead, slabs of 32 or 128
// rows and products left running into the next step were no faster.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

namespace {

#if !defined(FVT_K3_ROWS) || !defined(FVT_K3_AHEAD)
#error "build through ops/_build.py, which passes ops/conv2plus1d.py's tile plan"
#endif

constexpr int ROWS = FVT_K3_ROWS;      // (b, s) rows of a slab: one step's contraction
constexpr int AHEAD = FVT_K3_AHEAD;    // steps of loads in flight
constexpr int TAPS = 3;                // taps per block, one warpgroup each
constexpr int THREADS = 128 * TAPS;
constexpr int BM = 64;                 // output channels per block: wgmma's M
constexpr int X_SLOTS = AHEAD + TAPS;  // x slabs: one step's taps and the loads ahead
constexpr int G_SLOTS = AHEAD + 1;     // g slabs: one step's and the loads ahead
constexpr int LINE = 128;              // bytes of one slab row of a 64-channel atom
constexpr int ATOM = ROWS * LINE;      // bytes of one 64-channel atom of a slab
constexpr int ALIGN = 1024;            // the 128-byte swizzle repeats every 8 rows
constexpr int ST_LD = BM + 4;          // f32 per row of the epilogue's staging tile
static_assert(ROWS % 16 == 0, "a slab is whole k16 steps");
static_assert(AHEAD >= 1, "loads in flight");

template <int BN>
struct Tile {
  static constexpr int X_SLAB = (BN + 63) / 64 * ATOM;  // bytes of an x slab
  static constexpr int RING = X_SLOTS * X_SLAB + G_SLOTS * ATOM;
  static constexpr int STAGING = TAPS * BN * ST_LD * 4;
  static constexpr int SMEM = (RING > STAGING ? RING : STAGING) + ALIGN;
  static_assert(BN % 16 == 0 && BN <= 256, "wgmma's N");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk j of row r in an atom of 128-byte rows,
// 128-byte swizzled.
__device__ __forceinline__ uint32_t swz(int r, int j) {
  return static_cast<uint32_t>(r * LINE + ((j ^ (r & 7)) << 4));
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

// Shared-memory matrix descriptor of an MN-major operand in the 128-byte
// swizzle: start address >> 4; leading byte offset = one atom (the stride
// between 64-channel atoms along M or N); stride byte offset = 1024 (the
// stride between 8-row groups along K); layout type 1 (128B swizzle).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(ATOM >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

// wgmma.mma_async m64nNk16, bf16 x bf16 -> f32, A and B both MN-major in
// shared memory (both transpose bits set); d += A B.
__device__ __forceinline__ void wgmma_48(float (&d)[24], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23"
      "}, %24, %25, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
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
      "}, %72, %73, p, 1, 1, 1, 1;\n}\n"
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
  if constexpr (BN == 48) wgmma_48(d, da, db);
  else wgmma_144(d, da, db);
}

// One operand's loader: slabs of ROWS rows x CH 16-byte chunks (the
// operand's channels c0 .. c0 + 8 CH), one slab a call, in stream order.
// Thread tid copies entries e = tid + q * THREADS (row e / CH, chunk e % CH)
// by 16-byte cp.async into 64-channel atoms (chunk / 8) at the swizzled
// place of chunk % 8; src-size 0 writes zeros past the last (b, s) and past
// the channels.
template <int CH>
struct Loader {
  static constexpr int E = (ROWS * CH + THREADS - 1) / THREADS;
  const __nv_bfloat16* src;  // (rows, nc) bf16, nc % 8 == 0, 16-byte aligned
  int nc, c0;
  int col, t;    // the slab the stream loads next
  int row0[E];   // per entry: its (b, s) as a row at t = 0 in `col` (-1: none)

  __device__ __forceinline__ void column(int tid, int BS, int T, int S) {
#pragma unroll
    for (int q = 0; q < E; ++q) {
      const int n = col * ROWS + (tid + q * THREADS) / CH;
      const int b = n / S;
      row0[q] = n < BS ? b * T * S + (n - b * S) : -1;
    }
  }

  __device__ __forceinline__ void seek(int j, int tid, int BS, int T, int S) {
    col = j / T;
    t = j - col * T;
    column(tid, BS, T, S);
  }

  __device__ __forceinline__ void load(uint32_t slot, int tid, int BS, int T, int S) {
#pragma unroll
    for (int q = 0; q < E; ++q) {
      const int e = tid + q * THREADS;
      if (E * THREADS == ROWS * CH || e < ROWS * CH) {
        const int r = e / CH, ch = e % CH;
        const int c = c0 + ch * 8;
        const bool ok = row0[q] >= 0 && c < nc;
        const __nv_bfloat16* p =
            src + (static_cast<int64_t>(row0[q]) + static_cast<int64_t>(t) * S) * nc + c;
        cp_async16(slot + (ch >> 3) * ATOM + swz(r, ch & 7), ok ? p : src, ok);
      }
    }
    if (++t == T) {
      t = 0;
      ++col;
      column(tid, BS, T, S);
    }
  }
};

// out (+ chunk * k*C*Co) = this block's tile of dw over its chunk of steps.
// Block b is tile b % tiles of chunk b / tiles: the tiles of one chunk run
// side by side and share its x and g rows in L2. A tile is (tap group tg,
// output tile cot, input tile ct). x (rows, cp) and g (rows, cop) are the
// row-major operands with their channels padded to a multiple of 8; C and
// Co are dw's. BS = B * S; steps = ceil(BS / ROWS) * T, spc steps a chunk.
template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
temporal_dw_hopper_kernel(const __nv_bfloat16* __restrict__ x,
                          const __nv_bfloat16* __restrict__ g, float* __restrict__ out,
                          int BS, int T, int S, int cp, int cop, int C, int Co, int k,
                          int c_tiles, int co_tiles, int steps, int spc) {
  using Tl = Tile<BN>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + ALIGN - 1) & ~static_cast<uint32_t>(ALIGN - 1);
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t xring = base;
  const uint32_t gring = base + X_SLOTS * Tl::X_SLAB;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wg = warp >> 2;
  const int tiles = c_tiles * co_tiles * ((k + TAPS - 1) / TAPS);
  const int tile = blockIdx.x % tiles;
  const int chunk = blockIdx.x / tiles;
  const int c0 = (tile % c_tiles) * BN;
  const int n0 = (tile / c_tiles % co_tiles) * BM;
  const int tg = tile / (c_tiles * co_tiles);
  const int p = k / 2;
  const int lo = tg * TAPS - p;                                   // the group's tap offsets
  const int hi = (tg * TAPS + TAPS < k ? tg * TAPS + TAPS : k) - 1 - p;
  const int i0 = chunk * spc;                                      // this chunk's steps
  const int i1 = i0 + spc < steps ? i0 + spc : steps;

  Loader<BN / 8> xl;
  Loader<8> gl;
  xl.src = x;
  xl.nc = cp;
  xl.c0 = c0;
  gl.src = g;
  gl.nc = cop;
  gl.c0 = n0;
  // The loads of step u: its g slab and x slab u + hi (the first step that
  // reads x slab j is j - hi). One cp.async group a step, empty past the
  // chunk's end.
  auto issue = [&](int u) {
    if (u < i1) {
      gl.load(gring + (u % G_SLOTS) * ATOM, tid, BS, T, S);
      const int j = u + hi;
      if (j >= 0 && j < steps) xl.load(xring + (j % X_SLOTS) * Tl::X_SLAB, tid, BS, T, S);
    }
    cp_async_commit();
  };

  const int jx = i0 + lo > 0 ? i0 + lo : 0;  // the first x slab the chunk reads
  xl.seek(jx, tid, BS, T, S);
  gl.seek(i0, tid, BS, T, S);
  for (int j = jx; j < i0 + hi && j < steps; ++j)  // joins step i0's group
    xl.load(xring + (j % X_SLOTS) * Tl::X_SLAB, tid, BS, T, S);
#pragma unroll
  for (int a = 0; a < AHEAD; ++a) issue(i0 + a);

  const int dt = tg * TAPS + wg;  // this warpgroup's tap
  const int off = dt - p;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;

  int t = i0 % T;
  for (int i = i0; i < i1; ++i) {
    cp_async_wait<AHEAD - 1>();
    fence_proxy_async();
    __syncthreads();  // step i's slabs have landed; step i-1's products are done
    const int tx = t + off;
    if (dt < k && tx >= 0 && tx < T) {  // uniform over the warpgroup
      const uint32_t ga = gring + (i % G_SLOTS) * ATOM;
      const uint32_t xa = xring + ((i + off) % X_SLOTS) * Tl::X_SLAB;
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < ROWS / 16; ++ks)
        wgmma_tile<BN>(acc, smem_desc(ga + ks * 16 * LINE), smem_desc(xa + ks * 16 * LINE));
      wgmma_commit();
      fence_acc(acc);
    }
    issue(i + AHEAD);  // into the slots of slabs no step from i on reads
    wgmma_wait<0>();
    fence_acc(acc);
    if (++t == T) t = 0;
  }
  cp_async_wait<0>();
  __syncthreads();  // every load has landed and every product is done: the ring is free

  // Epilogue. Warp w of the warpgroup holds output channels 16 (w % 4) ..
  // +15 of the 64 (lane / 4 and lane / 4 + 8), input channels n8 block jn
  // in acc[4jn .. 4jn+3] (lane % 4 * 2, +1). Staged as (input channel,
  // output channel) f32, then stored 16 bytes at a time in dw's order.
  float* st = reinterpret_cast<float*>(smem);
  if (dt < k) {
    float* mine = st + wg * (BN * ST_LD);
    const int o = (warp & 3) * 16 + (lane >> 2);
#pragma unroll
    for (int jn = 0; jn < BN / 8; ++jn) {
      const int c = jn * 8 + (lane & 3) * 2;
      mine[c * ST_LD + o] = acc[4 * jn];
      mine[(c + 1) * ST_LD + o] = acc[4 * jn + 1];
      mine[c * ST_LD + o + 8] = acc[4 * jn + 2];
      mine[(c + 1) * ST_LD + o + 8] = acc[4 * jn + 3];
    }
  }
  __syncthreads();
  float* dst = out + static_cast<int64_t>(chunk) * k * C * Co;
  const int taps = k - tg * TAPS < TAPS ? k - tg * TAPS : TAPS;
  constexpr int V = BM / 4;  // float4s of a staged row
  for (int e = tid; e < taps * BN * V; e += THREADS) {
    const int w = e / (BN * V);
    const int c = e / V - w * BN;
    const int v = (e % V) * 4;
    if (c0 + c >= C || n0 + v >= Co) continue;
    const float* s = st + w * (BN * ST_LD) + c * ST_LD + v;
    float* d = dst + (static_cast<int64_t>(tg * TAPS + w) * C + c0 + c) * Co + n0 + v;
    if ((Co & 3) == 0) {
      *reinterpret_cast<float4*>(d) = *reinterpret_cast<const float4*>(s);
    } else {
      for (int q = 0; q < 4 && n0 + v + q < Co; ++q) d[q] = s[q];
    }
  }
}

// out[i] = part[0][i] + part[1][i] + ... in chunk order: the same sums,
// bit for bit, on every launch (no atomics).
__global__ void __launch_bounds__(256)
temporal_dw_reduce_kernel(const float* __restrict__ part, float* __restrict__ out, int64_t n,
                          int chunks) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x;
  if (i >= n) return;
  float a = 0.0f;
#pragma unroll 8
  for (int ch = 0; ch < chunks; ++ch) a += part[static_cast<int64_t>(ch) * n + i];
  out[i] = a;
}

// dst (rows, cp) = src (rows, c) with channels c .. cp-1 zero, cp = c
// rounded up to 8. Thread i writes 16-byte chunk i of dst from up to eight
// 2-byte reads of src (src may have any alignment): neighbouring threads
// read and write neighbouring bytes. WIDE is whether chunk indices need
// 64 bits.
template <bool WIDE>
__global__ void __launch_bounds__(256)
temporal_dw_pad_kernel(const unsigned short* __restrict__ src, uint4* __restrict__ dst,
                       int64_t chunks, int c, int cp) {
  using I = typename std::conditional<WIDE, int64_t, uint32_t>::type;
  const I per_row = static_cast<I>(cp / 8);
  const I stride = static_cast<I>(gridDim.x) * 256;
  for (I i = static_cast<I>(blockIdx.x) * 256 + threadIdx.x; i < static_cast<I>(chunks);
       i += stride) {
    const I r = i / per_row;
    const int j = static_cast<int>(i - r * per_row) * 8;
    const unsigned short* s = src + static_cast<int64_t>(r) * c + j;
    uint32_t w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint32_t a = j + 2 * q < c ? s[2 * q] : 0;
      const uint32_t b = j + 2 * q + 1 < c ? s[2 * q + 1] : 0;
      w[q] = a | (b << 16);
    }
    dst[i] = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

constexpr int kMaxDevices = 64;

// Opts the instance in to its shared memory once per device and size (a
// host call, not free), then launches it.
template <int BN>
cudaError_t start(unsigned blocks, int smem_bytes, int device, cudaStream_t s, const void* x,
                  const void* g, float* out, int bs, int t, int s_len, int cp, int cop, int c,
                  int co, int k, int c_tiles, int co_tiles, int steps, int spc) {
  if (smem_bytes < Tile<BN>::SMEM) return cudaErrorInvalidValue;
  auto kern = temporal_dw_hopper_kernel<BN>;
  static int opted_in[kMaxDevices] = {};
  if (opted_in[device] < smem_bytes) {
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return err;
    opted_in[device] = smem_bytes;
  }
  kern<<<blocks, THREADS, smem_bytes, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(g), out, bs, t,
      s_len, cp, cop, c, co, k, c_tiles, co_tiles, steps, spc);
  return cudaGetLastError();
}

cudaError_t pad(const void* src, void* dst, int64_t rows, int c, int cp, cudaStream_t s) {
  const int64_t chunks = rows * (cp / 8);
  const int64_t want = (chunks + 255) / 256;
  const unsigned blocks = static_cast<unsigned>(want < 16384 ? want : 16384);
  auto in = static_cast<const unsigned short*>(src);
  auto out = static_cast<uint4*>(dst);
  if (chunks + static_cast<int64_t>(blocks) * 256 <= UINT_MAX)
    temporal_dw_pad_kernel<false><<<blocks, 256, 0, s>>>(in, out, chunks, c, cp);
  else
    temporal_dw_pad_kernel<true><<<blocks, 256, 0, s>>>(in, out, chunks, c, cp);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

extern "C" {

// dw (k, C, Co) f32 from x (B, T, S, C) and g (B, T, S, Co), both bf16, on
// `stream` of CUDA device `device`; returns cudaGetLastError() after the
// launches (0 on success). x goes first through the pad kernel into xp
// (rows, C rounded up to 8) when C % 8 != 0 or x is not 16-byte aligned,
// g likewise into gp; either scratch is otherwise unused (may be null). ws
// holds chunks * k*C*Co floats when chunks > 1, else it is unused. The plan
// (bn, rows, ahead, chunks, steps_per_chunk, smem_bytes) comes from
// ops/conv2plus1d.py::temporal_dw_plan; the launch refuses one it was not
// built for or that does not cover the steps. The device is set
// explicitly: this library carries its own CUDA runtime, whose current
// device is not the caller's.
int fvt_temporal_dw_bf16(const void* x, const void* g, void* xp, void* gp, void* dw, void* ws,
                         long long b, int t, int s_len, int c, int co, int k, int bn, int rows,
                         int ahead, int chunks, int steps_per_chunk, int smem_bytes, int device,
                         void* stream) {
  if (b <= 0 || t <= 0 || s_len <= 0 || c <= 0 || co <= 0 || k <= 0 || (k % 2) == 0 ||
      rows != ROWS || ahead != AHEAD || chunks < 1 || steps_per_chunk < 1 || device < 0 ||
      device >= kMaxDevices || smem_bytes > 232448 || !aligned16(dw) ||
      (chunks > 1 && (ws == nullptr || !aligned16(ws))))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t bs = b * s_len;
  const int64_t m = bs * t;  // rows of x and g: 32-bit in the kernel
  const int64_t steps = (bs + ROWS - 1) / ROWS * t;
  const int cp = (c + 7) / 8 * 8, cop = (co + 7) / 8 * 8;
  const bool pad_x = cp != c || !aligned16(x);
  const bool pad_g = cop != co || !aligned16(g);
  if (m + ROWS > INT_MAX || (pad_x && (xp == nullptr || !aligned16(xp))) ||
      (pad_g && (gp == nullptr || !aligned16(gp))) ||
      static_cast<int64_t>(chunks) * steps_per_chunk < steps ||
      static_cast<int64_t>(chunks - 1) * steps_per_chunk >= steps)
    return static_cast<int>(cudaErrorInvalidValue);
  const int c_tiles = (cp + bn - 1) / bn, co_tiles = (cop + BM - 1) / BM;
  const int64_t blocks = static_cast<int64_t>(c_tiles) * co_tiles * ((k + TAPS - 1) / TAPS) * chunks;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (pad_x && (err = pad(x, xp, m, c, cp, st)) != cudaSuccess) return static_cast<int>(err);
  if (pad_g && (err = pad(g, gp, m, co, cop, st)) != cudaSuccess) return static_cast<int>(err);
  const void* xs = pad_x ? xp : x;
  const void* gs = pad_g ? gp : g;
  float* out = static_cast<float*>(chunks > 1 ? ws : dw);
  const unsigned nb = static_cast<unsigned>(blocks);
  const int ib = static_cast<int>(bs), is = static_cast<int>(steps);
  switch (bn) {
    case 48:
      err = start<48>(nb, smem_bytes, device, st, xs, gs, out, ib, t, s_len, cp, cop, c, co, k,
                      c_tiles, co_tiles, is, steps_per_chunk);
      break;
    case 144:
      err = start<144>(nb, smem_bytes, device, st, xs, gs, out, ib, t, s_len, cp, cop, c, co,
                       k, c_tiles, co_tiles, is, steps_per_chunk);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess || chunks == 1) return static_cast<int>(err);
  const int64_t n = static_cast<int64_t>(k) * c * co;
  temporal_dw_reduce_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(ws), static_cast<float*>(dw), n, chunks);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
