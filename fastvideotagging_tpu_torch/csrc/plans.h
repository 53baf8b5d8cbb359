// The launch plans of K1 / K2 (csrc/spatial_conv.cu) and Q1 (csrc/int8_conv.cu),
// and the sizes Q2's launch (csrc/int8_conv.cu::fvt_quantize_s8) is given, in
// plain C++: no CUDA, no torch. fvt_ops.cpp plans each launch of the native
// runner with these; the eager paths plan with their Python counterparts, which
// stay the reference: ops/conv2plus1d.py::_taps_plan / spatial_plan /
// temporal_plan, ops/int8_conv.py::conv_s8_plan / padded_channels. A CPU test
// (tests/test_torch_port_native.py) builds this header behind extern "C" shims
// and holds every plan equal to the Python one at each K1 / K2 / Q1 / Q2 call of
// an r2plus1d_18 forward, so that the two routes launch the same tiles.
#pragma once

#include <cstdint>

namespace fvt {

constexpr int kSmemLimit = 232448;  // bytes of shared memory one H100 block may use
constexpr int kSmemPerSm = 233472;  // bytes of shared memory of one SM for blocks
constexpr int kBns[3] = {144, 128, 64};  // column tiles K1 / K2 / Q1 are built for

// K1 / K2 (ops/conv2plus1d.py: _K1_BM, _K1_BK, _K1_STAGES, _K1_ALIGN,
// _K1_MIN_SPLIT_SLICES)
constexpr int kTapsBm = 128;
constexpr int kTapsBk = 64;
constexpr int kTapsStages = 3;
constexpr int kTapsAlign = 1024;
constexpr int kTapsMinSplitSlices = 8;

// Q1 (ops/int8_conv.py: _Q1_BM, _Q1_BK, _Q1_CONSUMERS, _Q1_MAX_STAGES,
// _Q1_MIN_STAGES, _Q1_ALIGN, _Q1_ROWS_TABLE, _Q1_OUT_BOX, _Q1_FIXED)
constexpr int kQ1Bm = 128;
constexpr int kQ1Bk = 128;
constexpr int kQ1Consumers = 2;
constexpr int kQ1MaxStages = 6;
constexpr int kQ1MinStages = 4;
constexpr int kQ1Align = 1024;
constexpr int kQ1RowsTable = kQ1Bm * 16;
constexpr int kQ1OutBox = 16;
constexpr int kQ1Fixed = 64;

// Q2 (ops/int8_conv.py: CHANNEL_ALIGN)
constexpr int kChannelAlign = 16;

inline int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }
inline int ceil8(int n) { return (n + 7) / 8 * 8; }
inline int padded_channels(int c) { return static_cast<int>(ceil_div(c, kChannelAlign)) * kChannelAlign; }

// The column tile: the narrowest tile that covers co, else the widest that
// divides it, else the least wasteful (ties to the wider).
inline int column_tile(int co) {
  int bn = 0;
  for (int b : kBns)
    if (b >= co) bn = b;
  if (bn) return bn;
  for (int b : kBns)
    if (co % b == 0) return b;
  int64_t best_waste = -1;
  for (int b : kBns) {
    const int64_t waste = ceil_div(co, b) * b - co;
    if (best_waste < 0 || waste < best_waste) best_waste = waste, bn = b;
  }
  return bn;
}

struct TapsPlan {
  int bn;          // output channels per block
  int stages;      // slices in the ring
  int smem_bytes;  // dynamic shared memory of one block
  int64_t row_tiles;
  int col_tiles;
  int splits;  // kappa chunks (1: none)
  int cp;      // contraction width of a tap
};

inline TapsPlan taps_plan(int64_t rows, int cp, int co, int taps, int sms) {
  TapsPlan p{};
  p.bn = column_tile(co);
  p.stages = kTapsStages;
  p.row_tiles = ceil_div(rows, kTapsBm);
  p.col_tiles = static_cast<int>(ceil_div(co, p.bn));
  const int64_t slices = ceil_div(static_cast<int64_t>(taps) * cp, kTapsBk);
  const int64_t tiles = p.row_tiles * p.col_tiles;
  int64_t splits = ceil_div(sms, tiles);
  if (slices / kTapsMinSplitSlices < splits) splits = slices / kTapsMinSplitSlices;
  p.splits = static_cast<int>(splits < 1 ? 1 : splits);
  p.smem_bytes = kTapsStages * (kTapsBm + p.bn) * kTapsBk * 2 + kTapsAlign;
  p.cp = cp;
  return p;
}

// K1: x (n, h, w, c) -> co channels, k*k taps.
inline TapsPlan spatial_plan(int64_t n, int64_t h, int64_t w, int c, int co, int k, int sms) {
  return taps_plan(n * h * w, ceil8(c), co, k * k, sms);
}

// K2: x (b, t, s, c) -> co channels, k taps.
inline TapsPlan temporal_plan(int64_t b, int64_t t, int64_t s, int c, int co, int k, int sms) {
  return taps_plan(b * t * s, ceil8(c), co, k, sms);
}

struct ConvS8Plan {
  int bn;
  int stages;
  bool staged;  // the output goes through shared memory and TMA stores
  int smem_bytes;
  int64_t row_tiles;
  int col_tiles;
  int64_t slices;
  int grid;  // blocks launched (persistent: one an SM)
};

inline int q1_smem(int bn, int stages, int out_bytes, bool staged) {
  const int staging = staged ? kQ1Consumers * 64 * bn * out_bytes : 0;
  return kQ1Align + stages * (kQ1Bm + bn) * kQ1Bk + staging + kQ1RowsTable +
         kQ1Consumers * bn * 16 + 16 * stages;
}

// Q1: rows output rows, co output channels, taps taps of cp channels, an
// output of out_bytes an element and row_bytes a row. False where no ring of
// at least kQ1MinStages fits.
inline bool conv_s8_plan(int64_t rows, int co, int taps, int cp, int out_bytes, int64_t row_bytes,
                         int sms, ConvS8Plan* plan) {
  int bn = column_tile(co);
  const int64_t row_tiles = ceil_div(rows, kQ1Bm);
  if (row_tiles < sms) {
    // the narrower tile where it finishes sooner: waves of tiles times a
    // tile's cost (ties to the wider)
    auto makespan = [&](int b) {
      return ceil_div(row_tiles * ceil_div(co, b), sms) * (b + kQ1Fixed);
    };
    int best = bn;
    for (int b : kBns)
      if (b < bn && makespan(b) < makespan(best)) best = b;
    bn = best;
  }
  const bool staged = row_bytes % kQ1OutBox == 0;
  int stages = kQ1MaxStages;
  while (q1_smem(bn, stages, out_bytes, staged) > kSmemLimit) --stages;
  if (stages < kQ1MinStages) return false;
  const int col_tiles = static_cast<int>(ceil_div(co, bn));
  const int64_t tiles = row_tiles * col_tiles;
  *plan = ConvS8Plan{bn, stages, staged, q1_smem(bn, stages, out_bytes, staged), row_tiles,
                     col_tiles, ceil_div(static_cast<int64_t>(taps) * cp, kQ1Bk),
                     static_cast<int>(tiles < sms ? tiles : sms)};
  return true;
}

// Q2: y (..., c) of numel values -> the rows and the padded int8 width its
// launch is given; the kernel sizes its own grid from the card's occupancy.
struct QuantizeSizes {
  int64_t rows;
  int cp;
};

inline QuantizeSizes quantize_sizes(int64_t numel, int c) {
  return QuantizeSizes{numel / c, padded_channels(c)};
}

}  // namespace fvt
