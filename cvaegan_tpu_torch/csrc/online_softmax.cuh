// What the online softmax of the block-attention kernels shares between
// `block_attention.cu` (float32 operands, mma.sync) and
// `block_attention_sm90.cu` (bf16 operands, wgmma): the constants, ex2,
// the quad reductions, the fold and the store. Each keeps its own update
// of a key tile (`softmax_tile` and `softmax_tile_ilp`).
//
// Both keep the scores of a key tile in the mma accumulator layout: each
// thread of a quad (g = lane / 4, t = lane % 4) holds, per 8-key step j,
// s[j] = {row g key 2t, row g key 2t + 1, row g + 8 key 2t, row g + 8
// key 2t + 1} (wgmma's m64 accumulator repeats this layout once per warp
// of the warpgroup). A row's values are spread over the 4 lanes of its
// quad, so row reductions are two shuffles.
//
// Numerics are the TPU kernels' (`cvaegan_tpu/kernels/block_attention.py`):
// running max from -1e30, the scale applied after the product, out =
// acc / l. Scores are prescaled by d^-0.5 log2(e) so that ex2.approx gives
// the exponentials; m, and sl below, are then in units of log2. The
// entropy carries sl relative to the running max, sl' = sum p (s - m),
// rescaled by alpha (sl' + (m_old - m_new) l_old), so that H = log l -
// sl' / l with no cancellation on peaked rows (scores ~ 300 at inputs of
// scale 10); the one conversion back to nats is the ln 2 in `store_rows`.
// l and sl are per-thread partial sums (the rescale is uniform along a
// row), reduced over the 4 lanes of a row once at the end; the row max
// reduces over those lanes per tile.

#pragma once

#include <stddef.h>

namespace {

constexpr float kNegInit = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr unsigned kFull = 0xffffffffu;

// 2^x by the special-function unit, as exp2f computes it but with
// results below 2^-126 flushed to 0 (p that small adds nothing to l >= 1).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
}

// acc = alpha acc + pv for column tiles n0 .., by a rounded fmaf: the
// tensor cores add into their float32 accumulator with truncation, whose
// bias would grow with the number of keys, so each tile's P V starts from
// zero and is folded in here.
template <int NC, int DT>
__device__ __forceinline__ void fold(float (&acc)[DT][4], const float (&pv)[NC][4], int n0,
                                     const float (&alpha)[2]) {
#pragma unroll
  for (int n = 0; n < NC; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n0 + n][i] = fmaf(alpha[i / 2], acc[n0 + n][i], pv[n][i]);
}

// Stores rows `row_g` and `row_g` + 8 of out (and their entropy) from the
// running sums, reduced over the 4 lanes of each row.
template <int DT, bool ENT>
__device__ __forceinline__ void store_rows(const float (&acc)[DT][4], const float (&l)[2],
                                           const float (&sl)[2], float* out, float* ent,
                                           size_t base, int head, int row_g, int seq, int t) {
  constexpr int D = 8 * DT;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l_row = quad_sum(l[r]);
    const float sl_row = ENT ? quad_sum(sl[r]) : 0.f;
    const int row = row_g + 8 * r;
    if (row >= seq) continue;
    float* o = out + base + static_cast<size_t>(row) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < DT; ++n)
      *reinterpret_cast<float2*>(o + 8 * n) =
          make_float2(acc[n][2 * r] / l_row, acc[n][2 * r + 1] / l_row);
    // sl_row is in units of log2: ln 2 brings it back to nats.
    if (ENT && t == 0)
      ent[static_cast<size_t>(head) * seq + row] = logf(l_row) - kLn2 * sl_row / l_row;
  }
}

}  // namespace
