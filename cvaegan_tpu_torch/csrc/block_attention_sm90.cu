// Blockwise (flash-style) non-causal self-attention forward on bfloat16
// q, k, v, for Hopper (sm_90a): TMA loads, a producer warpgroup and two
// consumer warpgroups on wgmma.
//
//   out = softmax(q k^T * d^-0.5) v          over [bh, seq, d] bf16 tensors
//   ent = -sum_j p_j log p_j  (per row)      only in the entropy variant
//
// out and ent are float32. Two kernels from one template, replacing the
// Pallas TPU kernels of `cvaegan_tpu/kernels/block_attention.py` as they
// run under the bf16 compute policy (the Pallas bodies are dtype-generic):
//   * ENT = false replaces `_attn_kernel` (:30; `pallas_call` :113);
//   * ENT = true replaces `_attn_ent_kernel` (:56; `pallas_call` :154).
// There S = Q K^T is jnp.dot(q, k.T, preferred_element_type=f32) and P V
// is jnp.dot(p, v, preferred_element_type=f32) with P in float32 and V
// promoted (:38,44,73,81). Head dims 16, 32, 64 and 128; any seq >= 1.
//
// Products. A product of two bf16 values is exact in float32, so S = Q K^T
// is one bf16 wgmma pass with a float32 accumulator. P is float32; one
// bf16 rounding of it (what scaled_dot_product_attention does) misses the
// float32 tolerance (2e-5) by 18-55x. So P is split in registers into hi =
// bf16(P) and lo = bf16(P - hi) (P - hi is exact in float32), and P V =
// lo V + hi V, two bf16 passes, small terms first, with V exact in bf16:
// ~2^-17 relative in P, 0.03-0.09 of the tolerance in a CPU emulation
// (`tests/test_torch_port_bf16_split.py`). Every product is then bf16
// wgmma. The unit adds into its float32 accumulator with truncation, so
// each tile's P V starts from zero and is folded into the running output
// by a rounded fmaf (`fold` in `online_softmax.cuh`), as in the float32
// kernel of `block_attention.cu`, where summing over all keys in the
// accumulator cost 0.59 of the tolerance at seq 8192 against 0.03.
//
// Layout of a block (384 threads, 128 query rows; the grid is bh x
// ceil(seq / 128), one block per SM for registers):
//   * warpgroup 0, the producer, gives up registers (setmaxnreg.dec to 24)
//     and one thread issues every TMA load: the Q tile once, then K and V
//     tiles of kKeys keys into a ring of kStages = 3 stages, each behind a
//     full/empty mbarrier pair;
//   * warpgroups 1 and 2, the consumers (setmaxnreg.inc to 240; ptxas
//     allocates up to that in their code), own 64 query rows each. Per
//     tile: S = Q K^T by wgmma.m64n{kKeys}k16 with both operands K-major
//     in shared memory; the online softmax in registers
//     (`softmax_tile_ilp`; the accumulator layout is mma.sync's, repeated
//     per warp); P split into hi and lo and packed as bf16 pairs, which is
//     the register A operand of the next product as it stands (the S
//     accumulator's 8-key steps 2kk and 2kk + 1 are A's k16 step kk); P V
//     by wgmma.m64n{D}k16 with A from registers and V read MN-major
//     through the descriptor's transpose bit; the release of the stage,
//     and the fold.
//   * The consumers take turns on the tensor cores (FA3's ping-pong, named
//     barriers 1 and 2): in its turn a consumer issues P V of its previous
//     tile and Q K^T of its next, then hands over and runs the softmax
//     while the other's products run.
//
// Data movement. One 3-D tensor map [bh, seq, d] per operand, built on the
// host for each call, so that a ragged tail is zero-filled (never the next
// head's rows: a tile at the end of a head reads nothing of the next).
// Zero-filled keys score 0, not -inf, so the ragged key tail is masked to
// p = 0 explicitly (their V rows are 0 as well); the ragged query tail is
// computed and not stored. Each tile row is one swizzle row: 32-byte
// swizzle at d 16, 64-byte at d 32, 128-byte at d 64, and at d 128 two
// 64-column boxes, each 128-byte swizzled; the wgmma descriptors name the
// same swizzle. kKeys is 128 at d <= 64 and 64 at d 128, where a 128-key
// tile would hold P's hi and lo (64 registers), the tile's P V (64) and
// the output (64) at once.
//
// Bound on an H100 SXM. Per call 2 bh seq^2 d FLOP of Q K^T and twice
// that of P V, all at the 989 TFLOP/s bf16 rate; bh seq^2 ex2 on the
// special-function units (132 SMs x 16 per clock at 1.98 GHz, ~4.18 T/s);
// 6 bh seq d bytes read and 4 bh seq d (+ 4 bh seq) written at 3.35 TB/s.
// At T1 [128, 1024, 64]: 0.0521 ms of tensor work, 0.0321 ms of ex2,
// 0.0252 ms of memory, so the tensor cores bound it; at [128, 1024, 32]
// and [128, 1024, 16] the ex2 (0.0321 ms against 0.0261 and 0.0130).
// Measured, the time is not the tensor cores': at d 16, with a quarter of
// d 64's tensor work, the kernel takes three quarters of d 64's time
// (PERF.md). The work outside them is the softmax side: each consumer
// has one warp on each scheduler, so its ex2, max and sum chains and the
// split run on latency.
// The split costs ~3 instructions per score (two conversions, the
// unpacking of hi, one subtraction) beside the softmax's ~4.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "online_softmax.cuh"

namespace {

constexpr int kRows = 128;          // query rows per block
constexpr int kConsumers = 2;       // warpgroups of 64 query rows
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kStages = 3;

// Shared memory of one block, for head dim D: the Q tile [kRows][D], then
// kStages stages of a K and a V tile [kKeys][D], each stored as D / kCols
// column blocks [rows][kCols] of one swizzle row per tile row (as TMA
// writes them), each tile 1024-byte aligned; then the mbarriers.
template <int D>
struct Sm90 {
  static constexpr int kKeys = D <= 64 ? 128 : 64;
  static constexpr int kCols = D < 64 ? D : 64;  // columns per TMA box
  static constexpr int kPitch = 2 * kCols;       // bytes per tile row: the swizzle width
  // wgmma descriptor layout type: 1 = 128-byte swizzle, 2 = 64, 3 = 32
  static constexpr int kLayout = kPitch == 128 ? 1 : kPitch == 64 ? 2 : 3;
  static constexpr CUtensorMapSwizzle kSwizzle =
      kPitch == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                    : kPitch == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
  static constexpr int kQBytes = kRows * D * 2;
  static constexpr int kTileBytes = kKeys * D * 2;
  static constexpr int kStageBytes = 2 * kTileBytes;  // K then V
  static constexpr int kBarOffset = kQBytes + kStages * kStageBytes;
  // full[kStages], empty[kStages], Q; plus 1024 bytes to align the base
  static constexpr size_t bytes = 1024 + kBarOffset + 8 * (2 * kStages + 1);
  static_assert(kQBytes % 1024 == 0 && kTileBytes % 1024 == 0, "tiles must stay aligned");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------- mbarriers

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Waits until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// Named barrier `id` over `threads` threads: wait (sync) or only count
// this warp's arrival (arrive).
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// A box of a 3-D tensor map at (column, row, head) into shared memory,
// completing its bytes on the barrier's transaction count.
__device__ __forceinline__ void tma_load(uint32_t to, const CUtensorMap* map, uint32_t bar,
                                         int col, int row, int head) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];"
      ::"r"(to), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row), "r"(head)
      : "memory");
}

// -------------------------------------------------------------------- wgmma

// A shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units) and the swizzle layout type.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              int layout) {
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 | static_cast<uint64_t>(sbo >> 4) << 32 |
         static_cast<uint64_t>(layout) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Ties the accumulator registers to the surrounding wgmma fences and
// waits, so that the compiler neither reads them early nor moves their
// writes across.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+f"(d[j][i])::"memory");
}

// d (+)= A B, m64nNk16, bf16 operands, float32 accumulator (d overwritten
// when scale_d is 0). SS: A and B K-major in shared memory. RS: A from
// registers (four bf16 pairs, mma.sync's m16n8k16 A fragment per warp), B
// MN-major in shared memory (transposed).
template <int N>
__device__ void wgmma_ss(float (&d)[N / 8][4], uint64_t a, uint64_t b, int scale_d);
template <int N>
__device__ void wgmma_rs(float (&d)[N / 8][4], const uint32_t (&a)[4], uint64_t b, int scale_d);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[8][4], uint64_t a, uint64_t b,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[16][4], uint64_t a, uint64_t b,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[2][4], const uint32_t (&a)[4],
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[4][4], const uint32_t (&a)[4],
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[8][4], const uint32_t (&a)[4],
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[16][4], const uint32_t (&a)[4],
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// Byte offset of depth step kk (16 columns) in a K-major tile of `rows`
// rows: 32 bytes per step into a tile row, in column block kk / (kCols /
// 16), each column block `rows` rows long.
template <int D>
__device__ __forceinline__ uint32_t depth_offset(int kk, int rows) {
  constexpr int kSteps = Sm90<D>::kCols / 16;
  return (kk / kSteps) * rows * Sm90<D>::kPitch + (kk % kSteps) * 32;
}

// The online-softmax update of one key tile: the arithmetic of the float32
// kernel's `softmax_tile` (`block_attention.cu`), with two changes for a
// consumer warpgroup, whose scheduler holds no other warp of its own to
// hide latency: the scale and the max are applied by
// one fmaf, x = s d^-0.5 log2(e) - m (m is the max of the raw scores times
// the same scale: the product rounds monotonically), and the row's max
// and sums run over 4 independent partials instead of one chain. Keys at
// or past seq get p = 0 with MASK (only the ragged last tile needs it).
template <int KT, bool ENT, bool MASK>
__device__ __forceinline__ void softmax_tile_ilp(float (&s)[KT][4], float (&m)[2], float (&l)[2],
                                                 float (&sl)[2], float (&alpha)[2], int key0,
                                                 int seq, float scale_log2) {
  constexpr int kParts = 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float part[kParts];
#pragma unroll
    for (int i = 0; i < kParts; ++i) part[i] = kNegInit;
#pragma unroll
    for (int j = 0; j < KT; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        if (!MASK || key0 + 8 * j + c < seq)
          part[j % kParts] = fmaxf(part[j % kParts], s[j][2 * r + c]);
    const float raw_max = fmaxf(fmaxf(part[0], part[1]), fmaxf(part[2], part[3]));
    const float m_new = fmaxf(m[r], quad_max(raw_max) * scale_log2);
    alpha[r] = fast_exp2(m[r] - m_new);
    float p_sum[kParts] = {}, ps_sum[kParts] = {};
#pragma unroll
    for (int j = 0; j < KT; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float x = fmaf(s[j][2 * r + c], scale_log2, -m_new);
        const float p = !MASK || key0 + 8 * j + c < seq ? fast_exp2(x) : 0.f;
        p_sum[j % kParts] += p;
        if constexpr (ENT) ps_sum[j % kParts] = fmaf(p, x, ps_sum[j % kParts]);
        s[j][2 * r + c] = p;
      }
    const float tile_l = (p_sum[0] + p_sum[1]) + (p_sum[2] + p_sum[3]);
    // sl' rescaled to the new max: alpha (sl' + (m_old - m_new) l_old).
    if constexpr (ENT)
      sl[r] = fmaf(alpha[r], fmaf(m[r] - m_new, l[r], sl[r]),
                   (ps_sum[0] + ps_sum[1]) + (ps_sum[2] + ps_sum[3]));
    l[r] = fmaf(alpha[r], l[r], tile_l);
    m[r] = m_new;
  }
}

// P's hi = bf16(x) and lo = bf16(x - hi) for a pair of columns (x0 the
// lower), each packed as one register, the lower column in the low half.
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(hi) : "f"(x1), "f"(x0));
  const float h0 = __uint_as_float(hi << 16), h1 = __uint_as_float(hi & 0xffff0000u);
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(lo) : "f"(x1 - h1), "f"(x0 - h0));
}

template <int D, bool ENT>
__global__ void __launch_bounds__(kThreads, 1)
block_attention_sm90_kernel(const __grid_constant__ CUtensorMap q_map,
                            const __grid_constant__ CUtensorMap k_map,
                            const __grid_constant__ CUtensorMap v_map, float* __restrict__ out,
                            float* __restrict__ ent, int seq, int q_tiles, float scale_log2) {
  using L = Sm90<D>;
  constexpr int kKeys = L::kKeys, kPitch = L::kPitch, kHalves = D / L::kCols;
  constexpr int KT = kKeys / 8;  // 8-key steps of S
  constexpr int DT = D / 8;      // 8-column steps of the output
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t stages = base + L::kQBytes;  // stage i: K at i kStageBytes, V after it
  const uint32_t full = base + L::kBarOffset, empty = full + 8 * kStages,
                 q_full = empty + 8 * kStages;

  const int head = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * kRows;
  const int tiles = (seq + kKeys - 1) / kKeys;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, 128 * kConsumers);
    }
    mbar_init(q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // The producer: one thread issues every load.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, L::kQBytes);
#pragma unroll
      for (int h = 0; h < kHalves; ++h)
        tma_load(q_s + h * kRows * kPitch, &q_map, q_full, h * L::kCols, q0, head);
      for (int i = 0; i < tiles; ++i) {
        const int st = i % kStages;
        // the consumers have released the stage's previous tile (a fresh
        // barrier passes the wait on parity 1)
        mbar_wait(empty + 8 * st, ((i / kStages) & 1) ^ 1);
        const uint32_t bar = full + 8 * st, k_s = stages + st * L::kStageBytes;
        mbar_expect_tx(bar, L::kStageBytes);
#pragma unroll
        for (int h = 0; h < kHalves; ++h) {
          tma_load(k_s + h * kKeys * kPitch, &k_map, bar, h * L::kCols, i * kKeys, head);
          tma_load(k_s + L::kTileBytes + h * kKeys * kPitch, &v_map, bar, h * L::kCols,
                   i * kKeys, head);
        }
      }
    }
    return;
  }

  // A consumer: query rows q0 + 64 c .. of the block, rows g and g + 8 of
  // its warp's 16 in this thread.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
  const int c = wg - 1;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  constexpr uint32_t kSbo = 8 * kPitch;  // between 8-row groups, all operands
  const uint32_t q_rows = q_s + c * 64 * kPitch;

  float m[2] = {kNegInit, kNegInit}, l[2] = {0.f, 0.f}, sl[2] = {0.f, 0.f};
  float acc[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;

  // The two consumers take turns on the tensor cores (FA3's ping-pong): in
  // its turn a consumer issues P V of its previous tile and Q K^T of its
  // next, then hands over (named barriers 1 and 2, one per consumer) and
  // runs that tile's softmax while the other's products run. Consumer 1
  // opens consumer 0's first turn and skips its own last hand-over, so
  // each barrier sees as many arrivals as waits. Nothing that depends on
  // which consumer runs it lies between a product's issue and its wait:
  // ptxas serializes wgmma in such a divergent path.
  const int my_turn = 1 + c, their_turn = 2 - c;
  float s[KT][4], alpha[2];
  uint32_t ph[KT / 2][4], pl[KT / 2][4];  // P of the tile in hand, hi and lo

  // P V = lo V + hi V of tile i, then the release of its stage and the
  // fold; V's step kk is 16 tile rows on, its column blocks (d 128) kKeys
  // rows apart.
  auto pv_and_fold = [&](int i) {
    const int st = i % kStages;
    const uint32_t v_s = stages + st * L::kStageBytes + L::kTileBytes;
    float pv[DT][4];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KT / 2; ++kk)
      wgmma_rs<D>(pv, pl[kk], gmma_desc(v_s + kk * 16 * kPitch, kKeys * kPitch, kSbo, L::kLayout),
                  kk > 0);
#pragma unroll
    for (int kk = 0; kk < KT / 2; ++kk)
      wgmma_rs<D>(pv, ph[kk], gmma_desc(v_s + kk * 16 * kPitch, kKeys * kPitch, kSbo, L::kLayout),
                  1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(pv);
    mbar_arrive(empty + 8 * st);
    fold<DT, DT>(acc, pv, 0, alpha);
  };
  // Issues S = Q K^T of tile i, once its stage has landed.
  auto issue_qk = [&](int i) {
    const int st = i % kStages;
    mbar_wait(full + 8 * st, (i / kStages) & 1);
    const uint32_t k_s = stages + st * L::kStageBytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<kKeys>(s, gmma_desc(q_rows + depth_offset<D>(kk, kRows), 16, kSbo, L::kLayout),
                      gmma_desc(k_s + depth_offset<D>(kk, kKeys), 16, kSbo, L::kLayout), kk > 0);
    wgmma_commit();
  };
  // Waits for S of tile i; its softmax, and P split into hi and lo as the
  // A operand of P V: step kk is keys 16kk .. 16kk + 15 = S steps 2kk,
  // 2kk + 1.
  auto softmax_and_split = [&](int i) {
    wgmma_wait_all();
    fence_regs(s);
    if ((i + 1) * kKeys <= seq)
      softmax_tile_ilp<KT, ENT, false>(s, m, l, sl, alpha, i * kKeys + 2 * t, seq, scale_log2);
    else
      softmax_tile_ilp<KT, ENT, true>(s, m, l, sl, alpha, i * kKeys + 2 * t, seq, scale_log2);
#pragma unroll
    for (int kk = 0; kk < KT / 2; ++kk)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        split_pair(s[2 * kk + h][0], s[2 * kk + h][1], ph[kk][2 * h], pl[kk][2 * h]);
        split_pair(s[2 * kk + h][2], s[2 * kk + h][3], ph[kk][2 * h + 1], pl[kk][2 * h + 1]);
      }
  };

  if (c == 1) named_arrive(their_turn, 2 * 128);
  mbar_wait(q_full, 0);
  named_sync(my_turn, 2 * 128);
  issue_qk(0);
  named_arrive(their_turn, 2 * 128);
  softmax_and_split(0);
  for (int i = 1; i < tiles; ++i) {
    named_sync(my_turn, 2 * 128);
    pv_and_fold(i - 1);
    issue_qk(i);
    named_arrive(their_turn, 2 * 128);
    softmax_and_split(i);
  }
  named_sync(my_turn, 2 * 128);
  pv_and_fold(tiles - 1);
  if (c == 0) named_arrive(their_turn, 2 * 128);

  const size_t base_out = static_cast<size_t>(head) * seq * D;
  store_rows<DT, ENT>(acc, l, sl, out, ent, base_out, head, q0 + 64 * c + 16 * warp + g, seq,
                      t);
}

// ---------------------------------------------------------------- host side

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up through the runtime (no -lcuda).
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// Return codes past cudaError_t's: the tensor map could not be made.
constexpr int kNoEncoder = 100000;
constexpr int kEncodeFailed = 100001;

// A 3-D map [bh, seq, d] of bf16 over `ptr`, boxes of `rows` rows of
// Sm90<D>::kCols columns of one head; rows past seq are zero-filled.
template <int D>
int tensor_map(CUtensorMap* map, const void* ptr, int bh, int seq, int rows) {
  using L = Sm90<D>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kNoEncoder;
  const cuuint64_t dims[3] = {D, static_cast<cuuint64_t>(seq), static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {2 * D, 2ull * D * static_cast<cuuint64_t>(seq)};
  const cuuint32_t box[3] = {L::kCols, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, L::kSwizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeFailed;
}

template <int D, bool ENT>
int launch(const void* q, const void* k, const void* v, float* out, float* ent, int bh, int seq,
           cudaStream_t stream) {
  using L = Sm90<D>;
  auto kernel = block_attention_sm90_kernel<D, ENT>;
  CUtensorMap q_map, k_map, v_map;
  int rc = tensor_map<D>(&q_map, q, bh, seq, kRows);
  if (rc == 0) rc = tensor_map<D>(&k_map, k, bh, seq, L::kKeys);
  if (rc == 0) rc = tensor_map<D>(&v_map, v, bh, seq, L::kKeys);
  if (rc != 0) return rc;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(L::bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int q_tiles = (seq + kRows - 1) / kRows;
  const long long blocks = static_cast<long long>(bh) * q_tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  kernel<<<static_cast<unsigned>(blocks), kThreads, L::bytes, stream>>>(
      q_map, k_map, v_map, out, ent, seq, q_tiles,
      static_cast<float>(kLog2e / sqrt(static_cast<double>(D))));
  return static_cast<int>(cudaGetLastError());
}

template <bool ENT>
int dispatch(const void* q, const void* k, const void* v, float* out, float* ent, int bh,
             int seq, int d, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<16, ENT>(q, k, v, out, ent, bh, seq, stream);
    case 32: return launch<32, ENT>(q, k, v, out, ent, bh, seq, stream);
    case 64: return launch<64, ENT>(q, k, v, out, ent, bh, seq, stream);
    case 128: return launch<128, ENT>(q, k, v, out, ent, bh, seq, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Launch on `stream` and return 0 on success, else cudaGetLastError() or
// a tensor-map failure (see the error string). q, k, v: contiguous
// [bh, seq, d] bfloat16, 16-byte aligned; out: [bh, seq, d] float32;
// `ent` ([bh, seq] float32) selects the entropy kernel when it is not
// null.
int block_attention_sm90_bf16(const void* q, const void* k, const void* v, void* out, void* ent,
                              int bh, int seq, int d, void* stream) {
  if (bh <= 0 || seq <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (ent != nullptr) return dispatch<true>(q, k, v, o, static_cast<float*>(ent), bh, seq, d, s);
  return dispatch<false>(q, k, v, o, nullptr, bh, seq, d, s);
}

const char* block_attention_error_string(int code) {
  if (code == kNoEncoder) return "libcuda has no cuTensorMapEncodeTiled";
  if (code == kEncodeFailed) return "cuTensorMapEncodeTiled refused the tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
