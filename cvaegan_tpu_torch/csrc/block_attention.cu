// Blockwise (flash-style) non-causal self-attention forward, float32, on
// Hopper's tensor cores.
//
//   out = softmax(q k^T * d^-0.5) v          over [bh, seq, d] tensors
//   ent = -sum_j p_j log p_j  (per row)      only in the entropy variant
//
// Two kernels from one template, both replacing Pallas TPU kernels of
// `cvaegan_tpu/kernels/block_attention.py`:
//   * ENT = false replaces `_attn_kernel` (entry `block_attention`);
//   * ENT = true replaces `_attn_ent_kernel` (entry
//     `block_attention_with_entropy`), the same sweep plus the exact row
//     entropy H = m + log l - sl / l without materialising P.
// The TPU kernels pin a head's whole K and V in VMEM and walk the key
// blocks of one query block in order, carrying (m, l, acc[, sl]) in
// scratch. Here a block of 8 warps owns 128 query rows (16 per warp) and
// streams K and V through shared memory in tiles of at most 2048 elements
// (64 keys at d <= 32, 32 at d 64, 16 at d 128), one block per SM.
// Head dims 16, 32, 64 and 128 are instantiated; any seq >= 1 runs.
//
// Products. QK^T and PV both run on the tensor cores as
// mma.sync.m16n8k8 with TF32 operands, in three passes for float32
// accuracy: each operand x is split into hi = tf32(x) and lo =
// tf32(x - hi), rounded to nearest as cvt.rna.tf32.f32 rounds (without
// it the unit truncates the low 13 mantissa bits), and a.b ~ hi.lo +
// lo.hi + hi.hi, small terms first. One TF32 pass keeps ~3 decimal digits
// and misses the JAX tests' float32 tolerance (2e-5) by an order of
// magnitude; three stay well inside it. The unit's float32 accumulator
// adds with truncation, so each tile's P V starts from zero and is folded
// into the running output by a rounded fmaf: summed over all keys in the
// accumulator, the error grew with seq, to 0.59 of the tolerance at seq
// 8192 against 0.03 with the fold.
//
// The split, the products and the fragment layouts (g = lane / 4,
// t = lane % 4) are in `tf32x3.cuh`, shared with `fused_mlp4.cu`.
// S = Q K^T leaves the scores of keys 2t and 2t + 1 in each thread. P
// never leaves registers: PV sums over keys, so their order inside an
// 8-key step is free, and P's accumulator c0, c1, c2, c3 serves as the A
// operand a0, a2, a1, a3. Column t of A is then key 2t and column t + 4
// key 2t + 1, so V's B fragment comes from key rows 2t and 2t + 1.
//
// Data movement. K and V arrive by 16-byte cp.async.cg into a landing
// area; rows past seq are zero-filled (src-size 0). Their scores are then
// 0, not -inf, so the ragged key tail is masked to p = 0 explicitly; the
// ragged query tail is zero-filled and not stored. Each thread then
// splits the very pieces it copied (its own copies are complete after
// cp.async.wait_group, with no barrier) into hi and lo, once per block and
// not once per warp, and stores them where a single 16-byte load is a
// whole B fragment with its hi and lo (`split2`): K[key][8s + t] and
// K[key][8s + t + 4], V[2i][c] and V[2i + 1][c]. The split
// tiles are double-buffered, so one __syncthreads per tile suffices: it
// publishes tile i's split and ends the reads of tile i - 1's stage and
// of the landing area; the copy of tile i + 1 is issued right after it
// and lands while tile i is computed. Pitches (see `Smem`) and a per-lane
// rotation of the split's stores (`store_split`) put the 8 lanes of a
// quarter-warp on distinct bank groups. Q is split once, before the
// key loop, and held in registers for d <= 64; at d 128 that would take
// 128 registers, so there each warp reads and splits its Q fragments from
// shared memory per tile.
//
// Softmax and entropy keep the TPU kernels' numerics (`softmax_tile`
// below; the pieces it shares with the bf16 kernel of
// `block_attention_sm90.cu` are in `online_softmax.cuh`).
//
// Bound on an H100 SXM. Per call: 4 bh seq^2 d FLOP (QK^T and PV), done
// three times over in TF32, plus 2 bh seq^2 for the entropy's p (s - m),
// against 16 bh seq d bytes moved (q, k, v read once, out written once).
// At [128, 1024, 64] that is 103 GFLOP of TF32 products: 0.208 ms at the
// 495 TFLOP/s dense TF32 rate, against 0.040 ms of memory at 3.35 TB/s, so
// the tensor cores bound it. mma.sync does not reach that rate on Hopper
// (only wgmma does). The kernels use mma.sync all the same: wgmma takes
// TF32 operands only K-major from shared memory, in its own swizzled
// layout, so V would have to be transposed there and the split tiles laid
// out for it, with warpgroup-wide products replacing the per-warp ones.
// That is the next redesign step (the bf16-operand kernels took it:
// `block_attention_sm90.cu`).

#include <cuda_runtime.h>
#include <stdint.h>

#include "online_softmax.cuh"
#include "tf32x3.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kRows = 16 * kWarps;  // query rows per block
constexpr int kThreads = 32 * kWarps;
// Shared memory of one block, for head dim D.
//   k4 [kKeys][KP] float4: K[key][8s + t] and K[key][8s + t + 4], split,
//      at [key][4s + t]: one 16-byte load is a B fragment of Q K^T;
//   v4 [kKeys / 2][VP] float4: V[2i][c] and V[2i + 1][c], split, at
//      [i][c]: one 16-byte load is a B fragment of P V;
// both twice (double-buffered), then the Q tile [kRows][D + 4] and the
// landing area of the copies, K and V of one tile as [kKeys][D] each.
// The pitches put the 8 lanes of a quarter-warp on distinct 16-byte bank
// groups: KP = D / 2 + 4 = 4 (mod 8) for the K reads (key g, lane t), and
// VP = D + 2 for the V reads (row 2t, column g).
template <int D>
struct Smem {
  // keys per tile: K and V tiles of at most 2048 elements each
  static constexpr int kKeys = 2048 / D < 64 ? 2048 / D : 64;
  static constexpr int KP = D / 2 + 4;
  static constexpr int VP = D + 2;
  static constexpr int kK4 = kKeys * KP;
  static constexpr int kV4 = kKeys / 2 * VP;
  static constexpr int kStage = kK4 + kV4;  // float4s
  static constexpr int QP = D + 4;
  static constexpr size_t bytes =
      sizeof(float4) * 2 * kStage + sizeof(float) * (kRows * QP + 2 * kKeys * D);
};

// Starts copying the Q tile (rows q0 ..) into `qs` [kRows][D + 4]; rows at
// or past seq are zero-filled (src-size 0).
template <int D>
__device__ __forceinline__ void load_q_async(float* qs, const float* q, int q0, int seq) {
  constexpr int kVecs = D / 4;
#pragma unroll
  for (int idx = threadIdx.x; idx < kRows * kVecs; idx += kThreads) {
    const int r = idx / kVecs, c = idx % kVecs;
    const bool valid = q0 + r < seq;
    cp_async16(qs + r * (D + 4) + 4 * c,
               q + static_cast<size_t>(valid ? q0 + r : 0) * D + 4 * c, valid);
  }
}

// Each thread copies, and later splits, the same pieces of a tile: K as
// (key, depth step) pairs of two 16-byte chunks, V as (key pair, column
// quad) pairs of two chunks, rows past seq zero-filled. `key0` is the
// tile's first key; raw K then raw V, [kKeys][D] each.
template <int D>
__device__ __forceinline__ void load_kv_async(float* raw, const float* k, const float* v,
                                              int key0, int seq) {
  constexpr int kKeys = Smem<D>::kKeys, DS = D / 8, DQ = D / 4;
#pragma unroll
  for (int p = threadIdx.x; p < kKeys * DS; p += kThreads) {
    const int r = p / DS, s = p % DS;
    const bool valid = key0 + r < seq;
    const float* from = k + static_cast<size_t>(valid ? key0 + r : 0) * D + 8 * s;
    cp_async16(raw + r * D + 8 * s, from, valid);
    cp_async16(raw + r * D + 8 * s + 4, from + 4, valid);
  }
  float* raw_v = raw + kKeys * D;
#pragma unroll
  for (int p = threadIdx.x; p < kKeys / 2 * DQ; p += kThreads) {
    const int i = p / DQ, c = p % DQ;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool valid = key0 + 2 * i + e < seq;
      cp_async16(raw_v + (2 * i + e) * D + 4 * c,
                 v + static_cast<size_t>(valid ? key0 + 2 * i + e : 0) * D + 4 * c, valid);
    }
  }
}

// (x, y, z, w) rotated left by `rot` in 0..3, by selects.
__device__ __forceinline__ float4 rotate(float4 a, int rot) {
  if (rot & 2) a = make_float4(a.z, a.w, a.x, a.y);
  if (rot & 1) a = make_float4(a.y, a.z, a.w, a.x);
  return a;
}

// Stores split2(a[e], b[e]) at to[e] for e = 0..3. A lane starts at
// e = rot = (lane % 8) / 2, so that the 8 lanes of a quarter-warp, whose
// `to` come in pairs 64 bytes apart (pieces 2m and 2m + 1), store to 8
// distinct 16-byte bank groups each time.
__device__ __forceinline__ void store_split(float4* to, float4 a, float4 b) {
  const int rot = (threadIdx.x & 7) >> 1;
  a = rotate(a, rot);
  b = rotate(b, rot);
  to[rot] = split2(a.x, b.x);
  to[(rot + 1) & 3] = split2(a.y, b.y);
  to[(rot + 2) & 3] = split2(a.z, b.z);
  to[(rot + 3) & 3] = split2(a.w, b.w);
}

// Splits the pieces this thread copied (see `load_kv_async`) from the
// landing area into a stage of split tiles.
template <int D>
__device__ __forceinline__ void split_kv(float4* k4, float4* v4, const float* raw) {
  using S = Smem<D>;
  constexpr int kKeys = S::kKeys, DS = D / 8, DQ = D / 4;
#pragma unroll
  for (int p = threadIdx.x; p < kKeys * DS; p += kThreads) {
    const int r = p / DS, s = p % DS;
    store_split(k4 + r * S::KP + 4 * s,
                *reinterpret_cast<const float4*>(raw + r * D + 8 * s),
                *reinterpret_cast<const float4*>(raw + r * D + 8 * s + 4));
  }
  const float* raw_v = raw + kKeys * D;
#pragma unroll
  for (int p = threadIdx.x; p < kKeys / 2 * DQ; p += kThreads) {
    const int i = p / DQ, c = p % DQ;
    store_split(v4 + i * S::VP + 4 * c,
                *reinterpret_cast<const float4*>(raw_v + 2 * i * D + 4 * c),
                *reinterpret_cast<const float4*>(raw_v + (2 * i + 1) * D + 4 * c));
  }
}

// The A fragment of Q for depth step s (columns 8s .. 8s + 7) of the
// warp's 16 rows, `qw` pointing at the warp's first row.
template <int D>
__device__ __forceinline__ void q_fragment(const float* qw, int s, int g, int t,
                                           uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  constexpr int P = D + 4;
  const float x[4] = {qw[g * P + 8 * s + t], qw[(g + 8) * P + 8 * s + t],
                      qw[g * P + 8 * s + t + 4], qw[(g + 8) * P + 8 * s + t + 4]};
  split4(x, hi, lo);
}

// The online-softmax update of one key tile for the warp's rows g (r = 0)
// and g + 8 (r = 1): `s` holds the tile's raw scores on entry (keys
// key0 + 8j, key0 + 8j + 1 with key0 = tile start + 2t) and p on exit;
// m, l (and sl) carry over tiles, `alpha` is the rescale of this tile.
template <int KT, bool ENT>
__device__ __forceinline__ void softmax_tile(float (&s)[KT][4], float (&m)[2], float (&l)[2],
                                             float (&sl)[2], float (&alpha)[2], int key0,
                                             int seq, float scale_log2) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float tile_max = kNegInit;
#pragma unroll
    for (int j = 0; j < KT; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        s[j][2 * r + c] *= scale_log2;
        if (key0 + 8 * j + c < seq) tile_max = fmaxf(tile_max, s[j][2 * r + c]);
      }
    const float m_new = fmaxf(m[r], quad_max(tile_max));
    alpha[r] = fast_exp2(m[r] - m_new);
    float p_sum = 0.f, ps_sum = 0.f;
#pragma unroll
    for (int j = 0; j < KT; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float x = s[j][2 * r + c] - m_new;
        const float p = key0 + 8 * j + c < seq ? fast_exp2(x) : 0.f;
        p_sum += p;
        if constexpr (ENT) ps_sum = fmaf(p, x, ps_sum);
        s[j][2 * r + c] = p;
      }
    // sl' rescaled to the new max: alpha (sl' + (m_old - m_new) l_old).
    if constexpr (ENT) sl[r] = fmaf(alpha[r], fmaf(m[r] - m_new, l[r], sl[r]), ps_sum);
    l[r] = fmaf(alpha[r], l[r], p_sum);
    m[r] = m_new;
  }
}

template <int D, bool ENT>
__global__ void __launch_bounds__(kThreads)
block_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out,
                       float* __restrict__ ent, int seq, int q_tiles,
                       float scale_log2) {
  using S = Smem<D>;
  constexpr int kKeys = S::kKeys;
  constexpr int DT = D / 8;      // depth steps of QK^T, column tiles of PV
  constexpr int KT = kKeys / 8;  // key tiles of QK^T, depth steps of PV
  constexpr bool kQInRegs = D <= 64;
  constexpr int QR = kQInRegs ? DT : 1;
  extern __shared__ float4 smem4[];
  float4* stages = smem4;                                       // 2 x {k4, v4}
  float* qs = reinterpret_cast<float*>(smem4 + 2 * S::kStage);  // [kRows][D + 4]
  float* raw = qs + kRows * S::QP;                              // K, V [kKeys][D]

  const int head = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * kRows;
  const size_t base = static_cast<size_t>(head) * seq * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const float* qw = qs + warp * 16 * S::QP;
  const int tiles = (seq + kKeys - 1) / kKeys;

  load_q_async<D>(qs, q + base, q0, seq);
  load_kv_async<D>(raw, k + base, v + base, 0, seq);
  cp_async_commit();

  // Rows g (r = 0) and g + 8 (r = 1) of the warp's 16; acc[n] holds
  // columns 8n + 2t, 8n + 2t + 1 of both rows, as an mma accumulator.
  float m[2] = {kNegInit, kNegInit}, l[2] = {0.f, 0.f}, sl[2] = {0.f, 0.f};
  float acc[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
  uint32_t qh[QR][4], ql[QR][4];

  for (int tile = 0; tile < tiles; ++tile) {
    float4* k4 = stages + (tile & 1) * S::kStage;
    float4* v4 = k4 + S::kK4;
    cp_async_wait_all();  // this thread's pieces of the tile have landed
    split_kv<D>(k4, v4, raw);
    // The split tile is complete; every warp is done with tile - 1, whose
    // stage the next split overwrites, and every thread with the landing
    // area, which the next copy overwrites.
    __syncthreads();
    if (tile + 1 < tiles) {
      load_kv_async<D>(raw, k + base, v + base, (tile + 1) * kKeys, seq);
      cp_async_commit();
    }
    if constexpr (kQInRegs) {
      if (tile == 0) {
#pragma unroll
        for (int d = 0; d < DT; ++d) q_fragment<D>(qw, d, g, t, qh[d], ql[d]);
      }
    }

    // s[j]: scores of keys 8j + 2t, 8j + 2t + 1 for rows g, g + 8.
    float s[KT][4];
#pragma unroll
    for (int j = 0; j < KT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      uint32_t ah[4], al[4];
      if constexpr (kQInRegs) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ah[i] = qh[d % QR][i];
          al[i] = ql[d % QR][i];
        }
      } else {
        q_fragment<D>(qw, d, g, t, ah, al);
      }
#pragma unroll
      for (int j = 0; j < KT; ++j) mma3(s[j], ah, al, k4[(8 * j + g) * S::KP + 4 * d + t]);
    }

    float alpha[2];
    softmax_tile<KT, ENT>(s, m, l, sl, alpha, tile * kKeys + 2 * t, seq, scale_log2);

    // acc = alpha acc + P V. The tensor cores add into their float32
    // accumulator with truncation, whose bias would grow with the number
    // of keys; so each tile's P V starts from zero and is folded into acc
    // by a rounded fmaf, in chunks of at most 8 column tiles (32
    // registers). Step j sums keys 8j .. 8j + 7, P's c0 c1 c2 c3 as A's
    // a0 a2 a1 a3 (column t = key 2t, column t + 4 = key 2t + 1).
    constexpr int NC = DT < 8 ? DT : 8;
#pragma unroll
    for (int n0 = 0; n0 < DT; n0 += NC) {
      float pv[NC][4];
#pragma unroll
      for (int n = 0; n < NC; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) pv[n][i] = 0.f;
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        uint32_t ph[4], pl[4];
        const float a[4] = {s[j][0], s[j][2], s[j][1], s[j][3]};
        split4(a, ph, pl);
        const float4* vr = v4 + (4 * j + t) * S::VP + 8 * n0 + g;
#pragma unroll
        for (int n = 0; n < NC; ++n) mma3(pv[n], ph, pl, vr[8 * n]);
      }
      fold<NC, DT>(acc, pv, n0, alpha);
    }
  }

  store_rows<DT, ENT>(acc, l, sl, out, ent, base, head, q0 + warp * 16 + g, seq, t);
}

// Launches the kernel for head dim D.
template <int D, bool ENT>
int launch(const float* q, const float* k, const float* v, float* out, float* ent, int bh,
           int seq, cudaStream_t stream) {
  auto kernel = block_attention_kernel<D, ENT>;
  constexpr size_t smem = Smem<D>::bytes;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int q_tiles = (seq + kRows - 1) / kRows;
  const long long blocks = static_cast<long long>(bh) * q_tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      q, k, v, out, ent, seq, q_tiles, static_cast<float>(kLog2e / sqrt(static_cast<double>(D))));
  return static_cast<int>(cudaGetLastError());
}

template <bool ENT>
int dispatch(const float* q, const float* k, const float* v, float* out, float* ent, int bh,
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

// Launch on `stream` and return cudaGetLastError() (0 on success).
// q, k, v: contiguous [bh, seq, d] float32, 16-byte aligned; out:
// [bh, seq, d] float32; `ent` ([bh, seq] float32) selects the entropy
// kernel when it is not null.
int block_attention_f32(const void* q, const void* k, const void* v, void* out, void* ent,
                        int bh, int seq, int d, void* stream) {
  if (bh <= 0 || seq <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  const auto *qf = static_cast<const float*>(q), *kf = static_cast<const float*>(k),
             *vf = static_cast<const float*>(v);
  float* o = static_cast<float*>(out);
  if (ent != nullptr) return dispatch<true>(qf, kf, vf, o, static_cast<float*>(ent), bh, seq, d, s);
  return dispatch<false>(qf, kf, vf, o, nullptr, bh, seq, d, s);
}

const char* block_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
