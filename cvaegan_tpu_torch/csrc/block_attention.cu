// Blockwise (flash-style) non-causal self-attention forward, float32.
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
// Head dims 16, 32, 64 and 128 are instantiated; any seq >= 1 runs.
//
// Numerics follow the TPU kernels: running max from -1e30, scores scaled
// by d^-0.5 after the dot product, online softmax (m, l, acc) in float32
// with exact FMA (no TF32, no tensor cores), out = acc / l. The entropy
// carries sl relative to the running max, sl' = sum exp(s - m) (s - m) =
// sl - m l, so that H = log l - sl' / l: the same formula, with the m's
// cancelling exactly instead of in float32. (On a peaked row, s ~ 300 at
// inputs of scale 10, m and sl / l agree to all float32 digits and their
// difference is rounding noise of ~1e-5.)
//
// Bound on an H100 SXM. Per call: 4 bh seq^2 d FLOP (QK^T and PV), plus
// 2 bh seq^2 for the entropy's p (s - m), against 16 bh seq d bytes
// moved (q, k, v read once, out written once). At [128, 1024, 64] that is
// 34.4 GFLOP against 134 MB: 0.51 ms at the 67 TFLOP/s float32 rate
// outside the tensor cores, 0.040 ms at 3.35 TB/s. The kernels are bound
// by float32 arithmetic, and the design aims at keeping the FMA pipes fed
// from registers and shared memory:
//   * one block of 256 threads per (head, tile of 64 query rows); the
//     flattened grid gives bh * ceil(seq / 64) blocks (2048 at both
//     [128, 1024] and [16, 8192]) for the 132 SMs;
//   * the TPU kernel pins a head's whole K and V in VMEM; a Hopper block
//     has at most 227 KB of shared memory, so K and V stream through it in
//     tiles of 64 keys (rows zero-filled past seq), beside the block's Q
//     tile and a 64 x 64 tile of probabilities;
//   * each warp owns 8 query rows and each thread a 4 x 4 tile of scores
//     (its 4 rows x keys tx, tx + 16, tx + 32, tx + 48) and a 4 x d/16
//     tile of the output; the 16 threads sharing a row sit in one half
//     of a warp, so the row max is 4 shuffles and the probability tile
//     only needs __syncwarp between writing and reading it;
//   * l and sl are kept as per-thread partial sums (the rescale by
//     exp(m_old - m_new) is uniform along a row) and reduced once at the
//     end; the ragged key tail gets p = 0, the ragged query tail is
//     zero-filled on load and not stored;
//   * shared-memory rows are padded by 4 floats, so the float4 reads of 16
//     key rows by a half-warp hit distinct banks.
// Tensor cores (TF32 wgmma, with its own tolerance), cp.async double
// buffering and larger register tiles are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 64;      // query rows per block
constexpr int kKeys = 64;      // keys per tile
constexpr int kThreads = 256;  // 8 warps x 8 rows
constexpr int kPPitch = kKeys + 4;
constexpr float kNegInit = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((kRows + 2 * kKeys) * (D + 4) + kRows * kPPitch);
}

// Copies rows [row0, row0 + n) of a [seq, D] matrix into a [n][D + 4]
// shared-memory tile, zero-filling rows at or past seq.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int row0, int n, int seq) {
  constexpr int kVecs = D / 4;
  for (int idx = threadIdx.x; idx < n * kVecs; idx += kThreads) {
    const int r = idx / kVecs, c = idx % kVecs;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < seq)
      val = reinterpret_cast<const float4*>(src + static_cast<size_t>(row0 + r) * D)[c];
    *reinterpret_cast<float4*>(dst + r * (D + 4) + 4 * c) = val;
  }
}

template <int D, bool ENT>
__global__ void __launch_bounds__(kThreads)
block_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out,
                       float* __restrict__ ent, int seq, int q_tiles,
                       float scale) {
  constexpr int P = D + 4;   // row pitch of the Q, K and V tiles
  constexpr int C = D / 16;  // output columns per thread
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [kRows][P]
  float* ks = qs + kRows * P;                   // [kKeys][P]
  float* vs = ks + kKeys * P;                   // [kKeys][P]
  float* ps = vs + kKeys * P;                   // [kRows][kPPitch]

  const int head = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * kRows;
  const size_t base = static_cast<size_t>(head) * seq * D;
  const int lane = threadIdx.x & 31;
  const int tx = lane & 15;
  const int r0 = (threadIdx.x >> 5) * 8 + (lane >> 4) * 4;  // first own row

  load_tile<D>(qs, q + base, q0, kRows, seq);

  float m[4], l[4], sl[4], acc[4][C];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInit;
    l[i] = 0.f;
    sl[i] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < seq; k0 += kKeys) {
    __syncthreads();  // the previous tile's K and V are no longer read
    load_tile<D>(ks, k + base, k0, kKeys, seq);
    load_tile<D>(vs, v + base, k0, kKeys, seq);
    __syncthreads();

    // s[i][j] = q[r0 + i] . k[k0 + tx + 16 j]
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int dd = 0; dd < D; dd += 4) {
      float4 a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(qs + (r0 + i) * P + dd);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        b[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * P + dd);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
          s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
          s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
          s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
        }
    }

    bool valid[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) valid[j] = k0 + tx + 16 * j < seq;

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float tile_max = kNegInit;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] *= scale;
        if (valid[j]) tile_max = fmaxf(tile_max, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(tile_max));
      const float alpha = expf(m[i] - m_new);
      float p_sum = 0.f, ps_sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = valid[j] ? expf(s[i][j] - m_new) : 0.f;
        p_sum += p;
        if constexpr (ENT) ps_sum = fmaf(p, s[i][j] - m_new, ps_sum);
        ps[(r0 + i) * kPPitch + tx + 16 * j] = p;
      }
      // sl' rescaled to the new max: alpha (sl' + (m_old - m_new) l_old).
      if constexpr (ENT) sl[i] = fmaf(alpha, fmaf(m[i] - m_new, l[i], sl[i]), ps_sum);
      l[i] = fmaf(alpha, l[i], p_sum);
#pragma unroll
      for (int c = 0; c < C; ++c) acc[i][c] *= alpha;
      m[i] = m_new;
    }
    __syncwarp();  // a warp reads back only the rows of p it wrote

    // acc[i][c] += sum_key p[r0 + i][key] v[key][tx + 16 c]
#pragma unroll 2
    for (int key = 0; key < kKeys; key += 4) {
      float4 p4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p4[i] = *reinterpret_cast<const float4*>(ps + (r0 + i) * kPPitch + key);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        float vv[C];
#pragma unroll
        for (int c = 0; c < C; ++c) vv[c] = vs[(key + t) * P + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = t == 0 ? p4[i].x : t == 1 ? p4[i].y : t == 2 ? p4[i].z : p4[i].w;
#pragma unroll
          for (int c = 0; c < C; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float l_row = half_warp_sum(l[i]);
    const float sl_row = ENT ? half_warp_sum(sl[i]) : 0.f;
    const int row = q0 + r0 + i;
    if (row >= seq) continue;
    float* o = out + base + static_cast<size_t>(row) * D;
#pragma unroll
    for (int c = 0; c < C; ++c) o[tx + 16 * c] = acc[i][c] / l_row;
    if (ENT && tx == 0)
      ent[static_cast<size_t>(head) * seq + row] = logf(l_row) - sl_row / l_row;
  }
}

template <int D, bool ENT>
int launch(const float* q, const float* k, const float* v, float* out,
           float* ent, int bh, int seq, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        block_attention_kernel<D, ENT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int q_tiles = (seq + kRows - 1) / kRows;
  const long long blocks = static_cast<long long>(bh) * q_tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  block_attention_kernel<D, ENT><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      q, k, v, out, ent, seq, q_tiles,
      static_cast<float>(1.0 / sqrt(static_cast<double>(D))));
  return static_cast<int>(cudaGetLastError());
}

template <bool ENT>
int dispatch(const float* q, const float* k, const float* v, float* out,
             float* ent, int bh, int seq, int d, cudaStream_t stream) {
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

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// q, k, v, out: contiguous [bh, seq, d] float32, 16-byte aligned; `ent`
// ([bh, seq] float32) selects the entropy kernel when it is not null.
int block_attention_f32(const void* q, const void* k, const void* v,
                        void* out, void* ent, int bh, int seq, int d,
                        void* stream) {
  if (bh <= 0 || seq <= 0) return 0;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (ent != nullptr)
    return dispatch<true>(f(q), f(k), f(v), o, static_cast<float*>(ent), bh,
                          seq, d, s);
  return dispatch<false>(f(q), f(k), f(v), o, nullptr, bh, seq, d, s);
}

const char* block_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
