// Fused 4-layer MLP forward for the generator's serving path, float32.
//
//   y = final(L4(lrelu(L3(lrelu(L2(lrelu(L1 x)))))))
//
// with LeakyReLU slope 0.2, Li(h) = h Wi + bi on [in, out] weights (eval
// BatchNorm already folded into W1-W3 by the caller), and final one of
// sigmoid, tanh or none. Replaces the Pallas TPU kernel
// `cvaegan_tpu/kernels/fused_mlp.py::_kernel`. Two kernels compute it;
// the wrapper (`kernels/fused_mlp.py::kernel_variant`) picks one from the
// layer widths alone:
//   * `tc_kernel`, on the tensor cores, whenever every layer is at most
//     256 wide and its shared memory fits (the serving widths do);
//   * `simt_kernel`, float32 FMA, for the others.
//
// Bound on an H100 SXM. At the serving shape 133->256->128->64->30 and
// 8192 rows the work is 8192 * 2 * (133*256 + 256*128 + 128*64 + 64*30)
// ~ 1.26 GFLOP: about 19 us at the 67 TFLOP/s float32 rate outside the
// tensor cores, and 7.6 us as three TF32 passes at the 495 TFLOP/s dense
// TF32 rate, against ~5.7 MB of device memory moved (x, weights, output),
// about 1.7 us at 3.35 TB/s. So the products bind; on the tensor cores
// every block also streams all ~300 KB of weights from L2 (~38 MB over
// 128 blocks), which the copies have to hide behind the products.
//
// tc_kernel. One block of 8 warps per 64 rows, so 8192 rows are 128
// blocks, one wave on 132 SMs; the ragged last tile is zero-filled on
// load and masked on store, never padded in device memory.
//   * Products: mma.sync.m16n8k8 in three TF32 passes (`tf32x3.cuh`).
//     Warp w owns rows 32 (w % 2) .. + 31 (two 16-row m-tiles) and the
//     layer's n-tiles w / 2, w / 2 + 4, ... (at most 8: 64 accumulators).
//     Each k step's three passes start from zero and are folded into the
//     float32 sum by a rounded add: the unit's truncating accumulator,
//     summed over a whole layer, drifted further from float64 on the card
//     and misses the tolerance in the CPU emulation
//     (`tests/test_torch_port_fused_mlp_tf32.py`).
//   * Activations never leave the SM: they ping-pong in float32 between
//     two shared-memory buffers ([64][K + 4], K rounded up to 8 and
//     zero-padded). A fragments are read from there and split in
//     registers, once per k step per warp, and reused across the warp's
//     n-tiles; no hi/lo copy of the activations is stored.
//   * Weights stream through shared memory layer by layer in k-chunks of
//     at most 4096 elements (16 k at 256 wide, all 64 k of the last
//     layer), by cp.async into a landing area. The thread that copied a
//     piece (rows r and r + 4 of a k step, four columns) splits it itself,
//     once per block, into fragment-ordered hi/lo tiles, where one 16-byte
//     load is a B fragment with its hi and lo; its four stores alternate
//     their order by column quad, so a quarter-warp hits 8 bank groups.
//     The split tiles are double-buffered: one __syncthreads per chunk
//     publishes a chunk's split (and, at a layer's first chunk, the
//     previous layer's epilogue) and ends every read of the landing area,
//     and the next chunk, the next layer's first one included, is copied
//     while the current chunk is multiplied.
//   * Epilogues in registers: bias and LeakyReLU into the other
//     activation buffer; in the last layer bias and the final activation,
//     stored to device memory for the rows the tile holds. The biases
//     arrive in shared memory with x, so no epilogue waits on a load.
//
// simt_kernel (the first port of the TPU kernel; float32 FMA, exact float32
// accumulation). One block per tile of TILE_M rows (32, or 16/8 for wide
// inputs); activations ping-pong in shared memory sized from the run-time
// widths; weights read through the read-only cache (L2-resident); each
// warp owns 4 rows and each lane 4 output columns strided by 32: 16
// register accumulators per thread, fed by 4 shared-memory broadcasts and
// 4 weight loads for every k. Loads, not FMAs, bind it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

constexpr float kSlope = 0.2f;

enum FinalKind { kSigmoid = 0, kTanh = 1, kNone = 2 };

__host__ __device__ __forceinline__ int imax(int a, int b) {
  return a > b ? a : b;
}

__device__ __forceinline__ float apply_final(float v, int kind) {
  if (kind == kSigmoid) return 1.0f / (1.0f + expf(-v));
  if (kind == kTanh) return tanhf(v);
  return v;
}

__device__ __forceinline__ float lrelu(float v) { return v >= 0.0f ? v : kSlope * v; }

// ------------------------------------------------------------ tc_kernel

constexpr int kTcRows = 64;            // rows per block: 4 m-tiles of 16
constexpr int kMTiles = 2;             // m-tiles per warp
constexpr int kRowGroups = 4 / kMTiles;
constexpr int kTcWarps = 4 * kRowGroups;  // x 4 n-groups
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kTcMaxN = 256;           // widest layer: 4 n-groups x 8 n-tiles
constexpr int kChunk = 4096;           // weights per k-chunk
constexpr int kMaxChunkRows = 128;     // k per chunk, at most
// Split tiles (2 x kChunk hi/lo pairs), the landing area (kChunk weights,
// rows padded by 8) and the 4 layers' biases, in floats.
constexpr int kLandingFloats = kChunk + 8 * kMaxChunkRows;
constexpr int kFixedFloats = 2 * 2 * kChunk + kLandingFloats + 4 * kTcMaxN;

__host__ __device__ __forceinline__ int round8(int x) { return (x + 7) & ~7; }

struct TcLayer {
  const float* w;  // [K, N]
  const float* b;  // [N]
  int K, N;
  int Kp, Np;      // rounded up to 8
  int kc;          // k per chunk, a multiple of 8
  int vec;         // rows copied as 16-byte pieces (N % 4 == 0, aligned)
};

struct TcParams {
  TcLayer layer[4];
  const float* x;
  float* out;
  int n, final_kind;
  // Pitches of the activation buffers (x, then layer 2's output; layer 1's,
  // then layer 3's): K rounded up to 8, plus 4, so that the 8 rows of an A
  // fragment (pitch = 4 mod 8) fall on distinct banks.
  int pa, pb;
};

// A k-chunk of layer L from k0 is copied, and split, in units (s, t, c):
// rows k0 + 8s + t and + 4 (the two rows of a B fragment) at columns
// 4c .. 4c + 3. Lanes take t fastest, then c. The landing area holds the
// chunk as [kc][Np + 8]; rows past K and columns past N are zero-filled.
struct Unit {
  int s, t, c;
  __device__ __forceinline__ Unit(int u, int quads)
      : s((u >> 2) / quads), t(u & 3), c((u >> 2) % quads) {}
};

__device__ __forceinline__ int chunk_units(const TcLayer& L, int k0) {
  return min(L.kc, L.Kp - k0) * L.Np / 8;
}

__device__ __forceinline__ void issue_chunk(float* landing, const TcLayer& L, int k0) {
  const int quads = L.Np / 4, lp = L.Np + 8, units = chunk_units(L, k0);
  for (int u = threadIdx.x; u < units; u += kTcThreads) {
    const Unit p(u, quads);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 8 * p.s + p.t + 4 * h, k = k0 + r;
      float* dst = landing + r * lp + 4 * p.c;
      const float* row = L.w + static_cast<size_t>(k) * L.N;
      if (L.vec) {
        const bool valid = k < L.K && 4 * p.c < L.N;
        cp_async16(dst, valid ? row + 4 * p.c : L.w, valid);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool valid = k < L.K && 4 * p.c + e < L.N;
          cp_async4(dst + e, valid ? row + 4 * p.c + e : L.w, valid);
        }
      }
    }
  }
}

// Splits this thread's units of the landing area into `stage`, laid out
// as [s][n][t] float4s: {hi, lo} of W[k0 + 8s + t][n] and of row + 4, so
// that lane (g, t) of a warp reads the B fragment of n-tile j at
// [s][8j + g][t], 32 consecutive float4s. A unit stores 4 float4s 64 bytes
// apart; units of odd c store them in the order 1 0 3 2, so the 8 lanes of
// a quarter-warp (t = 0..3 at columns c, c + 1) write 8 distinct bank groups.
__device__ __forceinline__ void split_chunk(float4* stage, const float* landing,
                                            const TcLayer& L, int k0) {
  const int quads = L.Np / 4, lp = L.Np + 8, units = chunk_units(L, k0);
  for (int u = threadIdx.x; u < units; u += kTcThreads) {
    const Unit p(u, quads);
    const int r = 8 * p.s + p.t;
    float4 a = *reinterpret_cast<const float4*>(landing + r * lp + 4 * p.c);
    float4 b = *reinterpret_cast<const float4*>(landing + (r + 4) * lp + 4 * p.c);
    const int f = p.c & 1;
    if (f) {
      a = make_float4(a.y, a.x, a.w, a.z);
      b = make_float4(b.y, b.x, b.w, b.z);
    }
    float4* to = stage + (p.s * L.Np + 4 * p.c) * 4 + p.t;
    to[4 * f] = split2(a.x, b.x);
    to[4 * (1 ^ f)] = split2(a.y, b.y);
    to[4 * (2 ^ f)] = split2(a.z, b.z);
    to[4 * (3 ^ f)] = split2(a.w, b.w);
  }
}

// One layer: src [64][ps] -> dst [64][pd] (hidden) or device memory (LAST).
// NTW is the warp's number of n-tiles, at least ceil(Np / 32). A warp with
// fewer live n-tiles multiplies, for the others, whatever lies past the
// layer's tiles in the split tiles or the landing area (in bounds: at most
// 256 columns of a chunk of at most 4096 weights) and stores none of it.
// `q` counts the block's chunks, so that chunk q's split lands in stage q % 2.
template <int NTW, bool LAST>
__device__ __forceinline__ void tc_layer(const TcParams& p, int l, const float* src,
                                         int ps, float* dst, int pd, float4* stages,
                                         float* landing, int& q, size_t row0,
                                         int rows_valid) {
  const TcLayer& L = p.layer[l];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = 16 * kMTiles * (warp % kRowGroups), ng = warp / kRowGroups;
  const int nt = L.Np >> 3;
  float acc[kMTiles][NTW][4];
#pragma unroll
  for (int m = 0; m < kMTiles; ++m)
#pragma unroll
    for (int i = 0; i < NTW; ++i)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[m][i][r] = 0.f;
  const float* aw = src + (m0 + g) * ps + t;  // a0 of the first m-tile

  for (int k0 = 0; k0 < L.Kp; k0 += L.kc) {
    float4* stage = stages + (q & 1) * (kChunk / 2);
    cp_async_wait_all();  // this thread's pieces of the chunk have landed
    split_chunk(stage, landing, L, k0);
    // The split chunk and the previous layer's output are complete; every
    // warp is done with chunk q - 1, whose stage the next split
    // overwrites, and every thread with the landing area.
    __syncthreads();
    if (k0 + L.kc < L.Kp)
      issue_chunk(landing, L, k0 + L.kc);
    else if (l < 3)
      issue_chunk(landing, p.layer[l + 1], 0);
    cp_async_commit();
    ++q;

    // Each k step's three passes of a tile start from zero in the unit
    // and are folded into acc by a rounded add.
    const int steps = min(L.kc, L.Kp - k0) >> 3;
    const float* a = aw + k0;
    const float4* b = stage + (ng * 8 + g) * 4 + t;  // n-tile ng of step 0
#pragma unroll 2
    for (int s = 0; s < steps; ++s, a += 8, b += 4 * L.Np) {
      uint32_t ah[kMTiles][4], al[kMTiles][4];
#pragma unroll
      for (int m = 0; m < kMTiles; ++m) {
        const float* am = a + 16 * m * ps;
        const float x[4] = {am[0], am[8 * ps], am[4], am[8 * ps + 4]};
        split4(x, ah[m], al[m]);
      }
#pragma unroll
      for (int i = 0; i < NTW; ++i) {
        const float4 bf = b[128 * i];  // n-tile ng + 4i
#pragma unroll
        for (int m = 0; m < kMTiles; ++m) {
          float part[4] = {0.f, 0.f, 0.f, 0.f};
          mma3(part, ah[m], al[m], bf);
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[m][i][r] += part[r];
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < NTW; ++i) {
    const int j = ng + 4 * i;
    if (j >= nt) break;
    const int col = 8 * j + 2 * t;
    const float* bias = landing + kLandingFloats + kTcMaxN * l;  // 0 past N
    const float b0 = bias[col], b1 = bias[col + 1];
#pragma unroll
    for (int m = 0; m < kMTiles; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // rows g and g + 8 of the m-tile
        const int row = m0 + 16 * m + g + 8 * h;
        const float v0 = acc[m][i][2 * h] + b0, v1 = acc[m][i][2 * h + 1] + b1;
        if constexpr (LAST) {
          if (row >= rows_valid) continue;
          float* o = p.out + (row0 + row) * L.N + col;
          if (col < L.N) o[0] = apply_final(v0, p.final_kind);
          if (col + 1 < L.N) o[1] = apply_final(v1, p.final_kind);
        } else {
          // Columns N .. Np - 1 come out 0: their weights and bias are 0.
          *reinterpret_cast<float2*>(dst + row * pd + col) =
              make_float2(lrelu(v0), lrelu(v1));
        }
      }
  }
}

template <bool LAST>
__device__ __forceinline__ void tc_layer_any(const TcParams& p, int l, const float* src,
                                             int ps, float* dst, int pd, float4* stages,
                                             float* landing, int& q, size_t row0,
                                             int rows_valid) {
  const int nt = p.layer[l].Np >> 3;
  if (nt > 16)
    tc_layer<8, LAST>(p, l, src, ps, dst, pd, stages, landing, q, row0, rows_valid);
  else if (nt > 8)
    tc_layer<4, LAST>(p, l, src, ps, dst, pd, stages, landing, q, row0, rows_valid);
  else if (nt > 4)
    tc_layer<2, LAST>(p, l, src, ps, dst, pd, stages, landing, q, row0, rows_valid);
  else
    tc_layer<1, LAST>(p, l, src, ps, dst, pd, stages, landing, q, row0, rows_valid);
}

// `p` is read in place from parameter space (`__grid_constant__`): the
// layers are indexed at run time, which would otherwise copy it to local
// memory.
__global__ void __launch_bounds__(kTcThreads, 1)
tc_kernel(const __grid_constant__ TcParams p) {
  extern __shared__ float4 smem4[];
  float4* stages = smem4;                                   // 2 x [kChunk / 2]
  float* landing = reinterpret_cast<float*>(smem4 + kChunk);
  float* biases = landing + kLandingFloats;                // [4][256]
  float* act_a = biases + 4 * kTcMaxN;                     // [64][pa]
  float* act_b = act_a + kTcRows * p.pa;                   // [64][pb]
  const size_t row0 = static_cast<size_t>(blockIdx.x) * kTcRows;
  const int rows_valid = min(kTcRows, static_cast<int>(p.n - row0));

  // x, zero-filled past the last row and in the padding columns, with the
  // first weight chunk; rows are not 16-byte aligned (133 floats), so one
  // float per copy, a warp per row.
  const int d0 = p.layer[0].K, kp0 = p.layer[0].Kp;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < kTcRows; r += kTcWarps)
    for (int c = lane; c < kp0; c += 32) {
      const bool valid = r < rows_valid && c < d0;
      cp_async4(act_a + r * p.pa + c, valid ? p.x + (row0 + r) * d0 + c : p.x, valid);
    }
  // The biases, zero-filled past N, so that the epilogues read them there.
  for (int l = 0; l < 4; ++l)
    for (int c = threadIdx.x; c < p.layer[l].Np; c += kTcThreads) {
      const bool valid = c < p.layer[l].N;
      cp_async4(biases + kTcMaxN * l + c, p.layer[l].b + (valid ? c : 0), valid);
    }
  issue_chunk(landing, p.layer[0], 0);
  cp_async_commit();

  int q = 0;
  float* src = act_a;
  float* dst = act_b;
  int ps = p.pa, pd = p.pb;
#pragma unroll 1
  for (int l = 0; l < 3; ++l) {
    tc_layer_any<false>(p, l, src, ps, dst, pd, stages, landing, q, row0, rows_valid);
    float* tmp = src; src = dst; dst = tmp;
    const int tp = ps; ps = pd; pd = tp;
  }
  tc_layer_any<true>(p, 3, src, ps, nullptr, 0, stages, landing, q, row0, rows_valid);
}

// ---------------------------------------------------------- simt_kernel

constexpr int kRowsPerWarp = 4;
constexpr int kColsPerLane = 4;

// dst[r][c] = act(sum_k src[r][k] * W[k][c] + b[c]) for the block's rows.
// Hidden layers (LAST = false) write lrelu into shared memory with row
// pitch N; the last layer writes final() to device memory, rows < rows_valid.
template <bool LAST>
__device__ __forceinline__ void dense_layer(const float* src, int K,
                                            const float* __restrict__ W,
                                            const float* __restrict__ bias,
                                            int N, float* dst, int rows_valid,
                                            int final_kind) {
  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * kRowsPerWarp;
  for (int c0 = 0; c0 < N; c0 += 32 * kColsPerLane) {
    int col[kColsPerLane];
    bool ok[kColsPerLane];
#pragma unroll
    for (int j = 0; j < kColsPerLane; ++j) {
      col[j] = c0 + lane + 32 * j;
      ok[j] = col[j] < N;
    }
    float acc[kRowsPerWarp][kColsPerLane];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j) acc[i][j] = 0.0f;

    for (int k = 0; k < K; ++k) {
      float a[kRowsPerWarp];
      float w[kColsPerLane];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) a[i] = src[(r0 + i) * K + k];
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j)
        w[j] = ok[j] ? __ldg(W + static_cast<size_t>(k) * N + col[j]) : 0.0f;
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
        for (int j = 0; j < kColsPerLane; ++j)
          acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }

#pragma unroll
    for (int j = 0; j < kColsPerLane; ++j) {
      if (!ok[j]) continue;
      const float b = __ldg(bias + col[j]);
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float v = acc[i][j] + b;
        if (LAST) {
          if (r0 + i < rows_valid)
            dst[static_cast<size_t>(r0 + i) * N + col[j]] =
                apply_final(v, final_kind);
        } else {
          dst[(r0 + i) * N + col[j]] = lrelu(v);
        }
      }
    }
  }
}

template <int TILE_M>
__global__ void __launch_bounds__(TILE_M / kRowsPerWarp * 32)
simt_kernel(const float* __restrict__ x, const float* __restrict__ w1,
            const float* __restrict__ b1, const float* __restrict__ w2,
            const float* __restrict__ b2, const float* __restrict__ w3,
            const float* __restrict__ b3, const float* __restrict__ w4,
            const float* __restrict__ b4, float* __restrict__ out, int n,
            int d0, int d1, int d2, int d3, int d4, int final_kind) {
  extern __shared__ float smem[];
  float* buf_a = smem;                          // x, then layer-2 output
  float* buf_b = smem + TILE_M * imax(d0, d2);  // layer-1, layer-3 output
  const size_t row0 = static_cast<size_t>(blockIdx.x) * TILE_M;
  const int rows = min(TILE_M, static_cast<int>(n - row0));

  const float* xt = x + row0 * d0;
  for (int idx = threadIdx.x; idx < TILE_M * d0; idx += blockDim.x)
    buf_a[idx] = idx < rows * d0 ? xt[idx] : 0.0f;
  __syncthreads();
  dense_layer<false>(buf_a, d0, w1, b1, d1, buf_b, rows, final_kind);
  __syncthreads();
  dense_layer<false>(buf_b, d1, w2, b2, d2, buf_a, rows, final_kind);
  __syncthreads();
  dense_layer<false>(buf_a, d2, w3, b3, d3, buf_b, rows, final_kind);
  __syncthreads();
  dense_layer<true>(buf_b, d3, w4, b4, d4, out + row0 * d4, rows, final_kind);
}

template <int TILE_M>
int simt_launch(const float* x, const float* w1, const float* b1, const float* w2,
                const float* b2, const float* w3, const float* b3, const float* w4,
                const float* b4, float* out, int n, int d0, int d1, int d2, int d3,
                int d4, int final_kind, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        simt_kernel<TILE_M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const unsigned grid = static_cast<unsigned>((n + TILE_M - 1) / TILE_M);
  simt_kernel<TILE_M><<<grid, TILE_M / kRowsPerWarp * 32, smem, stream>>>(
      x, w1, b1, w2, b2, w3, b3, w4, b4, out, n, d0, d1, d2, d3, d4, final_kind);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The tensor-core kernel; launches on `stream` and returns
// cudaGetLastError() (0 on success). Every layer at most 256 wide. The
// wrapper decides whether these widths fit and passes the layout
// (`kernels/fused_mlp.py::tc_layout`): the activation pitches and the
// shared memory, in bytes; a layout that does not hold the carve-up of
// `tc_kernel` is refused.
int fused_mlp4_tc_f32(const void* x, const void* w1, const void* b1, const void* w2,
                      const void* b2, const void* w3, const void* b3, const void* w4,
                      const void* b4, void* out, int n, int d0, int d1, int d2, int d3,
                      int d4, int final_kind, int pa, int pb, int smem_bytes,
                      void* stream) {
  if (n <= 0) return 0;
  if (final_kind < kSigmoid || final_kind > kNone)
    return static_cast<int>(cudaErrorInvalidValue);
  const int d[5] = {d0, d1, d2, d3, d4};
  const void* w[4] = {w1, w2, w3, w4};
  const void* b[4] = {b1, b2, b3, b4};
  TcParams p;
  for (int l = 0; l < 4; ++l) {
    if (d[l] < 1 || d[l + 1] < 1 || d[l + 1] > kTcMaxN)
      return static_cast<int>(cudaErrorInvalidValue);
    TcLayer& L = p.layer[l];
    L.w = static_cast<const float*>(w[l]);
    L.b = static_cast<const float*>(b[l]);
    L.K = d[l];
    L.N = d[l + 1];
    L.Kp = round8(L.K);
    L.Np = round8(L.N);
    const int kc = (kChunk / L.Np) & ~7;
    L.kc = kc < kMaxChunkRows ? kc : kMaxChunkRows;
    L.vec = L.N % 4 == 0 && (reinterpret_cast<uintptr_t>(L.w) & 15) == 0;
  }
  p.x = static_cast<const float*>(x);
  p.out = static_cast<float*>(out);
  p.n = n;
  p.final_kind = final_kind;
  p.pa = pa;
  p.pb = pb;
  if (pa % 8 != 4 || pb % 8 != 4 || pa < imax(p.layer[0].Kp, p.layer[2].Kp) ||
      pb < imax(p.layer[1].Kp, p.layer[3].Kp) ||
      static_cast<size_t>(smem_bytes) <
          sizeof(float) * (static_cast<size_t>(kFixedFloats) + kTcRows * (pa + pb)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = cudaFuncSetAttribute(
      tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned grid = static_cast<unsigned>((n + kTcRows - 1) / kTcRows);
  tc_kernel<<<grid, kTcThreads, static_cast<size_t>(smem_bytes),
              static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The SIMT kernel at `tile` rows per block (32, 16 or 8), which the wrapper
// picks (`kernels/fused_mlp.py::simt_tile_rows`); launches on `stream` and
// returns cudaGetLastError().
int fused_mlp4_simt_f32(const void* x, const void* w1, const void* b1,
                        const void* w2, const void* b2, const void* w3,
                        const void* b3, const void* w4, const void* b4, void* out,
                        int n, int d0, int d1, int d2, int d3, int d4,
                        int final_kind, int tile, void* stream) {
  if (n <= 0) return 0;
  if (final_kind < kSigmoid || final_kind > kNone)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * static_cast<size_t>(tile) *
                      (imax(d0, d2) + imax(d1, d3));
  auto s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  float* o = static_cast<float*>(out);
  switch (tile) {
    case 32:
      return simt_launch<32>(f(x), f(w1), f(b1), f(w2), f(b2), f(w3), f(b3), f(w4),
                             f(b4), o, n, d0, d1, d2, d3, d4, final_kind, smem, s);
    case 16:
      return simt_launch<16>(f(x), f(w1), f(b1), f(w2), f(b2), f(w3), f(b3), f(w4),
                             f(b4), o, n, d0, d1, d2, d3, d4, final_kind, smem, s);
    case 8:
      return simt_launch<8>(f(x), f(w1), f(b1), f(w2), f(b2), f(w3), f(b3), f(w4),
                            f(b4), o, n, d0, d1, d2, d3, d4, final_kind, smem, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* fused_mlp4_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
