// Fused 4-layer MLP forward for the generator's serving path, float32.
//
//   y = final(L4(lrelu(L3(lrelu(L2(lrelu(L1 x)))))))
//
// with LeakyReLU slope 0.2, Li(h) = h Wi + bi on [in, out] weights (eval
// BatchNorm already folded into W1-W3 by the caller), and final one of
// sigmoid, tanh or none. Replaces the Pallas TPU kernel
// `cvaegan_tpu/kernels/fused_mlp.py::_kernel`.
//
// Bound on an H100 SXM: at the serving shape 133->256->128->64->30 and
// 8192 rows the work is 8192 * 2 * (133*256 + 256*128 + 128*64 + 64*30)
// ~ 1.26 GFLOP, about 19 us at the 67 TFLOP/s float32 (non-tensor-core)
// rate, against ~5.6 MB moved, about 1.7 us at 3.35 TB/s: the kernel is
// bound by float32 arithmetic. It keeps exact float32 FMA accumulation
// (no TF32, no tensor cores), so it matches the plain PyTorch version to
// float32 rounding.
//
// Design. The TPU kernel pins all ~300 KB of weights in VMEM and walks
// 512-row tiles; a Hopper block has at most 227 KB of shared memory, so
// here:
//   * one block per tile of TILE_M rows (32, or 16/8 for wide inputs);
//     the ragged last tile is zero-filled on load and masked on store,
//     never padded in device memory;
//   * the activations ping-pong between two shared-memory buffers sized
//     from the runtime layer widths, so no intermediate reaches device
//     memory; above 48 KB the buffers are dynamic shared memory enabled
//     with cudaFuncSetAttribute;
//   * the weights are read from device memory through the read-only
//     cache; at ~300 KB they stay resident in the 50 MB L2 across blocks;
//   * each warp owns 4 rows of the tile and each lane 4 output columns
//     (strided by 32, so a warp's weight loads are one coalesced 128-byte
//     row) per pass: 16 register accumulators per thread, fed by 4
//     shared-memory broadcasts and 4 weight loads for every k.
// Making it fast (wgmma, TMA, bf16) is later work with its own tolerance.

#include <cuda_runtime.h>

namespace {

constexpr int kRowsPerWarp = 4;
constexpr int kColsPerLane = 4;
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
          dst[(r0 + i) * N + col[j]] = v >= 0.0f ? v : kSlope * v;
        }
      }
    }
  }
}

template <int TILE_M>
__global__ void __launch_bounds__(TILE_M / kRowsPerWarp * 32)
fused_mlp4_kernel(const float* __restrict__ x, const float* __restrict__ w1,
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
int launch(const float* x, const float* w1, const float* b1, const float* w2,
           const float* b2, const float* w3, const float* b3, const float* w4,
           const float* b4, float* out, int n, int d0, int d1, int d2, int d3,
           int d4, int final_kind, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fused_mlp4_kernel<TILE_M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const unsigned grid = static_cast<unsigned>((n + TILE_M - 1) / TILE_M);
  fused_mlp4_kernel<TILE_M>
      <<<grid, TILE_M / kRowsPerWarp * 32, smem, stream>>>(
          x, w1, b1, w2, b2, w3, b3, w4, b4, out, n, d0, d1, d2, d3, d4,
          final_kind);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Rows per block that the kernel would use for these widths, or 0 if
// even 8 rows do not fit in one block's shared memory.
int fused_mlp4_tile_rows(int d0, int d1, int d2, int d3) {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  const size_t per_row = sizeof(float) * static_cast<size_t>(
      imax(d0, d2) + imax(d1, d3));
  for (int tile = 32; tile >= 8; tile /= 2)
    if (tile * per_row <= static_cast<size_t>(optin)) return tile;
  return 0;
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).
int fused_mlp4_f32(const void* x, const void* w1, const void* b1,
                   const void* w2, const void* b2, const void* w3,
                   const void* b3, const void* w4, const void* b4, void* out,
                   int n, int d0, int d1, int d2, int d3, int d4,
                   int final_kind, void* stream) {
  if (n <= 0) return 0;
  if (final_kind < kSigmoid || final_kind > kNone)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tile = fused_mlp4_tile_rows(d0, d1, d2, d3);
  const size_t smem = sizeof(float) * static_cast<size_t>(tile) *
                      (imax(d0, d2) + imax(d1, d3));
  auto s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  float* o = static_cast<float*>(out);
  switch (tile) {
    case 32:
      return launch<32>(f(x), f(w1), f(b1), f(w2), f(b2), f(w3), f(b3), f(w4),
                        f(b4), o, n, d0, d1, d2, d3, d4, final_kind, smem, s);
    case 16:
      return launch<16>(f(x), f(w1), f(b1), f(w2), f(b2), f(w3), f(b3), f(w4),
                        f(b4), o, n, d0, d1, d2, d3, d4, final_kind, smem, s);
    case 8:
      return launch<8>(f(x), f(w1), f(b1), f(w2), f(b2), f(w3), f(b3), f(w4),
                       f(b4), o, n, d0, d1, d2, d3, d4, final_kind, smem, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* fused_mlp4_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
