// Fused block-gather backward for a block-sketched linear site, for Hopper
// (sm_90a), float32 or bfloat16 inputs with float32 accumulation.
//
// Replaces the Pallas TPU kernel
// repro/kernels/sketch_matmul.py::block_gather_matmul_fused. With G [N, n],
// kept block ids idx [rb] (block width `block`), scales s [rb], W [n, d] and
// X [N, d] it computes
//     dX      = sum_k s_k G[:, blk_k] W[blk_k, :]          [N, d]         (G's type)
//     dWc[k]  = s_k G[:, blk_k]^T X                        [rb, block, d] (G's type)
//     db[k]   = s_k sum_rows G[:, blk_k]                   [rb, block]    float32
//     sc[k]   = sum_rows |G[:, blk_k]|  (mode 0, "l1")                    float32
//               sum_rows G[:, blk_k]^2  (mode 1, "l2")     (optional)
// The G tile is scaled by s_k before both products and db; the raw scores
// use the unscaled tile.
//
// What bounds it: 4 N (rb block) d floating-point operations against roughly
// 4 (N rb block + 2 rb block d + 2 N d) bytes, so at the path's shapes it is
// bound by operations (float32 outside the tensor cores, 67 TFLOP/s on an
// H100 SXM). This first version is a plain shared-memory tiled FFMA kernel:
// no wgmma, no TMA, no pipelining. float32 runs in full float32, not TF32.
//
// Design. The TPU kernel walks a sequential grid and keeps the whole
// [rb*block, d] dW accumulator resident in VMEM; Hopper blocks run in
// parallel and in no order, so one launch carries two block roles and no
// block ever adds into another's output (deterministic, no atomics):
//   * dX blocks own a 64x64 tile of dX and loop over the kept blocks,
//     reading idx and s themselves;
//   * dW blocks own a 64x64 tile of one kept block's dWc and loop over all N
//     rows; the blocks of the first d-tile also reduce db and the raw scores
//     of their 64 columns in the same loop.
// Kept blocks of G are therefore read twice, once by each role, where the
// TPU kernel reads them once. Ragged edges (N, d not multiples of 64) are
// masked in the kernel; nothing is padded.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int TM = 64;   // tile rows (dX: rows of N; dW: columns of the block)
constexpr int TN = 64;   // tile columns (columns of d)
constexpr int TK = 16;   // depth of one shared-memory step
constexpr int THREADS = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// acc[r][c] += sum_kk As[kk][ty + 16 r] * Bs[kk][tx + 16 c]
__device__ __forceinline__ void tile_fma(const float (&As)[TK][TM], const float (&Bs)[TK][TN],
                                         int ty, int tx, float (&acc)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < TK; ++kk) {
    float a[4], b[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) a[r] = As[kk][ty + 16 * r];
#pragma unroll
    for (int c = 0; c < 4; ++c) b[c] = Bs[kk][tx + 16 * c];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
bgm_fused_kernel(const T* __restrict__ G, const int* __restrict__ idx,
                 const float* __restrict__ scales, const T* __restrict__ W,
                 const T* __restrict__ X, T* __restrict__ dX, T* __restrict__ dWc,
                 float* __restrict__ db, float* __restrict__ kept_scores,
                 int N, int n, int d, int rb, int block, int mode) {
  __shared__ float As[TK][TM];
  __shared__ float Bs[TK][TN];
  __shared__ float red[2][THREADS / TM][TM];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int nb = n / block;
  const int d_tiles = (d + TN - 1) / TN;
  const int dx_blocks = ((N + TM - 1) / TM) * d_tiles;
  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

  int b = blockIdx.x;
  if (b < dx_blocks) {
    // ---- dX role: one [TM, TN] tile of dX, loop over the kept blocks ----
    const int row0 = (b / d_tiles) * TM;
    const int col0 = (b % d_tiles) * TN;
    for (int k = 0; k < rb; ++k) {
      const int blk = idx[k];
      if (blk < 0 || blk >= nb) __trap();  // a kept block outside G
      const size_t gcol0 = (size_t)blk * block;
      const float s = scales[k];
      for (int c0 = 0; c0 < block; c0 += TK) {
#pragma unroll
        for (int l = 0; l < (TM * TK) / THREADS; ++l) {
          const int e = tid + l * THREADS;
          const int i = e / TK, kk = e % TK;
          const int row = row0 + i;
          As[kk][i] = row < N ? to_f32(G[(size_t)row * n + gcol0 + c0 + kk]) * s : 0.f;
        }
#pragma unroll
        for (int l = 0; l < (TK * TN) / THREADS; ++l) {
          const int e = tid + l * THREADS;
          const int kk = e / TN, j = e % TN;
          const int col = col0 + j;
          Bs[kk][j] = col < d ? to_f32(W[(gcol0 + c0 + kk) * d + col]) : 0.f;
        }
        __syncthreads();
        tile_fma(As, Bs, ty, tx, acc);
        __syncthreads();
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = row0 + ty + 16 * r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = col0 + tx + 16 * c;
        if (row < N && col < d) dX[(size_t)row * d + col] = from_f32<T>(acc[r][c]);
      }
    }
    return;
  }

  // ---- dW role: one [TM, TN] tile of dWc[k], loop over all N rows ----
  b -= dx_blocks;
  const int c_tiles = block / TM;
  const int k = b / (c_tiles * d_tiles);
  const int rem = b % (c_tiles * d_tiles);
  const int ct = rem / d_tiles;
  const int col0 = (rem % d_tiles) * TN;
  const bool first_d_tile = col0 == 0;  // block-uniform
  const int blk = idx[k];
  if (blk < 0 || blk >= nb) __trap();
  const size_t gcol0 = (size_t)blk * block + ct * TM;
  const float s = scales[k];
  // every A tile load below gives this thread the same column, tid % TM,
  // so it can reduce db and the raw scores of that column in registers
  float db_acc = 0.f, sc_acc = 0.f;
  for (int i0 = 0; i0 < N; i0 += TK) {
#pragma unroll
    for (int l = 0; l < (TK * TM) / THREADS; ++l) {
      const int e = tid + l * THREADS;
      const int i = e / TM, c = e % TM;
      const int row = i0 + i;
      const float raw = row < N ? to_f32(G[(size_t)row * n + gcol0 + c]) : 0.f;
      const float v = raw * s;
      As[i][c] = v;
      db_acc += v;
      sc_acc += mode == 0 ? fabsf(raw) : raw * raw;
    }
#pragma unroll
    for (int l = 0; l < (TK * TN) / THREADS; ++l) {
      const int e = tid + l * THREADS;
      const int i = e / TN, j = e % TN;
      const int row = i0 + i, col = col0 + j;
      Bs[i][j] = (row < N && col < d) ? to_f32(X[(size_t)row * d + col]) : 0.f;
    }
    __syncthreads();
    tile_fma(As, Bs, ty, tx, acc);
    __syncthreads();
  }
  T* out = dWc + (size_t)k * block * d;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int m = ct * TM + ty + 16 * r;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = col0 + tx + 16 * c;
      if (col < d) out[(size_t)m * d + col] = from_f32<T>(acc[r][c]);
    }
  }
  if (first_d_tile) {
    red[0][tid / TM][tid % TM] = db_acc;
    red[1][tid / TM][tid % TM] = sc_acc;
    __syncthreads();
    if (tid < TM) {
      float a = 0.f, q = 0.f;
#pragma unroll
      for (int p = 0; p < THREADS / TM; ++p) {  // fixed order: deterministic
        a += red[0][p][tid];
        q += red[1][p][tid];
      }
      const size_t o = (size_t)k * block + ct * TM + tid;
      db[o] = a;
      if (kept_scores != nullptr) kept_scores[o] = q;
    }
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. mode: 0 = "l1", 1 = "l2". kept_scores
// may be null. Launches on `stream` and returns cudaGetLastError() (0 = ok).
extern "C" int bgm_fused_launch(int dtype, const void* G, const void* idx,
                                const void* scales, const void* W, const void* X,
                                void* dX, void* dWc, void* db, void* kept_scores,
                                int N, int n, int d, int rb, int block, int mode,
                                void* stream) {
  if (N <= 0 || n <= 0 || d <= 0 || rb <= 0 || block <= 0 || block % TM != 0 ||
      block % TK != 0 || n % block != 0 || (mode != 0 && mode != 1))
    return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)((N + TM - 1) / TM) * ((d + TN - 1) / TN) +
                           (long long)rb * (block / TM) * ((d + TN - 1) / TN);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)blocks);
  if (dtype == 0) {
    bgm_fused_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(G), static_cast<const int*>(idx),
        static_cast<const float*>(scales), static_cast<const float*>(W),
        static_cast<const float*>(X), static_cast<float*>(dX), static_cast<float*>(dWc),
        static_cast<float*>(db), static_cast<float*>(kept_scores), N, n, d, rb, block, mode);
  } else if (dtype == 1) {
    bgm_fused_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(G), static_cast<const int*>(idx),
        static_cast<const float*>(scales), static_cast<const __nv_bfloat16*>(W),
        static_cast<const __nv_bfloat16*>(X), static_cast<__nv_bfloat16*>(dX),
        static_cast<__nv_bfloat16*>(dWc), static_cast<float*>(db),
        static_cast<float*>(kept_scores), N, n, d, rb, block, mode);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
