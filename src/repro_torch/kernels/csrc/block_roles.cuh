// Block roles of the block-gather backward kernels for Hopper (sm_90a):
// block_gather_matmul_fused.cu runs dx_role and dw_role, for the fused kernel
// and the unfused dX / dW pair. The streaming kernel
// (block_stream_matmul_fused.cu) runs roles of its own, which keep these
// roles' accumulation orders, so its dX, dWc, db and kept scores are these
// roles' bit for bit; it uses only this header's Args, kept_block, type
// conversions, add_score and check_shapes.
//
// With G [N, n], kept block ids idx [rb] (block width `block`, ascending),
// scales s [rb], W [n, d] and X [N, d], float32 or bfloat16 inputs with
// float32 accumulation, a launch is a grid of 256-thread blocks, each of which
// takes one role and owns its own outputs (no block adds into another's, no
// atomics, deterministic):
//   * dx_role: one 64x64 tile of dX = sum_k s_k G[:, blk_k] W[blk_k, :],
//     looping over the kept blocks in ascending order;
//   * dw_role: one 64x64 tile of dWc[k] = s_k G[:, blk_k]^T X, looping over
//     all N rows; the blocks of the first d-tile also reduce
//     db[k] = s_k sum_rows G[:, blk_k] and, on request, the raw column
//     reduction sum_rows |G| ("l1", mode 0) or sum_rows G^2 ("l2", mode 1)
//     of their 64 columns in the same loop.
// The G tile is scaled by s_k before both products and db; the raw scores use
// the unscaled tile. Every launch of these roles computes dX, dWc and db with
// the same code in the same order, and the scaling and the
// reductions use explicitly rounded intrinsics (__fmul_rn, __fadd_rn,
// __fmaf_rn, fmaf), which the compiler never contracts or reorders, so the
// kernels agree bit for bit for the same keeps. Ragged edges (N, d not
// multiples of 64) are masked; nothing is padded.
//
// This is a plain shared-memory tiled FFMA design: no wgmma, no TMA, no
// pipelining. float32 runs in full float32, not TF32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace roles {

constexpr int TM = 64;   // tile rows (dX: rows of N; dW: columns of the block)
constexpr int TN = 64;   // tile columns (columns of d)
constexpr int TK = 16;   // depth of one shared-memory step
constexpr int THREADS = 256;
constexpr int PARTS = THREADS / TM;  // threads that share one column

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// one raw column-reduction term: |v| ("l1", mode 0) or v^2 ("l2", mode 1)
__device__ __forceinline__ float add_score(float acc, float v, int mode) {
  return mode == 0 ? __fadd_rn(acc, fabsf(v)) : __fmaf_rn(v, v, acc);
}

struct Smem {
  float As[TK][TM];
  float Bs[TK][TN];
  float red[2][PARTS][TM];
};

// acc[r][c] += sum_kk As[kk][ty + 16 r] * Bs[kk][tx + 16 c]
__device__ __forceinline__ void tile_fma(const Smem& sm, int ty, int tx, float (&acc)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < TK; ++kk) {
    float a[4], b[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) a[r] = sm.As[kk][ty + 16 * r];
#pragma unroll
    for (int c = 0; c < 4; ++c) b[c] = sm.Bs[kk][tx + 16 * c];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
  }
}

__host__ __device__ inline int d_tiles(int d) { return (d + TN - 1) / TN; }
__host__ __device__ inline int dx_blocks(int N, int d) { return ((N + TM - 1) / TM) * d_tiles(d); }
__host__ __device__ inline int dw_blocks(int d, int rb, int block) {
  return rb * (block / TM) * d_tiles(d);
}

// The arguments every role reads. Output pointers a launch does not produce
// are null.
template <typename T>
struct Args {
  const T* G;
  const int* idx;
  const float* scales;
  const T* W;
  const T* X;
  T* dX;
  T* dWc;
  float* db;
  float* scores;
  bool scores_full;  // scores is [n] (column-indexed), else [rb, block] (kept)
  int N, n, d, rb, block, mode;
};

template <typename T>
__device__ __forceinline__ int kept_block(const Args<T>& a, int k) {
  const int blk = a.idx[k];
  if (blk < 0 || blk >= a.n / a.block) __trap();  // a kept block outside G
  return blk;
}

// ---- dX role: one [TM, TN] tile of dX, loop over the kept blocks ----
template <typename T>
__device__ __forceinline__ void dx_role(Smem& sm, const Args<T>& a, int b) {
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int row0 = (b / d_tiles(a.d)) * TM;
  const int col0 = (b % d_tiles(a.d)) * TN;
  float acc[4][4] = {};
  for (int k = 0; k < a.rb; ++k) {
    const size_t gcol0 = (size_t)kept_block(a, k) * a.block;
    const float s = a.scales[k];
    for (int c0 = 0; c0 < a.block; c0 += TK) {
#pragma unroll
      for (int l = 0; l < (TM * TK) / THREADS; ++l) {
        const int e = tid + l * THREADS;
        const int i = e / TK, kk = e % TK;
        const int row = row0 + i;
        sm.As[kk][i] = row < a.N ? __fmul_rn(to_f32(a.G[(size_t)row * a.n + gcol0 + c0 + kk]), s)
                                 : 0.f;
      }
#pragma unroll
      for (int l = 0; l < (TK * TN) / THREADS; ++l) {
        const int e = tid + l * THREADS;
        const int kk = e / TN, j = e % TN;
        const int col = col0 + j;
        sm.Bs[kk][j] = col < a.d ? to_f32(a.W[(gcol0 + c0 + kk) * a.d + col]) : 0.f;
      }
      __syncthreads();
      tile_fma(sm, ty, tx, acc);
      __syncthreads();
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = row0 + ty + 16 * r;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = col0 + tx + 16 * c;
      if (row < a.N && col < a.d) a.dX[(size_t)row * a.d + col] = from_f32<T>(acc[r][c]);
    }
  }
}

// ---- dW role: one [TM, TN] tile of dWc[k], loop over all N rows ----
template <typename T>
__device__ __forceinline__ void dw_role(Smem& sm, const Args<T>& a, int b) {
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int c_tiles = a.block / TM;
  const int k = b / (c_tiles * d_tiles(a.d));
  const int rem = b % (c_tiles * d_tiles(a.d));
  const int ct = rem / d_tiles(a.d);
  const int col0 = (rem % d_tiles(a.d)) * TN;
  const int blk = kept_block(a, k);
  const size_t gcol0 = (size_t)blk * a.block + ct * TM;
  const float s = a.scales[k];
  float acc[4][4] = {};
  // every A tile load below gives this thread the same column, tid % TM, so
  // it can reduce db and the raw scores of that column in registers
  float db_acc = 0.f, sc_acc = 0.f;
  for (int i0 = 0; i0 < a.N; i0 += TK) {
#pragma unroll
    for (int l = 0; l < (TK * TM) / THREADS; ++l) {
      const int e = tid + l * THREADS;
      const int i = e / TM, c = e % TM;
      const int row = i0 + i;
      const float raw = row < a.N ? to_f32(a.G[(size_t)row * a.n + gcol0 + c]) : 0.f;
      const float v = __fmul_rn(raw, s);
      sm.As[i][c] = v;
      db_acc = __fadd_rn(db_acc, v);
      sc_acc = add_score(sc_acc, raw, a.mode);
    }
#pragma unroll
    for (int l = 0; l < (TK * TN) / THREADS; ++l) {
      const int e = tid + l * THREADS;
      const int i = e / TN, j = e % TN;
      const int row = i0 + i, col = col0 + j;
      sm.Bs[i][j] = (row < a.N && col < a.d) ? to_f32(a.X[(size_t)row * a.d + col]) : 0.f;
    }
    __syncthreads();
    tile_fma(sm, ty, tx, acc);
    __syncthreads();
  }
  T* out = a.dWc + (size_t)k * a.block * a.d;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int m = ct * TM + ty + 16 * r;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = col0 + tx + 16 * c;
      if (col < a.d) out[(size_t)m * a.d + col] = from_f32<T>(acc[r][c]);
    }
  }
  // block-uniform: the first d-tile's blocks finish db and the kept scores
  if (col0 == 0 && (a.db != nullptr || a.scores != nullptr)) {
    sm.red[0][tid / TM][tid % TM] = db_acc;
    sm.red[1][tid / TM][tid % TM] = sc_acc;
    __syncthreads();
    if (tid < TM) {
      float q0 = 0.f, q1 = 0.f;
#pragma unroll
      for (int p = 0; p < PARTS; ++p) {  // fixed order: deterministic
        q0 = __fadd_rn(q0, sm.red[0][p][tid]);
        q1 = __fadd_rn(q1, sm.red[1][p][tid]);
      }
      if (a.db != nullptr) a.db[(size_t)k * a.block + ct * TM + tid] = q0;
      if (a.scores != nullptr) {
        const size_t o = a.scores_full ? (size_t)blk * a.block : (size_t)k * a.block;
        a.scores[o + ct * TM + tid] = q1;
      }
    }
  }
}

// Shape checks shared by the launchers (0 = ok).
inline int check_shapes(int N, int n, int d, int rb, int block, int mode) {
  if (N <= 0 || n <= 0 || d <= 0 || rb <= 0 || block <= 0 || block % TM != 0 ||
      block % TK != 0 || n % block != 0 || (mode != 0 && mode != 1))
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace roles
