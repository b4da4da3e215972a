// Block-gather backward for a block-sketched linear site, for Hopper
// (sm_90a), float32 or bfloat16 inputs with float32 accumulation: the fused
// kernel and, by a role mask on the same kernel, the unfused dX and dW
// kernels.
//
// Replaces three Pallas TPU kernels of repro/kernels/sketch_matmul.py. With
// G [N, n], kept block ids idx [rb] (block width `block`), scales s [rb],
// W [n, d] and X [N, d]:
//   * block_gather_matmul_fused (roles dX | dW) computes
//       dX      = sum_k s_k G[:, blk_k] W[blk_k, :]          [N, d]         (G's type)
//       dWc[k]  = s_k G[:, blk_k]^T X                        [rb, block, d] (G's type)
//       db[k]   = s_k sum_rows G[:, blk_k]                   [rb, block]    float32
//       sc[k]   = sum_rows |G[:, blk_k]|  (mode 0, "l1")                    float32
//                 sum_rows G[:, blk_k]^2  (mode 1, "l2")     (optional)
//   * block_gather_matmul (role dX alone) computes dX;
//   * block_gather_matmul_dw (role dW alone) computes dWc.
// The roles are in block_roles.cuh. The unfused launches run the same role
// code as the fused one, so their dX and dWc equal the fused kernel's bit for
// bit, which is the TPU kernels' own contract (sketch_matmul.py:230-233).
//
// What bounds it: 4 N (rb block) d floating-point operations against roughly
// 4 (N rb block + 2 rb block d + 2 N d) bytes, so at the path's shapes it is
// bound by operations (float32 outside the tensor cores, 67 TFLOP/s on an
// H100 SXM).
//
// Design. The TPU kernel walks a sequential grid and keeps the whole
// [rb*block, d] dW accumulator resident in VMEM; Hopper blocks run in
// parallel and in no order, so one launch carries two block roles and no
// block ever adds into another's output: dX blocks own a tile of dX and loop
// over the kept blocks; dW blocks own a tile of one kept block's dWc and loop
// over all N rows, reducing db and the raw scores of their columns on the
// way. G's kept blocks are therefore read twice by the fused launch, once by
// each role, where the TPU kernel reads them once; the unfused launches read
// them once each, as the TPU's unfused kernels do.

#include "block_roles.cuh"

namespace {

using namespace roles;

constexpr int ROLE_DX = 1;
constexpr int ROLE_DW = 2;

template <typename T>
__global__ void __launch_bounds__(THREADS) bgm_kernel(const Args<T> a, int role_mask) {
  __shared__ Smem sm;
  int b = blockIdx.x;
  if (role_mask & ROLE_DX) {
    const int nx = dx_blocks(a.N, a.d);
    if (b < nx) {
      dx_role(sm, a, b);
      return;
    }
    b -= nx;
  }
  dw_role(sm, a, b);
}

template <typename T>
int launch(int role_mask, const void* G, const void* idx, const void* scales, const void* W,
           const void* X, void* dX, void* dWc, void* db, void* kept_scores, int N, int n, int d,
           int rb, int block, int mode, cudaStream_t s) {
  const Args<T> a{static_cast<const T*>(G), static_cast<const int*>(idx),
                  static_cast<const float*>(scales), static_cast<const T*>(W),
                  static_cast<const T*>(X), static_cast<T*>(dX), static_cast<T*>(dWc),
                  static_cast<float*>(db), static_cast<float*>(kept_scores), false,
                  N, n, d, rb, block, mode};
  long long blocks = 0;
  if (role_mask & ROLE_DX) blocks += dx_blocks(N, d);
  if (role_mask & ROLE_DW) blocks += (long long)dw_blocks(d, rb, block);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  bgm_kernel<T><<<dim3((unsigned)blocks), THREADS, 0, s>>>(a, role_mask);
  return (int)cudaGetLastError();
}

}  // namespace

// role_mask: 1 = dX alone (block_gather_matmul), 2 = dW alone
// (block_gather_matmul_dw), 3 = both (block_gather_matmul_fused). dtype:
// 0 = float32, 1 = bfloat16. mode: 0 = "l1", 1 = "l2". The outputs a role
// mask does not produce, db with the dW role alone and kept_scores always,
// may be null. Launches on `stream` and returns cudaGetLastError() (0 = ok).
extern "C" int bgm_launch(int role_mask, int dtype, const void* G, const void* idx,
                          const void* scales, const void* W, const void* X, void* dX,
                          void* dWc, void* db, void* kept_scores, int N, int n, int d, int rb,
                          int block, int mode, void* stream) {
  if (int err = check_shapes(N, n, d, rb, block, mode)) return err;
  if (role_mask < 1 || role_mask > 3 ||
      ((role_mask & ROLE_DX) && (W == nullptr || dX == nullptr)) ||
      ((role_mask & ROLE_DW) && (X == nullptr || dWc == nullptr)) ||
      (role_mask == ROLE_DX && (db != nullptr || kept_scores != nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(role_mask, G, idx, scales, W, X, dX, dWc, db, kept_scores, N, n, d,
                         rb, block, mode, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(role_mask, G, idx, scales, W, X, dX, dWc, db, kept_scores, N,
                                 n, d, rb, block, mode, s);
  return (int)cudaErrorInvalidValue;
}
