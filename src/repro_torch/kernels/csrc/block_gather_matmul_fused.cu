// Block-gather backward for a block-sketched linear site, for Hopper
// (sm_90a), float32 or bfloat16 inputs with float32 accumulation: the fused
// kernel and, by a role mask on the same kernel, the unfused dX and dW
// kernels.
//
// Replaces three Pallas TPU kernels of repro/kernels/sketch_matmul.py. With
// G [N, n], kept block ids idx [rb] (block width `block`), scales s [rb],
// W [n, d] and X [N, d]:
//   * block_gather_matmul_fused (roles dW | dX) computes
//       dX      = sum_k s_k G[:, blk_k] W[blk_k, :]          [N, d]         (G's type)
//       dWc[k]  = s_k G[:, blk_k]^T X                        [rb, block, d] (G's type)
//       db[k]   = s_k sum_rows G[:, blk_k]                   [rb, block]    float32
//       sc[k]   = sum_rows |G[:, blk_k]|  (mode 0, "l1")                    float32
//                 sum_rows G[:, blk_k]^2  (mode 1, "l2")     (optional)
//   * block_gather_matmul (role dX alone) computes dX;
//   * block_gather_matmul_dw (role dW alone) computes dWc.
// The roles are the pipelined dW and dX tiles of block_roles.cuh, which the
// streaming kernel (block_stream_matmul_fused.cu) runs too. So the unfused
// launches' dX and dWc equal the fused kernel's bit for bit, which is the TPU
// kernels' own contract (sketch_matmul.py:230-233), and the fused kernel's
// dX, dWc, db and kept scores equal the streaming kernel's.
//
// What bounds it: 4 N (rb block) d floating-point operations against roughly
// 4 (N rb block + 2 rb block d + 2 N d) bytes, so at the path's shapes it is
// bound by operations (float32 outside the tensor cores, 67 TFLOP/s on an
// H100 SXM). In practice the dW chain sets the time: each dWc output is one
// chain over all N rows in one thread.
//
// Design. The TPU kernel walks a sequential grid and keeps the whole
// [rb*block, d] dW accumulator resident in VMEM; Hopper blocks run in
// parallel and in no order, so one launch of 128-thread blocks carries two
// block roles and no block ever adds into another's output. dW blocks come
// first in the grid, since each walks all N rows (96 of them at n 768, d 768,
// rb 1): a 32 x 32 tile of one kept block's dWc, whose first d-tile also
// reduces db and, on request, the kept scores ([rb, block], indexed by kept
// block) on the way. Then dX blocks: a 64 x 32 tile of dX over the kept
// blocks' columns. Both stream G (only its kept blocks), X and W through a
// cp.async ring: 64-row dW stages, 3 deep, as in the streaming kernel, or,
// where the fused launch has at least two dW blocks per SM, 32-row stages,
// 4 deep, in half the shared memory (same bits; see launch()). G's kept
// blocks are therefore read by both roles in the fused launch, where the TPU
// kernel reads them once; the unfused launches read them once each, as the
// TPU's unfused kernels do.

#include "block_roles.cuh"

namespace {

using namespace roles;

constexpr int ROLE_DX = 1;
constexpr int ROLE_DW = 2;

template <typename T, int RS, int NS>
__global__ void __launch_bounds__(THREADS) bgm_kernel(const Args<T> a, int vec, int role_mask) {
  extern __shared__ __align__(16) unsigned char smem[];
  int b = blockIdx.x;
  if (role_mask & ROLE_DW) {
    const int nw = n_dw(a.d, a.rb, a.block);
    if (b < nw) {
      const DwTile t = dw_tile_of(a, b);
      dw_tile<RS, NS>(smem, a, vec, t, (size_t)t.k * a.block + t.row0);  // scores: [rb, block]
      return;
    }
    b -= nw;
  }
  dx_block<NS>(smem, a, vec, b);
}

// One launch with RS rows per dW stage and an NS-deep ring; a launch without
// the dW role takes only the dX role's shared memory, so more blocks fit.
template <typename T, int RS, int NS>
int launch_as(const Args<T>& a, int vec, int role_mask, unsigned blocks, cudaStream_t s) {
  constexpr size_t most = smem_bytes<T, RS, NS>();
  const size_t smem = (role_mask & ROLE_DW) ? most : DxSmem<T, NS>::bytes;
  static int allowed_on = -1;
  if (cudaError_t err = allow_smem((const void*)bgm_kernel<T, RS, NS>, most, allowed_on))
    return (int)err;
  bgm_kernel<T, RS, NS><<<dim3(blocks), THREADS, smem, s>>>(a, vec, role_mask);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(int role_mask, const void* G, const void* idx, const void* scales, const void* W,
           const void* X, void* dX, void* dWc, void* db, void* kept_scores, int N, int n, int d,
           int rb, int block, int mode, cudaStream_t s) {
  const Args<T> a{static_cast<const T*>(G), static_cast<const int*>(idx),
                  static_cast<const float*>(scales), static_cast<const T*>(W),
                  static_cast<const T*>(X), static_cast<T*>(dX), static_cast<T*>(dWc),
                  static_cast<float*>(db), static_cast<float*>(kept_scores), N, n, d, rb, block,
                  mode};
  const int vec = vec_bits<T>(G, X, W, d);
  const long long nw = n_dw(d, rb, block);
  long long blocks = 0;
  if (role_mask & ROLE_DW) blocks += nw;
  if (role_mask & ROLE_DX) blocks += n_dx(N, d);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  // The stages change no output's bits. Where the fused launch's dW blocks
  // fill two per SM, it is bound by the SMs' throughput, and 32-row stages in
  // a 4-deep ring (half the shared memory) let more dX blocks share an SM
  // with them; below that each dW block's own walk over N sets the time, and
  // the streaming kernel's 64-row stages serve it best (measured on an H100
  // at the path's shapes, PERF.md).
  if (role_mask == (ROLE_DX | ROLE_DW) && nw >= 2LL * sms)
    return launch_as<T, 32, 4>(a, vec, role_mask, (unsigned)blocks, s);
  return launch_as<T, R, STAGES>(a, vec, role_mask, (unsigned)blocks, s);
}

}  // namespace

// role_mask: 1 = dX alone (block_gather_matmul), 2 = dW alone
// (block_gather_matmul_dw), 3 = both (block_gather_matmul_fused). dtype:
// 0 = float32, 1 = bfloat16. mode: 0 = "l1", 1 = "l2". The outputs a role
// mask does not produce, db with the dW role alone and kept_scores always,
// may be null; the dW role alone writes no db. Launches on `stream` and
// returns cudaGetLastError() (0 = ok).
extern "C" int bgm_launch(int role_mask, int dtype, const void* G, const void* idx,
                          const void* scales, const void* W, const void* X, void* dX,
                          void* dWc, void* db, void* kept_scores, int N, int n, int d, int rb,
                          int block, int mode, void* stream) {
  if (int err = check_shapes(N, n, d, rb, block, mode)) return err;
  if (role_mask < 1 || role_mask > 3 ||
      ((role_mask & ROLE_DX) && (W == nullptr || dX == nullptr)) ||
      ((role_mask & ROLE_DW) && (X == nullptr || dWc == nullptr)) ||
      (role_mask != 3 && (db != nullptr || kept_scores != nullptr)))
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
