// Streaming one-pass backward for a block-sketched linear site, for Hopper
// (sm_90a), float32 or bfloat16 inputs with float32 accumulation.
//
// Replaces the Pallas TPU kernel
// repro/kernels/sketch_matmul.py::block_stream_matmul_fused. With G [N, n],
// the kept block ids idx [rb] (block width `block`, ascending) and scales
// s [rb] sampled from the previous step's carried scores, W [n, d] and
// X [N, d], it computes
//     dX        = sum_k s_k G[:, blk_k] W[blk_k, :]        [N, d]         (G's type)
//     dWc[k]    = s_k G[:, blk_k]^T X                      [rb, block, d] (G's type)
//     db[k]     = s_k sum_rows G[:, blk_k]                 [rb, block]    float32
//     scores[j] = sum_rows |G[:, j]|  (mode 0, "l1")       [n]            float32
//                 sum_rows G[:, j]^2  (mode 1, "l2")
// for EVERY column j, kept or dropped: the onepass estimator's full score
// refresh, so no separate score pass over G is needed.
//
// What bounds it: the dX and dW products, 4 N (rb block) d floating-point
// operations, against 4 (N n + 2 rb block d + 2 N d) bytes; at the path's
// shapes it is bound by operations (float32 outside the tensor cores,
// 67 TFLOP/s on an H100 SXM). The score reduction adds 2 N n operations and
// the dropped part of G, which is small beside that.
//
// Design. The TPU kernel streams every block of G through VMEM once and gates
// the matmuls per block. Here the TPU kernel's gates and slot map, which exist
// for its BlockSpec index maps, are not needed: the kernel takes idx and s as
// they are. One launch carries three block roles (block_roles.cuh):
//   * dX blocks and dW blocks run the fused kernel's roles unchanged: same
//     tiles, same ascending kept-block order, scale applied to the G tile
//     before both products. dX, dWc and db are therefore bit-identical to
//     block_gather_matmul_fused's for the same keeps (the TPU kernel's own
//     contract, sketch_matmul.py:402-404). The dW blocks of the first d-tile
//     also write the kept columns' scores, in the same loop that reduces db;
//   * score blocks each reduce one 64-column strip of a DROPPED block over
//     all N rows (strips of kept blocks return at once).
// Each column's score comes from one block with a fixed-order reduction and
// no float atomics, so the same G always gives the same scores, hence the same
// next plan. G's kept blocks are read twice (dX and dW roles) and its dropped
// blocks once (score role); the TPU kernel reads every block once.

#include "block_roles.cuh"

namespace {

using namespace roles;

template <typename T>
__global__ void __launch_bounds__(THREADS) stream_kernel(const Args<T> a) {
  __shared__ Smem sm;
  int b = blockIdx.x;
  const int ns = score_blocks(a.n);
  if (b < ns) {
    score_role(sm, a, b);
    return;
  }
  b -= ns;
  const int nx = dx_blocks(a.N, a.d);
  if (b < nx) {
    dx_role(sm, a, b);
    return;
  }
  dw_role(sm, a, b - nx);
}

template <typename T>
int launch(const void* G, const void* idx, const void* scales, const void* W, const void* X,
           void* dX, void* dWc, void* db, void* scores, int N, int n, int d, int rb, int block,
           int mode, cudaStream_t s) {
  const Args<T> a{static_cast<const T*>(G), static_cast<const int*>(idx),
                  static_cast<const float*>(scales), static_cast<const T*>(W),
                  static_cast<const T*>(X), static_cast<T*>(dX), static_cast<T*>(dWc),
                  static_cast<float*>(db), static_cast<float*>(scores), true,
                  N, n, d, rb, block, mode};
  const long long blocks = (long long)score_blocks(n) + dx_blocks(N, d) +
                           (long long)dw_blocks(d, rb, block);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  stream_kernel<T><<<dim3((unsigned)blocks), THREADS, 0, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. mode: 0 = "l1", 1 = "l2". Every output is
// required. Launches on `stream` and returns cudaGetLastError() (0 = ok).
extern "C" int bsm_stream_launch(int dtype, const void* G, const void* idx, const void* scales,
                                 const void* W, const void* X, void* dX, void* dWc, void* db,
                                 void* scores, int N, int n, int d, int rb, int block, int mode,
                                 void* stream) {
  if (int err = check_shapes(N, n, d, rb, block, mode)) return err;
  if (rb > n / block || dX == nullptr || dWc == nullptr || db == nullptr || scores == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(G, idx, scales, W, X, dX, dWc, db, scores, N, n, d, rb, block, mode, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(G, idx, scales, W, X, dX, dWc, db, scores, N, n, d, rb, block,
                                 mode, s);
  return (int)cudaErrorInvalidValue;
}
