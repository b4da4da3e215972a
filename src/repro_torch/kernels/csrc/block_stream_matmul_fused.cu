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
// the dropped part of G, which is small beside that. In practice the dW
// reduction sets the time: each output is one chain over all N rows, so a
// dW block's time is N times a row's cost however many blocks run.
//
// The contract: dX, dWc, db and the kept columns' scores are bit for bit
// block_gather_matmul_fused's for the same keeps (the TPU kernel's own
// contract, sketch_matmul.py:402-404). Both kernels run the same dW and dX
// roles, from block_roles.cuh, which also sets out their accumulation orders;
// this kernel adds the dropped columns' scores, whose strips keep the same
// order (four partials by row mod 4, combined in order).
//
// Design. One launch of 128-thread blocks in three roles, the longest first
// in the grid (the order of blocks changes no output's bits):
//   1. dW blocks (roles::dw_tile): one 32 x 32 tile of one kept block's dWc,
//      so the smallest path shape (n 768, d 768, rb 1) still runs 96 of them;
//      the tiles of the first d-tile also reduce db and the kept scores,
//      which this kernel writes column-indexed into scores [n];
//   2. score blocks: the raw column reduction of one 32-column strip of a
//      DROPPED block (strips of kept blocks return at once); G alone streams
//      through the roles' cp.async ring in 64-row stages and is reduced in
//      place;
//   3. dX blocks (roles::dx_tile): one 64 x 32 tile of dX.
// Each output has one writer, no float atomics: the same G gives the same
// scores, hence the same next plan. G's kept blocks are read by both the dX
// and the dW blocks (each d-tile's blocks read the same G tile, mostly from
// L2) and its dropped blocks once; the TPU kernel reads every block once.

#include "block_roles.cuh"

namespace {

using namespace roles;

__host__ __device__ inline int n_score(int n) { return n / STRIP; }

// ---- score role: raw column reduction of one DROPPED 32-column strip ----
// G alone streams through the ring, in stages of R rows of raw input read
// in place: thread (column cm, part cp) adds rows = cp (mod 4).
template <typename T>
__device__ void score_strip(unsigned char* smem, const Args<T>& a, int vec, int c0) {
  constexpr int E = R * STRIP;
  T* Gr = reinterpret_cast<T*>(smem);
  float* red = reinterpret_cast<float*>(smem + DwSmem<T>::red_off);
  const int tid = threadIdx.x;
  const int cm = tid % STRIP, cp = tid / STRIP;
  const int nst = cdiv(a.N, R);
  auto load = [&](int st, int buf) {
    const int i0 = st * R;
    load_tile<T, R, STRIP>(Gr + buf * E, a.G + (size_t)i0 * a.n + c0, a.n, a.N - i0, STRIP,
                           vec & VEC_G);
  };
  float sc_acc = 0.f;
#pragma unroll
  for (int p = 0; p < STAGES - 1; ++p) {
    if (p < nst) load(p, p);
    cp_async_commit();
  }
  for (int st = 0; st < nst; ++st) {
    const T* gr = Gr + (st % STAGES) * E;
    cp_async_wait_ring<STAGES>();
    __syncthreads();
    if (st + STAGES - 1 < nst) load(st + STAGES - 1, (st + STAGES - 1) % STAGES);
    cp_async_commit();
#pragma unroll
    for (int q = 0; q < R / PARTS; ++q)
      sc_acc = add_score(sc_acc, to_f32(gr[(cp + PARTS * q) * STRIP + cm]), a.mode);
  }
  red[cp * STRIP + cm] = sc_acc;
  __syncthreads();
  if (tid < STRIP) {
    float q = 0.f;
#pragma unroll
    for (int p = 0; p < PARTS; ++p) q = __fadd_rn(q, red[p * STRIP + tid]);  // fixed order
    a.scores[c0 + tid] = q;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) stream_kernel(const Args<T> a, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  int b = blockIdx.x;
  const int nw = n_dw(a.d, a.rb, a.block);
  if (b < nw) {
    const DwTile t = dw_tile_of(a, b);
    dw_tile(smem, a, vec, t, (size_t)t.gcol0);  // scores are column-indexed, [n]
    return;
  }
  b -= nw;
  const int ns = n_score(a.n);
  if (b < ns) {
    const int c0 = b * STRIP;
    const int blk = c0 / a.block;
    for (int k = 0; k < a.rb; ++k)
      if (a.idx[k] == blk) return;  // kept (block-uniform): the dW blocks reduce it
    score_strip(smem, a, vec, c0);
    return;
  }
  b -= ns;
  dx_block(smem, a, vec, b);
}

template <typename T>
int launch(const void* G, const void* idx, const void* scales, const void* W, const void* X,
           void* dX, void* dWc, void* db, void* scores, int N, int n, int d, int rb, int block,
           int mode, cudaStream_t s) {
  const Args<T> a{static_cast<const T*>(G), static_cast<const int*>(idx),
                  static_cast<const float*>(scales), static_cast<const T*>(W),
                  static_cast<const T*>(X), static_cast<T*>(dX), static_cast<T*>(dWc),
                  static_cast<float*>(db), static_cast<float*>(scores), N, n, d, rb, block,
                  mode};
  const int vec = vec_bits<T>(G, X, W, d);
  const long long blocks = (long long)n_dw(d, rb, block) + n_dx(N, d) + n_score(n);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  constexpr size_t smem = smem_bytes<T>();
  static int allowed_on = -1;
  if (cudaError_t err = allow_smem((const void*)stream_kernel<T>, smem, allowed_on))
    return (int)err;
  stream_kernel<T><<<dim3((unsigned)blocks), THREADS, smem, s>>>(a, vec);
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
