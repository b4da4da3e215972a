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
// contract, sketch_matmul.py:402-404). That kernel's roles
// (block_roles.cuh) fix every output's accumulation order, and this kernel
// keeps each order whole inside one thread:
//   * dWc[k][m][j]: one fmaf chain over the rows 0 .. ceil16(N) - 1 in
//     ascending order from 0.f, operands __fmul_rn(G, s_k) and X (rows past N
//     are zeros, as there);
//   * dX[i][j]: one fmaf chain over the kept blocks in ascending order and
//     within each over its columns in ascending order, from 0.f;
//   * db[k][c] and the scores of column c: four partials from 0.f, partial p
//     over the rows = p (mod 4) in ascending order (__fadd_rn of
//     __fmul_rn(G, s_k); __fadd_rn of |G| or __fmaf_rn(G, G, .)), combined
//     as ((((0 + p0) + p1) + p2) + p3). A row past N adds +0, which changes
//     no sum (a chain that starts at +0 never holds -0).
// Split-N partials would change dWc's bits, so the dW reduction stays whole
// in one block; tensor cores would too, so the products are FFMA.
//
// Design. One launch of 128-thread blocks in three roles, the longest first
// in the grid (the order of blocks changes no output's bits):
//   1. dW blocks: one 32 x 32 tile of one kept block's dWc (rows m of the
//      block's columns, columns j of d), so the smallest path shape (n 768,
//      d 768, rb 1) still runs 96 of them; a thread owns a 2 x 4 microtile.
//      G's strip and X's columns stream through a 3-stage ring of 64-row
//      tiles filled by 16-byte cp.async from per-thread copy pointers, so
//      later rows are in flight while earlier rows' FMAs run. A conversion
//      pass per stage writes __fmul_rn(G, s_k) in float32 (in place for
//      float32; bf16 G and X are widened, exactly, into float32 buffers); in
//      the blocks of the first d-tile the same pass, thread (column m, part
//      p), adds the stage's rows = p (mod 4) to db and the kept scores.
//   2. score blocks: the raw column reduction of one 32-column strip of a
//      DROPPED block (strips of kept blocks return at once); G alone streams
//      through the ring in 64-row stages and is reduced in place.
//   3. dX blocks: one 64 x 32 tile of dX; a thread owns a 4 x 4 microtile.
//      The kept blocks' G columns (16 per stage) and W rows stream through
//      the same kind of ring, G scaled in the conversion pass; 8 float4
//      loads per 64 FMAs.
// What holds a dW block back (measured with clock64 on an H100): with one
// warp per scheduler, a row's shared-memory loads and its 8 FMAs cannot hide
// each other's latency, and wider microtiles on fewer warps were slower;
// the copy issue and the two barriers per stage cost the rest.
// A cp.async needs 16-byte-aligned rows; where G's, X's or W's base pointer,
// or d, breaks that, the launcher clears that operand's bit and its tiles are
// filled by plain loads instead. Each output has one writer, no float
// atomics: the same G gives the same scores, hence the same next plan. G's
// kept blocks are read by both the dX and the dW blocks (each d-tile's
// blocks read the same G tile, mostly from L2) and its dropped blocks once;
// the TPU kernel reads every block once.

#include <stdint.h>

#include "block_roles.cuh"

namespace {

using roles::add_score;
using roles::Args;
using roles::check_shapes;
using roles::from_f32;
using roles::kept_block;
using roles::to_f32;

constexpr int THREADS = 128;
constexpr int STAGES = 3;  // ring depth
constexpr int STRIP = 32;   // dW tile rows (columns of G) and score strip width
constexpr int TJ = 32;      // dW and dX tile columns (columns of d)
constexpr int R = 64;       // rows of G per dW or score stage
constexpr int TX = 64;      // dX tile rows
constexpr int KC = 16;      // G columns (W rows) per dX stage
constexpr int PARTS = 4;    // db / score partials per column
constexpr int VEC_G = 1, VEC_X = 2, VEC_W = 4;

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline int n_dw(int d, int rb, int block) {
  return rb * (block / STRIP) * cdiv(d, TJ);
}
__host__ __device__ inline int n_dx(int N, int d) { return cdiv(N, TX) * cdiv(d, TJ); }
__host__ __device__ inline int n_score(int n) { return n / STRIP; }

// Shared memory per role, in bytes: the ring of raw input tiles, then (bf16
// only) the float32 buffers the conversion pass widens them into; float32
// inputs are scaled in place in the ring.
template <typename T>
struct DwSmem {
  static constexpr bool RAW = sizeof(T) != 4;
  static constexpr int ELEMS = R * STRIP;  // per stage and operand (STRIP == TJ)
  static constexpr size_t f_off = (size_t)STAGES * 2 * ELEMS * sizeof(T);  // bf16: widened G, X
  static constexpr size_t red_off = f_off + (RAW ? (size_t)2 * ELEMS * 4 : 0);
  static constexpr size_t bytes = red_off + 2 * PARTS * STRIP * 4;
};
template <typename T>
struct DxSmem {
  static constexpr bool RAW = sizeof(T) != 4;
  static constexpr int A = TX * KC, B = KC * TJ;  // per stage
  static constexpr size_t f_off = (size_t)STAGES * (A + B) * sizeof(T);  // bf16: widened A, B
  static constexpr size_t bytes = f_off + (RAW ? (size_t)(A + B) * 4 : 0);
};
template <typename T>
constexpr size_t smem_bytes() {
  return DwSmem<T>::bytes > DxSmem<T>::bytes ? DwSmem<T>::bytes : DxSmem<T>::bytes;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(pred ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2) : "memory");
}

// One 16-byte chunk of a row into shared memory: `valid` of its elements lie
// inside the row (the rest, and all of them when !in, are zeros). With vec the
// chunk is wholly in or out, and src is read only when in.
template <typename T>
__device__ __forceinline__ void copy_chunk(T* dst, const T* src, bool in, int valid, bool vec) {
  constexpr int CH = 16 / (int)sizeof(T);
  if (vec) {
    cp_async16(dst, src, in && valid > 0);
  } else {
#pragma unroll
    for (int e = 0; e < CH; ++e) dst[e] = in && e < valid ? src[e] : from_f32<T>(0.f);
  }
}

// Copy a [rows, cols] tile of a row-major array (row stride ld, `nrows` and
// `ncols` valid from its origin) into shared memory [rows][cols].
template <typename T, int ROWS, int COLS>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long ld, int nrows, int ncols,
                                          bool vec) {
  constexpr int CH = 16 / (int)sizeof(T);
  constexpr int CPR = COLS / CH;
  for (int e = threadIdx.x; e < ROWS * CPR; e += THREADS) {
    const int i = e / CPR, c = (e % CPR) * CH;
    const bool in = i < nrows && c < ncols;
    copy_chunk(dst + i * COLS + c, in ? src + i * ld + c : src, in, ncols - c, vec);
  }
}

// Widen a bf16 stage into its float32 buffer (no-op for float32 inputs).
template <typename T, int ELEMS>
__device__ __forceinline__ void widen(float* dst, const T* src) {
  if constexpr (sizeof(T) != 4)
    for (int e = threadIdx.x; e < ELEMS; e += THREADS) dst[e] = to_f32(src[e]);
}

// ---- dW role: one [STRIP, TJ] tile of dWc[k] (G columns gcol0 .., d columns
// j0 ..), reducing db and the kept scores of its columns when j0 == 0 ----
// Per stage of R rows: raw G and X land in the ring by cp.async (each thread
// keeps its own copy pointers); the conversion pass scales G in float32 (in
// place for float32 inputs) and, for bf16, widens G and X into float32
// buffers; then each thread runs its 2 x 4 microtile over the stage's rows.
template <typename T>
__device__ void dw_tile(unsigned char* smem, const Args<T>& a, int vec, int k, int gcol0, int j0,
                        int out_row0) {
  using S = DwSmem<T>;
  constexpr int E = S::ELEMS;
  constexpr int CH = 16 / (int)sizeof(T);
  constexpr int CPR = STRIP / CH;             // 16-byte copies per row of a tile
  constexpr int NCP = R * CPR / THREADS;      // copies per thread per operand and stage
  T* Gr = reinterpret_cast<T*>(smem);
  T* Xr = Gr + STAGES * E;
  float* Gf = S::RAW ? reinterpret_cast<float*>(smem + S::f_off) : nullptr;  // bf16 only
  float* Xf = S::RAW ? Gf + E : nullptr;
  float* red = reinterpret_cast<float*>(smem + S::red_off);

  const int tid = threadIdx.x;
  const int cm = tid % STRIP, cp = tid / STRIP;   // conversion: column cm, rows = cp (mod 4)
  const int tm = tid / 8, tj = tid % 8;          // products: m 2 tm, 2 tm + 1; j 4 tj ..
  const float s = a.scales[k];
  const bool reduce = j0 == 0;  // block-uniform
  const int N16 = cdiv(a.N, 16) * 16;
  const int nst = cdiv(N16, R);

  // this thread's copies: tile row i = e / CPR, column c = (e % CPR) CH
  const T* gsrc[NCP];
  const T* xsrc[NCP];
  int crow[NCP], soff[NCP], xvalid[NCP];
#pragma unroll
  for (int u = 0; u < NCP; ++u) {
    const int e = tid + u * THREADS;
    crow[u] = e / CPR;
    const int c = (e % CPR) * CH;
    soff[u] = crow[u] * STRIP + c;
    gsrc[u] = a.G + (size_t)crow[u] * a.n + gcol0 + c;
    xvalid[u] = a.d - j0 - c;
    xsrc[u] = a.X + (size_t)crow[u] * a.d + j0 + (xvalid[u] > 0 ? c : 0);
  }
  auto load = [&](int st, int buf) {
    const int i0 = st * R;
#pragma unroll
    for (int u = 0; u < NCP; ++u) {
      const bool in = i0 + crow[u] < a.N;
      copy_chunk(Gr + buf * E + soff[u], in ? gsrc[u] + (size_t)i0 * a.n : a.G, in, CH,
                 vec & VEC_G);
      const bool xin = in && xvalid[u] > 0;
      copy_chunk(Xr + buf * E + soff[u], xin ? xsrc[u] + (size_t)i0 * a.d : a.X, xin,
                 xvalid[u], vec & VEC_X);
    }
  };

  float acc[2][4] = {};
  float db_acc = 0.f, sc_acc = 0.f;
#pragma unroll
  for (int p = 0; p < STAGES - 1; ++p) {
    if (p < nst) load(p, p);
    cp_async_commit();
  }
  for (int st = 0; st < nst; ++st) {
    const int buf = st % STAGES;
    cp_async_wait_ring();
    __syncthreads();  // stage st landed everywhere; stage st - 1's products are done
    if (st + STAGES - 1 < nst) load(st + STAGES - 1, (st + STAGES - 1) % STAGES);
    cp_async_commit();

    // conversion pass: thread (cm, cp) takes rows cp, cp + 4, ... of column cm
    const T* gr = Gr + buf * E;
    float* g = S::RAW ? Gf : reinterpret_cast<float*>(Gr + buf * E);
#pragma unroll
    for (int q = 0; q < R / PARTS; ++q) {
      const int i = cp + PARTS * q;
      const float raw = to_f32(gr[i * STRIP + cm]);
      const float v = __fmul_rn(raw, s);
      g[i * STRIP + cm] = v;
      if (reduce) {
        db_acc = __fadd_rn(db_acc, v);
        sc_acc = add_score(sc_acc, raw, a.mode);
      }
    }
    if constexpr (S::RAW) widen<T, E>(Xf, Xr + buf * E);
    __syncthreads();

    const float* x = S::RAW ? Xf : reinterpret_cast<const float*>(Xr + buf * E);
    const int rows = min(R, N16 - st * R);  // 16 or 32: the fused kernel's row count
#pragma unroll
    for (int h = 0; h < R / 16; ++h) {
      if (h * 16 >= rows) break;
#pragma unroll
      for (int ii = 0; ii < 16; ++ii) {
        const int i = 16 * h + ii;  // rows in ascending order
        const float2 g2 = *reinterpret_cast<const float2*>(g + i * STRIP + 2 * tm);
        const float4 x4 = *reinterpret_cast<const float4*>(x + i * TJ + 4 * tj);
        const float gv[2] = {g2.x, g2.y};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          acc[r][0] = fmaf(gv[r], x4.x, acc[r][0]);
          acc[r][1] = fmaf(gv[r], x4.y, acc[r][1]);
          acc[r][2] = fmaf(gv[r], x4.z, acc[r][2]);
          acc[r][3] = fmaf(gv[r], x4.w, acc[r][3]);
        }
      }
    }
  }

  T* out = a.dWc + ((size_t)k * a.block + out_row0) * a.d;
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = j0 + 4 * tj + c;
      if (col < a.d) out[(size_t)(2 * tm + r) * a.d + col] = from_f32<T>(acc[r][c]);
    }
  if (reduce) {
    red[cp * STRIP + cm] = db_acc;
    red[(PARTS + cp) * STRIP + cm] = sc_acc;
    __syncthreads();
    if (tid < STRIP) {
      float q0 = 0.f, q1 = 0.f;
#pragma unroll
      for (int p = 0; p < PARTS; ++p) {  // fixed order: the fused kernel's
        q0 = __fadd_rn(q0, red[p * STRIP + tid]);
        q1 = __fadd_rn(q1, red[(PARTS + p) * STRIP + tid]);
      }
      a.db[(size_t)k * a.block + out_row0 + tid] = q0;
      a.scores[gcol0 + tid] = q1;  // column-indexed
    }
  }
}

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
    cp_async_wait_ring();
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

// ---- dX role: one [TX, TJ] tile of dX, over the kept blocks' columns ----
// Per stage, KC columns of G (rows row0 ..) and the KC matching rows of W
// (columns col0 ..) land in the ring by cp.async; the conversion pass writes
// __fmul_rn(G, s_k) (and, for bf16, the widened W) in float32; each thread
// runs its 4 x 4 microtile over the stage's columns in ascending order.
template <typename T>
__device__ void dx_tile(unsigned char* smem, const Args<T>& a, int vec, int row0, int col0) {
  using S = DxSmem<T>;
  constexpr int CH = 16 / (int)sizeof(T);
  constexpr int ACP = KC / CH, BCP = TJ / CH;  // 16-byte copies per row of A, of B
  constexpr int NA = TX * ACP / THREADS;       // A copies per thread and stage
  constexpr int NB = (KC * BCP + THREADS - 1) / THREADS;
  T* Ar = reinterpret_cast<T*>(smem);
  T* Br = Ar + STAGES * S::A;
  float* Af = S::RAW ? reinterpret_cast<float*>(smem + S::f_off) : nullptr;  // bf16 only
  float* Bf = S::RAW ? Af + S::A : nullptr;

  const int tid = threadIdx.x;
  const int ty = tid / 8, tx = tid % 8;  // rows 4 ty .., columns 4 tx ..
  const int per_blk = a.block / KC;
  const int nst = a.rb * per_blk;

  // this thread's copies (offsets from the stage's first G column / W row)
  size_t aoff[NA];
  int asm_off[NA];
  bool ain[NA];
#pragma unroll
  for (int u = 0; u < NA; ++u) {
    const int e = tid + u * THREADS, i = e / ACP, c = (e % ACP) * CH;
    ain[u] = row0 + i < a.N;
    aoff[u] = ain[u] ? (size_t)(row0 + i) * a.n + c : 0;
    asm_off[u] = i * KC + c;
  }
  size_t boff[NB];
  int bsm_off[NB], bvalid[NB];
  bool bmine[NB];
#pragma unroll
  for (int u = 0; u < NB; ++u) {
    const int e = tid + u * THREADS, kk = e / BCP, c = (e % BCP) * CH;
    bmine[u] = e < KC * BCP;
    bvalid[u] = a.d - col0 - c;
    boff[u] = (size_t)kk * a.d + col0 + (bvalid[u] > 0 ? c : 0);
    bsm_off[u] = kk * TJ + c;
  }
  auto load = [&](int st, int buf) {
    const size_t c = (size_t)kept_block(a, st / per_blk) * a.block + (st % per_blk) * KC;
#pragma unroll
    for (int u = 0; u < NA; ++u)
      copy_chunk(Ar + buf * S::A + asm_off[u], ain[u] ? a.G + aoff[u] + c : a.G, ain[u], CH,
                 vec & VEC_G);
#pragma unroll
    for (int u = 0; u < NB; ++u)
      if (bmine[u])
        copy_chunk(Br + buf * S::B + bsm_off[u], bvalid[u] > 0 ? a.W + boff[u] + c * a.d : a.W,
                   bvalid[u] > 0, bvalid[u], vec & VEC_W);
  };

  float acc[4][4] = {};
#pragma unroll
  for (int p = 0; p < STAGES - 1; ++p) {
    if (p < nst) load(p, p);
    cp_async_commit();
  }
  for (int st = 0; st < nst; ++st) {
    const int buf = st % STAGES;
    cp_async_wait_ring();
    __syncthreads();  // stage st landed everywhere; stage st - 1's products are done
    if (st + STAGES - 1 < nst) load(st + STAGES - 1, (st + STAGES - 1) % STAGES);
    cp_async_commit();

    const float s = a.scales[st / per_blk];
    const T* araw = Ar + buf * S::A;
    float* A = S::RAW ? Af : reinterpret_cast<float*>(Ar + buf * S::A);
#pragma unroll
    for (int e = tid; e < S::A; e += THREADS) A[e] = __fmul_rn(to_f32(araw[e]), s);
    if constexpr (S::RAW) widen<T, S::B>(Bf, Br + buf * S::B);
    __syncthreads();

    const float* B = S::RAW ? Bf : reinterpret_cast<const float*>(Br + buf * S::B);
#pragma unroll
    for (int k4 = 0; k4 < KC; k4 += 4) {  // the block's columns in ascending order
      float4 av[4], bv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        av[r] = *reinterpret_cast<const float4*>(A + (4 * ty + r) * KC + k4);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        bv[e] = *reinterpret_cast<const float4*>(B + (k4 + e) * TJ + 4 * tx);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float g = e == 0 ? av[r].x : e == 1 ? av[r].y : e == 2 ? av[r].z : av[r].w;
          acc[r][0] = fmaf(g, bv[e].x, acc[r][0]);
          acc[r][1] = fmaf(g, bv[e].y, acc[r][1]);
          acc[r][2] = fmaf(g, bv[e].z, acc[r][2]);
          acc[r][3] = fmaf(g, bv[e].w, acc[r][3]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = row0 + 4 * ty + r;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = col0 + 4 * tx + c;
      if (row < a.N && col < a.d) a.dX[(size_t)row * a.d + col] = from_f32<T>(acc[r][c]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) stream_kernel(const Args<T> a, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  int b = blockIdx.x;
  const int nw = n_dw(a.d, a.rb, a.block);
  if (b < nw) {  // dW: (k, ct, j-tile), j-tile fastest
    const int jt = cdiv(a.d, TJ), ct_n = a.block / STRIP;
    const int k = b / (ct_n * jt), rem = b % (ct_n * jt);
    const int ct = rem / jt, j0 = (rem % jt) * TJ;
    dw_tile(smem, a, vec, k, kept_block(a, k) * a.block + ct * STRIP, j0, ct * STRIP);
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
  const int jt = cdiv(a.d, TJ);
  dx_tile(smem, a, vec, (b / jt) * TX, (b % jt) * TJ);
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
  const bool d_ok = ((long long)d * sizeof(T)) % 16 == 0;
  const int vec = ((uintptr_t)G % 16 == 0 ? VEC_G : 0) |
                  ((uintptr_t)X % 16 == 0 && d_ok ? VEC_X : 0) |
                  ((uintptr_t)W % 16 == 0 && d_ok ? VEC_W : 0);
  const long long blocks = (long long)n_dw(d, rb, block) + n_dx(N, d) + n_score(n);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  constexpr size_t smem = smem_bytes<T>();
  // above 48 KB a block's shared memory must be allowed per function and
  // device; set once, so that a launch inside a CUDA graph capture makes no
  // other runtime call
  static int allowed_on = -1;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (allowed_on != dev) {
    err = cudaFuncSetAttribute(stream_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    allowed_on = dev;
  }
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
