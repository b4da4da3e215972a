// Pipelined block roles of the block-sketched backward kernels for Hopper
// (sm_90a), float32 or bfloat16 inputs with float32 accumulation. One copy,
// run by both sources:
//   * block_gather_matmul_fused.cu: the fused kernel (dW and dX roles) and the
//     unfused dX / dW pair (one role each);
//   * block_stream_matmul_fused.cu: the same two roles plus its own score
//     role over the dropped columns.
// So every launch computes dX, dWc, db and the kept scores with the same code
// in the same order, and the kernels agree bit for bit for the same keeps.
//
// With G [N, n], kept block ids idx [rb] (block width `block`, ascending),
// scales s [rb], W [n, d] and X [N, d]:
//   * dw_tile: one STRIP x TJ (32 x 32) tile of dWc[k] = s_k G[:, blk_k]^T X
//     (rows m of the block's columns, columns j of d); a thread owns a 2 x 4
//     microtile. Where the launch asks for db or the kept scores, the tiles
//     of the first d-tile also reduce db[k] = s_k sum_rows G[:, blk_k] and the
//     raw column reduction sum_rows |G| ("l1", mode 0) or sum_rows G^2 ("l2",
//     mode 1) of their 32 columns in the same loop, and write those asked for;
//   * dx_tile: one TX x TJ (64 x 32) tile of dX = sum_k s_k G[:, blk_k]
//     W[blk_k, :]; a thread owns a 4 x 4 microtile.
// Both stream their operands through a STAGES-deep ring of shared-memory
// tiles filled by 16-byte cp.async from per-thread copy pointers, so later
// rows (dW) or columns (dX) are in flight while earlier ones' FMAs run. A
// conversion pass per stage writes __fmul_rn(G, s_k) in float32 (in place for
// float32; bf16 G, X and W are widened, exactly, into float32 buffers); in the
// dW tiles that reduce, the same pass adds the stage's rows = p (mod 4) to
// thread (column, part p)'s db and score partials. G's kept blocks are read by
// both roles (each d-tile's blocks read the same G tile, mostly from L2).
// What holds a dW tile back (measured with clock64 on an H100): with one
// warp per scheduler, a row's shared-memory loads and its 8 FMAs cannot hide
// each other's latency, and wider microtiles on fewer warps were slower;
// the copy issue and the two barriers per stage cost the rest.
//
// Accumulation orders (fixed; every kernel keeps them):
//   * dWc[k][m][j]: one fmaf chain over the rows 0 .. ceil16(N) - 1 in
//     ascending order from 0.f, operands __fmul_rn(G, s_k) and X (rows past N
//     are zeros);
//   * dX[i][j]: one fmaf chain over the kept blocks in ascending order and
//     within each over its columns in ascending order, from 0.f;
//   * db[k][c] and the score of column c: four partials from 0.f, partial p
//     over the rows = p (mod 4) in ascending order (__fadd_rn of
//     __fmul_rn(G, s_k); __fadd_rn of |G| or __fmaf_rn(G, G, .)), combined as
//     ((((0 + p0) + p1) + p2) + p3). A row past N adds +0, which changes no
//     sum (a chain that starts at +0 never holds -0).
// The explicitly rounded intrinsics are never contracted or reordered by the
// compiler. Split-N partials or tensor cores would change dWc's bits, so each
// dW output stays one chain in one thread, and the products are float32 FFMA
// (no TF32). Each output has one writer, no atomics: deterministic.
//
// A cp.async needs 16-byte-aligned rows; where G's, X's or W's base pointer,
// or d, breaks that, the launcher clears that operand's `vec` bit and its
// tiles are filled by plain loads instead. Ragged edges (N, d) are masked.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace roles {

constexpr int THREADS = 128;
constexpr int STAGES = 3;  // ring depth
constexpr int STRIP = 32;  // dW tile rows (columns of G); the stream kernel's score strip
constexpr int TJ = 32;     // dW and dX tile columns (columns of d)
constexpr int R = 64;      // rows of G per dW (or score) stage
constexpr int TX = 64;     // dX tile rows
constexpr int KC = 16;     // G columns (W rows) per dX stage
constexpr int PARTS = 4;   // db / score partials per column
constexpr int VEC_G = 1, VEC_X = 2, VEC_W = 4;

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline int n_dw(int d, int rb, int block) {
  return rb * (block / STRIP) * cdiv(d, TJ);
}
__host__ __device__ inline int n_dx(int N, int d) { return cdiv(N, TX) * cdiv(d, TJ); }

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
  int N, n, d, rb, block, mode;
};

template <typename T>
__device__ __forceinline__ int kept_block(const Args<T>& a, int k) {
  const int blk = a.idx[k];
  if (blk < 0 || blk >= a.n / a.block) __trap();  // a kept block outside G
  return blk;
}

// Shared memory per role, in bytes: the ring of raw input tiles, then (bf16
// only) the float32 buffers the conversion pass widens them into; float32
// inputs are scaled in place in the ring.
template <typename T, int RS = R, int NS = STAGES>
struct DwSmem {
  static constexpr bool RAW = sizeof(T) != 4;
  static constexpr int ELEMS = RS * STRIP;  // per stage and operand (STRIP == TJ)
  static constexpr size_t f_off = (size_t)NS * 2 * ELEMS * sizeof(T);  // bf16: widened G, X
  static constexpr size_t red_off = f_off + (RAW ? (size_t)2 * ELEMS * 4 : 0);
  static constexpr size_t bytes = red_off + 2 * PARTS * STRIP * 4;
};
template <typename T, int NS = STAGES>
struct DxSmem {
  static constexpr bool RAW = sizeof(T) != 4;
  static constexpr int A = TX * KC, B = KC * TJ;  // per stage
  static constexpr size_t f_off = (size_t)NS * (A + B) * sizeof(T);  // bf16: widened A, B
  static constexpr size_t bytes = f_off + (RAW ? (size_t)(A + B) * 4 : 0);
};
template <typename T, int RS = R, int NS = STAGES>
constexpr size_t smem_bytes() {
  return DwSmem<T, RS, NS>::bytes > DxSmem<T, NS>::bytes ? DwSmem<T, RS, NS>::bytes
                                                         : DxSmem<T, NS>::bytes;
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
template <int NS>
__device__ __forceinline__ void cp_async_wait_ring() {  // all but the newest NS - 2 groups
  asm volatile("cp.async.wait_group %0;\n" ::"n"(NS - 2) : "memory");
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

// The dW tile of block b of a launch's dW blocks: (k, ct, j-tile), j-tile
// fastest. gcol0 is its first column of G, row0 its first row of dWc[k] (and
// of db[k]), j0 its first column of d.
struct DwTile {
  int k, gcol0, row0, j0;
};
template <typename T>
__device__ __forceinline__ DwTile dw_tile_of(const Args<T>& a, int b) {
  const int jt = cdiv(a.d, TJ), ct_n = a.block / STRIP;
  const int k = b / (ct_n * jt), rem = b % (ct_n * jt);
  const int ct = rem / jt;
  return DwTile{k, kept_block(a, k) * a.block + ct * STRIP, ct * STRIP, (rem % jt) * TJ};
}

// ---- dW role: one [STRIP, TJ] tile of dWc[k]; the tiles with j0 == 0 also
// reduce db[k] and the kept raw scores of their columns where the launch asks
// for either, and write db[k] (where a.db is set) and the scores (where
// a.scores is set; the tile's first score at a.scores[sc0]) ----
// Per stage of R rows: raw G and X land in the ring by cp.async (each thread
// keeps its own copy pointers); the conversion pass scales G in float32 (in
// place for float32 inputs) and, for bf16, widens G and X into float32
// buffers; then each thread runs its 2 x 4 microtile over the stage's rows.
template <int RS = R, int NS = STAGES, typename T>
__device__ void dw_tile(unsigned char* smem, const Args<T>& a, int vec, DwTile t, size_t sc0) {
  using S = DwSmem<T, RS, NS>;
  constexpr int E = S::ELEMS;
  constexpr int CH = 16 / (int)sizeof(T);
  constexpr int CPR = STRIP / CH;             // 16-byte copies per row of a tile
  constexpr int NCP = RS * CPR / THREADS;     // copies per thread per operand and stage
  T* Gr = reinterpret_cast<T*>(smem);
  T* Xr = Gr + NS * E;
  float* Gf = S::RAW ? reinterpret_cast<float*>(smem + S::f_off) : nullptr;  // bf16 only
  float* Xf = S::RAW ? Gf + E : nullptr;
  float* red = reinterpret_cast<float*>(smem + S::red_off);

  const int tid = threadIdx.x;
  const int cm = tid % STRIP, cp = tid / STRIP;   // conversion: column cm, rows = cp (mod 4)
  const int tm = tid / 8, tj = tid % 8;          // products: m 2 tm, 2 tm + 1; j 4 tj ..
  const float s = a.scales[t.k];
  // block-uniform: the first d-tile's blocks reduce db and the kept scores
  // where the launch asks for either (one flag: a flag per reduction in the
  // loop below measured slower on an H100)
  const bool reduce = t.j0 == 0 && (a.db != nullptr || a.scores != nullptr);
  const int N16 = cdiv(a.N, 16) * 16;
  const int nst = cdiv(N16, RS);

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
    gsrc[u] = a.G + (size_t)crow[u] * a.n + t.gcol0 + c;
    xvalid[u] = a.d - t.j0 - c;
    xsrc[u] = a.X + (size_t)crow[u] * a.d + t.j0 + (xvalid[u] > 0 ? c : 0);
  }
  auto load = [&](int st, int buf) {
    const int i0 = st * RS;
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
  for (int p = 0; p < NS - 1; ++p) {
    if (p < nst) load(p, p);
    cp_async_commit();
  }
  for (int st = 0; st < nst; ++st) {
    const int buf = st % NS;
    cp_async_wait_ring<NS>();
    __syncthreads();  // stage st landed everywhere; stage st - 1's products are done
    if (st + NS - 1 < nst) load(st + NS - 1, (st + NS - 1) % NS);
    cp_async_commit();

    // conversion pass: thread (cm, cp) takes rows cp, cp + 4, ... of column cm
    const T* gr = Gr + buf * E;
    float* g = S::RAW ? Gf : reinterpret_cast<float*>(Gr + buf * E);
#pragma unroll
    for (int q = 0; q < RS / PARTS; ++q) {
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
    const int rows = min(RS, N16 - st * RS);  // a multiple of 16
#pragma unroll
    for (int h = 0; h < RS / 16; ++h) {
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

  T* out = a.dWc + ((size_t)t.k * a.block + t.row0) * a.d;
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = t.j0 + 4 * tj + c;
      if (col < a.d) out[(size_t)(2 * tm + r) * a.d + col] = from_f32<T>(acc[r][c]);
    }
  if (reduce) {
    red[cp * STRIP + cm] = db_acc;
    red[(PARTS + cp) * STRIP + cm] = sc_acc;
    __syncthreads();
    if (tid < STRIP) {
      float q0 = 0.f, q1 = 0.f;
#pragma unroll
      for (int p = 0; p < PARTS; ++p) {  // fixed order
        q0 = __fadd_rn(q0, red[p * STRIP + tid]);
        q1 = __fadd_rn(q1, red[(PARTS + p) * STRIP + tid]);
      }
      if (a.db != nullptr) a.db[(size_t)t.k * a.block + t.row0 + tid] = q0;
      if (a.scores != nullptr) a.scores[sc0 + tid] = q1;
    }
  }
}

// ---- dX role: one [TX, TJ] tile of dX, over the kept blocks' columns ----
// Per stage, KC columns of G (rows row0 ..) and the KC matching rows of W
// (columns col0 ..) land in the ring by cp.async; the conversion pass writes
// __fmul_rn(G, s_k) (and, for bf16, the widened W) in float32; each thread
// runs its 4 x 4 microtile over the stage's columns in ascending order.
template <int NS = STAGES, typename T>
__device__ void dx_tile(unsigned char* smem, const Args<T>& a, int vec, int row0, int col0) {
  using S = DxSmem<T, NS>;
  constexpr int CH = 16 / (int)sizeof(T);
  constexpr int ACP = KC / CH, BCP = TJ / CH;  // 16-byte copies per row of A, of B
  constexpr int NA = TX * ACP / THREADS;       // A copies per thread and stage
  constexpr int NB = (KC * BCP + THREADS - 1) / THREADS;
  T* Ar = reinterpret_cast<T*>(smem);
  T* Br = Ar + NS * S::A;
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
  for (int p = 0; p < NS - 1; ++p) {
    if (p < nst) load(p, p);
    cp_async_commit();
  }
  for (int st = 0; st < nst; ++st) {
    const int buf = st % NS;
    cp_async_wait_ring<NS>();
    __syncthreads();  // stage st landed everywhere; stage st - 1's products are done
    if (st + NS - 1 < nst) load(st + NS - 1, (st + NS - 1) % NS);
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

// The dX tile of block b of a launch's dX blocks (d-tile fastest).
template <int NS = STAGES, typename T>
__device__ __forceinline__ void dx_block(unsigned char* smem, const Args<T>& a, int vec, int b) {
  const int jt = cdiv(a.d, TJ);
  dx_tile<NS>(smem, a, vec, (b / jt) * TX, (b % jt) * TJ);
}

// ---- host side, shared by the launchers ----

// The vec bits of a launch: an operand's 16-byte cp.async path needs its base
// pointer and (X, W) its rows of d elements to be 16-byte aligned.
template <typename T>
inline int vec_bits(const void* G, const void* X, const void* W, int d) {
  const bool d_ok = ((long long)d * sizeof(T)) % 16 == 0;
  return ((uintptr_t)G % 16 == 0 ? VEC_G : 0) |
         ((uintptr_t)X % 16 == 0 && d_ok ? VEC_X : 0) |
         ((uintptr_t)W % 16 == 0 && d_ok ? VEC_W : 0);
}

// Above 48 KB a block's dynamic shared memory must be allowed per function and
// device. Each launcher keeps one `allowed_on` per kernel and calls this
// before every launch; it sets the attribute once per device, so that a launch
// inside a CUDA graph capture makes no other runtime call.
inline cudaError_t allow_smem(const void* kernel, size_t bytes, int& allowed_on) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (allowed_on != dev) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    allowed_on = dev;
  }
  return cudaSuccess;
}

// Shape checks shared by the launchers (0 = ok).
inline int check_shapes(int N, int n, int d, int rb, int block, int mode) {
  if (N <= 0 || n <= 0 || d <= 0 || rb <= 0 || block <= 0 || block % STRIP != 0 ||
      block % KC != 0 || n % block != 0 || (mode != 0 && mode != 1))
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace roles
