// Flash-attention forward for Hopper (sm_90a), float32 or bfloat16 inputs with
// float32 scores, softmax and sums.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::flash_attention.
// With q [B, Sq, H, dh] and k, v [B, Skv, Kv, dh] (GQA: query head h reads kv
// head h / (H / Kv)) it computes, per (batch, query head),
//     O = softmax(scale Q K^T + mask) V,   scale = dh^-1/2,            [B, Sq, H, dh] (q's type)
// where query i keeps key j iff j < Skv and, when causal, j <= Skv - Sq + i
// (the causal mask is right-aligned) and, with a window w, Skv - Sq + i - j < w.
// Masked scores are -1e30 and the divide is by max(l, 1e-30), as in the TPU
// kernel. A causal call needs Sq <= Skv.
//
// What bounds it: about 4 dh (unmasked pairs) float32 operations against the
// bytes of q, k, v and o, each moved once. At lm-100m's prefill (8 x 1024
// tokens, 12 heads, dh 64, causal) that is 12.9 GFLOP against 101 MB: bound by
// operations, 0.19 ms at 67 TFLOP/s (float32 outside the tensor cores on an
// H100 SXM), against 0.03 ms for the bytes. Float32 stays full float32 on the
// FFMA pipes: no TF32.
//
// Head widths. The kernel is instantiated for dh 64, 128 and 256; any other
// dh up to 256 runs in the next instantiated width (DH), its columns dh..DH
// zero-filled in shared memory: a zero Q or K column adds nothing to a
// score, and a zero V column only feeds output columns that are never
// written. The scale stays the true dh^-1/2 (the caller passes it).
//
// Design. The TPU kernel walks the key tiles as the innermost, sequential grid
// dimension and carries the running max m, the sum l and the accumulator in
// VMEM scratch. Hopper blocks run in parallel and carry nothing over, so one
// 128-thread block owns one query tile of one (b, h) (128 rows at DH 64, 64
// at DH 128, 32 at DH 256) and loops over the 64-key tiles itself; the causal
// tiles are scheduled longest first. Two blocks fit an SM at DH 64 and 128
// (100 KB of shared memory each at DH 64 float32); at DH 256 a block takes
// 171 KB in float32 (one per SM) and 91 KB in bf16 (two per SM).
//   * Register blocking. A thread owns RQ = 8 query rows (rows ty + NR r)
//     and, of the NC = DH / 8 threads that share them, 8 of the tile's keys
//     (tx + NC c) for S = Q K^T and 8 of the DH columns (4 tx + 4 NC g + c)
//     for O += P V: 16 FMAs per 16-byte shared load in both products. Shared
//     memory hands a thread 32 floats per clock per SM against 128 FMAs, so
//     4 FMAs per loaded float is what keeps the FFMA pipes fed at all: that
//     ratio, not the FMA count, is the bound of a float32 FFMA design here.
//     Q and K rows are padded to a 16-byte row stride that puts the 4 rows,
//     or 8 keys, a warp reads at once on distinct banks.
//   * Online softmax per row in registers: the row max over the NC threads
//     of a row by xor-shuffles, scores pre-scaled by log2(e) dh^-1/2 and
//     exponentiated with ex2.approx; l stays a per-thread partial sum (every
//     thread of a row rescales by the same alpha), reduced once at the end.
//     Tiles wholly inside every row's window skip the mask.
//   * P is written transposed to shared memory, P^T [64][TQ + 4]. A row's P
//     comes from the NC lanes of its own warp, so O += P V waits on a warp
//     barrier, not a block barrier.
//   * Asynchronous copies. Q and the first K tile, then each V tile and the
//     next K tile, arrive by 16-byte cp.async in the input type (bf16 is
//     widened when read from shared memory): V(t) is in flight during Q K^T,
//     K(t + 1) during the softmax and P V, with two block barriers per tile.
//     A cp.async needs 16-byte-aligned rows: when a base pointer, a stride or
//     the row width dh breaks that (in bf16 any dh not divisible by 8, in
//     float32 any not divisible by 4), the launcher clears the operand's
//     `vec` bit and the same buffers are filled by plain loads.
// Rows past Sq and keys past Skv are zero-filled in shared memory and
// masked. Key tiles past the causal frontier are skipped, as the TPU kernel
// skips them, and so are tiles wholly left of the window; a skipped tile would
// add nothing (a row's -1e30 placeholder terms are wiped by the rescale
// exp(m_old - m_new) = 0 once a real key arrives). q, k and v are read in
// place through their strides: no head-major copy and no repeat of K/V for
// GQA. Each output element has one writer, no atomics: deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int RQ = 8;  // query rows per thread
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// 4 consecutive elements from shared memory, widened to float32
__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ void st4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y), b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<unsigned*>(&a);
  u.y = *reinterpret_cast<unsigned*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

// 16-byte global -> shared copy, zero-filled when !pred (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(pred ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// 2^x on the special-function unit (relative error ~2^-22; results below
// 2^-126 flush to 0, which no sum of p values >= 1 can see)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

struct Strides {
  long long b, s, h;  // in elements; the last (dh) axis is contiguous
};

template <typename T>
struct Args {
  const T* q;
  const T* k;
  const T* v;
  T* o;
  Strides qs, ks, vs, os;
  int Sq, Skv, H, G;   // G = H / Kv query heads per kv head
  int dh;              // true head width, <= DH; columns dh..DH are zero in shared memory
  int causal, window;  // window 0: none
  int vec;             // bit 0: q rows, bit 1: k and v rows 16-byte aligned (cp.async)
  float scale;
};

// Tiles per head width. A thread owns RQ = 8 query rows; the NC = DH / 8
// threads that share them split the tile's keys (CK each, keys tx + NC c)
// and the output's DH columns (8 each: two float4 groups 4 tx + 4 NC g).
template <typename T, int DH>
struct Cfg {
  static constexpr int TQ = DH == 64 ? 128 : DH == 128 ? 64 : 32;  // query rows per block
  static constexpr int TKV = 64;                     // keys per tile
  static constexpr int NC = DH / 8;                  // threads per row
  static constexpr int NR = TQ / RQ;                 // row groups
  static constexpr int THREADS = (TQ / RQ) * NC;     // 128
  static constexpr int CK = TKV / NC;                // keys per thread
  static constexpr int CH = 16 / (int)sizeof(T);     // elements per 16-byte copy
  static constexpr int KS = DH + CH;                 // Q and K row stride (elements)
  static constexpr int PS = TQ + 4;                  // P^T row stride (floats)
  static constexpr size_t q_bytes = (size_t)TQ * KS * sizeof(T);
  static constexpr size_t k_bytes = (size_t)TKV * KS * sizeof(T);
  static constexpr size_t v_bytes = (size_t)TKV * DH * sizeof(T);
  static constexpr size_t k_off = q_bytes;
  static constexpr size_t v_off = k_off + k_bytes;
  static constexpr size_t p_off = v_off + v_bytes;
  static constexpr size_t bytes = p_off + (size_t)TKV * PS * 4;
  static_assert(NC <= 32 && 32 % NC == 0, "a row's threads lie in one warp");
  static_assert(THREADS == 128, "the launch and the copies assume 128 threads");
};

// Copy rows [r0, r0 + ROWS) of one head (global row stride ss, dh elements a
// row) into shared memory (row stride rs, DH elements a row); rows at or past
// `rows` and columns at or past dh are zero-filled. `vec` needs dh to be a
// multiple of a 16-byte copy.
template <typename T, int DH, int ROWS, int THREADS>
__device__ __forceinline__ void fill_tile(T* dst, int rs, const T* src, long long ss, int r0,
                                          int rows, int dh, bool vec) {
  constexpr int CH = 16 / (int)sizeof(T);
  constexpr int CPR = DH / CH;  // copies per row
  if (vec) {
#pragma unroll
    for (int e = threadIdx.x; e < ROWS * CPR; e += THREADS) {
      const int j = e / CPR, c = (e % CPR) * CH;
      const bool in = r0 + j < rows && c < dh;
      cp_async16(dst + j * rs + c, in ? src + (r0 + j) * ss + c : src, in);
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * DH; e += THREADS) {
      const int j = e / DH, d = e % DH;
      dst[j * rs + d] = r0 + j < rows && d < dh ? src[(r0 + j) * ss + d] : from_f32<T>(0.f);
    }
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(Cfg<T, DH>::THREADS, 2) flash_fwd(const Args<T> a) {
  using C = Cfg<T, DH>;
  constexpr int TQ = C::TQ, TKV = C::TKV, NC = C::NC, CK = C::CK;
  constexpr int THREADS = C::THREADS;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = reinterpret_cast<T*>(smem + C::k_off);
  T* Vs = reinterpret_cast<T*>(smem + C::v_off);
  float* Pt = reinterpret_cast<float*>(smem + C::p_off);

  const int tid = threadIdx.x;
  const int tx = tid % NC, ty = tid / NC;  // rows ty + NR r; keys tx + NC c
  constexpr int NR = C::NR;
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * TQ;  // the longest causal tiles start first
  const int off = a.Skv - a.Sq;  // query i sits at key position off + i
  const int q_last = min(q0 + TQ, a.Sq) - 1;
  const bool vec_q = (a.vec & 1) != 0, vec = (a.vec & 2) != 0;

  const T* qp = a.q + b * a.qs.b + h * a.qs.h;
  const T* kp = a.k + b * a.ks.b + (h / a.G) * a.ks.h;
  const T* vp = a.v + b * a.vs.b + (h / a.G) * a.vs.h;

  // the key tiles any row of this query tile can see: [t_lo, t_hi]
  int t_lo = 0, t_hi = (a.Skv + TKV - 1) / TKV - 1;
  if (a.causal) {
    t_hi = min(t_hi, (off + q_last) / TKV);
    if (a.window > 0) t_lo = max(0, (off + q0 - a.window + 1) / TKV);
  }

  fill_tile<T, DH, TQ, THREADS>(Qs, C::KS, qp, a.qs.s, q0, a.Sq, a.dh, vec_q);
  fill_tile<T, DH, TKV, THREADS>(Ks, C::KS, kp, a.ks.s, t_lo * TKV, a.Skv, a.dh, vec);
  cp_async_commit();

  const float sl2 = a.scale * LOG2E;
  float m[RQ], l[RQ], acc[RQ][8];
#pragma unroll
  for (int r = 0; r < RQ; ++r) {
    m[r] = NEG;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
  }

  for (int t = t_lo; t <= t_hi; ++t) {
    const int k0 = t * TKV;
    cp_async_wait<0>();  // this tile's K (and, first, Q)
    __syncthreads();     // K visible; the previous tile's P V is done, so V is free
    fill_tile<T, DH, TKV, THREADS>(Vs, DH, vp, a.vs.s, k0, a.Skv, a.dh, vec);
    cp_async_commit();   // lands while Q K^T and the softmax run

    float s[RQ][CK];
#pragma unroll
    for (int r = 0; r < RQ; ++r)
#pragma unroll
      for (int c = 0; c < CK; ++c) s[r][c] = 0.f;
#pragma unroll 2
    for (int d0 = 0; d0 < DH; d0 += 4) {
      float kf[4][CK];
#pragma unroll
      for (int c = 0; c < CK; ++c) {
        const float4 k4 = ld4(Ks + (tx + NC * c) * C::KS + d0);
        kf[0][c] = k4.x;
        kf[1][c] = k4.y;
        kf[2][c] = k4.z;
        kf[3][c] = k4.w;
      }
#pragma unroll
      for (int r = 0; r < RQ; ++r) {
        const float4 q4 = ld4(Qs + (ty + NR * r) * C::KS + d0);
        const float qv[4] = {q4.x, q4.y, q4.z, q4.w};
        // consecutive FMAs update different scores: no dependent chain
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int c = 0; c < CK; ++c) s[r][c] = fmaf(qv[e], kf[e][c], s[r][c]);
      }
    }
    cp_async_wait<0>();  // this tile's V
    __syncthreads();     // every thread is done with K; V is visible
    if (t < t_hi)
      fill_tile<T, DH, TKV, THREADS>(Ks, C::KS, kp, a.ks.s, k0 + TKV, a.Skv, a.dh, vec);
    cp_async_commit();  // lands while the softmax and P V run

    // block-uniform: no row of this tile needs a mask
    const bool full = k0 + TKV <= a.Skv &&
                      (!a.causal || (k0 + TKV - 1 <= off + q0 &&
                                     (a.window <= 0 || off + q_last - k0 < a.window)));

    // mask, online softmax; P^T to shared memory
#pragma unroll
    for (int r = 0; r < RQ; ++r) {
      const int qpos = off + q0 + ty + NR * r;
      float mx = NEG;
#pragma unroll
      for (int c = 0; c < CK; ++c) {
        const int kpos = k0 + tx + NC * c;
        bool live = full || kpos < a.Skv;
        if (a.causal && !full)
          live = live && kpos <= qpos && (a.window <= 0 || qpos - kpos < a.window);
        s[r][c] = live ? s[r][c] * sl2 : NEG;
        mx = fmaxf(mx, s[r][c]);
      }
#pragma unroll
      for (int o = NC / 2; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = fast_exp2(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < CK; ++c) {
        s[r][c] = fast_exp2(s[r][c] - m_new);
        sum += s[r][c];
      }
      l[r] = l[r] * alpha + sum;
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] *= alpha;
      m[r] = m_new;
    }
#pragma unroll
    for (int c = 0; c < CK; ++c) {
      float* pr = Pt + (tx + NC * c) * C::PS + RQ * ty;
      st4(pr, make_float4(s[0][c], s[1][c], s[2][c], s[3][c]));
      st4(pr + 4, make_float4(s[4][c], s[5][c], s[6][c], s[7][c]));
    }
    __syncwarp();  // a row's P comes from the lanes of its own warp

#pragma unroll 4
    for (int j = 0; j < TKV; ++j) {
      const float4 p0 = ld4(Pt + j * C::PS + RQ * ty);
      const float4 p1 = ld4(Pt + j * C::PS + RQ * ty + 4);
      const float p[RQ] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        const float4 v4 = ld4(Vs + j * DH + 4 * NC * g + 4 * tx);
#pragma unroll
        for (int r = 0; r < RQ; ++r) {
          acc[r][4 * g] = fmaf(p[r], v4.x, acc[r][4 * g]);
          acc[r][4 * g + 1] = fmaf(p[r], v4.y, acc[r][4 * g + 1]);
          acc[r][4 * g + 2] = fmaf(p[r], v4.z, acc[r][4 * g + 2]);
          acc[r][4 * g + 3] = fmaf(p[r], v4.w, acc[r][4 * g + 3]);
        }
      }
    }
  }

  T* op = a.o + b * a.os.b + h * a.os.h;
#pragma unroll
  for (int r = 0; r < RQ; ++r) {
    float lr = l[r];
#pragma unroll
    for (int o = NC / 2; o > 0; o >>= 1) lr += __shfl_xor_sync(0xffffffffu, lr, o);
    const int row = q0 + ty + NR * r;
    if (row >= a.Sq) continue;
    const float inv = 1.f / fmaxf(lr, 1e-30f);
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const int col = 4 * NC * g + 4 * tx;  // padded columns are not written
      T* dst = op + row * a.os.s + col;
      if ((a.dh & 3) == 0) {  // o's rows are dh wide, so 4-aligned: vector stores
        if (col < a.dh)
          st4(dst, make_float4(acc[r][4 * g] * inv, acc[r][4 * g + 1] * inv,
                               acc[r][4 * g + 2] * inv, acc[r][4 * g + 3] * inv));
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (col + e < a.dh) dst[e] = from_f32<T>(acc[r][4 * g + e] * inv);
      }
    }
  }
}

template <typename T, int DH>
int launch(const Args<T>& a, int B, cudaStream_t s) {
  using C = Cfg<T, DH>;
  // above 48 KB a block's shared memory must be allowed per function and
  // device; set once, so that a launch inside a CUDA graph capture makes
  // no other runtime call
  static int allowed_on = -1;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (allowed_on != dev) {
    err = cudaFuncSetAttribute(flash_fwd<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)C::bytes);
    if (err != cudaSuccess) return (int)err;
    allowed_on = dev;
  }
  const int tiles = (a.Sq + C::TQ - 1) / C::TQ;
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(B * a.H), (unsigned)tiles);
  flash_fwd<T, DH><<<grid, C::THREADS, C::bytes, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int dh, const void* q, const void* k, const void* v, void* o, int B, int Sq, int Skv,
             int H, int Kv, const long long* st, int causal, int window, float scale,
             cudaStream_t s) {
  // cp.async needs every row it copies 16-byte aligned
  auto aligned = [&](const void* p, int first) {
    bool ok = (uintptr_t)p % 16 == 0;
    for (int i = first; i < first + 3; ++i) ok = ok && (st[i] * (long long)sizeof(T)) % 16 == 0;
    return ok;
  };
  const bool rows16 = (dh * (int)sizeof(T)) % 16 == 0;  // whole 16-byte copies per row
  const int vec = (rows16 && aligned(q, 0) ? 1 : 0) |
                  (rows16 && aligned(k, 3) && aligned(v, 6) ? 2 : 0);
  const Args<T> a{static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
                  static_cast<T*>(o),
                  Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
                  Strides{st[6], st[7], st[8]},
                  Strides{(long long)Sq * H * dh, (long long)H * dh, (long long)dh},
                  Sq, Skv, H, H / Kv, dh, causal, window, vec, scale};
  // the next instantiated width; the columns past dh are zero-filled
  if (dh <= 64) return launch<T, 64>(a, B, s);
  if (dh <= 128) return launch<T, 128>(a, B, s);
  return launch<T, 256>(a, B, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; dh: 1 to 256. q, k and v are read through
// their batch, sequence and head strides (elements; the dh axis contiguous);
// o is a contiguous [B, Sq, H, dh] of q's type. window: 0 = none (ignored
// unless causal). Launches on `stream` and returns cudaGetLastError()
// (0 = ok) or cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int flash_attention_launch(int dtype, int dh, const void* q, const void* k,
                                      const void* v, void* o, int B, int Sq, int Skv, int H,
                                      int Kv, long long q_sb, long long q_ss, long long q_sh,
                                      long long k_sb, long long k_ss, long long k_sh,
                                      long long v_sb, long long v_ss, long long v_sh, int causal,
                                      int window, float scale, void* stream) {
  if (dh <= 0 || dh > 256 || B <= 0 || Sq <= 0 || Skv <= 0 || H <= 0 || Kv <= 0 ||
      H % Kv != 0 || window < 0 ||
      (causal && Sq > Skv) || (long long)B * H > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const long long st[9] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(dh, q, k, v, o, B, Sq, Skv, H, Kv, st, causal, window, scale, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(dh, q, k, v, o, B, Sq, Skv, H, Kv, st, causal, window, scale,
                                   s);
  return (int)cudaErrorInvalidValue;
}
