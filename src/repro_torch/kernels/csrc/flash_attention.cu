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
// H100 SXM), against 0.03 ms for the bytes.
//
// Design. The TPU kernel walks the key tiles as the innermost, sequential grid
// dimension and carries the running max m, the sum l and the accumulator in
// VMEM scratch from one grid step to the next. Hopper blocks run in parallel
// and carry nothing over, so here one block owns one 64-row query tile of one
// (b, h) and loops over the 64-key tiles itself, with m, l and the [64, dh]
// accumulator in registers (256 threads; each holds 4 rows by dh/16 columns).
// It writes its output once: no block writes another's output, no atomics, so
// the result is deterministic. Key tiles past the causal frontier are skipped,
// as the TPU kernel skips them, and so are tiles wholly left of the window;
// a skipped tile would add nothing (a row's -1e30 placeholder terms are
// wiped by the rescale exp(m_old - m_new) = 0 once a real key arrives).
// q, k and v are read in place through their strides: no head-major copy and
// no repeat of K/V for GQA, which the TPU wrapper both makes. The Q tile, the
// transposed K tile, the V tile and the probabilities are staged in dynamic
// shared memory (66 KB at dh 64, 116 KB at dh 128), rows padded by one float
// against bank conflicts. Plain FFMA arithmetic: no wgmma, no TMA, no
// pipelining; float32 runs in full float32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int TQ = 64;   // query rows per block
constexpr int TKV = 64;  // keys per tile
constexpr int THREADS = 256;
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
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
  int Sq, Skv, H, G;  // G = H / Kv query heads per kv head
  int causal, window;  // window 0: none
  float scale;
};

// Dynamic shared memory, in floats: Q [TQ][DH+1], K^T [DH][TKV+1],
// V [TKV][DH], P [TQ][TKV+1].
template <int DH>
struct Layout {
  static constexpr int QS = DH + 1;
  static constexpr int KS = TKV + 1;
  static constexpr int PS = TKV + 1;
  static constexpr int k_off = TQ * QS;
  static constexpr int v_off = k_off + DH * KS;
  static constexpr int p_off = v_off + TKV * DH;
  static constexpr size_t bytes = (size_t)(p_off + TQ * PS) * sizeof(float);
};

// max / sum over the 16 threads of a half-warp that share one row
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS) flash_fwd(const Args<T> a) {
  constexpr int C = DH / 16;  // accumulator columns per thread
  using L = Layout<DH>;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Kt = smem + L::k_off;
  float* Vs = smem + L::v_off;
  float* Ps = smem + L::p_off;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;  // thread owns rows ty + 16 r, columns tx + 16 c
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * TQ;  // the longest causal tiles start first
  const int off = a.Skv - a.Sq;  // query i sits at key position off + i
  const int q_last = min(q0 + TQ, a.Sq) - 1;

  const T* qp = a.q + b * a.qs.b + h * a.qs.h;
  const T* kp = a.k + b * a.ks.b + (h / a.G) * a.ks.h;
  const T* vp = a.v + b * a.vs.b + (h / a.G) * a.vs.h;

  for (int e = tid; e < TQ * DH; e += THREADS) {
    const int i = e / DH, d = e % DH;
    const int row = q0 + i;
    Qs[i * L::QS + d] = row < a.Sq ? to_f32(qp[row * a.qs.s + d]) : 0.f;
  }

  // the key tiles any row of this query tile can see: [t_lo, t_hi]
  int t_lo = 0, t_hi = (a.Skv + TKV - 1) / TKV - 1;
  if (a.causal) {
    t_hi = min(t_hi, (off + q_last) / TKV);
    if (a.window > 0) t_lo = max(0, (off + q0 - a.window + 1) / TKV);
  }

  float m[4], l[4], acc[4][C];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = NEG;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[r][c] = 0.f;
  }

  for (int t = t_lo; t <= t_hi; ++t) {
    const int k0 = t * TKV;
    __syncthreads();  // Q is staged; the previous tile's K, V and P are consumed
    for (int e = tid; e < TKV * DH; e += THREADS) {
      const int j = e / DH, d = e % DH;
      const int key = k0 + j;
      const bool in = key < a.Skv;
      Kt[d * L::KS + j] = in ? to_f32(kp[key * a.ks.s + d]) : 0.f;
      Vs[j * DH + d] = in ? to_f32(vp[key * a.vs.s + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
#pragma unroll 16
    for (int d = 0; d < DH; ++d) {
      float qa[4], kb[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) qa[r] = Qs[(ty + 16 * r) * L::QS + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kb[c] = Kt[d * L::KS + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = fmaf(qa[r], kb[c], s[r][c]);
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qpos = off + q0 + ty + 16 * r;
      float mx = NEG;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kpos = k0 + tx + 16 * c;
        bool live = kpos < a.Skv;
        if (a.causal) live = live && kpos <= qpos && (a.window <= 0 || qpos - kpos < a.window);
        s[r][c] = live ? s[r][c] * a.scale : NEG;
        mx = fmaxf(mx, s[r][c]);
      }
      const float m_new = fmaxf(m[r], row_max(mx));
      const float alpha = expf(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(s[r][c] - m_new);
        Ps[(ty + 16 * r) * L::PS + tx + 16 * c] = p;
        sum += p;
      }
      l[r] = l[r] * alpha + row_sum(sum);
#pragma unroll
      for (int c = 0; c < C; ++c) acc[r][c] *= alpha;
      m[r] = m_new;
    }
    __syncthreads();

#pragma unroll 16
    for (int j = 0; j < TKV; ++j) {
      float pa[4], vv[C];
#pragma unroll
      for (int r = 0; r < 4; ++r) pa[r] = Ps[(ty + 16 * r) * L::PS + j];
#pragma unroll
      for (int c = 0; c < C; ++c) vv[c] = Vs[j * DH + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < C; ++c) acc[r][c] = fmaf(pa[r], vv[c], acc[r][c]);
    }
  }

  T* op = a.o + b * a.os.b + h * a.os.h;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + ty + 16 * r;
    if (row >= a.Sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < C; ++c) op[row * a.os.s + tx + 16 * c] = from_f32<T>(acc[r][c] / denom);
  }
}

template <typename T, int DH>
int launch(const Args<T>& a, int B, cudaStream_t s) {
  const size_t smem = Layout<DH>::bytes;
  // above 48 KB a block's shared memory must be allowed per function and
  // device; set once, so that a launch inside a CUDA graph capture makes
  // no other runtime call
  static int allowed_on = -1;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (allowed_on != dev) {
    err = cudaFuncSetAttribute(flash_fwd<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    allowed_on = dev;
  }
  const dim3 grid((unsigned)(B * a.H), (unsigned)((a.Sq + TQ - 1) / TQ));
  flash_fwd<T, DH><<<grid, THREADS, smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int dh, const void* q, const void* k, const void* v, void* o, int B, int Sq, int Skv,
             int H, int Kv, const long long* st, int causal, int window, float scale,
             cudaStream_t s) {
  const Args<T> a{static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
                  static_cast<T*>(o),
                  Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
                  Strides{st[6], st[7], st[8]},
                  Strides{(long long)Sq * H * dh, (long long)H * dh, (long long)dh},
                  Sq, Skv, H, H / Kv, causal, window, scale};
  if (dh == 64) return launch<T, 64>(a, B, s);
  if (dh == 128) return launch<T, 128>(a, B, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; dh: 64 or 128. q, k and v are read through
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
  if (B <= 0 || Sq <= 0 || Skv <= 0 || H <= 0 || Kv <= 0 || H % Kv != 0 || window < 0 ||
      (causal && Sq > Skv) || (Sq + TQ - 1) / TQ > 65535 || (long long)B * H > 0x7fffffffLL)
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
