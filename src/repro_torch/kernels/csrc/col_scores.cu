// Column score reduction for Hopper (sm_90a): G [N, n], float32 or bfloat16,
// to scores [n] float32, sum_rows |G| ("l1", mode 0) or sum_rows G^2 ("l2",
// mode 1), accumulated in float32 for either input type.
//
// Replaces the Pallas TPU kernel repro/kernels/col_scores.py::col_l1_scores.
// What bounds it: it reads G once and writes [n]: two operations per element
// against four (or two) bytes, so it is bound by device-memory bytes
// (3.35 TB/s on an H100 SXM).
//
// Design: one launch. The grid is (column strips) x (row splits). A strip is
// 32 x V columns, V = 16 / sizeof(T) (128 float32 or 256 bf16 columns), so a
// warp reads 512 contiguous bytes of a row with one 16-byte load per thread.
// A block of 8 warps takes its split's rows, warp w the rows w, w + 8, ...,
// with U rows' loads in flight per thread before it accumulates them (U = 16
// for float32, 8 for bf16: 256 or 128 bytes a thread), and the wrapper picks
// the split, a multiple of 8 U rows, so that at most about four blocks per SM
// are in flight (at the path's [2048, 768] float32, 16 splits of 128 rows, 96
// blocks: fewer blocks with more loads in flight measured faster than more
// blocks with fewer, as they leave fewer partial rows to the finish). Then:
//   1. the block sums its 8 warps' partials in warp order and writes its
//      float32 partial row into the scratch part[split, strip's columns];
//   2. __threadfence(), then one thread takes a ticket from the strip's
//      counter (an integer atomicAdd; no float atomics);
//   3. the block that takes the last ticket sums the strip's partial rows in
//      split order into scores and resets the counter to 0 for the next call.
// Every sum has a fixed order (a thread's rows ascending, warps, splits), so
// the result is the same bits whatever order the blocks run or finish in.
//
// The counters. A launch takes MAX_STRIPS counters; strip s ticks counter
// s % MAX_STRIPS, so a G wider than MAX_STRIPS strips (131,072 float32 or
// 262,144 bf16 columns) shares a counter among the k strips s, s + MAX_STRIPS,
// ...: the last of their k * splits tickets finishes all k strips, each in
// split order, and the launch stays one launch at any width. Each (device,
// stream) the wrapper launches on has a slot of counters of its own, so
// concurrent launches never share one, and the kernel leaves them at 0: no
// fill launch per call, and a launch inside a CUDA graph capture works (a
// graph replays on its capture stream's slot). A slot is allocated and
// zeroed once, at its first launch on a device, through a private stream
// and with the thread's capture mode relaxed for that moment, so it can be
// made while a capture is under way (as PyTorch's allocator does); there is
// no cap on the streams.
// Where n is not a multiple of V, or G's pointer is not 16-byte aligned, the
// launcher clears `vec` and every element goes through a masked scalar load;
// a ragged last split or strip is masked either way.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <utility>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int FIN = 32;  // partial rows whose loads the finish has in flight together
constexpr int MAX_STRIPS = 1024;  // counters per slot

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// The V elements of one 16-byte chunk, widened to float32 (exactly for bf16).
__device__ __forceinline__ void unpack(const uint4 w, float (&v)[4]) {
  v[0] = __uint_as_float(w.x);
  v[1] = __uint_as_float(w.y);
  v[2] = __uint_as_float(w.z);
  v[3] = __uint_as_float(w.w);
}
__device__ __forceinline__ void unpack(const uint4 w, float (&v)[8]) {
  const unsigned int u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(u[i] << 16);             // the lower bf16 is element 2 i
    v[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

// Elements per 16-byte load, rows per warp whose loads are in flight together
// (16 loads of float32, 8 of bf16, measured fastest on an H100), and the rows
// of a split's step (a split is a multiple of them).
template <typename T>
__host__ __device__ constexpr int vec_of() { return 16 / (int)sizeof(T); }
template <typename T>
__host__ __device__ constexpr int rows_in_flight() { return 64 / vec_of<T>(); }
template <typename T>
__host__ __device__ constexpr int split_rows_of() { return WARPS * rows_in_flight<T>(); }

template <typename T, int MODE>
__global__ void __launch_bounds__(THREADS)
    col_scores_kernel(const T* __restrict__ G, float* __restrict__ part, float* __restrict__ out,
                      unsigned int* __restrict__ counters, int N, int n, int split_rows,
                      int splits, int vec) {
  constexpr int V = vec_of<T>();
  constexpr int U = rows_in_flight<T>();
  constexpr int SW = 32 * V;  // strip width
  static_assert(SW <= THREADS, "one thread per column of the strip in the sums below");
  __shared__ __align__(16) float red[WARPS][SW];
  __shared__ unsigned int ticket;

  const int strip = blockIdx.x, split = blockIdx.y;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int c = strip * SW + lane * V;  // this thread's first column
  const int r0 = split * split_rows;
  const int r1 = min(N, r0 + split_rows);

  float acc[V];
#pragma unroll
  for (int e = 0; e < V; ++e) acc[e] = 0.f;
  for (int r = r0 + warp; r < r1; r += WARPS * U) {
    float v[U][V];
#pragma unroll
    for (int u = 0; u < U; ++u) {  // all U rows' loads first
      const int row = r + u * WARPS;
      const T* src = G + (size_t)row * n + c;
      if (vec) {
        if (row < r1 && c < n) {
          unpack(__ldg(reinterpret_cast<const uint4*>(src)), v[u]);
        } else {
#pragma unroll
          for (int e = 0; e < V; ++e) v[u][e] = 0.f;
        }
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) v[u][e] = row < r1 && c + e < n ? to_f32(src[e]) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)  // rows in ascending order; a masked 0 adds nothing
#pragma unroll
      for (int e = 0; e < V; ++e)
        acc[e] = MODE == 0 ? acc[e] + fabsf(v[u][e]) : fmaf(v[u][e], v[u][e], acc[e]);
  }
#pragma unroll
  for (int e = 0; e < V; e += 4)
    *reinterpret_cast<float4*>(&red[warp][lane * V + e]) =
        make_float4(acc[e], acc[e + 1], acc[e + 2], acc[e + 3]);
  __syncthreads();

  const int col = strip * SW + threadIdx.x;
  const bool mine = threadIdx.x < SW && col < n;
  if (mine) {
    float p = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) p += red[w][threadIdx.x];  // warp order
    part[(size_t)split * n + col] = p;
  }
  __threadfence();  // this block's partial row is visible before its ticket
  __syncthreads();
  // strips strip % MAX_STRIPS + MAX_STRIPS j share this counter
  const int cidx = strip % MAX_STRIPS;
  const unsigned int sharing = (unsigned int)((gridDim.x - 1 - cidx) / MAX_STRIPS + 1);
  unsigned int* counter = counters + cidx;
  if (threadIdx.x == 0) ticket = atomicAdd(counter, 1u);
  __syncthreads();
  if (ticket != sharing * (unsigned int)splits - 1u) return;

  // the counter's last block: every split's partial row of its strips is written
  __threadfence();
  for (int s = cidx; s < (int)gridDim.x; s += MAX_STRIPS) {
    const int fcol = s * SW + threadIdx.x;
    if (threadIdx.x >= SW || fcol >= n) continue;
    float q = 0.f;
    for (int s0 = 0; s0 < splits; s0 += FIN) {
      float v[FIN];
#pragma unroll
      for (int i = 0; i < FIN; ++i)
        v[i] = s0 + i < splits ? __ldcg(part + (size_t)(s0 + i) * n + fcol) : 0.f;
#pragma unroll
      for (int i = 0; i < FIN; ++i)
        if (s0 + i < splits) q += v[i];  // split order
    }
    out[fcol] = q;
  }
  if (threadIdx.x == 0) *counter = 0u;  // every block of its strips has taken its ticket
}

std::mutex slots_mu;
std::map<std::pair<int, int>, unsigned int*> slots;  // (device, slot) -> counters

// The counters of `slot` on the current device, allocated and zeroed at its
// first launch.
int slot_counters(int slot, unsigned int** out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  std::lock_guard<std::mutex> lock(slots_mu);
  const auto key = std::make_pair(dev, slot);
  const auto it = slots.find(key);
  if (it != slots.end()) {
    *out = it->second;
    return 0;
  }
  // allowed while a capture is under way on this thread: the allocation and
  // the zeroing run now, on a stream of their own, and are not captured
  cudaStreamCaptureMode mode = cudaStreamCaptureModeRelaxed;
  err = cudaThreadExchangeStreamCaptureMode(&mode);
  if (err != cudaSuccess) return (int)err;
  void* p = nullptr;
  cudaStream_t init = nullptr;
  err = cudaMalloc(&p, sizeof(unsigned int) * MAX_STRIPS);
  if (err == cudaSuccess) err = cudaStreamCreateWithFlags(&init, cudaStreamNonBlocking);
  if (err == cudaSuccess) err = cudaMemsetAsync(p, 0, sizeof(unsigned int) * MAX_STRIPS, init);
  if (err == cudaSuccess) err = cudaStreamSynchronize(init);
  if (init != nullptr) cudaStreamDestroy(init);
  cudaThreadExchangeStreamCaptureMode(&mode);  // the caller's mode again
  if (err != cudaSuccess) {
    if (p != nullptr) cudaFree(p);
    return (int)err;
  }
  slots[key] = static_cast<unsigned int*>(p);  // kept for the process's life
  *out = static_cast<unsigned int*>(p);
  return 0;
}

template <typename T>
int launch(const void* G, void* part, void* out, int N, int n, int split_rows, int splits,
           int slot, int mode, cudaStream_t s) {
  constexpr int SW = 32 * vec_of<T>();
  const int strips = (n + SW - 1) / SW;
  if (split_rows % split_rows_of<T>() != 0) return (int)cudaErrorInvalidValue;
  if (splits > 65535) return (int)cudaErrorInvalidConfiguration;
  unsigned int* counters = nullptr;
  const int err = slot_counters(slot, &counters);
  if (err != 0) return err;
  const int vec = (uintptr_t)G % 16 == 0 && n % vec_of<T>() == 0;
  const dim3 grid((unsigned)strips, (unsigned)splits);
  const T* g = static_cast<const T*>(G);
  float* p = static_cast<float*>(part);
  float* o = static_cast<float*>(out);
  if (mode == 0)
    col_scores_kernel<T, 0><<<grid, THREADS, 0, s>>>(g, p, o, counters, N, n, split_rows, splits,
                                                     vec);
  else
    col_scores_kernel<T, 1><<<grid, THREADS, 0, s>>>(g, p, o, counters, N, n, split_rows, splits,
                                                     vec);
  return (int)cudaGetLastError();
}

}  // namespace

// G [N, n] (dtype 0 = float32, 1 = bfloat16), part [splits, n] float32
// scratch, out [n] float32; the rows are cut into `splits` splits of
// `split_rows` (a positive multiple of 128 for float32, 64 for bf16; splits =
// ceil(N / split_rows)); slot >= 0: the caller's counters, one slot per
// (device, stream); any n. mode: 0 = "l1", 1 = "l2".
// Launches on `stream` and returns cudaGetLastError() (0 = ok).
extern "C" int cs_launch(int dtype, const void* G, void* part, void* out, int N, int n,
                         int split_rows, int splits, int slot, int mode, void* stream) {
  if (N <= 0 || n <= 0 || split_rows <= 0 ||
      splits != (N + split_rows - 1) / split_rows || slot < 0 ||
      (mode != 0 && mode != 1) || G == nullptr || part == nullptr || out == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(G, part, out, N, n, split_rows, splits, slot, mode, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(G, part, out, N, n, split_rows, splits, slot, mode, s);
  return (int)cudaErrorInvalidValue;
}
