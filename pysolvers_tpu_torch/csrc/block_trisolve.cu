// K8: exact block-banded triangular solve for Hopper (sm_90a).
//
//   x_i = dinv_i b_i - s_hat_i [x_{i-p} ... x_{i-1}],   i = 0 .. nb-1,
//
// over the row blocks of bs rows of a banded triangular factor (zeros
// before block 0), with dinv_i the dense inverse of diagonal block i and
// s_hat_i = dinv_i [S_{i,p} ... S_{i,1}] (nb, bs, p*bs), both row-major.
// b is read and x written in the caller's order: for an upper factor
// (flip) padded position g is original row n-1-g; rows g >= n are padding.
//
// Replaces pysolvers_tpu/ops/block_trisolve.py::block_trisolve (the
// lax.scan at :349-381; XLA ops there, not a Pallas kernel).
//
// What bounds it: device-memory bandwidth in principle (each plan value is
// read once for 2 flops), but the recurrence is serial over the nb blocks:
// block i needs x_{i-1}.  So in practice the latency of one step (its
// reads of s_hat_i, a reduction, a barrier) times nb.
//
// What the design does about it (the simple design; ROADMAP names the
// faster ones):
// - stage 1 (diag_block_kernel), parallel: one 256-thread block per
//   diagonal block computes u_i = dinv_i b_i, a warp per row, so the
//   dinv reads (half the bytes when p = 1) stream at the card's rate.
//   For p = 0 this is the whole solve and writes x directly.
// - stage 2 (recurrence_kernel), serial: ONE 1024-thread block walks the
//   nb steps.  x_{i-p} .. x_i live in a ring of p + 1 blocks in shared
//   memory (x_i goes to slot i mod (p+1), which held x_{i-p-1}), so a step
//   copies nothing and needs one __syncthreads().  A warp computes a row's
//   dot product over the row's contiguous p*bs values of s_hat_i, lanes
//   on neighbouring values (coalesced), and four rows at a time, so each
//   lane keeps four independent loads in flight.
// Both stages launch on the caller's stream from one C call (one K8
// launch per solve for the wrapper's count); nothing synchronises.
//
// Plain C interface for ctypes: each entry returns cudaGetLastError(); the
// wrapper raises if it is not 0.

#include <cuda_runtime.h>

namespace {

constexpr int kStage1Threads = 256;
constexpr int kStage2Threads = 1024;
constexpr int kRows = 4;  // rows per warp at once in stage 2

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ long long caller_row(long long g, long long n,
                                                int flip) {
  return flip ? n - 1 - g : g;
}

template <typename T>
__global__ void __launch_bounds__(kStage1Threads)
diag_block_kernel(const T* __restrict__ dinv, const T* __restrict__ b,
                  T* __restrict__ out, long long n, int bs, int flip,
                  int final_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* bi = reinterpret_cast<T*>(smem_raw);
  const long long base = (long long)blockIdx.x * bs;
  for (int k = threadIdx.x; k < bs; k += blockDim.x) {
    const long long g = base + k;
    bi[k] = g < n ? b[caller_row(g, n, flip)] : T(0);
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const T* D = dinv + base * bs;
  for (int r = threadIdx.x >> 5; r < bs; r += warps) {
    const T* row = D + (long long)r * bs;
    T acc = T(0);
#pragma unroll 4
    for (int k = lane; k < bs; k += 32) acc += row[k] * bi[k];
    acc = warp_sum(acc);
    if (lane == 0) {
      const long long g = base + r;
      if (!final_out)
        out[g] = acc;
      else if (g < n)
        out[caller_row(g, n, flip)] = acc;
    }
  }
}

// R rows of step i: rows r0, r0 + stride, ... of s_hat_i against the
// carry blocks in the ring; the results go to the ring's slot of x_i and
// to x.
template <typename T, int R>
__device__ __forceinline__ void step_rows(
    const T* __restrict__ S, const T* __restrict__ u, T* ring,
    T* __restrict__ x, long long i, int r0, int stride, int bs, int p,
    long long n, int flip, int lane) {
  const long long width = (long long)p * bs;
  const int slots = p + 1;
  T acc[R];
#pragma unroll
  for (int q = 0; q < R; ++q) acc[q] = T(0);
  for (int j = 0; j < p; ++j) {
    // x_{i-p+j} sits in slot (i - p + j) mod (p + 1) = (i + 1 + j) mod
    // (p + 1); before block 0 that slot is still zero
    const T* xj = ring + (int)((i + 1 + j) % slots) * bs;
    const T* Sj = S + (long long)j * bs;
#pragma unroll 2
    for (int k = lane; k < bs; k += 32) {
      const T xv = xj[k];
#pragma unroll
      for (int q = 0; q < R; ++q)
        acc[q] += Sj[(long long)(r0 + q * stride) * width + k] * xv;
    }
  }
  T* xi = ring + (int)(i % slots) * bs;
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const T s = warp_sum(acc[q]);
    if (lane == 0) {
      const int r = r0 + q * stride;
      const long long g = i * bs + r;
      const T v = u[g] - s;
      xi[r] = v;
      if (g < n) x[caller_row(g, n, flip)] = v;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kStage2Threads, 1)
recurrence_kernel(const T* __restrict__ s_hat, const T* __restrict__ u,
                  T* __restrict__ x, long long n, long long nb, int bs,
                  int p, int flip) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);  // (p + 1) * bs
  for (int k = threadIdx.x; k < (p + 1) * bs; k += blockDim.x) ring[k] = T(0);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const long long block_vals = (long long)bs * p * bs;
  for (long long i = 0; i < nb; ++i) {
    const T* S = s_hat + i * block_vals;
    int r = warp;
    for (; r + (kRows - 1) * warps < bs; r += kRows * warps)
      step_rows<T, kRows>(S, u, ring, x, i, r, warps, bs, p, n, flip, lane);
    for (; r < bs; r += warps)
      step_rows<T, 1>(S, u, ring, x, i, r, warps, bs, p, n, flip, lane);
    __syncthreads();
  }
}

template <typename T>
int launch(const void* s_hat, const void* dinv, const void* b, void* u,
           void* x, long long n, long long nb, int bs, int p, int flip,
           void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  diag_block_kernel<T><<<(unsigned)nb, kStage1Threads,
                         (size_t)bs * sizeof(T), st>>>(
      (const T*)dinv, (const T*)b, (T*)(p ? u : x), n, bs, flip, p == 0);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p == 0) return (int)err;
  recurrence_kernel<T><<<1, kStage2Threads,
                         (size_t)(p + 1) * bs * sizeof(T), st>>>(
      (const T*)s_hat, (const T*)u, (T*)x, n, nb, bs, p, flip);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int block_trisolve_f32(const void* s_hat, const void* dinv,
                                  const void* b, void* u, void* x,
                                  long long n, long long nb, int bs, int p,
                                  int flip, void* stream) {
  return launch<float>(s_hat, dinv, b, u, x, n, nb, bs, p, flip, stream);
}

extern "C" int block_trisolve_f64(const void* s_hat, const void* dinv,
                                  const void* b, void* u, void* x,
                                  long long n, long long nb, int bs, int p,
                                  int flip, void* stream) {
  return launch<double>(s_hat, dinv, b, u, x, n, nb, bs, p, flip, stream);
}
