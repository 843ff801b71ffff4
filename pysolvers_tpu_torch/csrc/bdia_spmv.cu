// K4 and K5: planar block-DIA SpMV and lockstep SpMM for Hopper (sm_90a).
//
// The block-DIA layout (sparse/bdia.py): D block offsets off_d, b×b blocks,
// nb block rows, planes[((d * b + q) * b + p) * nb_pad + i] =
// A[i * b + p, (i + off_d) * b + q], vectors in planar (dof-major) order.
//
//   K4:  y[p * nb + i] = sum_d sum_q planes[d, q, p, i] * x[q * nb + i + off_d]
//   K5:  Y[r, p * nb + i] = sum_d sum_q planes[d, q, p, i] * V[r, q * nb + i + off_d]
//        for the k <= 16 rows r of a row-layout (k, b * nb) block,
//
// with x (each row of V) taken as zero outside [0, nb) PER DOF: the mask is
// 0 <= i + off_d < nb, never a bound on the whole planar vector, which would
// read dof q +- 1's values at the ends of a row.  Planes stride by nb_pad
// (>= nb); x, y and the rows of V and Y by nb.
//
// Replaces pysolvers_tpu/ops/spmv.py::bdia_spmv_pallas (K4, kernel
// _bdia_kernel) and ::bdia_spmm_tiles (K5, kernel _bdia_spmm_kernel).
//
// What bounds them: device-memory bandwidth.  The planes are D * b * b
// values per block row (25 * 5 = 125 at b = 5, D = 5), read once per call,
// for two flops each; x and y add 2 * b values per block row.  K5 reads the
// planes once for all k rows, so its bytes per row fall about k-fold.
//
// What the design does about it:
// - K4: one thread per block row i and group of up to 8 output dofs p
//   (grid.y groups; all b dofs in one group for b <= 8).  For fixed (d, q, p)
//   neighbouring threads read neighbouring plane entries, so every plane
//   read is coalesced; each x value x[q, i + off_d] is loaded once and used
//   for all the thread's p.  The per-p accumulators live in registers (the
//   group width is a template parameter).
// - K5: one thread per block row i (threads along i, so every plane and V
//   read is coalesced) and group of PB output dofs, holding acc[PB][K] for
//   the PB dofs and K >= k rows in registers.  For each (q, d) it loads the
//   k values V[r, q, i + off_d] once and the PB plane values, all before
//   the first of the PB * k FMAs, so 13 loads are in flight per thread at
//   b = 5, k = 8: each V value passes through L1/L2 D * ceil(b / PB) times
//   per call, not D * b times (one thread per (i, p) re-read it for every
//   p and was bound by those loads, not by device memory).  q is the outer
//   loop, so the reads at i - 1, i, i + 1 follow each other in L1; each
//   output thus adds its D * b terms in (q, d) order, the twin in (d, q).
//   PB and the row capacity K (1, 2, 4, 8 or 16; rows past k are masked)
//   are template parameters with PB * K <= kSpmmAcc, so the accumulators
//   never spill; grid.y = ceil(b / PB) balanced groups (one group at
//   b = 5, k = 8).  More than 16 rows are chunked by the wrapper.  The
//   kernel stays bound by device memory (2 flops per 8-byte plane value),
//   so there is no case for wgmma or the f64 tensor cores.
// - x (V) is not staged: the shifted reads of neighbouring threads hit the
//   same lines (the +-1 neighbours in L1, the +-m rows in L2), so x comes
//   from device memory about once.  The TPU kernels' x windows, VMEM tile
//   budget and halo tiles have no counterpart.  The offsets are staged in
//   shared memory.
//
// Indices are 64-bit, as in K1.
//
// Plain C interface for ctypes: every entry launches on the given stream and
// returns cudaGetLastError() (or cudaErrorInvalidValue for an argument the
// kernels do not take); the wrapper raises if it is not 0.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;          // K4
constexpr int kSpmmThreads = 128;      // K5
constexpr long long kMaxBlocks = 8192;  // beyond this the grid-stride loop
constexpr int kMaxGroup = 8;            // output dofs per thread
constexpr int kMaxRows = 16;            // K5: right-hand sides per launch
constexpr int kSpmmAcc = 64;            // K5: accumulators per thread

__device__ __forceinline__ void stage_offsets(const int* offsets, int* s_off,
                                              int n_offsets) {
  for (int d = threadIdx.x; d < n_offsets; d += blockDim.x)
    s_off[d] = offsets[d];
  __syncthreads();
}

template <typename T, int PB>
__global__ void __launch_bounds__(kThreads)
bdia_spmv_kernel(const T* __restrict__ planes, const int* __restrict__ offsets,
                 const T* __restrict__ x, T* __restrict__ y, long long nb,
                 long long nb_pad, int b, int n_offsets) {
  extern __shared__ int s_off[];
  stage_offsets(offsets, s_off, n_offsets);
  const int p0 = blockIdx.y * PB;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < nb; i += stride) {
    T acc[PB];
#pragma unroll
    for (int j = 0; j < PB; ++j) acc[j] = T(0);
    for (int d = 0; d < n_offsets; ++d) {
      const long long col = i + s_off[d];
      if (col < 0 || col >= nb) continue;
      for (int q = 0; q < b; ++q) {
        const T xv = x[(long long)q * nb + col];
        const T* pl = planes + ((long long)(d * b + q) * b + p0) * nb_pad + i;
#pragma unroll
        for (int j = 0; j < PB; ++j)
          if (p0 + j < b) acc[j] += pl[(long long)j * nb_pad] * xv;
      }
    }
#pragma unroll
    for (int j = 0; j < PB; ++j)
      if (p0 + j < b) y[(long long)(p0 + j) * nb + i] = acc[j];
  }
}

// minBlocks = 1: without it ptxas caps the registers for occupancy (128
// at f64, PB = 5, K = 8), which schedules fewer loads ahead of the FMAs
template <typename T, int PB, int K>
__global__ void __launch_bounds__(kSpmmThreads, 1)
bdia_spmm_kernel(const T* __restrict__ planes, const int* __restrict__ offsets,
                 const T* __restrict__ v, T* __restrict__ out, long long nb,
                 long long nb_pad, int b, int n_offsets, int k) {
  extern __shared__ int s_off[];
  stage_offsets(offsets, s_off, n_offsets);
  const int p0 = blockIdx.y * PB;
  const long long ld = (long long)b * nb;  // row stride of V and Y
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < nb; i += stride) {
    T acc[PB][K];
#pragma unroll
    for (int j = 0; j < PB; ++j)
#pragma unroll
      for (int r = 0; r < K; ++r) acc[j][r] = T(0);
    // q outer, d inner: the reads of V at i - 1, i, i + 1 follow each
    // other, so the lines stay in L1.  Not unrolled: the loads of one
    // (q, d) step are meant to fill the memory pipe, and unrolled steps
    // would add registers
#pragma unroll 1
    for (int q = 0; q < b; ++q) {
#pragma unroll 1
      for (int d = 0; d < n_offsets; ++d) {
        const long long col = i + s_off[d];
        if (col < 0 || col >= nb) continue;
        // the k values V[r, q, i + off_d], loaded once for all PB dofs,
        // and the PB plane values, all issued before the first FMA
        const T* vq = v + (long long)q * nb + col;
        T vr[K];
#pragma unroll
        for (int r = 0; r < K; ++r) vr[r] = r < k ? vq[r * ld] : T(0);
        const T* pl = planes + ((long long)(d * b + q) * b + p0) * nb_pad + i;
        T a[PB];
#pragma unroll
        for (int j = 0; j < PB; ++j)
          a[j] = p0 + j < b ? pl[(long long)j * nb_pad] : T(0);
#pragma unroll
        for (int j = 0; j < PB; ++j)
#pragma unroll
          for (int r = 0; r < K; ++r) acc[j][r] += a[j] * vr[r];
      }
    }
#pragma unroll
    for (int j = 0; j < PB; ++j)
      if (p0 + j < b)
#pragma unroll
        for (int r = 0; r < K; ++r)
          if (r < k) out[r * ld + (long long)(p0 + j) * nb + i] = acc[j][r];
  }
}

unsigned grid_x(long long nb, int threads = kThreads) {
  long long blocks = (nb + threads - 1) / threads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  return (unsigned)blocks;
}

template <typename T, int PB>
void launch_spmv(const void* planes, const void* offsets, const void* x,
                 void* y, long long nb, long long nb_pad, int b, int n_offsets,
                 cudaStream_t stream) {
  const dim3 grid(grid_x(nb), (unsigned)((b + PB - 1) / PB));
  bdia_spmv_kernel<T, PB><<<grid, kThreads, (size_t)n_offsets * sizeof(int),
                            stream>>>(
      (const T*)planes, (const int*)offsets, (const T*)x, (T*)y, nb, nb_pad, b,
      n_offsets);
}

template <typename T>
int spmv(const void* planes, const void* offsets, const void* x, void* y,
         long long nb, long long nb_pad, long long b, long long n_offsets,
         void* stream_ptr) {
  if (b < 1 || nb_pad < nb || n_offsets < 1 || b * b * n_offsets > (1 << 30))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream_ptr;
  const int bi = (int)b, D = (int)n_offsets;
  switch (b <= kMaxGroup ? bi : kMaxGroup) {
    case 1: launch_spmv<T, 1>(planes, offsets, x, y, nb, nb_pad, bi, D, s); break;
    case 2: launch_spmv<T, 2>(planes, offsets, x, y, nb, nb_pad, bi, D, s); break;
    case 3: launch_spmv<T, 3>(planes, offsets, x, y, nb, nb_pad, bi, D, s); break;
    case 4: launch_spmv<T, 4>(planes, offsets, x, y, nb, nb_pad, bi, D, s); break;
    case 5: launch_spmv<T, 5>(planes, offsets, x, y, nb, nb_pad, bi, D, s); break;
    case 6: launch_spmv<T, 6>(planes, offsets, x, y, nb, nb_pad, bi, D, s); break;
    case 7: launch_spmv<T, 7>(planes, offsets, x, y, nb, nb_pad, bi, D, s); break;
    default: launch_spmv<T, 8>(planes, offsets, x, y, nb, nb_pad, bi, D, s); break;
  }
  return (int)cudaGetLastError();
}

template <typename T, int PB, int K>
void launch_spmm(const void* planes, const void* offsets, const void* v,
                 void* out, long long nb, long long nb_pad, int b,
                 int n_offsets, int k, unsigned groups, cudaStream_t stream) {
  const dim3 grid(grid_x(nb, kSpmmThreads), groups);
  bdia_spmm_kernel<T, PB, K>
      <<<grid, kSpmmThreads, (size_t)n_offsets * sizeof(int), stream>>>(
          (const T*)planes, (const int*)offsets, (const T*)v, (T*)out, nb,
          nb_pad, b, n_offsets, k);
}

// K5 at a row capacity K: the b output dofs in grid.y = ceil(b / PB)
// balanced groups of PB <= min(8, kSpmmAcc / K).
template <typename T, int K>
void spmm_rows(const void* planes, const void* offsets, const void* v,
               void* out, long long nb, long long nb_pad, int b,
               int n_offsets, int k, cudaStream_t s) {
  constexpr int kPbMax = kSpmmAcc / K < kMaxGroup ? kSpmmAcc / K : kMaxGroup;
  const int groups = (b + kPbMax - 1) / kPbMax;
  const int pb = (b + groups - 1) / groups;
#define PST_SPMM_PB(PBV)                                                    \
  case PBV:                                                                 \
    if constexpr (PBV <= kPbMax)                                            \
      launch_spmm<T, PBV, K>(planes, offsets, v, out, nb, nb_pad, b,        \
                             n_offsets, k, (unsigned)groups, s);            \
    break;
  switch (pb) {
    PST_SPMM_PB(1) PST_SPMM_PB(2) PST_SPMM_PB(3) PST_SPMM_PB(4)
    PST_SPMM_PB(5) PST_SPMM_PB(6) PST_SPMM_PB(7) PST_SPMM_PB(8)
  }
#undef PST_SPMM_PB
}

template <typename T>
int spmm(const void* planes, const void* offsets, const void* v, void* out,
         long long nb, long long nb_pad, long long b, long long n_offsets,
         long long k, void* stream_ptr) {
  if (b < 1 || b > 65535 || nb_pad < nb || n_offsets < 1 || k < 1 ||
      k > kMaxRows || b * b * n_offsets > (1 << 30))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream_ptr;
  const int bi = (int)b, D = (int)n_offsets, ki = (int)k;
  // row capacities 1, 2, 4, 8, 16: rows past k are masked
  if (ki == 1)
    spmm_rows<T, 1>(planes, offsets, v, out, nb, nb_pad, bi, D, ki, s);
  else if (ki <= 2)
    spmm_rows<T, 2>(planes, offsets, v, out, nb, nb_pad, bi, D, ki, s);
  else if (ki <= 4)
    spmm_rows<T, 4>(planes, offsets, v, out, nb, nb_pad, bi, D, ki, s);
  else if (ki <= 8)
    spmm_rows<T, 8>(planes, offsets, v, out, nb, nb_pad, bi, D, ki, s);
  else
    spmm_rows<T, 16>(planes, offsets, v, out, nb, nb_pad, bi, D, ki, s);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int bdia_spmv_f32(const void* planes, const void* offsets,
                             const void* x, void* y, long long nb,
                             long long nb_pad, long long b, long long n_offsets,
                             void* stream) {
  return spmv<float>(planes, offsets, x, y, nb, nb_pad, b, n_offsets, stream);
}

extern "C" int bdia_spmv_f64(const void* planes, const void* offsets,
                             const void* x, void* y, long long nb,
                             long long nb_pad, long long b, long long n_offsets,
                             void* stream) {
  return spmv<double>(planes, offsets, x, y, nb, nb_pad, b, n_offsets, stream);
}

extern "C" int bdia_spmm_f32(const void* planes, const void* offsets,
                             const void* v, void* out, long long nb,
                             long long nb_pad, long long b, long long n_offsets,
                             long long k, void* stream) {
  return spmm<float>(planes, offsets, v, out, nb, nb_pad, b, n_offsets, k,
                     stream);
}

extern "C" int bdia_spmm_f64(const void* planes, const void* offsets,
                             const void* v, void* out, long long nb,
                             long long nb_pad, long long b, long long n_offsets,
                             long long k, void* stream) {
  return spmm<double>(planes, offsets, v, out, nb, nb_pad, b, n_offsets, k,
                      stream);
}
