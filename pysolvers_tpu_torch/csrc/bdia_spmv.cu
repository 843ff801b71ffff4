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
// - K5: one thread per (block row i, output dof p = blockIdx.y) with the k
//   row accumulators in registers (k is a template parameter, 1..16).  Each
//   plane value is loaded once and used k times; the k reads of V are
//   coalesced along i.  More than 16 rows are chunked by the wrapper.
// - x is not staged: the D * b shifted reads of neighbouring threads hit the
//   same lines, so x comes from device memory about once and is reused
//   through L1/L2.  The TPU kernels' x windows, VMEM tile budget and halo
//   tiles have no counterpart.  The offsets are staged in shared memory.
//
// Indices are 64-bit, as in K1.
//
// Plain C interface for ctypes: every entry launches on the given stream and
// returns cudaGetLastError() (or cudaErrorInvalidValue for an argument the
// kernels do not take); the wrapper raises if it is not 0.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 8192;  // beyond this the grid-stride loop
constexpr int kMaxGroup = 8;            // K4: output dofs per thread
constexpr int kMaxRows = 16;            // K5: right-hand sides per launch

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

template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
bdia_spmm_kernel(const T* __restrict__ planes, const int* __restrict__ offsets,
                 const T* __restrict__ v, T* __restrict__ out, long long nb,
                 long long nb_pad, int b, int n_offsets) {
  extern __shared__ int s_off[];
  stage_offsets(offsets, s_off, n_offsets);
  const int p = blockIdx.y;
  const long long ld = (long long)b * nb;  // row stride of V and Y
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < nb; i += stride) {
    T acc[K];
#pragma unroll
    for (int r = 0; r < K; ++r) acc[r] = T(0);
    for (int d = 0; d < n_offsets; ++d) {
      const long long col = i + s_off[d];
      if (col < 0 || col >= nb) continue;
      for (int q = 0; q < b; ++q) {
        const T a = planes[((long long)(d * b + q) * b + p) * nb_pad + i];
        const T* vq = v + (long long)q * nb + col;
#pragma unroll
        for (int r = 0; r < K; ++r) acc[r] += a * vq[r * ld];
      }
    }
#pragma unroll
    for (int r = 0; r < K; ++r) out[r * ld + (long long)p * nb + i] = acc[r];
  }
}

unsigned grid_x(long long nb) {
  long long blocks = (nb + kThreads - 1) / kThreads;
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

template <typename T, int K>
void launch_spmm(const void* planes, const void* offsets, const void* v,
                 void* out, long long nb, long long nb_pad, int b,
                 int n_offsets, cudaStream_t stream) {
  const dim3 grid(grid_x(nb), (unsigned)b);
  bdia_spmm_kernel<T, K><<<grid, kThreads, (size_t)n_offsets * sizeof(int),
                           stream>>>(
      (const T*)planes, (const int*)offsets, (const T*)v, (T*)out, nb, nb_pad,
      b, n_offsets);
}

template <typename T>
int spmm(const void* planes, const void* offsets, const void* v, void* out,
         long long nb, long long nb_pad, long long b, long long n_offsets,
         long long k, void* stream_ptr) {
  if (b < 1 || b > 65535 || nb_pad < nb || n_offsets < 1 || k < 1 ||
      k > kMaxRows || b * b * n_offsets > (1 << 30))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream_ptr;
  const int bi = (int)b, D = (int)n_offsets;
#define PST_SPMM_CASE(KK)                                                   \
  case KK:                                                                  \
    launch_spmm<T, KK>(planes, offsets, v, out, nb, nb_pad, bi, D, s);      \
    break;
  switch ((int)k) {
    PST_SPMM_CASE(1) PST_SPMM_CASE(2) PST_SPMM_CASE(3) PST_SPMM_CASE(4)
    PST_SPMM_CASE(5) PST_SPMM_CASE(6) PST_SPMM_CASE(7) PST_SPMM_CASE(8)
    PST_SPMM_CASE(9) PST_SPMM_CASE(10) PST_SPMM_CASE(11) PST_SPMM_CASE(12)
    PST_SPMM_CASE(13) PST_SPMM_CASE(14) PST_SPMM_CASE(15) PST_SPMM_CASE(16)
  }
#undef PST_SPMM_CASE
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
