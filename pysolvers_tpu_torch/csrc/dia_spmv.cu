// K1: DIA sparse matrix-vector product for Hopper (sm_90a).
//
//   y[i] = sum_d diags[d * ld + i] * x[i + offsets[d]],   0 <= i < n_rows,
//   with x taken as zero outside [0, n_cols) (rectangular operators allowed).
//
// Replaces pysolvers_tpu/ops/spmv.py::dia_spmv_pallas (kernel _dia_kernel).
//
// What bounds it: device-memory bandwidth.  Each row streams its D diagonal
// entries, reads x (about once, see below) and writes y: about
// (D + 2) * sizeof(T) bytes per row for 2 * D flops, far below the card's
// flop-per-byte balance.
//
// What the design does about it: one thread per output row (grid-stride
// loop).  For a fixed d, neighbouring threads read neighbouring entries of
// diagonal d, so every diagonal read is coalesced along the row-major
// (D, ld) table.  The D shifted reads of x by neighbouring threads (and by
// the same thread for neighbouring offsets) hit the same cache lines, so x
// comes from device memory about once and is reused through L1/L2.  The
// offsets are staged once per block in shared memory.  The TPU kernel's
// windowed copy of x and its (D, n_tiles, tile) layout are not needed.
//
// Indices are 64-bit: d * ld + i exceeds 2^31 at the largest problems the
// repository runs (n up to 2.9e8 with 9 offsets).
//
// The kernel is a template over what it writes after the accumulation
// (sweep_epilogue.cuh): the product, the residual f - A x, or a whole
// weighted-Jacobi sweep x + (omega * dinv) * (f - A x) of a square
// operator.  A multigrid smoother's sweep is then one launch that moves
// (D + 4) words a row, where the product and four elementwise passes moved
// (D + 13).  The accumulation is the same code in every instance.
//
// Plain C interface for ctypes: every entry launches on the given stream
// and returns cudaGetLastError(); the wrapper raises if it is not 0.

#include <cuda_runtime.h>

#include "sweep_epilogue.cuh"

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 8192;  // beyond this the grid-stride loop

using epilogue::Epilogue;

template <typename T, Epilogue E>
__global__ void __launch_bounds__(kThreads)
dia_spmv_kernel(const T* __restrict__ diags, const int* __restrict__ offsets,
                const T* __restrict__ x, const T* __restrict__ f,
                const T* __restrict__ dinv, T* __restrict__ y,
                long long n_rows, long long n_cols, long long ld,
                int n_diags, T omega) {
  extern __shared__ int s_off[];
  for (int d = threadIdx.x; d < n_diags; d += blockDim.x) s_off[d] = offsets[d];
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n_rows; i += stride) {
    T acc = T(0);
    for (int d = 0; d < n_diags; ++d) {
      const long long j = i + s_off[d];
      if (j >= 0 && j < n_cols) acc += diags[(long long)d * ld + i] * x[j];
    }
    y[i] = epilogue::apply<T, E>(acc, i, x, f, dinv, omega);
  }
}

// epi: the wrapper's epilogue code (0 product, 1 residual, 2 Jacobi sweep);
// f and dinv are read only by the epilogues that need them
template <typename T>
int launch(const void* diags, const void* offsets, const void* x,
           const void* f, const void* dinv, void* y, long long n_rows,
           long long n_cols, long long ld, long long n_diags, double omega,
           int epi, void* stream) {
  long long blocks = (n_rows + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  return epilogue::dispatch(epi, [&](auto e) {
    dia_spmv_kernel<T, decltype(e)::value>
        <<<(unsigned)blocks, kThreads, (size_t)n_diags * sizeof(int),
           (cudaStream_t)stream>>>(
            (const T*)diags, (const int*)offsets, (const T*)x, (const T*)f,
            (const T*)dinv, (T*)y, n_rows, n_cols, ld, (int)n_diags,
            (T)omega);
    return (int)cudaGetLastError();
  });
}

}  // namespace

extern "C" int dia_spmv_f32(const void* diags, const void* offsets,
                            const void* x, const void* f, const void* dinv,
                            void* y, long long n_rows, long long n_cols,
                            long long ld, long long n_diags, double omega,
                            int epi, void* stream) {
  return launch<float>(diags, offsets, x, f, dinv, y, n_rows, n_cols, ld,
                       n_diags, omega, epi, stream);
}

extern "C" int dia_spmv_f64(const void* diags, const void* offsets,
                            const void* x, const void* f, const void* dinv,
                            void* y, long long n_rows, long long n_cols,
                            long long ld, long long n_diags, double omega,
                            int epi, void* stream) {
  return launch<double>(diags, offsets, x, f, dinv, y, n_rows, n_cols, ld,
                        n_diags, omega, epi, stream);
}
