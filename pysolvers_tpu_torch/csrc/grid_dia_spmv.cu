// K6: 2-D grid-DIA sparse matrix-vector product for Hopper (sm_90a).
//
//   y[r*mc + c] = sum_d diags[d*ld_d + r*ldc + c] * x[(r+dr_d)*mc + (c+dc_d)],
//   0 <= r < mr, 0 <= c < mc, with x taken as zero off the grid in both
//   directions (0 <= r+dr_d < mr and 0 <= c+dc_d < mc).
//
// Replaces pysolvers_tpu/ops/grid_spmv.py::grid_dia_spmv (kernel
// _gdia_kernel): the stencil operator of the geometric-multigrid levels on
// grids of m >= 4096 (n up to ~1e8 and beyond).
//
// What bounds it: device-memory bandwidth.  Each grid point streams its D
// table entries, reads x (about once, see below) and writes y: about
// (D + 2) * sizeof(T) bytes per point for 2 * D flops.  At m = 10239, f64,
// D = 5 that is 5.9 GB per product, ~1.75 ms at 3.35 TB/s.
//
// What the design does about it: one thread per grid point, threads of a
// block along c.  For a fixed offset d, neighbouring threads read
// neighbouring table entries and neighbouring x entries of grid row r+dr_d,
// so every read is coalesced.  The rows r-1 and r+1 of x that a point's
// stencil touches are the rows the neighbouring blocks (next in launch
// order) read as their own, so they come from L2, and x leaves device
// memory about once.  The table's row pitch ldc (a multiple of 32 elements,
// chosen by the wrapper) keeps every table row aligned.  x is read
// directly from the flat vector under the grid masks: the TPU kernel's
// padded window copy of x is not needed.  The (dr, dc) pairs come as a
// device int32 (D, 2) array, staged once per block in shared memory; D is
// free (the converter admits up to 5 x 17 = 85 pairs).  A narrow grid
// (mc < 256) packs several grid rows into one block.
//
// Indices are 64-bit: d * ld_d exceeds 2^31 at n = 1e8.
//
// Plain C interface for ctypes: every entry launches on the given stream
// and returns cudaGetLastError(); the wrapper raises if it is not 0.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxRowBlocks = 65535;  // grid.y limit; rows loop beyond

template <typename T>
__global__ void __launch_bounds__(kThreads)
grid_dia_spmv_kernel(const T* __restrict__ diags, const int* __restrict__ pairs,
                     const T* __restrict__ x, T* __restrict__ y, long long mr,
                     long long mc, long long ld_d, long long ldc,
                     int n_diags) {
  extern __shared__ int s_pairs[];  // dr_0, dc_0, dr_1, dc_1, ...
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int i = tid; i < 2 * n_diags; i += blockDim.x * blockDim.y)
    s_pairs[i] = pairs[i];
  __syncthreads();
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= mc) return;
  const long long row_stride = (long long)gridDim.y * blockDim.y;
  for (long long r = (long long)blockIdx.y * blockDim.y + threadIdx.y; r < mr;
       r += row_stride) {
    const T* drow = diags + r * ldc + c;
    T acc = T(0);
    for (int d = 0; d < n_diags; ++d) {
      const long long rr = r + s_pairs[2 * d];
      const long long cc = c + s_pairs[2 * d + 1];
      if (rr >= 0 && rr < mr && cc >= 0 && cc < mc)
        acc += drow[(long long)d * ld_d] * x[rr * mc + cc];
    }
    y[r * mc + c] = acc;
  }
}

template <typename T>
int launch(const void* diags, const void* pairs, const void* x, void* y,
           long long mr, long long mc, long long ld_d, long long ldc,
           long long n_diags, void* stream) {
  // block width: the grid row rounded up to a power of two, 32..256;
  // the rest of the 256 threads take further grid rows
  int bx = 32;
  while (bx < kThreads && bx < mc) bx *= 2;
  const int by = kThreads / bx;
  long long gx = (mc + bx - 1) / bx;
  long long gy = (mr + by - 1) / by;
  if (gy > kMaxRowBlocks) gy = kMaxRowBlocks;
  if (gx < 1) gx = 1;
  if (gy < 1) gy = 1;
  grid_dia_spmv_kernel<T><<<dim3((unsigned)gx, (unsigned)gy), dim3(bx, by),
                            (size_t)(2 * n_diags) * sizeof(int),
                            (cudaStream_t)stream>>>(
      (const T*)diags, (const int*)pairs, (const T*)x, (T*)y, mr, mc, ld_d,
      ldc, (int)n_diags);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int grid_dia_spmv_f32(const void* diags, const void* pairs,
                                 const void* x, void* y, long long mr,
                                 long long mc, long long ld_d, long long ldc,
                                 long long n_diags, void* stream) {
  return launch<float>(diags, pairs, x, y, mr, mc, ld_d, ldc, n_diags, stream);
}

extern "C" int grid_dia_spmv_f64(const void* diags, const void* pairs,
                                 const void* x, void* y, long long mr,
                                 long long mc, long long ld_d, long long ldc,
                                 long long n_diags, void* stream) {
  return launch<double>(diags, pairs, x, y, mr, mc, ld_d, ldc, n_diags,
                        stream);
}
