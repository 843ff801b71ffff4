// K2 and K3: sparse matrix-vector product of a BWS-packed operator for
// Hopper (sm_90a), in the pack's own (permuted) ordering, over the
// operator's device CSR (sparse/bws.py::bws_device_csr):
//
//   y[r] = sum over k in [indptr[r], indptr[r + 1]) of
//          values[k] * x[indices[k]].
//
// K2 (bws_spmv_*) runs every row block, one launch per product.  It
// replaces pysolvers_tpu/ops/bws_spmv.py::bws_spmv (_bws_call, kernel
// _bws_kernel).  K3 (bws_spmv_classes_*) runs the row blocks of one
// segment class, from a list of block ids, and writes only their rows.
// It replaces pysolvers_tpu/ops/bws_spmv.py::_bws_call_classes (kernel
// _bws_kernel_cls).  Both share one device function.
//
// What bounds it: device-memory bytes.  Each nonzero moves its value and
// a 32-bit column index (sizeof(T) + 4 bytes) for one multiply-add; the
// row pointers, the block table, x and y add 4 (n_rows + 1) +
// 4 (n_blocks + 1) + sizeof(T) (n_cols + n_rows).  That is the CSR
// minimum.  The TPU's pack is no layout for this card: a slot costs a
// value and a lane index whether it holds a nonzero or padding, and on
// the FEM operators 19-24 % of the slots hold one.  So the card reads
// the CSR derived from the pack when the matrix is made.  The segment
// classes let the TPU kernel skip padded segments; the CSR has none to
// skip, so the solve paths run K2 alone, one launch per product, and K3
// serves a product by class (ops/bws_spmv.py::bws_spmv_by_class).
//
// What the design does about it (CSR-stream): a block of 256 threads
// takes one row block of the partition (sparse/bws.py::row_block_table).
// A block of several rows holds fewer than kStage = 2 kWindow nonzeros.
// Its threads read values[k] and indices[k] of the block's contiguous
// range, fully coalesced whatever the row lengths (FEM rows hold about 7
// nonzeros, so a warp per row would leave most lanes idle), with the
// evict-first hint (__ldcs): they are read once, and x, gathered through
// the read-only path, keeps the caches.  The products are staged in shared
// memory; each row is then summed from there, by one thread or, where
// the block holds few rows, by up to 32 threads with shuffles.  Each
// thread loads its row's bounds together with its products, so the sums
// wait on no second round trip.  A block of one row (a row longer than
// kWindow, or alone in its window) is reduced across the block.  Sums
// run in T in a fixed order, so a result does not vary from run to run.
//
// Offsets into values and indices are 64-bit; indptr is int32 below 2^31
// nonzeros and int64 from there (template parameter P).
//
// Plain C interface for ctypes: every entry launches on `device` and the
// given stream (switching to the device and back when it is not the
// calling thread's current one, so the wrapper needs no device context)
// and returns cudaGetLastError(); the wrapper raises if it is not 0.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// sparse/bws.py's ROW_BLOCK_WINDOW (tests/test_torch_bws_layout.py holds
// them equal): the partition keeps a block of several rows below kStage
constexpr int kWindow = 1024;
constexpr int kStage = 2 * kWindow;   // nonzeros of a block of several rows
constexpr int kUnroll = 4;            // loads in flight per thread

// values and indices are read once: evict-first, so x keeps the caches
template <typename T>
__device__ __forceinline__ T load_once(const T* p) {
  return __ldcs(p);
}

// Sum over aligned groups of `width` lanes (a power of two up to 32); lane
// 0 of each group holds its group's sum.  Every lane of the warp calls it.
template <typename T>
__device__ __forceinline__ T group_sum(T v, int width) {
  for (int o = width >> 1; o > 0; o >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, o, width);
  return v;
}

template <typename T, typename P>
__device__ __forceinline__ void row_block_spmv(
    int blk, const int* __restrict__ row_blocks, const P* __restrict__ indptr,
    const int* __restrict__ indices, const T* __restrict__ values,
    const T* __restrict__ x, T* __restrict__ y, T* stage) {
  const int r0 = row_blocks[blk];
  const int r1 = row_blocks[blk + 1];
  const long long k0 = (long long)indptr[r0];
  const long long k1 = (long long)indptr[r1];
  const int tid = threadIdx.x;

  if (r1 - r0 == 1) {  // one row: strided partial sums, block reduction
    T acc = T(0);
    for (long long k = k0 + tid; k < k1; k += kThreads)
      acc += load_once(values + k) * __ldg(x + load_once(indices + k));
    acc = group_sum(acc, 32);
    if ((tid & 31) == 0) stage[tid >> 5] = acc;
    __syncthreads();
    if (tid < 32) {
      acc = group_sum(tid < kWarps ? stage[tid] : T(0), 32);
      if (tid == 0) y[r0] = acc;
    }
    return;
  }

  // Threads per row: 1 where the block holds more than kThreads / 2 rows,
  // else the largest power of two up to 32 that still covers every row.
  const int rows = r1 - r0;
  int tpr = 1;
  if (2 * rows <= kThreads) {
    tpr = 2;
    while (tpr < 32 && 2 * tpr * rows <= kThreads) tpr <<= 1;
  }
  int r = r0 + tid / tpr;
  const int lane = tid & (tpr - 1);
  long long a = 0, b = 0;
  if (r < r1) {
    a = (long long)indptr[r] - k0;
    b = (long long)indptr[r + 1] - k0;
  }

  const int nnz = (int)(k1 - k0);  // < kStage by the partition
  for (int i = tid; i < nnz; i += kUnroll * kThreads) {
    T v[kUnroll];
    int c[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = i + u * kThreads;
      v[u] = T(0);
      c[u] = 0;
      if (j < nnz) {
        v[u] = load_once(values + k0 + j);
        c[u] = load_once(indices + k0 + j);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = i + u * kThreads;
      if (j < nnz) stage[j] = v[u] * __ldg(x + c[u]);
    }
  }
  __syncthreads();

  if (tpr > 1) {  // every row has its group; one pass
    T acc = T(0);
    for (long long j = a + lane; j < b; j += tpr) acc += stage[j];
    acc = group_sum(acc, tpr);
    if (lane == 0 && r < r1) y[r] = acc;
    return;
  }
  while (r < r1) {
    T acc = T(0);
    for (long long j = a; j < b; ++j) acc += stage[j];
    y[r] = acc;
    r += kThreads;
    if (r < r1) {
      a = (long long)indptr[r] - k0;
      b = (long long)indptr[r + 1] - k0;
    }
  }
}

template <typename T, typename P>
__global__ void __launch_bounds__(kThreads)
bws_spmv_kernel(const int* __restrict__ row_blocks,
                const P* __restrict__ indptr, const int* __restrict__ indices,
                const T* __restrict__ values, const T* __restrict__ x,
                T* __restrict__ y) {
  __shared__ T stage[kStage];
  row_block_spmv<T, P>(blockIdx.x, row_blocks, indptr, indices, values, x, y,
                       stage);
}

template <typename T, typename P>
__global__ void __launch_bounds__(kThreads)
bws_spmv_classes_kernel(const int* __restrict__ block_ids,
                        const int* __restrict__ row_blocks,
                        const P* __restrict__ indptr,
                        const int* __restrict__ indices,
                        const T* __restrict__ values, const T* __restrict__ x,
                        T* __restrict__ y) {
  __shared__ T stage[kStage];
  row_block_spmv<T, P>(block_ids[blockIdx.x], row_blocks, indptr, indices,
                       values, x, y, stage);
}

// Launches K2 (block_ids null: blocks 0 .. n - 1) or K3 (the n blocks of
// block_ids) on `device`.
template <typename T, typename P>
int launch(const void* block_ids, long long n, const void* row_blocks,
           const void* indptr, const void* indices, const void* values,
           const void* x, void* y, int device, void* stream) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n > 0 && block_ids == nullptr)
    bws_spmv_kernel<T, P><<<(unsigned)n, kThreads, 0, (cudaStream_t)stream>>>(
        (const int*)row_blocks, (const P*)indptr, (const int*)indices,
        (const T*)values, (const T*)x, (T*)y);
  else if (n > 0)
    bws_spmv_classes_kernel<T, P><<<(unsigned)n, kThreads, 0,
                                    (cudaStream_t)stream>>>(
        (const int*)block_ids, (const int*)row_blocks, (const P*)indptr,
        (const int*)indices, (const T*)values, (const T*)x, (T*)y);
  err = cudaGetLastError();
  if (prev != device) cudaSetDevice(prev);
  return (int)err;
}

}  // namespace

#define BWS_ENTRIES(SUFFIX, T, P)                                             \
  extern "C" int bws_spmv_##SUFFIX(                                           \
      const void* row_blocks, long long n_blocks, const void* indptr,         \
      const void* indices, const void* values, const void* x, void* y,        \
      int device, void* stream) {                                             \
    return launch<T, P>(nullptr, n_blocks, row_blocks, indptr, indices,       \
                        values, x, y, device, stream);                        \
  }                                                                           \
  extern "C" int bws_spmv_classes_##SUFFIX(                                   \
      const void* block_ids, long long n_ids, const void* row_blocks,         \
      const void* indptr, const void* indices, const void* values,            \
      const void* x, void* y, int device, void* stream) {                     \
    return launch<T, P>(block_ids, n_ids, row_blocks, indptr, indices,        \
                        values, x, y, device, stream);                        \
  }

BWS_ENTRIES(f32_i32, float, int)
BWS_ENTRIES(f64_i32, double, int)
BWS_ENTRIES(f32_i64, float, long long)
BWS_ENTRIES(f64_i64, double, long long)
