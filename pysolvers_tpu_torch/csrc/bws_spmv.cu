// K2 and K3: block-window SELL (BWS) sparse matrix-vector product for
// Hopper (sm_90a), in the pack's own (permuted) ordering.
//
//   y[g * group_rows + l / slots] = sum over s < S, and the slots lanes l of
//       that row, of data[g, s, l] * x[(base[g / gt] + delta[g, s]) * 128
//                                      + lidx[g, s, l]],
//   with x taken as zero at columns >= n_cols; slots = 128 / group_rows.
//
// K2 (bws_spmv_*) runs every group with the pack's full segment count S.
// Replaces pysolvers_tpu/ops/bws_spmv.py::bws_spmv (_bws_call, kernel
// _bws_kernel).  K3 (bws_spmv_classes_*) runs the groups of one segment
// class: its tiles come from a tile-id list, and only the class's first
// S_c segments are read (the rest of those tiles' segments hold zeros).
// Replaces pysolvers_tpu/ops/bws_spmv.py::_bws_call_classes (kernel
// _bws_kernel_cls).  Both share one device function.
//
// What bounds it: device-memory bytes.  Each slot moves its value and its
// 32-bit lane index (sizeof(T) + 4 bytes) for one multiply-add, and the
// slots are mostly padding: on the 1M-unknown FEM operator 14.6 % of the
// slots hold a nonzero, so the kernel reads about 7x the bytes of the
// real entries.  Narrower lane indices and a layout with less padding are
// the levers; neither is pulled here.
//
// What the design does about it: one 128-thread slice per group, thread l
// on lane l, two groups per 256-thread block.  For each segment s the
// slice reads data[g, s, :] and lidx[g, s, :] as 128 contiguous values
// (coalesced) and delta[g, s] as one broadcast; the x reads of one
// segment fall inside one 128-column block, a few cache lines served
// from L1/L2.  The TPU kernel's one-hot MXU block select, its x window in
// VMEM and its reduction matmul are not needed on Hopper: a gather is a
// plain load, and the slots of a row (2 to 16 adjacent lanes, inside one
// warp) are summed with warp shuffles.  x is not padded: the column mask
// takes the place of the TPU's W trailing zero blocks.  Each class tile
// writes its own rows of y, so there is no zero-fill and no scatter.
//
// Offsets into the (n_groups, S, 128) tables are 64-bit.
//
// Plain C interface for ctypes: every entry launches on the given stream
// and returns cudaGetLastError(); the wrapper raises if it is not 0.

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;
constexpr int kGroupsPerBlock = 2;
constexpr int kThreads = kLanes * kGroupsPerBlock;

// One group's product: the calling 128 threads (four whole warps) hold
// lanes 0..127 of group g.
template <typename T>
__device__ __forceinline__ void group_spmv(
    const int* __restrict__ base, const int* __restrict__ delta,
    const T* __restrict__ data, const int* __restrict__ lidx,
    const T* __restrict__ x, T* __restrict__ y, long long g, int tile,
    int lane, long long n_rows, long long n_cols, int S_stride, int S_run,
    int group_rows) {
  const long long tile_col = (long long)base[tile] * kLanes;
  const long long seg0 = g * S_stride;
  T acc = T(0);
#pragma unroll 4
  for (int s = 0; s < S_run; ++s) {
    const long long off = (seg0 + s) * kLanes + lane;
    const long long col =
        tile_col + (long long)delta[seg0 + s] * kLanes + lidx[off];
    const T v = data[off];
    acc += v * (col < n_cols ? x[col] : T(0));
  }
  const int slots = kLanes / group_rows;
  for (int o = slots >> 1; o > 0; o >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, o);
  if ((lane & (slots - 1)) == 0) {
    const long long row = g * group_rows + lane / slots;
    if (row < n_rows) y[row] = acc;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bws_spmv_kernel(const int* __restrict__ base, const int* __restrict__ delta,
                const T* __restrict__ data, const int* __restrict__ lidx,
                const T* __restrict__ x, T* __restrict__ y, long long n_rows,
                long long n_cols, long long n_groups, int S, int gt,
                int group_rows) {
  const long long g =
      (long long)blockIdx.x * kGroupsPerBlock + threadIdx.x / kLanes;
  if (g >= n_groups) return;  // whole groups, so whole warps, leave
  group_spmv<T>(base, delta, data, lidx, x, y, g, (int)(g / gt),
                threadIdx.x % kLanes, n_rows, n_cols, S, S, group_rows);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bws_spmv_classes_kernel(const int* __restrict__ ids,
                        const int* __restrict__ base,
                        const int* __restrict__ delta,
                        const T* __restrict__ data,
                        const int* __restrict__ lidx,
                        const T* __restrict__ x, T* __restrict__ y,
                        long long n_rows, long long n_cols,
                        long long n_class_groups, int S, int S_c, int gt,
                        int group_rows) {
  const long long local =
      (long long)blockIdx.x * kGroupsPerBlock + threadIdx.x / kLanes;
  if (local >= n_class_groups) return;
  const int tile = ids[local / gt];
  const long long g = (long long)tile * gt + local % gt;
  group_spmv<T>(base, delta, data, lidx, x, y, g, tile, threadIdx.x % kLanes,
                n_rows, n_cols, S, S_c, group_rows);
}

unsigned blocks_for(long long groups) {
  return (unsigned)((groups + kGroupsPerBlock - 1) / kGroupsPerBlock);
}

template <typename T>
int launch(const void* base, const void* delta, const void* data,
           const void* lidx, const void* x, void* y, long long n_rows,
           long long n_cols, long long n_groups, long long S, long long gt,
           long long group_rows, void* stream) {
  if (n_groups > 0)
    bws_spmv_kernel<T><<<blocks_for(n_groups), kThreads, 0,
                         (cudaStream_t)stream>>>(
        (const int*)base, (const int*)delta, (const T*)data,
        (const int*)lidx, (const T*)x, (T*)y, n_rows, n_cols, n_groups,
        (int)S, (int)gt, (int)group_rows);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_classes(const void* ids, long long n_ids, const void* base,
                   const void* delta, const void* data, const void* lidx,
                   const void* x, void* y, long long n_rows, long long n_cols,
                   long long S, long long S_c, long long gt,
                   long long group_rows, void* stream) {
  const long long groups = n_ids * gt;
  if (groups > 0)
    bws_spmv_classes_kernel<T><<<blocks_for(groups), kThreads, 0,
                                 (cudaStream_t)stream>>>(
        (const int*)ids, (const int*)base, (const int*)delta,
        (const T*)data, (const int*)lidx, (const T*)x, (T*)y, n_rows, n_cols,
        groups, (int)S, (int)S_c, (int)gt, (int)group_rows);
  return (int)cudaGetLastError();
}

}  // namespace

#define BWS_ENTRIES(SUFFIX, T)                                                \
  extern "C" int bws_spmv_##SUFFIX(                                           \
      const void* base, const void* delta, const void* data,                  \
      const void* lidx, const void* x, void* y, long long n_rows,             \
      long long n_cols, long long n_groups, long long S, long long gt,        \
      long long group_rows, void* stream) {                                   \
    return launch<T>(base, delta, data, lidx, x, y, n_rows, n_cols,           \
                     n_groups, S, gt, group_rows, stream);                    \
  }                                                                           \
  extern "C" int bws_spmv_classes_##SUFFIX(                                   \
      const void* ids, long long n_ids, const void* base, const void* delta,  \
      const void* data, const void* lidx, const void* x, void* y,             \
      long long n_rows, long long n_cols, long long S, long long S_c,         \
      long long gt, long long group_rows, void* stream) {                     \
    return launch_classes<T>(ids, n_ids, base, delta, data, lidx, x, y,       \
                             n_rows, n_cols, S, S_c, gt, group_rows, stream); \
  }

BWS_ENTRIES(f32, float)
BWS_ENTRIES(f64, double)
