// K7: hardware probe for narrow lane indices (Hopper, sm_90a).
//
//   out[r, l] = x[r, (int)idx[r, l]],   idx int16, x float32,
//   r < rows, l < 128.
//
// Replaces benchmarks/probe_idx16.py (the inline Pallas kernel `kernel`):
// the TPU probe asked whether int16 lane indices, loaded and widened to
// int32 inside a kernel, gather correctly; int8 indices had given wrong
// results on the TPU, so the BWS lane index table stayed int32.  The same
// question decides the width of K2's lidx table here (4 bytes of every
// slot's sizeof(T) + 4).
//
// What bounds it: launch latency — one (8, 128) tile is 10 KB.  So a call
// is one launch and nothing else: the index range is checked here, on
// each lane, not by the host (a min/max read back per call would be two
// round trips).  A lane whose index lies outside [0, 128) reads nothing,
// writes 0 and sets *bad to 1, a flag the caller owns and reads where it
// synchronises anyway.  One block per row, thread l on lane l: a 16-bit
// load, a widening conversion and a gather from the row, as K2 would do
// with narrow indices.
//
// Plain C interface for ctypes: launches on `device` (switching to it and
// back when it is not the calling thread's current device, so the
// wrapper needs no device context) and returns cudaGetLastError() after
// the launch; the wrapper raises if it is not 0.

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;

__global__ void __launch_bounds__(kLanes)
lane_gather_probe_kernel(const short* __restrict__ idx,
                         const float* __restrict__ x, float* __restrict__ out,
                         int* __restrict__ bad) {
  const long long row = (long long)blockIdx.x * kLanes;
  const int i = (int)idx[row + threadIdx.x];  // int16 widened to int32
  if (i >= 0 && i < kLanes) {
    out[row + threadIdx.x] = x[row + i];
  } else {
    out[row + threadIdx.x] = 0.0f;
    *bad = 1;
  }
}

}  // namespace

extern "C" int lane_gather_probe(const void* idx, const void* x, void* out,
                                 void* bad, long long rows, int device,
                                 void* stream) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (rows > 0)
    lane_gather_probe_kernel<<<(unsigned)rows, kLanes, 0,
                               (cudaStream_t)stream>>>(
        (const short*)idx, (const float*)x, (float*)out, (int*)bad);
  err = cudaGetLastError();
  if (prev != device) cudaSetDevice(prev);
  return (int)err;
}
