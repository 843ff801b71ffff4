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
// block i needs x_{i-1}.  A walk on one CTA is held to one SM's load rate
// (~100 GB/s) and pays each step's load latency after the step before,
// although s_hat_i does not depend on x at all.
//
// What the design does about it:
// - stage 1 (diag_block_kernel), parallel: four 256-thread blocks per
//   diagonal block compute u_i = dinv_i b_i, a warp per row (four, so
//   that 4 nb blocks fill the card in even waves).  dinv_i is
//   exactly lower triangular (ops/block_trisolve.py::_tri_inverse_doubling
//   builds I plus strictly lower products, then scales rows), so row r
//   reads only its r + 1 leading values, 16 bytes a load where bs and the
//   pointer allow.  For p = 0 this is the whole solve and writes x.
// - stage 2 (recurrence_kernel), serial: ONE thread-block cluster of C
//   CTAs (16, or 8 where the card does not fit 16: the wrapper asks
//   cudaOccupancyMaxActiveClusters) walks the nb steps.  CTA c owns rows
//   c*R .. c*R + R - 1 of every step (R = ceil(bs / C); the last CTAs may
//   own fewer, or none, and those take no part in the walk).  Each CTA
//   keeps its own copy of the ring of the p + 1 latest x blocks in shared
//   memory.  At step i each of 16 compute warps computes its CTA's rows
//   of x_i (one each at bs = 256) and stores each into ring slot
//   i mod (p+1) of EVERY owning CTA through distributed shared memory, by
//   st.async, which completes bs*sizeof(T) transaction bytes on the
//   receiver's "x_i complete" mbarrier; step i+1 starts when that barrier
//   completes.  So a step costs one DSMEM trip and no cluster-wide
//   barrier, and no global load or store waits on a release fence.  Two
//   such barriers (even and odd steps) are enough: a CTA sends x_{i+2}
//   only after it has all of x_{i+1}, whose rows each owning CTA
//   computes only after its x_i barrier completed.  One ring slot per
//   step is written safely for the same reason: the slot step i writes
//   held x_{i-p-1}, last read in step i - 1, and a row of x_i is sent
//   only after its sender had every row of x_{i-1}, each computed after
//   its warp's reads of step i - 1.
// - the matrix stream runs ahead of x: a CTA's rows of s_hat_i are one
//   contiguous run of R*p*bs values, streamed in chunks of whole rows (the
//   whole run where three stages of it fit, else kChunkBytes or one
//   row) through a ring of S stages in shared memory, S chunks ahead of
//   the chunk being computed.  A producer warp, which computes no rows,
//   issues them: where the rows are 16-byte multiples as one bulk async
//   copy per chunk (cp.async.bulk, the TMA's linear form) that completes
//   on the stage's mbarrier, otherwise as cp.async of 4 or 8 bytes per
//   value, its lanes arriving on the same mbarrier when their copies
//   land.  It refills a stage once the whole CTA has read it: after a CTA
//   barrier inside a step (where a step has several chunks), or, for a
//   step's last chunk, once x of that step is complete in the CTA's ring
//   (its rows were sent after they were read).  It also re-arms the x
//   barriers, so the compute warps' step is the wait, their rows and the
//   sends, nothing else.
// - u_{i+1} (stage 1's output) is loaded into registers at the start of
//   step i, a row per lane, so no device-memory load sits on a step's
//   critical path.
// Both stages launch on the caller's stream from one C call (one K8
// launch per solve for the wrapper's count); nothing synchronises.  The
// launch geometry (R, rows per chunk, S, the stage and shared-memory bytes)
// is worked out here, by geometry(), from bs, p, the value size and the
// cluster size C the wrapper picks; block_trisolve_geometry reports it.  A
// refused cluster launch returns its error and is never replaced by
// another launch.
//
// Plain C interface for ctypes: each entry returns the CUDA error of its
// calls (cudaGetLastError() after each launch); the wrapper raises if it is
// not 0.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace cg = cooperative_groups;

namespace {

constexpr int kStage1Threads = 256;
constexpr int kStage1Split = 4;  // CTAs per diagonal block in stage 1
// stage 2
constexpr int kComputeWarps = 16;  // then one producer warp
constexpr int kStage2Threads = 32 * (kComputeWarps + 1);
constexpr int kMaxStages = 16;
constexpr int kBarrierBytes = 256;  // 8-byte mbarriers: S stages, 2 steps
static_assert(8 * (kMaxStages + 2) <= kBarrierBytes, "room for the barriers");
constexpr int kAlign = 128;
constexpr int kMaxCluster = 16;
constexpr long long kSmemMax = 232448;  // what a CTA may opt in to (227 KB)
// a step's slice is one chunk where this many stages of it fit, else
// chunks of kChunkBytes (whole rows, at least one)
constexpr int kStepStages = 3;
constexpr long long kChunkBytes = 32 * 1024;

__host__ __device__ constexpr long long align_up(long long v) {
  return (v + kAlign - 1) / kAlign * kAlign;
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;  // the same bits in every lane
}

__device__ __forceinline__ long long caller_row(long long g, long long n,
                                                int flip) {
  return flip ? n - 1 - g : g;
}

__device__ __forceinline__ float vdot(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

__device__ __forceinline__ double vdot(double2 a, double2 b) {
  return a.x * b.x + a.y * b.y;
}

template <typename T> struct Vec16;
template <> struct Vec16<float> { using type = float4; };
template <> struct Vec16<double> { using type = double2; };

template <typename T>
__global__ void __launch_bounds__(kStage1Threads)
diag_block_kernel(const T* __restrict__ dinv, const T* __restrict__ b,
                  T* __restrict__ out, long long n, int bs, int flip,
                  int final_out, int vec) {
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
  // the block's rows, interleaved over its kStage1Split CTAs so that each
  // reads a like share of the triangle
  for (int r = blockIdx.y * warps + (threadIdx.x >> 5); r < bs;
       r += warps * kStage1Split) {
    const T* row = D + (long long)r * bs;
    T acc = T(0);
    if (vec) {
      // whole 16-byte vectors up to column r; the last one's tail lies in
      // the upper triangle, whose values are exact zeros
      using V = typename Vec16<T>::type;
      constexpr int kPer = 16 / sizeof(T);
      const V* rv = reinterpret_cast<const V*>(row);
      const V* bv = reinterpret_cast<const V*>(bi);
      const int nv = r / kPer + 1;
#pragma unroll 4
      for (int k = lane; k < nv; k += 32) acc += vdot(rv[k], bv[k]);
    } else {
#pragma unroll 4
      for (int k = lane; k <= r; k += 32) acc += row[k] * bi[k];
    }
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

// --- shared-memory barriers, copies and the cluster barrier (PTX) -------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// until the phase of parity `parity` of the barrier has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

template <int kBytes>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst),
               "l"(src), "n"(kBytes)
               : "memory");
}

// one arrival on the barrier once this thread's earlier cp.async land
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                   "r"(bar)
               : "memory");
}

__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// the address of a local shared-memory address in the cluster's CTA `rank`
__device__ __forceinline__ uint32_t cluster_addr(uint32_t local,
                                                 uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(local), "r"(rank));
  return out;
}

// store v at a cluster address, completing its bytes on a barrier of the
// same CTA
__device__ __forceinline__ void send(uint32_t addr, float v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];\n" ::"r"(addr),
      "r"(__float_as_uint(v)), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void send(uint32_t addr, double v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b64 [%0], %1, "
      "[%2];\n" ::"r"(addr),
      "l"(__double_as_longlong(v)), "r"(bar)
      : "memory");
}

// store V consecutive values at a cluster address (16-byte aligned for
// V > 1) as one message, completing their bytes on a barrier of that CTA
template <typename T, int V>
__device__ __forceinline__ void send_rows(uint32_t addr, const T* v,
                                          uint32_t bar) {
  if constexpr (sizeof(T) == 8 && V == 2) {
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b64 "
        "[%0], {%1, %2}, [%3];\n" ::"r"(addr),
        "l"(__double_as_longlong(v[0])), "l"(__double_as_longlong(v[1])),
        "r"(bar)
        : "memory");
  } else if constexpr (sizeof(T) == 4 && V == 4) {
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 "
        "[%0], {%1, %2, %3, %4}, [%5];\n" ::"r"(addr),
        "r"(__float_as_uint(v[0])), "r"(__float_as_uint(v[1])),
        "r"(__float_as_uint(v[2])), "r"(__float_as_uint(v[3])), "r"(bar)
        : "memory");
  } else {
    static_assert(V == 1, "one value, or 16 bytes");
    send(addr, v[0], bar);
  }
}

// The shared-memory layout of stage 2: the mbarriers (S stages, then x
// complete for even and odd steps), the ring of p + 1 x blocks, S stages.
__host__ __device__ long long stage_offset(int bs, int p, int size) {
  return kBarrierBytes + align_up((long long)(p + 1) * bs * size);
}

// The launch geometry of stage 2 on a cluster of `cluster` CTAs.
struct Geometry {
  int rows;            // of each step a CTA owns: CTA c from c * rows (the
                       // last CTAs may own fewer, or none)
  int rows_per_chunk;  // whole rows of s_hat in one stage of the stream
  int chunks;          // chunks of a full CTA's slice per step
  int stages;          // of the stream in shared memory
  int chunk_bytes;     // one stage, a multiple of kAlign
  int smem;            // the mbarriers, the ring of p + 1 x blocks, stages
  int bulk;            // rows of s_hat are 16-byte multiples: each chunk is
                       // one bulk async copy; else cp.async of one value
  int vec;             // rows a compute warp computes together and sends as
                       // one 16-byte message (16 / size where rows, bs and
                       // rows_per_chunk are its multiples, else 1)
};

// false where no geometry fits: p < 1, a cluster size beyond 1 ..
// kMaxCluster, more rows a CTA than its compute warps' lanes hold, or room
// for fewer than two stages
__host__ bool geometry(int bs, int p, int size, int cluster, Geometry* g) {
  if (bs < 1 || p < 1 || cluster < 1 || cluster > kMaxCluster ||
      (size != 4 && size != 8))
    return false;
  g->rows = (bs + cluster - 1) / cluster;
  if (g->rows > 32 * kComputeWarps) return false;
  const long long row_bytes = (long long)p * bs * size;
  const long long fixed = stage_offset(bs, p, size);
  if (fixed >= kSmemMax) return false;
  long long per_chunk = g->rows;
  if (kStepStages * align_up(g->rows * row_bytes) > kSmemMax - fixed)
    per_chunk = std::max(1LL, std::min<long long>(g->rows,
                                                  kChunkBytes / row_bytes));
  const long long chunk_bytes = align_up(per_chunk * row_bytes);
  const long long stages =
      std::min<long long>(kMaxStages, (kSmemMax - fixed) / chunk_bytes);
  if (stages < 2) return false;
  g->rows_per_chunk = (int)per_chunk;
  g->chunks = (g->rows + g->rows_per_chunk - 1) / g->rows_per_chunk;
  g->stages = (int)stages;
  g->chunk_bytes = (int)chunk_bytes;
  g->smem = (int)(fixed + stages * chunk_bytes);
  g->bulk = row_bytes % 16 == 0;
  const int wide = 16 / size;
  g->vec = g->rows % wide == 0 && bs % wide == 0 &&
                   g->rows_per_chunk % wide == 0
               ? wide
               : 1;
  return true;
}

// The geometry of one CTA's slice of the matrix stream.
struct Stream {
  const unsigned char* s_hat;  // the plan's s_hat, bytes
  unsigned char* stages;       // stage 0 in shared memory
  uint64_t* full;              // one mbarrier per stage
  long long row_bytes;         // p * bs values
  int bs, rows_here, rows_per_chunk, chunks, nstages, chunk_bytes, bulk;
};

// Issue chunk q of this CTA's stream (step q / chunks, chunk q % chunks)
// into stage q mod S.  Called by the producer warp.
template <typename T>
__device__ __forceinline__ void issue_chunk(const Stream& st, int r0, int q,
                                            int lane) {
  const int step = q / st.chunks;
  const int c = q - step * st.chunks;
  const int s = q % st.nstages;
  const int first = c * st.rows_per_chunk;
  const int cnt = min(st.rows_per_chunk, st.rows_here - first);
  const unsigned char* src =
      st.s_hat + ((long long)step * st.bs + r0 + first) * st.row_bytes;
  unsigned char* dst = st.stages + (long long)s * st.chunk_bytes;
  const uint32_t bar = smem_addr(&st.full[s]);
  if (st.bulk) {
    if (lane == 0) {
      const uint32_t bytes = (uint32_t)(cnt * st.row_bytes);
      mbar_expect_tx(bar, bytes);
      bulk_copy(smem_addr(dst), src, bytes, bar);
    }
  } else {
    const int vals = (int)(cnt * st.row_bytes / (long long)sizeof(T));
    const T* s_src = reinterpret_cast<const T*>(src);
    T* s_dst = reinterpret_cast<T*>(dst);
    for (int k = lane; k < vals; k += 32)
      cp_async<(int)sizeof(T)>(smem_addr(s_dst + k), s_src + k);
    cp_async_arrive(bar);
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kStage2Threads, 1)
recurrence_kernel(const T* __restrict__ s_hat, const T* __restrict__ u,
                  T* __restrict__ x, long long n, int nb, int bs, int p,
                  int flip, int rows, int rows_per_chunk, int nstages,
                  int chunk_bytes, int bulk) {
  extern __shared__ __align__(128) unsigned char walk_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int r0 = (int)cluster.block_rank() * rows;
  const int active = (bs + rows - 1) / rows;  // the CTAs that own rows
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool producer = warp == kComputeWarps;
  const int mine = max(0, min(rows, bs - r0));  // rows this CTA owns
  const int slots = p + 1;
  const int width = p * bs;
  const uint32_t step_bytes = (uint32_t)(bs * sizeof(T));

  Stream st;
  st.s_hat = reinterpret_cast<const unsigned char*>(s_hat);
  st.stages = walk_smem + stage_offset(bs, p, (int)sizeof(T));
  st.full = reinterpret_cast<uint64_t*>(walk_smem);
  st.row_bytes = (long long)width * sizeof(T);
  st.bs = bs;
  st.rows_here = mine;
  st.rows_per_chunk = rows_per_chunk;
  st.chunks = (mine + rows_per_chunk - 1) / rows_per_chunk;
  st.nstages = nstages;
  st.chunk_bytes = chunk_bytes;
  st.bulk = bulk;
  const int total = nb * st.chunks;       // this CTA's stream, in chunks
  uint64_t* xbar = st.full + kMaxStages;  // x_i complete: i even, i odd
  T* ring = reinterpret_cast<T*>(walk_smem + kBarrierBytes);

  for (int k = tid; k < slots * bs; k += blockDim.x) ring[k] = T(0);
  if (tid == 0) {
    for (int s = 0; s < nstages; ++s)
      mbar_init(smem_addr(&st.full[s]), bulk ? 1u : 32u);
    mbar_init(smem_addr(&xbar[0]), 1);
    mbar_init(smem_addr(&xbar[1]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // the bytes of x_0 and x_1 this CTA's ring receives
    for (int k = 0; k < 2 && k < nb && mine > 0; ++k)
      mbar_expect_tx(smem_addr(&xbar[k]), step_bytes);
  }
  __syncthreads();
  if (producer)
    for (int q = 0; q < nstages && q < total; ++q)
      issue_chunk<T>(st, r0, q, lane);
  // every CTA of the cluster has zeroed its ring and armed its barriers
  // before the first remote store
  cluster_barrier();

  if (mine > 0) {
    // lane l < active: CTA l's ring and x barriers as cluster addresses
    uint32_t to_ring = 0, to_xbar = 0;
    if (lane < active) {
      to_ring = cluster_addr(smem_addr(ring), lane);
      to_xbar = cluster_addr(smem_addr(xbar), lane);
    }
    // a compute warp takes the groups of V consecutive rows warp, warp +
    // kComputeWarps, ...: lane k holds u of its k-th row of the step
    const int my_row =
        producer ? rows
                 : (warp + lane / V * kComputeWarps) * V + lane % V;
    T u_cur = my_row < mine ? u[r0 + my_row] : T(0);
    int slot = 0;  // i mod (p + 1)
    int q = 0;     // the stream's next chunk, in stage s, phase parity ph
    int s = 0;
    uint32_t ph = 0;
    for (int i = 0; i < nb; ++i) {
      const T u_nx = i + 1 < nb && my_row < mine
                         ? u[(long long)(i + 1) * bs + r0 + my_row]
                         : T(0);
      if (i > 0) {
        const int k = i - 1;  // x_{i-1} complete in this ring
        mbar_wait(smem_addr(&xbar[k & 1]), (uint32_t)((k >> 1) & 1));
        if (producer) {
          if (lane == 0 && k + 2 < nb)
            mbar_expect_tx(smem_addr(&xbar[k & 1]), step_bytes);
          // so step i - 1's last stage is read: refill it
          if (q - 1 + nstages < total)
            issue_chunk<T>(st, r0, q - 1 + nstages, lane);
        }
      }
      const uint32_t to_x = to_ring + (uint32_t)((slot * bs + r0) * sizeof(T));
      const uint32_t to_bar = to_xbar + (uint32_t)((i & 1) * sizeof(uint64_t));
      for (int c = 0; c < st.chunks; ++c, ++q) {
        const int first = c * rows_per_chunk;  // rows; multiples of V
        const int last = producer ? first : min(first + rows_per_chunk, mine);
        const int g0 = first / V;
        int g = g0 + ((warp - g0) % kComputeWarps + kComputeWarps) %
                         kComputeWarps;
        if (g * V < last) mbar_wait(smem_addr(&st.full[s]), ph);
        const T* S = reinterpret_cast<const T*>(
            st.stages + (long long)s * chunk_bytes);
        for (; g * V < last; g += kComputeWarps) {
          const int t = g * V;  // rows t .. t + V - 1
          const T* row = S + (long long)(t - first) * width;
          T acc[V];
#pragma unroll
          for (int e = 0; e < V; ++e) acc[e] = T(0);
          // x_{i-p+j} sits in slot (i + 1 + j) mod (p + 1); before block 0
          // that slot is still zero
          int sj = slot + 1 == slots ? 0 : slot + 1;
          for (int j = 0; j < p; ++j) {
            const T* xj = ring + sj * bs;
            const T* Sj = row + j * bs;
#pragma unroll 4
            for (int k = lane; k < bs; k += 32) {
              const T xv = xj[k];
#pragma unroll
              for (int e = 0; e < V; ++e) acc[e] += Sj[e * width + k] * xv;
            }
            sj = sj + 1 == slots ? 0 : sj + 1;
          }
          T v[V];
          const int m = (g - warp) / kComputeWarps;  // the warp's m-th group
#pragma unroll
          for (int e = 0; e < V; ++e)
            v[e] = __shfl_sync(0xffffffffu, u_cur, m * V + e) -
                   warp_sum(acc[e]);
          if (lane < active)  // into CTA lane's ring
            send_rows<T, V>(to_x + (uint32_t)(t * sizeof(T)), v, to_bar);
          if (lane == 31) {
#pragma unroll
            for (int e = 0; e < V; ++e) {
              const long long gr = (long long)i * bs + r0 + t + e;
              if (gr < n) x[caller_row(gr, n, flip)] = v[e];
            }
          }
        }
        if (++s == nstages) {
          s = 0;
          ph ^= 1;
        }
        if (c + 1 < st.chunks) {
          __syncthreads();  // the stage is read: refill it
          if (producer && q + nstages < total)
            issue_chunk<T>(st, r0, q + nstages, lane);
        }
      }
      u_cur = u_nx;
      slot = slot + 1 == slots ? 0 : slot + 1;
    }
    // the last step's rows are in this ring before the cluster may leave
    const int k = nb - 1;
    mbar_wait(smem_addr(&xbar[k & 1]), (uint32_t)((k >> 1) & 1));
  }
  cluster_barrier();
}

template <typename T>
using WalkFn = void (*)(const T*, const T*, T*, long long, int, int, int, int,
                        int, int, int, int, int);

// stage 2 for rows sent one value or 16 bytes at a time (Geometry::vec)
template <typename T>
WalkFn<T> walk_kernel(int vec) {
  constexpr int kWide = 16 / (int)sizeof(T);
  return vec == 1 ? recurrence_kernel<T, 1> : recurrence_kernel<T, kWide>;
}

template <typename T>
cudaError_t configure(WalkFn<T> fn, int cluster, long long smem) {
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && cluster > 8)
    err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

cudaLaunchConfig_t cluster_config(int cluster, long long smem,
                                  cudaStream_t st, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)cluster, 1, 1);
  cfg.blockDim = dim3(kStage2Threads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename T>
int launch(const void* s_hat, const void* dinv, const void* b, void* u,
           void* x, long long n, long long nb, int bs, int p, int flip,
           int cluster, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int wide = bs % (16 / (int)sizeof(T)) == 0 &&
                   (uintptr_t)dinv % 16 == 0;  // stage 1's 16-byte loads
  diag_block_kernel<T><<<dim3((unsigned)nb, kStage1Split), kStage1Threads,
                         (size_t)bs * sizeof(T), st>>>(
      (const T*)dinv, (const T*)b, (T*)(p ? u : x), n, bs, flip, p == 0,
      wide);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p == 0) return (int)err;
  Geometry g;
  if (nb >= (1LL << 31) || !geometry(bs, p, (int)sizeof(T), cluster, &g))
    return (int)cudaErrorInvalidValue;
  const WalkFn<T> fn = walk_kernel<T>(g.vec);
  err = configure<T>(fn, cluster, g.smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(cluster, g.smem, st, &attr);
  // bulk copies also need s_hat itself 16-byte aligned
  const int bulk = g.bulk && (uintptr_t)s_hat % 16 == 0;
  err = cudaLaunchKernelEx(&cfg, fn, (const T*)s_hat, (const T*)u, (T*)x, n,
                           (int)nb, bs, p, flip, g.rows, g.rows_per_chunk,
                           g.stages, g.chunk_bytes, bulk);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  return (int)cudaGetLastError();
}

template <typename T>
int max_clusters(int bs, int p, int cluster, int* out) {
  *out = 0;
  Geometry g;
  if (!geometry(bs, p, (int)sizeof(T), cluster, &g))
    return (int)cudaErrorInvalidValue;
  const WalkFn<T> fn = walk_kernel<T>(g.vec);
  cudaError_t err = configure<T>(fn, cluster, g.smem);
  if (err == cudaSuccess) {
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg = cluster_config(cluster, g.smem, 0, &attr);
    err = cudaOccupancyMaxActiveClusters(out, fn, &cfg);
  }
  cudaGetLastError();  // leave no error behind for the next launch's check
  return (int)err;
}

}  // namespace

extern "C" int block_trisolve_f32(const void* s_hat, const void* dinv,
                                  const void* b, void* u, void* x,
                                  long long n, long long nb, int bs, int p,
                                  int flip, int cluster, void* stream) {
  return launch<float>(s_hat, dinv, b, u, x, n, nb, bs, p, flip, cluster,
                       stream);
}

extern "C" int block_trisolve_f64(const void* s_hat, const void* dinv,
                                  const void* b, void* u, void* x,
                                  long long n, long long nb, int bs, int p,
                                  int flip, int cluster, void* stream) {
  return launch<double>(s_hat, dinv, b, u, x, n, nb, bs, p, flip, cluster,
                        stream);
}

// Stage 2's geometry for blocks of bs rows, block reach p and values of
// `size` bytes on a cluster of `cluster` CTAs, into out[0..7]: rows,
// rows_per_chunk, chunks, stages, chunk_bytes, smem, bulk, vec (Geometry's
// fields).  cudaErrorInvalidValue where none fits.
extern "C" int block_trisolve_geometry(int bs, int p, int size, int cluster,
                                       int* out) {
  Geometry g;
  if (!geometry(bs, p, size, cluster, &g)) return (int)cudaErrorInvalidValue;
  const int fields[8] = {g.rows,        g.rows_per_chunk, g.chunks, g.stages,
                         g.chunk_bytes, g.smem,           g.bulk,   g.vec};
  for (int k = 0; k < 8; ++k) out[k] = fields[k];
  return 0;
}

// How many clusters of `cluster` CTAs the card runs at once (0: none) with
// the geometry of blocks of bs rows and block reach p.
extern "C" int block_trisolve_max_clusters_f32(int bs, int p, int cluster,
                                               int* out) {
  return max_clusters<float>(bs, p, cluster, out);
}

extern "C" int block_trisolve_max_clusters_f64(int bs, int p, int cluster,
                                               int* out) {
  return max_clusters<double>(bs, p, cluster, out);
}

extern "C" const char* block_trisolve_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
