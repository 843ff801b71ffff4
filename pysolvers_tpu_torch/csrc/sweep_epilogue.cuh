// The epilogue that K1 (dia_spmv.cu) and K6 (grid_dia_spmv.cu) apply to a
// row's accumulated product acc = (A x)[i] before writing it: a compile-time
// choice, so each kernel keeps one body for the product and its loop.
//
//   kProduct   y[i] = acc
//   kResidual  y[i] = f[i] - acc                          (the V-cycle's r)
//   kJacobi    y[i] = x[i] + (omega * dinv[i]) * (f[i] - acc)
//                                              (one weighted-Jacobi sweep)
//
// A multigrid level's sweep is then one pass over the diagonals, x, f and
// dinv, writing the new x: (D + 4) words a row against (D + 2) for the
// product and 11 more for the four elementwise passes it replaces
// (f - y, omega * dinv, that times r, x plus it).  A Jacobi step reads the
// old x of its neighbours, so y never aliases x.
//
// Each operation after the accumulation rounds on its own (the _rn
// intrinsics, which nvcc never contracts into an FMA), in the order of
// the unfused passes: f - acc, then omega * dinv, then that times r, then
// x plus it.  So a fused launch gives, bit for bit, what the product
// followed by torch's elementwise passes gives on the card.
//
// The integer values are the wrappers' epilogue codes
// (ops/_cuda_build.py: PRODUCT, RESIDUAL, JACOBI).

#pragma once

#include <cuda_runtime.h>

#include <type_traits>

namespace epilogue {

enum class Epilogue : int { kProduct = 0, kResidual = 1, kJacobi = 2 };

__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

// The value row i writes: acc is its product, i its flat index into x, f
// and dinv (read only by the epilogues that need them).
template <typename T, Epilogue E>
__device__ __forceinline__ T apply(T acc, long long i,
                                   const T* __restrict__ x,
                                   const T* __restrict__ f,
                                   const T* __restrict__ dinv, T omega) {
  if constexpr (E == Epilogue::kProduct) {
    return acc;
  } else {
    const T r = sub_rn(f[i], acc);
    if constexpr (E == Epilogue::kResidual) return r;
    else return add_rn(x[i], mul_rn(mul_rn(omega, dinv[i]), r));
  }
}

// Calls launch(std::integral_constant<Epilogue, E>{}) for the epilogue of
// the wrapper's code and returns what it returns; an unknown code launches
// nothing and returns cudaErrorInvalidValue.
template <typename Launch>
int dispatch(int code, Launch launch) {
  switch (code) {
    case 0:
      return launch(std::integral_constant<Epilogue, Epilogue::kProduct>{});
    case 1:
      return launch(std::integral_constant<Epilogue, Epilogue::kResidual>{});
    case 2:
      return launch(std::integral_constant<Epilogue, Epilogue::kJacobi>{});
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace epilogue
