// sa_setup: the port's host passes of SA-AMG's Galerkin stage.
//
// Two O(nnz) passes that replace numpy COO rebuilds in
// linear/amg.py::sa_coarsen and sparse/host.py::HostCSR.transpose, with
// output bit-equal to the numpy routes they replace.  A plain C ABI for
// ctypes (utils/native.py builds this file with g++ at first use);
// every buffer is a caller-allocated numpy array.
//
// Bit-equality needs each product rounded before the add that follows:
// the build passes -ffp-contract=off, so no FMA fuses them on any target.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// One thread's rows [i0, i1) of the smoothed prolongator, written from
// out_indices/out_data[base] on (base = indptr[i0] + i0, the bound of the
// rows before i0), row lengths into row_nnz[i].  Returns the entries
// written; -1 where a row lumps weak entries but stores no diagonal, -2
// on a column id out of range.
int64_t prolongator_rows(int64_t i0, int64_t i1, int64_t n,
                         int64_t n_agg,
                         const int64_t* indptr, const int32_t* indices,
                         const double* data, const uint8_t* strong,
                         const int64_t* agg, double omega, int64_t* row_nnz,
                         int32_t* out_indices, double* out_data) {
  std::vector<double> acc(n_agg, 0.0);
  std::vector<int64_t> mark(n_agg, -1);
  std::vector<int32_t> cols;
  cols.reserve(64);
  const int64_t base = indptr[i0] + i0;
  int64_t w = base;
  for (int64_t i = i0; i < i1; ++i) {
    const int64_t lo = indptr[i], hi = indptr[i + 1];
    double lump = 0.0, diag = 0.0;
    bool has_diag = false;
    for (int64_t p = lo; p < hi; ++p) {
      if (indices[p] < 0 || indices[p] >= n) return -2;
      if (indices[p] == i) {
        has_diag = true;
        diag = data[p];
      } else if (!strong[p]) {
        lump += data[p];
      }
    }
    if (!has_diag && lump != 0.0) return -1;
    double d = has_diag ? diag + lump : 0.0;
    if (d == 0.0) d = 1.0;
    const double s = 1.0 / d;
    cols.clear();
    for (int64_t p = lo; p < hi; ++p) {
      const int64_t j = indices[p];
      const bool on_diag = j == i;
      if (!on_diag && !strong[p]) continue;
      const int64_t c = agg[j];
      if (mark[c] != i) {
        mark[c] = i;
        acc[c] = 0.0;
        cols.push_back(static_cast<int32_t>(c));
      }
      acc[c] += (on_diag ? data[p] + lump : data[p]) * s;
    }
    const int64_t ci = agg[i];
    const bool ci_summed = mark[ci] == i;
    if (!ci_summed) cols.push_back(static_cast<int32_t>(ci));
    std::sort(cols.begin(), cols.end());
    for (int32_t c : cols) {
      out_indices[w] = c;
      if (c != ci)
        out_data[w] = -omega * acc[c];
      else
        out_data[w] = ci_summed ? 1.0 + -omega * acc[c] : 1.0;
      ++w;
    }
    row_nnz[i] = static_cast<int64_t>(cols.size());
  }
  return w - base;
}

template <typename T>
void transpose_scatter(int64_t n_rows, const int64_t* indptr,
                       const int32_t* indices, const T* data, int64_t* pos,
                       int32_t* out_indices, T* out_data) {
  for (int64_t i = 0; i < n_rows; ++i)
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
      const int64_t q = pos[indices[p]]++;
      out_indices[q] = static_cast<int32_t>(i);
      out_data[q] = data[p];
    }
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// SA smoothed prolongator: P = (I − ω·D_f⁻¹·A_f)·P̂ in one pass over A.
// P̂ holds one 1 per row, at agg[i]; A_f is A without its weak
// off-diagonal entries, each row's weak sum lumped onto its stored
// diagonal.  Row i of P is read straight from A, the strength mask and
// agg, with the floating-point operations of the numpy route
// (linear/amg.py: filtered_matrix, tentative_prolongator,
// smooth_prolongator) in the same order, so P is bit-equal to it:
//   lump_i = 0.0 + Σ weak a_ij, in storage order;
//   d_i = (last stored a_ii) + lump_i, 1.0 where that (or no diagonal)
//   is 0;  s_i = 1.0 / d_i;
//   each kept term (a_ij, + lump_i on the diagonal) · s_i is summed into
//   slot agg[j] in storage order from 0.0, as Gustavson's accumulator;
//   each slot becomes (−ω)·acc, and at agg[i] 1.0 + (−ω)·acc (1.0 where
//   no term reached it); columns ascending, stored zeros kept.
// Outputs: out_indptr (n + 1), out_indices and out_data (nnz(A) + n, the
// most P can hold: a row's entries of A plus agg[i]); *out_nnz is P's.
// Row ranges per thread as the native SpGEMM's (at most 8 threads, one
// below 200,000 nonzeros), each writing straight into its own stretch of
// the outputs, packed in row order afterwards.
// Returns 0; 1 where a row lumps weak entries but stores no diagonal
// (the numpy route's general rebuild), 2 on a column or aggregate id
// out of range: the caller then takes the numpy route.
// ---------------------------------------------------------------------------
int32_t sa_prolongator(int64_t n, int64_t n_agg, const int64_t* indptr,
                       const int32_t* indices, const double* data,
                       const uint8_t* strong, const int64_t* agg,
                       double omega, int64_t* out_indptr,
                       int32_t* out_indices, double* out_data,
                       int64_t* out_nnz) {
  for (int64_t i = 0; i < n; ++i)
    if (agg[i] < 0 || agg[i] >= n_agg) return 2;
  unsigned hw = std::thread::hardware_concurrency();
  int nt = (indptr[n] > 200000 && hw > 1)
               ? static_cast<int>(std::min<unsigned>(hw, 8))
               : 1;
  if (nt > 1 && n < nt * 64) nt = 1;

  int64_t* row_nnz = out_indptr + 1;
  std::vector<int64_t> written(nt, 0);
  std::vector<std::thread> ts;
  const int64_t chunk = (n + nt - 1) / nt;
  auto run = [&](int t) {
    const int64_t i0 = t * chunk;
    const int64_t i1 = std::min<int64_t>(n, i0 + chunk);
    if (i0 < i1)
      written[t] = prolongator_rows(i0, i1, n, n_agg, indptr, indices, data,
                                    strong, agg, omega, row_nnz, out_indices,
                                    out_data);
  };
  if (nt == 1) {
    run(0);
  } else {
    for (int t = 0; t < nt; ++t) ts.emplace_back(run, t);
    for (auto& th : ts) th.join();
  }
  for (int t = 0; t < nt; ++t)
    if (written[t] < 0) return static_cast<int32_t>(-written[t]);

  // pack each thread's stretch behind the one before (never forward of
  // where it lies, so the moves are safe in thread order)
  int64_t off = 0;
  for (int t = 0; t < nt; ++t) {
    const int64_t i0 = std::min<int64_t>(n, t * chunk);
    const int64_t base = indptr[i0] + i0;
    if (base != off) {
      std::memmove(out_indices + off, out_indices + base,
                   written[t] * sizeof(int32_t));
      std::memmove(out_data + off, out_data + base,
                   written[t] * sizeof(double));
    }
    off += written[t];
  }
  out_indptr[0] = 0;
  for (int64_t i = 0; i < n; ++i) out_indptr[i + 1] += out_indptr[i];
  *out_nnz = off;
  return 0;
}

// ---------------------------------------------------------------------------
// Counting CSR transpose: Aᵀ in O(nnz + n_cols).  Entries are scattered in
// old-row order, so each new row keeps its old rows ascending — the same
// arrays as a stable argsort of the column ids.  Values are moved as raw
// items of ``itemsize`` bytes (4 or 8: float32/64, int32/64).  Caller
// allocates the outputs (n_cols + 1, nnz, nnz items).  Returns 0, or 2
// on another itemsize or a column id out of range.
// ---------------------------------------------------------------------------
int32_t csr_transpose(int64_t n_rows, int64_t n_cols, const int64_t* indptr,
                      const int32_t* indices, const void* data,
                      int64_t itemsize, int64_t* out_indptr,
                      int32_t* out_indices, void* out_data) {
  const int64_t nnz = indptr[n_rows];
  std::fill(out_indptr, out_indptr + n_cols + 1, 0);
  for (int64_t p = 0; p < nnz; ++p) {
    const int64_t c = indices[p];
    if (c < 0 || c >= n_cols) return 2;
    ++out_indptr[c + 1];
  }
  for (int64_t c = 0; c < n_cols; ++c) out_indptr[c + 1] += out_indptr[c];
  std::vector<int64_t> pos(out_indptr, out_indptr + n_cols);
  switch (itemsize) {
    case 4:
      transpose_scatter(n_rows, indptr, indices,
                        static_cast<const uint32_t*>(data), pos.data(),
                        out_indices, static_cast<uint32_t*>(out_data));
      break;
    case 8:
      transpose_scatter(n_rows, indptr, indices,
                        static_cast<const uint64_t*>(data), pos.data(),
                        out_indices, static_cast<uint64_t*>(out_data));
      break;
    default:
      return 2;
  }
  return 0;
}

}  // extern "C"
