// tpusparse native setup engine — C++ kernels for the host-side (setup-time)
// sparse work that the device does not see: CSR SpMV oracle, Vanek greedy
// aggregation, and two-pass CSR SpGEMM for the Galerkin triple product.
//
// Role parity: the reference's setup-time compute runs inside PETSc's C
// internals (MatAssemblyEnd_SeqAIJ compaction, GAMG's MatPtAP /
// MatTransposeMatMult SpGEMM at KSPSetUp — exercised from
// the reference's src/main_ksp.cpp:97).  The framework keeps the *apply*
// path on-device (JAX/XLA); this library is the native runtime for the
// once-per-matrix setup path, replacing scipy so unstructured AMG setup does
// not bottleneck on Python.
//
// Exposed via a plain C ABI consumed with ctypes (tpusparse/native/).
//
// Conventions: CSR = (indptr int64[n+1], indices int32[nnz], data f64[nnz]),
// rows sorted by column.  All functions are single-threaded (setup path;
// the build host is single-core) but written cache-friendly.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// y = A @ x.  Semantics of PETSc MatMult_SeqAIJ (aij.c:1277-1335 as extracted
// by the reference's scripts/petsc.sh:81-86): per-row dot over stored entries.
void csr_spmv_f64(int64_t n_rows, const int64_t* indptr,
                  const int32_t* indices, const double* data, const double* x,
                  double* y) {
  for (int64_t i = 0; i < n_rows; ++i) {
    double sum = 0.0;
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
      sum += data[p] * x[indices[p]];
    }
    y[i] = sum;
  }
}

// Vanek-style greedy aggregation over the strong-connection graph
// (GAMG "agg" family; see tpusparse/amg/unstructured.py for the algorithm
// contract and the pure-Python reference implementation).
// strong: per-entry uint8 mask aligned with indices.  agg: out, int64[n].
// Returns the number of aggregates.
int64_t greedy_aggregate(int64_t n, const int64_t* indptr,
                         const int32_t* indices, const uint8_t* strong,
                         int64_t* agg) {
  std::fill(agg, agg + n, int64_t{-1});
  int64_t n_agg = 0;

  // pass 1: root an aggregate wherever the whole strong neighborhood is free
  for (int64_t i = 0; i < n; ++i) {
    if (agg[i] != -1) continue;
    bool all_free = true;
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
      if (strong[p] && agg[indices[p]] != -1) {
        all_free = false;
        break;
      }
    }
    if (!all_free) continue;
    agg[i] = n_agg;
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
      if (strong[p]) agg[indices[p]] = n_agg;
    }
    ++n_agg;
  }

  // pass 2: attach remaining nodes to the first aggregated strong neighbor —
  // decisions read the pass-1 snapshot (attach buffer), matching the Python
  // reference exactly so both paths produce identical hierarchies
  std::vector<int64_t> attach(agg, agg + n);
  for (int64_t i = 0; i < n; ++i) {
    if (agg[i] != -1) continue;
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
      if (strong[p] && agg[indices[p]] != -1) {
        attach[i] = agg[indices[p]];
        break;
      }
    }
  }
  std::memcpy(agg, attach.data(), sizeof(int64_t) * n);

  // pass 3: leftovers root their own aggregates from still-free neighbors
  for (int64_t i = 0; i < n; ++i) {
    if (agg[i] != -1) continue;
    agg[i] = n_agg;
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
      if (strong[p] && agg[indices[p]] == -1) agg[indices[p]] = n_agg;
    }
    ++n_agg;
  }
  return n_agg;
}

// Two-pass CSR SpGEMM, C = A(m x k) @ B(k x n) — the kernel behind the
// Galerkin product A_c = P^T (A P) (PETSc MatPtAP equivalent).
//
// Pass 1 (symbolic): per-row output nnz into c_indptr (cumulative on exit).
// Pass 2 (numeric): caller allocates c_indices/c_data of size c_indptr[m]
// and calls csr_spgemm_numeric.  Dense sparse-accumulator (SPA) of width n:
// O(flops) time, O(n) scratch — right trade for setup-time products.
void csr_spgemm_symbolic(int64_t m, int64_t n, const int64_t* a_indptr,
                         const int32_t* a_indices, const int64_t* b_indptr,
                         const int32_t* b_indices, int64_t* c_indptr) {
  std::vector<int64_t> mark(static_cast<size_t>(n), -1);
  c_indptr[0] = 0;
  for (int64_t i = 0; i < m; ++i) {
    int64_t cnt = 0;
    for (int64_t pa = a_indptr[i]; pa < a_indptr[i + 1]; ++pa) {
      const int32_t j = a_indices[pa];
      for (int64_t pb = b_indptr[j]; pb < b_indptr[j + 1]; ++pb) {
        const int32_t col = b_indices[pb];
        if (mark[col] != i) {
          mark[col] = i;
          ++cnt;
        }
      }
    }
    c_indptr[i + 1] = c_indptr[i] + cnt;
  }
}

void csr_spgemm_numeric(int64_t m, int64_t n, const int64_t* a_indptr,
                        const int32_t* a_indices, const double* a_data,
                        const int64_t* b_indptr, const int32_t* b_indices,
                        const double* b_data, const int64_t* c_indptr,
                        int32_t* c_indices, double* c_data) {
  std::vector<double> spa(static_cast<size_t>(n), 0.0);
  std::vector<int64_t> mark(static_cast<size_t>(n), -1);
  std::vector<int32_t> row_cols;
  row_cols.reserve(256);
  for (int64_t i = 0; i < m; ++i) {
    row_cols.clear();
    for (int64_t pa = a_indptr[i]; pa < a_indptr[i + 1]; ++pa) {
      const int32_t j = a_indices[pa];
      const double av = a_data[pa];
      for (int64_t pb = b_indptr[j]; pb < b_indptr[j + 1]; ++pb) {
        const int32_t col = b_indices[pb];
        if (mark[col] != i) {
          mark[col] = i;
          spa[col] = av * b_data[pb];
          row_cols.push_back(col);
        } else {
          spa[col] += av * b_data[pb];
        }
      }
    }
    std::sort(row_cols.begin(), row_cols.end());
    int64_t p = c_indptr[i];
    for (const int32_t col : row_cols) {
      c_indices[p] = col;
      c_data[p] = spa[col];
      ++p;
    }
  }
}

// CSR transpose (PETSc MatTranspose equivalent): B = A^T, counting sort by
// column.  b_* must be sized (n_cols+1 / nnz / nnz).
void csr_transpose(int64_t n_rows, int64_t n_cols, const int64_t* indptr,
                   const int32_t* indices, const double* data,
                   int64_t* b_indptr, int32_t* b_indices, double* b_data) {
  const int64_t nnz = indptr[n_rows];
  std::fill(b_indptr, b_indptr + n_cols + 1, int64_t{0});
  for (int64_t p = 0; p < nnz; ++p) ++b_indptr[indices[p] + 1];
  for (int64_t c = 0; c < n_cols; ++c) b_indptr[c + 1] += b_indptr[c];
  std::vector<int64_t> next(b_indptr, b_indptr + n_cols);
  for (int64_t i = 0; i < n_rows; ++i) {
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
      const int64_t q = next[indices[p]]++;
      b_indices[q] = static_cast<int32_t>(i);
      b_data[q] = data[p];
    }
  }
}

// Reverse Cuthill-McKee ordering — the bandwidth-reduction pass that turns
// arbitrary-sparsity CSR into the bounded-band world the banded executors
// need (sparse/bandell.py windows, sparse/dia.py offsets).  Role parity:
// the reference's patched MatMult_SeqAIJ handles ANY row structure
// (its src/openacc-step1/MatMult_SeqAIJ.patch:19-30); here the equivalent
// generality comes from reorder + banded executor, a design made for an
// accelerator that could not stream large scattered gathers (not measured
// on the GPU).
//
// Assumes a structurally symmetric pattern (true for the FDM/FEM problem
// families; callers symmetrize otherwise).  perm[new] = old.  BFS from a
// pseudo-peripheral start per component (two-sweep George-Liu heuristic),
// neighbors visited in increasing-degree order, final order reversed.
void rcm_order(int64_t n, const int64_t* indptr, const int32_t* indices,
               int64_t* perm) {
  std::vector<int64_t> deg(n);
  for (int64_t i = 0; i < n; ++i) deg[i] = indptr[i + 1] - indptr[i];
  std::vector<uint8_t> vis(n, 0);
  std::vector<int64_t> order;
  order.reserve(n);
  std::vector<int64_t> q;     // BFS queue (reused)
  std::vector<int64_t> nbrs;  // per-node neighbor scratch

  auto bfs = [&](int64_t start, std::vector<uint8_t>& mark,
                 std::vector<int64_t>& out) -> int64_t {
    // BFS in degree-sorted neighbor order; returns index where the last
    // level begins in `out`
    out.clear();
    out.push_back(start);
    mark[start] = 1;
    size_t head = 0;
    size_t level_begin = 0, level_end = 1;
    while (head < out.size()) {
      if (head == level_end) {
        level_begin = level_end;
        level_end = out.size();
      }
      const int64_t u = out[head++];
      nbrs.clear();
      for (int64_t p = indptr[u]; p < indptr[u + 1]; ++p) {
        const int64_t v = indices[p];
        if (!mark[v]) {
          mark[v] = 1;
          nbrs.push_back(v);
        }
      }
      std::sort(nbrs.begin(), nbrs.end(), [&](int64_t a, int64_t b) {
        return deg[a] != deg[b] ? deg[a] < deg[b] : a < b;
      });
      for (const int64_t v : nbrs) out.push_back(v);
    }
    if (level_end < out.size()) level_begin = level_end;
    return static_cast<int64_t>(level_begin);
  };

  std::vector<uint8_t> tmp_mark(n, 0);
  std::vector<int64_t> sweep;
  sweep.reserve(n);
  for (int64_t s = 0; s < n; ++s) {
    if (vis[s]) continue;
    // pseudo-peripheral start: BFS from s, restart from a min-degree node
    // of the last level (one extra sweep is enough in practice)
    std::fill(tmp_mark.begin(), tmp_mark.end(), uint8_t{0});
    int64_t last = bfs(s, tmp_mark, sweep);
    int64_t start = sweep[last];
    for (size_t i = last; i < sweep.size(); ++i) {
      if (deg[sweep[i]] < deg[start]) start = sweep[i];
    }
    // the component's nodes are exactly those reached by the probe sweep;
    // un-mark them for the real pass
    for (const int64_t v : sweep) tmp_mark[v] = 0;
    bfs(start, vis, q);
    order.insert(order.end(), q.begin(), q.end());
  }
  // RCM = reversed Cuthill-McKee
  for (int64_t i = 0; i < n; ++i) perm[i] = order[n - 1 - i];
}

// 7-point Poisson assembly (reference generateA, src/helper.cpp:161-246):
// all-Neumann via dropped entries absorbed into the diagonal, natural
// (k, j, i) ordering, sorted columns.  Writes a fixed-width-7 CSR directly.
// indptr must be int64[n+1]; indices/data sized for 7*n (actual nnz returned
// via indptr[n]).
void assemble_poisson7(int64_t nx, int64_t ny, int64_t nz, double dx,
                       double dy, double dz, int64_t* indptr, int32_t* indices,
                       double* data) {
  const double ax = 1.0 / (dx * dx), ay = 1.0 / (dy * dy),
               az = 1.0 / (dz * dz);
  const int64_t n = nx * ny * nz;
  int64_t p = 0;
  indptr[0] = 0;
  for (int64_t k = 0; k < nz; ++k) {
    for (int64_t j = 0; j < ny; ++j) {
      for (int64_t i = 0; i < nx; ++i) {
        const int64_t row = (k * ny + j) * nx + i;
        double diag = 0.0;
        const int64_t diag_slot_mark = p;  // lower nbrs first, then diag
        if (k > 0) { indices[p] = static_cast<int32_t>(row - ny * nx);
                     data[p++] = az; diag -= az; }
        if (j > 0) { indices[p] = static_cast<int32_t>(row - nx);
                     data[p++] = ay; diag -= ay; }
        if (i > 0) { indices[p] = static_cast<int32_t>(row - 1);
                     data[p++] = ax; diag -= ax; }
        const int64_t dslot = p++;
        indices[dslot] = static_cast<int32_t>(row);
        if (i < nx - 1) { indices[p] = static_cast<int32_t>(row + 1);
                          data[p++] = ax; diag -= ax; }
        if (j < ny - 1) { indices[p] = static_cast<int32_t>(row + nx);
                          data[p++] = ay; diag -= ay; }
        if (k < nz - 1) { indices[p] = static_cast<int32_t>(row + ny * nx);
                          data[p++] = az; diag -= az; }
        data[dslot] = diag;
        (void)diag_slot_mark;
        indptr[row + 1] = p;
      }
    }
  }
  (void)n;
}

}  // extern "C"
