"""ctypes bindings for the native (C++) setup engine.

The hot solve path is JAX/XLA on the GPU; this package is the native
runtime for the *setup* path — CSR SpGEMM (Galerkin PtAP), greedy
aggregation, transpose, and the 7-point assembly — mirroring how the
reference's setup work runs inside PETSc's C internals (GAMG MatPtAP etc.,
exercised from ``/root/reference/src/main_ksp.cpp:97``).

``lib()`` loads (building on demand with g++) ``tpusparse_native.so`` from
``csrc/``; every entry point has a pure-Python/scipy fallback, so the library
remains fully functional without a C++ toolchain (``available()`` reports
which path is active).
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess

import numpy as np

_CSRC = pathlib.Path(__file__).resolve().parent.parent.parent / "csrc"
_SO = _CSRC / "tpusparse_native.so"
_lib: ctypes.CDLL | None = None
_tried = False

_I64P = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_I32P = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_F64P = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_U8P = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")


def _build() -> bool:
    src = _CSRC / "tpusparse_native.cpp"
    if not src.exists():
        return False
    try:
        subprocess.run(
            ["g++", "-O3", "-fPIC", "-std=c++17", "-shared",
             "-o", str(_SO), str(src)],
            check=True, capture_output=True, timeout=300,
        )
        return True
    except (subprocess.SubprocessError, FileNotFoundError, OSError):
        return False


def lib() -> ctypes.CDLL | None:
    """The loaded native library, or None if unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if os.environ.get("TPUSPARSE_NO_NATIVE"):
        return None
    src = _CSRC / "tpusparse_native.cpp"
    stale = (
        _SO.exists()
        and src.exists()
        and src.stat().st_mtime > _SO.stat().st_mtime
    )
    if (not _SO.exists() or stale) and not _build():
        # a stale .so is worse than none: source edits would be silently
        # ignored.  Refuse to load it if the rebuild failed.
        return None
    try:
        L = ctypes.CDLL(str(_SO))
    except OSError:
        return None
    c_i64 = ctypes.c_int64
    L.csr_spmv_f64.argtypes = [c_i64, _I64P, _I32P, _F64P, _F64P, _F64P]
    L.csr_spmv_f64.restype = None
    L.greedy_aggregate.argtypes = [c_i64, _I64P, _I32P, _U8P, _I64P]
    L.greedy_aggregate.restype = c_i64
    L.csr_spgemm_symbolic.argtypes = [
        c_i64, c_i64, _I64P, _I32P, _I64P, _I32P, _I64P
    ]
    L.csr_spgemm_symbolic.restype = None
    L.csr_spgemm_numeric.argtypes = [
        c_i64, c_i64, _I64P, _I32P, _F64P, _I64P, _I32P, _F64P,
        _I64P, _I32P, _F64P,
    ]
    L.csr_spgemm_numeric.restype = None
    L.csr_transpose.argtypes = [
        c_i64, c_i64, _I64P, _I32P, _F64P, _I64P, _I32P, _F64P
    ]
    L.csr_transpose.restype = None
    L.assemble_poisson7.argtypes = [
        c_i64, c_i64, c_i64, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, _I64P, _I32P, _F64P,
    ]
    L.assemble_poisson7.restype = None
    L.rcm_order.argtypes = [c_i64, _I64P, _I32P, _I64P]
    L.rcm_order.restype = None
    _lib = L
    return _lib


def available() -> bool:
    return lib() is not None


def _as_csr_arrays(a):
    """(indptr i64, indices i32, data f64 contiguous) from a HostCSR."""
    return (
        np.ascontiguousarray(a.indptr, np.int64),
        np.ascontiguousarray(a.indices, np.int32),
        np.ascontiguousarray(a.data, np.float64),
    )


def spmv(a, x: np.ndarray) -> np.ndarray:
    """y = A @ x (f64). Native when available, else HostCSR numpy oracle."""
    L = lib()
    if L is None:
        return a.mv(x)
    ip, ix, dt = _as_csr_arrays(a)
    xx = np.ascontiguousarray(x, np.float64)
    y = np.empty(a.n_rows, np.float64)
    L.csr_spmv_f64(a.n_rows, ip, ix, dt, xx, y)
    return y


def spgemm(a, b):
    """C = A @ B on HostCSR (f64), sorted columns.  scipy fallback."""
    from tpusparse.sparse.csr import HostCSR

    L = lib()
    if L is None:
        c = (a.to_scipy() @ b.to_scipy()).tocsr()
        c.sum_duplicates()
        c.sort_indices()
        return HostCSR.from_scipy(c)
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(f"shape mismatch {a.shape} @ {b.shape}")
    a_ip, a_ix, a_dt = _as_csr_arrays(a)
    b_ip, b_ix, b_dt = _as_csr_arrays(b)
    c_ip = np.empty(m + 1, np.int64)
    L.csr_spgemm_symbolic(m, n, a_ip, a_ix, b_ip, b_ix, c_ip)
    nnz = int(c_ip[m])
    c_ix = np.empty(nnz, np.int32)
    c_dt = np.empty(nnz, np.float64)
    L.csr_spgemm_numeric(
        m, n, a_ip, a_ix, a_dt, b_ip, b_ix, b_dt, c_ip, c_ix, c_dt
    )
    return HostCSR(indptr=c_ip, indices=c_ix, data=c_dt, shape=(m, n))


def transpose(a):
    """B = A^T on HostCSR (f64), sorted columns."""
    from tpusparse.sparse.csr import HostCSR

    L = lib()
    if L is None:
        return a.transpose()
    m, n = a.shape
    ip, ix, dt = _as_csr_arrays(a)
    b_ip = np.empty(n + 1, np.int64)
    b_ix = np.empty(a.nnz, np.int32)
    b_dt = np.empty(a.nnz, np.float64)
    L.csr_transpose(m, n, ip, ix, dt, b_ip, b_ix, b_dt)
    return HostCSR(indptr=b_ip, indices=b_ix, data=b_dt, shape=(n, m))


def ptap(p, a):
    """Galerkin product P^T A P (PETSc MatPtAP parity)."""
    return spgemm(transpose(p), spgemm(a, p))


def aggregate(a, strong: np.ndarray) -> tuple[np.ndarray, int]:
    """Greedy Vanek aggregation over the strong mask (per-entry bool array
    aligned with a.indices).  Returns (agg ids int64[n], n_agg).

    Native implementation matches tpusparse.amg.unstructured.greedy_aggregate
    decision-for-decision (tested); falls back to it when native is absent.
    """
    L = lib()
    if L is None:
        from tpusparse.amg.unstructured import _greedy_aggregate_py

        agg = _greedy_aggregate_py(a, strong)
        return agg, int(agg.max()) + 1
    ip, ix, _ = (
        np.ascontiguousarray(a.indptr, np.int64),
        np.ascontiguousarray(a.indices, np.int32),
        None,
    )
    s = np.ascontiguousarray(strong.astype(np.uint8))
    agg = np.empty(a.n_rows, np.int64)
    n_agg = L.greedy_aggregate(a.n_rows, ip, ix, s, agg)
    return agg, int(n_agg)


def rcm(a) -> np.ndarray:
    """Reverse Cuthill-McKee ordering of a HostCSR's graph: perm int64[n]
    with perm[new] = old, minimizing the bandwidth of A[perm][:, perm].
    Assumes a structurally symmetric pattern (symmetrize first otherwise).
    scipy.sparse.csgraph fallback when the native library is absent."""
    L = lib()
    if L is None:
        from scipy.sparse.csgraph import reverse_cuthill_mckee

        return np.asarray(
            reverse_cuthill_mckee(a.to_scipy(), symmetric_mode=True),
            np.int64,
        )
    ip = np.ascontiguousarray(a.indptr, np.int64)
    ix = np.ascontiguousarray(a.indices, np.int32)
    perm = np.empty(a.n_rows, np.int64)
    L.rcm_order(a.n_rows, ip, ix, perm)
    return perm


def assemble_poisson7(nx: int, ny: int, nz: int, dx: float, dy: float,
                      dz: float):
    """Native 7-point Neumann Laplacian assembly (generateA parity,
    reference src/helper.cpp:161-246).  Returns HostCSR; None if native
    unavailable (callers fall back to the vectorized numpy assembler)."""
    from tpusparse.sparse.csr import HostCSR

    L = lib()
    if L is None:
        return None
    n = nx * ny * nz
    indptr = np.empty(n + 1, np.int64)
    indices = np.empty(7 * n, np.int32)
    data = np.empty(7 * n, np.float64)
    L.assemble_poisson7(nx, ny, nz, dx, dy, dz, indptr, indices, data)
    nnz = int(indptr[n])
    return HostCSR(
        indptr=indptr, indices=indices[:nnz], data=data[:nnz], shape=(n, n)
    )
