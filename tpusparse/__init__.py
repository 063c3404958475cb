"""tpusparse — a sparse linear-algebra framework in JAX for GPUs.

A from-scratch JAX/XLA re-design of the capability surface of
olcf/PETSC-OpenACC (3D Poisson + CG + smoothed-aggregation AMG with
GPU-accelerated SpMV): structured-grid stencil operators, padded-ELL /
CSR / COO sparse containers, Krylov solvers, an algebraic-multigrid
preconditioner, and multi-chip distribution over a ``jax.sharding.Mesh``.

Design stance (vs the reference): the reference patches a CPU library's CSR
SpMV kernel with OpenACC and hand-manages device residency
(``src/openacc-step{1..4}/*.patch``). Here everything lives in device memory
under XLA management and the whole solve is a single jitted functional program;
the reference's four optimization "steps" (persistent device data, async
transfer, overlap, stream pipelining) are structural properties here.
"""

__version__ = "0.1.0"

from tpusparse.grid.grid3d import Grid3D
from tpusparse.ksp import KSP, KSPResult
from tpusparse.sparse.csr import HostCSR
from tpusparse.sparse.ell import ELL
from tpusparse.sparse.stencil import StarStencil3D

__all__ = [
    "Grid3D",
    "HostCSR",
    "ELL",
    "KSP",
    "KSPResult",
    "StarStencil3D",
    "__version__",
]
