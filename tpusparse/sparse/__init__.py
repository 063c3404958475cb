from tpusparse.sparse.bsr import BSR
from tpusparse.sparse.coo import COO
from tpusparse.sparse.csr import HostCSR
from tpusparse.sparse.dia import DIA
from tpusparse.sparse.ell import ELL
from tpusparse.sparse.io import (
    load_matrix,
    load_petsc_mat,
    load_petsc_vec,
    save_petsc_mat,
    save_petsc_vec,
)
from tpusparse.sparse.stencil import StarStencil3D, StarStencilDF
from tpusparse.sparse.varstencil import VarStencil27

__all__ = [
    "BSR",
    "COO",
    "HostCSR",
    "DIA",
    "ELL",
    "StarStencil3D",
    "StarStencilDF",
    "VarStencil27",
    "load_matrix",
    "load_petsc_mat",
    "load_petsc_vec",
    "save_petsc_mat",
    "save_petsc_vec",
]
