"""Galerkin coarse operators A_c = P^T A P by exact on-device probing.

The reference's GAMG builds coarse operators with distributed SpGEMM triple
products inside ``KSPSetUp`` (``src/main_ksp.cpp:97``) — the classic
dynamic-sparsity nightmare on a static-shape machine.  The structured design
dissolves it: A_c is known a priori to be a 27-point ``VarStencil27``
(see ``varstencil.py``), so its coefficients can be *probed exactly* with 27
comb vectors.  Comb (a,b,c) is the indicator of all coarse cells p with
``p % 3 == (a,b,c)``; since A_c has radius 1 and comb members are 3 apart, the
rows of all member cells land in disjoint regions of y = A_c e, and

    coef[offset][p] = y[p + offset]          for p in the comb.

27 applications of the matrix-free pipeline restrict(A(prolong(.))) — each a
handful of stencil passes at full HBM bandwidth — replace the SpGEMM
entirely, run on device, and are exact (not sampled): a direct device-side
answer to SURVEY.md's "hardest kernel" (section 7).
"""

from __future__ import annotations

import itertools
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from tpusparse.sparse.varstencil import OFFSETS, VarStencil27, shift3


def galerkin_coarse(fine_op, dinv, transfer, dtype=None) -> VarStencil27:
    """Build A_c = P^T A P as a VarStencil27 via 27-comb probing.

    ``fine_op``: fine-level operator (StarStencil3D or VarStencil27);
    ``dinv``: fine diagonal inverse field; ``transfer``: StructuredTransfer.
    """
    c_shape = transfer.c_shape
    dt = dtype or dinv.dtype

    # ONE jitted program running all 27 probes in a fori_loop: a single
    # compile + dispatch instead of 27 eager round trips.  The comb
    # residue mask is computed from the loop index on device; the combs
    # write disjoint coefficients, so the functional updates commute.
    @jax.jit
    def probe_all(fine_op, dinv, transfer):
        kz = jax.lax.broadcasted_iota(jnp.int32, c_shape, 0) % 3
        jy = jax.lax.broadcasted_iota(jnp.int32, c_shape, 1) % 3
        ix = jax.lax.broadcasted_iota(jnp.int32, c_shape, 2) % 3

        def body(comb, coef):
            a, rem = comb // 9, comb % 9
            b, c = rem // 3, rem % 3
            mask = (kz == a) & (jy == b) & (ix == c)
            e = mask.astype(dt)
            y = transfer.restrict(fine_op, dinv, fine_op.mv(
                transfer.prolong(fine_op, dinv, e)
            ))
            for o, off in enumerate(OFFSETS):
                coef = coef.at[o].set(
                    jnp.where(mask, shift3(y, off), coef[o])
                )
            return coef

        coef0 = jnp.zeros((27,) + tuple(c_shape), dtype=dt)
        return jax.lax.fori_loop(
            jnp.int32(0), jnp.int32(27), body, coef0
        )

    return VarStencil27(coef=probe_all(fine_op, dinv, transfer))


def ptap_scipy(a_csr, p_scipy):
    """Host oracle: P^T A P via scipy SpGEMM (tests only)."""
    from tpusparse.sparse.csr import HostCSR

    a = a_csr.to_scipy()
    ac = (p_scipy.T @ (a @ p_scipy)).tocsr()
    ac.sum_duplicates()
    ac.sort_indices()
    # prune exact zeros created by cancellation to keep patterns comparable
    ac.eliminate_zeros()
    return HostCSR.from_scipy(ac)
