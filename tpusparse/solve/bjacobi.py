"""Block-Jacobi preconditioner — real PCBJACOBI, not the point degeneracy.

PETSc's reference config (``configs/PETSc_SolverOptions_GAMG.info:12-21``)
composes ``bjacobi`` with a ``jacobi`` sub-PC per block, which degenerates to
point Jacobi with one block per process — the shape round 1 shipped.  This
module is the non-degenerate capability: extract the bs x bs diagonal blocks
of A, invert them once at setup (KSPSetUp parity), and apply

    z_block = inv(D_block) @ r_block

as one batched small matmul.  Properties: the apply is a single
(nb, bs, bs) x (nb, bs) einsum at full float32 precision, **gather-free**
(block i reads exactly slice i of r).

Use: AMG level smoother sub-PC (``gamg_setup_unstructured(...,
bjacobi_bs=4)``) for multi-dof-per-node discretizations where coupling the
dofs of a node per smoother application beats point relaxation; or
standalone as ``m_mv=bj.apply``.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["dinv_blocks"],
    meta_fields=["bs", "n"],
)
@dataclasses.dataclass
class BlockJacobi:
    """Inverted diagonal blocks of A: ``dinv_blocks[k] = inv(A[kb:kb+bs,
    kb:kb+bs])`` (tail block padded with identity when bs does not divide
    n)."""

    dinv_blocks: jax.Array  # (nb, bs, bs)
    bs: int
    n: int

    @classmethod
    def build(cls, a, bs: int, dtype=None, device=None) -> "BlockJacobi":
        """Extract + invert the diagonal blocks of a HostCSR (host-side,
        vectorized — runs once at setup)."""
        from tpusparse.sparse.csr import HostCSR

        if not isinstance(a, HostCSR):
            a = HostCSR.from_scipy(a)
        n = a.n_rows
        nb = -(-n // bs)
        rows = np.repeat(np.arange(n, dtype=np.int64), a.row_nnz())
        cols = a.indices.astype(np.int64)
        mask = rows // bs == cols // bs
        if nb * bs * bs > cls.DENSE_ENTRY_CAP:
            off = (cols - rows)[mask]
            if not np.all(np.abs(off) <= 1):
                raise ValueError(
                    f"bjacobi bs={bs}: dense inverted blocks would hold "
                    f"{nb * bs * bs:.3g} entries (> "
                    f"{cls.DENSE_ENTRY_CAP:.3g} cap) and the blocks are "
                    f"not tridiagonal — shrink bs"
                )
            tri = np.zeros((3, nb * bs), np.float64)
            tri[off + 1, rows[mask]] = a.data[mask]
            tri[1, n:] = 1.0  # identity tail block
            tri[1, tri[1] == 0.0] = 1.0  # singular-block regularization
            lo, d, up = (
                r.reshape(nb, bs)
                for r in jax.device_put(
                    tri if dtype is None else tri.astype(dtype),
                    device=device,
                )
            )
            return PCRLineJacobi.build(lo, d, up, n)
        blocks = np.zeros((nb, bs, bs), np.float64)
        blocks[rows[mask] // bs, rows[mask] % bs, cols[mask] % bs] = (
            a.data[mask]
        )
        # pad rows beyond n (tail block) with identity so inversion is safe
        for r in range(n, nb * bs):
            blocks[r // bs, r % bs, r % bs] = 1.0
        # structurally-empty diagonal entries would make a block singular;
        # PETSc's bjacobi would likewise fail there — regularize explicitly
        dg = np.einsum("kii->ki", blocks)
        dg[dg == 0.0] = 1.0
        inv = np.linalg.inv(blocks)
        if dtype is not None:
            inv = inv.astype(dtype)
        return cls(
            dinv_blocks=jax.device_put(inv, device=device), bs=bs, n=n
        )

    # Dense inverted blocks cost O(n*bs) memory and O(n*bs) flops per
    # apply.  Past this many block entries (f32: 256 MiB) the dense form
    # is the wrong tool: tridiagonal blocks (the x-line case — only +-1
    # offsets fall inside a line block on a star stencil) reroute to the
    # O(n log bs) PCR factorization below; anything denser must shrink bs.
    DENSE_ENTRY_CAP = 64 * 2**20

    @classmethod
    def from_bands(cls, diag: jax.Array, bands: dict, bs: int):
        """Device-side build from a structured operator's flat-offset band
        fields (``flat_band_fields(bs)`` on StarStencil3D / VarStencil27:
        {o: f} with ``f[p] = A[p, p+o]`` for 0 < |o| < bs — offsets at or
        beyond bs can never land inside a bs x bs diagonal block).  Runs
        entirely on the accelerator (traceable — used inside the
        one-dispatch ``gamg_setup_compiled`` program); couplings that
        straddle a block boundary are dropped, which is exactly what
        block-Jacobi means.

        Returns a :class:`BlockJacobi` (dense inverted blocks, one batched
        einsum per apply) while that fits the entry cap; tridiagonal
        blocks past the cap — the production x-line case, ``bs = nx`` at
        300^3 would need ~32 GB dense — return a :class:`PCRLineJacobi`
        instead (same ``apply`` contract).
        """
        d = diag.reshape(-1)
        n = d.shape[0]
        nb = -(-n // bs)
        pad = nb * bs - n

        def prep(v, fill):
            v = v.reshape(-1).astype(d.dtype)
            if pad:
                v = jnp.concatenate(
                    [v, jnp.full((pad,), fill, d.dtype)]
                )
            return v.reshape(nb, bs)

        rel = {o: f for o, f in bands.items() if 0 < abs(o) < bs}
        # structurally-empty diagonal entries would make a block singular
        # (same regularization as the host CSR build above); the tail
        # block pads with identity
        d2 = prep(jnp.where(d == 0, jnp.ones((), d.dtype), d), 1.0)
        if nb * bs * bs > cls.DENSE_ENTRY_CAP:
            if set(rel) <= {-1, 1}:
                zero = jnp.zeros((nb, bs), d.dtype)
                lo = prep(rel[-1], 0.0) if -1 in rel else zero
                up = prep(rel[1], 0.0) if 1 in rel else zero
                # couplings straddling a block boundary are dropped
                lo = lo.at[:, 0].set(0.0)
                up = up.at[:, bs - 1].set(0.0)
                return PCRLineJacobi.build(lo, d2, up, n)
            raise ValueError(
                f"bjacobi bs={bs}: dense inverted blocks would hold "
                f"{nb * bs * bs:.3g} entries (> {cls.DENSE_ENTRY_CAP:.3g} "
                f"cap) and the blocks are not tridiagonal "
                f"(offsets {sorted(rel)}) — shrink bs"
            )
        blocks = d2[:, :, None] * jnp.eye(bs, dtype=d.dtype)
        for o, f in sorted(rel.items()):
            # entry (j, j+o) of block k = f[k*bs + j]; jnp.eye's k-th
            # diagonal masks the rows whose j+o falls outside the block
            blocks = blocks + prep(f, 0.0)[:, :, None] * jnp.eye(
                bs, k=o, dtype=d.dtype
            )
        return cls(dinv_blocks=jnp.linalg.inv(blocks), bs=bs, n=n)

    def apply(self, r: jax.Array) -> jax.Array:
        """z = inv(blockdiag(A)) @ r — batched matmul, no gather.  Accepts
        the flat vector or any field view of it (the structured V-cycle
        smooths on (nz, ny, nx) fields); the output keeps r's shape."""
        nb, bs = self.dinv_blocks.shape[0], self.bs
        pad = nb * bs - self.n
        rf = r.reshape(-1)
        rb = (jnp.pad(rf, (0, pad)) if pad else rf).reshape(nb, bs)
        z = jnp.einsum(
            "kij,kj->ki", self.dinv_blocks, rb,
            preferred_element_type=rb.dtype,
            precision=jax.lax.Precision.HIGHEST,
        ).reshape(-1)
        return (z[: self.n] if pad else z).reshape(r.shape)

    def __call__(self, r: jax.Array) -> jax.Array:
        return self.apply(r)


def _sh_dn(v: jax.Array, k: int, fill: float = 0.0) -> jax.Array:
    """result[:, j] = v[:, j-k] (entries below the block start read fill)."""
    nb = v.shape[0]
    return jnp.concatenate(
        [jnp.full((nb, k), fill, v.dtype), v[:, :-k]], axis=1
    )


def _sh_up(v: jax.Array, k: int, fill: float = 0.0) -> jax.Array:
    """result[:, j] = v[:, j+k] (entries past the block end read fill)."""
    nb = v.shape[0]
    return jnp.concatenate(
        [v[:, k:], jnp.full((nb, k), fill, v.dtype)], axis=1
    )


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["alphas", "gammas", "binv"],
    meta_fields=["bs", "n", "shifts"],
)
@dataclasses.dataclass
class PCRLineJacobi:
    """Exact tridiagonal block-diagonal solve by parallel cyclic reduction.

    The x-line relaxation case of PCBJACOBI (bs = nx: each block is one
    grid line, and on a star stencil only the +-1 offsets land inside it,
    so every block is tridiagonal).  A dense inverse would need
    O(n*bs) memory — ~32 GB at the production 300^3 — and a Thomas sweep
    is a bs-step sequential scan, the worst shape for a wide-vector
    machine.  PCR is the parallel answer: ceil(log2 bs) recursive-
    doubling steps, each a handful of elementwise madds + static-slice
    shifts over the (nb, bs) batch — gather-free, fully vectorized, and
    because the reduction coefficients depend only on the matrix they are
    precomputed ONCE at setup.  Apply then replays

        d <- d + alpha_k * d_{j-2^k} + gamma_k * d_{j+2^k}   (k = 0..L-1)
        x = d / b_final

    costing O(n log bs) flops/bytes per application and O(n log bs)
    setup memory (the stored alpha/gamma ladders).

    Same ``apply`` contract as :class:`BlockJacobi`; built via
    ``BlockJacobi.from_bands`` when blocks are tridiagonal and over the
    dense cap, or directly from the three diagonals with :meth:`build`.
    """

    alphas: tuple  # L arrays (nb, bs) — lower elimination coefficients
    gammas: tuple  # L arrays (nb, bs) — upper elimination coefficients
    binv: jax.Array  # (nb, bs) — reciprocal of the fully-reduced diagonal
    bs: int
    n: int
    shifts: tuple  # L ints — 2^k ladder

    @classmethod
    def build(
        cls, lo: jax.Array, d: jax.Array, up: jax.Array, n: int
    ) -> "PCRLineJacobi":
        """Factor blockdiag tridiagonal systems: ``lo/d/up`` are (nb, bs)
        with ``lo[:, 0] == 0`` and ``up[:, -1] == 0`` (block boundaries).
        Traceable — runs inside the one-dispatch compiled setup."""
        nb, bs = d.shape
        a, b, c = lo, d, up
        alphas, gammas, shifts = [], [], []
        k = 1
        while k < bs:
            # eliminate the +-k couplings: row j combines rows j-k, j+k.
            # Out-of-block reads: a/c read 0 (no coupling), b reads 1
            # (identity rows) so the divisions stay finite.
            bm, bp = _sh_dn(b, k, 1.0), _sh_up(b, k, 1.0)
            alpha = -a / bm
            gamma = -c / bp
            b = b + alpha * _sh_dn(c, k) + gamma * _sh_up(a, k)
            a, c = alpha * _sh_dn(a, k), gamma * _sh_up(c, k)
            alphas.append(alpha)
            gammas.append(gamma)
            shifts.append(k)
            k *= 2
        return cls(
            alphas=tuple(alphas), gammas=tuple(gammas), binv=1.0 / b,
            bs=bs, n=n, shifts=tuple(shifts),
        )

    def apply(self, r: jax.Array) -> jax.Array:
        """z = inv(blockdiag(tridiag)) @ r — replay the precomputed PCR
        ladder on the right-hand side.  Shape contract matches
        :meth:`BlockJacobi.apply`."""
        nb, bs = self.binv.shape
        pad = nb * bs - self.n
        rf = r.reshape(-1)
        d = (jnp.pad(rf, (0, pad)) if pad else rf).reshape(nb, bs)
        for alpha, gamma, k in zip(self.alphas, self.gammas, self.shifts):
            d = d + alpha * _sh_dn(d, k) + gamma * _sh_up(d, k)
        z = (self.binv * d).reshape(-1)
        return (z[: self.n] if pad else z).reshape(r.shape)

    def __call__(self, r: jax.Array) -> jax.Array:
        return self.apply(r)
