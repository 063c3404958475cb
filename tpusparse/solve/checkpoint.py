"""Solver-state checkpoint / resume.

The reference has none (SURVEY.md sections 5.3-5.4): its solves finish in
seconds-to-minutes and PBS jobs are fixed-size, so fail-fast (CHKERRQ /
SETERRQ) was enough.  For long multi-host solves the cheap insurance the
survey recommends is snapshotting the Krylov state — for CG that is just the
current iterate (plus metadata): on resume we warm-restart CG from the saved
x, recomputing r = b - A x.  A warm restart drops the conjugacy history, but
restarted CG is a standard method — total work to tolerance grows by at most
the few iterations needed to rebuild the Krylov subspace, and the true
residual is exact at the restart point (no recurrence drift to inherit).

State is written atomically (tmp file + rename) as npz: leaves of an
arbitrary pytree plus a user metadata dict — no pickle, no custom formats.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np


def save_pytree(path: str | os.PathLike, tree, meta: dict | None = None):
    """Atomically write a pytree's leaves (+ JSON-able metadata) to npz."""
    path = pathlib.Path(path)
    leaves = jax.tree.leaves(tree)
    arrays = {f"leaf_{i}": np.asarray(jax.device_get(v))
              for i, v in enumerate(leaves)}
    arrays["__meta__"] = np.frombuffer(
        json.dumps(meta or {}).encode(), dtype=np.uint8
    )
    tmp = path.with_suffix(path.suffix + ".tmp")
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)  # atomic on POSIX
    return path


def load_pytree(path: str | os.PathLike, template):
    """Load leaves saved by ``save_pytree`` back into ``template``'s
    structure.  Returns (tree, meta)."""
    with np.load(pathlib.Path(path)) as z:
        meta = json.loads(bytes(z["__meta__"].tobytes()).decode() or "{}")
        flat, treedef = jax.tree.flatten(template)
        leaves = [z[f"leaf_{i}"] for i in range(len(flat))]
    restored = [
        jnp.asarray(v, dtype=t.dtype) if hasattr(t, "dtype") else v
        for v, t in zip(leaves, flat)
    ]
    return jax.tree.unflatten(treedef, restored), meta


@dataclasses.dataclass
class CheckpointConfig:
    path: str | os.PathLike
    every: int = 50          # iterations between snapshots
    keep_history: bool = False  # also write path.it<N> copies


def cg_checkpointed(
    a_mv: Callable,
    b: jax.Array,
    cfg: CheckpointConfig,
    *,
    rtol: float = 1e-5,
    atol: float = 1e-50,
    maxiter: int = 10000,
    m_mv: Callable | None = None,
    resume: bool = True,
):
    """CG with periodic solver-state snapshots and automatic resume.

    Runs ``cg`` in chunks of ``cfg.every`` iterations; after each chunk the
    iterate is snapshotted to ``cfg.path``.  If ``resume`` and the file
    exists, the solve continues from the saved iterate instead of zero —
    convergence criteria stay global (||r|| <= max(rtol*||b||, atol) on the
    true residual, PETSc KSPConvergedDefault parity like ``cg``).
    """
    from tpusparse.solve.cg import ConvergedReason, cg

    path = pathlib.Path(cfg.path)
    # state template: (x, r, z, p, rz, rnorm, it) — matches cg's loop carry
    zeros = jnp.zeros_like(b)
    template = (zeros, zeros, zeros, zeros,
                jnp.zeros((), b.dtype), jnp.zeros((), b.dtype), jnp.int32(0))
    # problem fingerprint: resuming a checkpoint written for different
    # tolerances or a different rhs would silently continue from an
    # incompatible Krylov state — validate identity before trusting it
    ident = {
        "rtol": float(rtol), "atol": float(atol),
        "shape": list(b.shape), "dtype": str(b.dtype),
        "b_norm2": float(jnp.vdot(b, b)),
    }
    state = None
    done = 0  # global iterations completed (the state's counter is
    # chunk-RELATIVE so every chunk runs the same static-maxiter compiled
    # program; a global counter would retrace/recompile once per chunk)
    if resume and path.exists():
        state, meta = load_pytree(path, template)
        saved = {k: meta.get(k) for k in ident}

        def mismatch(k):
            if meta.get(k) is None:
                return False  # pre-fingerprint checkpoint: nothing to check
            if k == "b_norm2":  # backend-dependent last-ulp rounding is fine
                return abs(meta[k] - ident[k]) > 1e-10 * max(abs(ident[k]), 1)
            return meta[k] != ident[k]

        if any(mismatch(k) for k in ident):
            raise ValueError(
                f"checkpoint {path} was written for a different problem or "
                f"tolerances (saved {saved}, current {ident}); delete it or "
                f"pass resume=False to restart"
            )
        done = int(meta.get("iters", 0))
        state = state[:6] + (jnp.int32(0),)

    while True:
        n = min(cfg.every, maxiter - done)  # != cfg.every only on the final
        # chunk, so at most two programs are ever compiled
        res, state = cg(
            a_mv, b, rtol=rtol, atol=atol, maxiter=n, m_mv=m_mv,
            state0=state, return_state=True,
        )
        done += int(res.iters)
        state = state[:6] + (jnp.int32(0),)
        save_pytree(path, state, {"iters": done, **ident})
        if cfg.keep_history:
            save_pytree(
                path.with_suffix(path.suffix + f".it{done}"), state,
                {"iters": done},
            )
        if int(res.reason) > 0:  # converged (rtol/atol — cg never stalls)
            break
        if int(res.reason) == int(ConvergedReason.DIVERGED_NANORINF):
            break
        if done >= maxiter:
            break  # global budget exhausted (stays DIVERGED_ITS)
        # otherwise the chunk budget ran out — continue from the saved state
    res = dataclasses.replace(res, iters=jnp.int32(done))
    return res, done
