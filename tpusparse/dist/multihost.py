"""Multi-host runtime bring-up — MPI_Init/aprun parity.

The reference launches N MPI ranks with ``aprun -n N`` under PBS/ALPS and
brackets everything in ``MPI_Init``/``MPI_Finalize``
(``src/main_ksp.cpp:70-71,138-139``; ``runs/multiple-node-scaling.pbs:59``).
The JAX equivalent is ONE process per host + ``jax.distributed.initialize``:
all GPUs on all hosts then appear in ``jax.devices()``, meshes span hosts
transparently, and XLA routes collectives between the devices (NCCL on
GPUs) — there is no rank-level code at all
(SURVEY.md section 5.8).

Launch (e.g. under Slurm/GKE, one process per host):

    python -c "import tpusparse.dist.multihost as mh; mh.initialize(); ..."

with the coordinator env vars set, or pass the coordinator address,
process count and rank explicitly.
"""

from __future__ import annotations

import os

import jax


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Bring up the multi-host runtime (idempotent).

    Pass the coordinator host:port and this process's rank, or set
    JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID.

    Must run before any backend-initializing JAX call — so the check below
    is on the distributed client only; calling e.g. ``jax.process_count()``
    here would itself initialize the backend and break the bring-up (bug
    found by tests/test_multiprocess.py, the first real 2-process exercise
    of this path).
    """
    if _already_initialized():
        return
    kw = {}
    addr = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if addr:
        kw["coordinator_address"] = addr
    if num_processes is not None or os.environ.get("JAX_NUM_PROCESSES"):
        kw["num_processes"] = (
            num_processes
            if num_processes is not None
            else int(os.environ["JAX_NUM_PROCESSES"])
        )
    if process_id is not None or os.environ.get("JAX_PROCESS_ID"):
        kw["process_id"] = (
            process_id
            if process_id is not None
            else int(os.environ["JAX_PROCESS_ID"])
        )
    try:
        jax.distributed.initialize(**kw)
    except (ValueError, RuntimeError):
        # single-process runs (tests, one host with one chip) are fine
        if kw:
            raise


def _already_initialized() -> bool:
    try:
        from jax._src.distributed import global_state

        return global_state.client is not None
    except Exception:
        return False


def describe() -> dict:
    """Topology summary for rank-0-style logging (PetscPrintf parity)."""
    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": len(jax.local_devices()),
        "global_devices": len(jax.devices()),
        "device_kind": jax.devices()[0].device_kind if jax.devices() else "",
        "backend": jax.default_backend(),
    }
