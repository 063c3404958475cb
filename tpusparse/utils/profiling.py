"""Profiler integration — the substitute for the reference's Score-P /
nvprof twin-binary infrastructure (SURVEY.md section 5.1).

The reference compiles every executable three ways (plain, Score-P
-instrumented, nvprof-ready; ``Makefile:48-51``) and drives them from
dedicated PBS jobs.  Here the equivalent capability is one runtime switch:
wrap any region in ``trace()`` (or pass ``--profile`` to the CLI) and a
TensorBoard/XProf trace with per-kernel timelines, HLO cost analysis, and
memory-copy activity lands in the given directory — covering what the
reference's SCOREP_OPENACC_ENABLE kernel/memcpy capture and nvprof
per-stream timelines covered.
"""

from __future__ import annotations

import contextlib
import pathlib
import time


@contextlib.contextmanager
def trace(logdir: str | pathlib.Path | None):
    """Context manager: JAX profiler trace of the enclosed region.

    No-op when ``logdir`` is falsy, so call sites can thread a CLI flag
    straight through.  View with ``tensorboard --logdir <dir>`` or xprof.
    """
    if not logdir:
        yield None
        return
    import jax

    logdir = str(logdir)
    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def annotate(name: str):
    """Named sub-region inside a trace (TraceAnnotation), for phase-level
    attribution like the reference's PetscLogEvent brackets."""
    import jax

    with jax.profiler.TraceAnnotation(name):
        yield


class Stopwatch:
    """Tiny repeated-region timer for quick roofline spot-checks without a
    full trace (PetscTime parity in spirit)."""

    def __init__(self):
        self.times: list[float] = []

    @contextlib.contextmanager
    def lap(self):
        t0 = time.perf_counter()
        yield
        self.times.append(time.perf_counter() - t0)

    @property
    def best(self) -> float:
        return min(self.times)

    @property
    def mean(self) -> float:
        return sum(self.times) / len(self.times)
