"""Test harness config: run on CPU with 8 virtual devices so multi-chip
sharding paths (halo exchange, psum reductions) are exercised without a pod,
per the reference's gap of having no test suite at all (SURVEY.md section 4).
"""

import os

# the suite runs on the CPU and exercises the 8-device virtual mesh; tests
# that need the GPU are marked ``gpu`` and skip here (chip_smoke.py runs the
# same checks on the card)
os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

from tpusparse.utils.compile_cache import enable_compile_cache  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
# persistent compile cache: XLA:CPU compilation of the jitted solves
# dominates the suite's wall time.  Without $JAX_COMPILATION_CACHE_DIR the
# cache dir is FINGERPRINTED BY HOST CPU FEATURES: XLA:CPU AOT artifacts
# compiled on one CPU flavour can SIGSEGV when deserialized on another
# (observed: full-suite segfaults inside compilation_cache preceded by
# cpu_aot_loader machine-feature mismatch warnings), so a checkout that
# moves between machines keeps one cache per CPU flavour.
def _cpu_tag() -> str:
    import hashlib

    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    return hashlib.sha1(line.encode()).hexdigest()[:12]
    except OSError:
        pass
    return "nocpuinfo"


enable_compile_cache(f"pytest_{_cpu_tag()}")
