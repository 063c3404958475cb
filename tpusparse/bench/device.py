"""What the measurement scripts run on, and the refusal to run elsewhere.

Every timed result names its device.  A measurement script that finds no
GPU stops with a non-zero exit: a CPU time is not a device time.
"""

from __future__ import annotations

import sys


def describe_device() -> dict:
    """``{"platform", "kind", "count"}`` as JAX reports them."""
    import jax

    devs = jax.devices()
    return {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }


def require_gpu(prog: str) -> dict:
    """``describe_device()``, or exit non-zero when the device is no GPU."""
    dev = describe_device()
    if dev["platform"] != "gpu":
        print(
            f"{prog}: JAX found no GPU (platform {dev['platform']!r},"
            f" {dev['kind']!r}); refusing to report a device measurement",
            file=sys.stderr,
        )
        raise SystemExit(2)
    return dev


def peak_bytes_in_use(device=None) -> int | None:
    """``memory_stats()["peak_bytes_in_use"]`` of the device (None where the
    backend keeps no memory statistics, as the CPU does)."""
    import jax

    stats = (device or jax.devices()[0]).memory_stats()
    return None if not stats else stats.get("peak_bytes_in_use")
