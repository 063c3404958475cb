"""Double-single ("two-float") arithmetic: ~48-bit-mantissa values as
(hi, lo) f32 pairs, built from error-free transformations.

Why: it was built for an accelerator without native f64, where XLA's
emulation made the f64 stencil applies slow; the H100 has native f64 and
the comparison there is not measured yet.  Double-single arithmetic runs
entirely on the f32 datapath: each (hi, lo) field moves the same bytes as
one f64 field, the extra flops fuse into the same memory pass, and the
result carries ~1.4e-14 relative precision — enough
for the rtol 1e-8 benchmark gate and for all but the last decade of the
reference's rtol 1e-14 config (strict-f64 mode remains available for that).

Algorithms: Knuth two-sum, Dekker split/two-prod (no FMA assumed — Dekker's
26/27-bit split is exact in any IEEE binary format), Dekker/Kahan df64
add/mul.  References: Dekker 1971; Hida-Li-Bailey QD library; the same
technique NVIDIA shipped as float-float "df64" before GF100 gave them f64.

All functions are elementwise jnp ops on pytrees of (hi, lo) pairs — they
jit, shard, and fuse like any other elementwise graph.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

_SPLIT = jnp.float32(4097.0)  # 2^12 + 1: Dekker split constant for f32 (24-bit)


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["hi", "lo"],
    meta_fields=[],
)
@dataclasses.dataclass
class DF64:
    """A two-float number/array: value = hi + lo, |lo| <= ulp(hi)/2."""

    hi: jax.Array
    lo: jax.Array

    @classmethod
    def from_f64(cls, x) -> "DF64":
        hi = x.astype(jnp.float32)
        lo = (x - hi.astype(x.dtype)).astype(jnp.float32)
        return cls(hi=hi, lo=lo)

    @classmethod
    def from_f32(cls, x: jax.Array) -> "DF64":
        return cls(hi=x, lo=jnp.zeros_like(x))

    def to_f64(self) -> jax.Array:
        return self.hi.astype(jnp.float64) + self.lo.astype(jnp.float64)

    @property
    def shape(self):
        return self.hi.shape

    # operators (elementwise) -------------------------------------------------
    def __add__(self, other):
        return df_add(self, other)

    def __sub__(self, other):
        return df_add(self, df_neg(other))

    def __mul__(self, other):
        return df_mul(self, other)


def _two_sum(a, b):
    """s + e == a + b exactly (Knuth)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def _quick_two_sum(a, b):
    """Requires |a| >= |b|; s + e == a + b exactly."""
    s = a + b
    e = b - (s - a)
    return s, e


def _split(a):
    """a == hi + lo with hi, lo each 12-bit-mantissa (Dekker)."""
    t = _SPLIT * a
    hi = t - (t - a)
    lo = a - hi
    return hi, lo


def _two_prod(a, b):
    """p + e == a * b exactly (Dekker, FMA-free)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def df_neg(x: DF64) -> DF64:
    return DF64(hi=-x.hi, lo=-x.lo)


def df_add(x: DF64, y: DF64) -> DF64:
    """Two-float + two-float — the accurate (QD ``ieee_add``) 20-flop
    variant: two_sum on BOTH the hi and lo components with two
    renormalizations, which keeps the error bound under cancellation that
    the 11-flop 'sloppy' add loses."""
    s, e = _two_sum(x.hi, y.hi)
    t, f = _two_sum(x.lo, y.lo)
    e = e + t
    s, e = _quick_two_sum(s, e)
    e = e + f
    hi, lo = _quick_two_sum(s, e)
    return DF64(hi=hi, lo=lo)


def df_add_f32(x: DF64, y: jax.Array) -> DF64:
    s, e = _two_sum(x.hi, y)
    e = e + x.lo
    hi, lo = _quick_two_sum(s, e)
    return DF64(hi=hi, lo=lo)


def df_mul(x: DF64, y: DF64) -> DF64:
    p, e = _two_prod(x.hi, y.hi)
    e = e + (x.hi * y.lo + x.lo * y.hi)
    hi, lo = _quick_two_sum(p, e)
    return DF64(hi=hi, lo=lo)


def df_mul_f32(x: DF64, y: jax.Array) -> DF64:
    p, e = _two_prod(x.hi, y)
    e = e + x.lo * y
    hi, lo = _quick_two_sum(p, e)
    return DF64(hi=hi, lo=lo)


def df_scale_pow2(x: DF64, s) -> DF64:
    """Exact scaling by a power of two (both components scale exactly)."""
    return DF64(hi=x.hi * s, lo=x.lo * s)


def df_norm2(x: DF64) -> jax.Array:
    """||x||_2 as an f32-accurate scalar, overflow/underflow-safe.

    A convergence gate needs ~4 correct digits, not 48 bits: scale by
    max|hi|, square, reduce in f32.
    """
    m = jnp.maximum(jnp.max(jnp.abs(x.hi)), jnp.float32(1e-30))
    v = x.hi / m + x.lo / m
    return m * jnp.sqrt(jnp.sum(v * v))


def df_dot_f64ref(x: DF64, y: DF64) -> jax.Array:
    """Reference dot via f64 (tests only)."""
    return jnp.vdot(x.to_f64().reshape(-1), y.to_f64().reshape(-1))
