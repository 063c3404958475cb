"""Collective-traffic extraction from compiled (post-SPMD) HLO.

The weak-scaling projection (``bench/scaling.comm_model``) prices halo,
seam, and reduction traffic from FORMULAS; this module makes those volume
terms falsifiable by reading what GSPMD actually emitted: every
``collective-permute`` / ``all-gather`` / ``all-reduce`` in the compiled
module, with per-shard byte counts parsed from the HLO result shapes.
(Post-partitioning HLO carries LOCAL shapes, so a plane exchange shows up
as exactly one plane per permute.)  SURVEY §5.7 / round-3 verdict item 4.
"""

from __future__ import annotations

import re

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "bf16": 2, "f16": 2,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4,
    "s16": 2, "u16": 2, "s8": 1, "u8": 1, "pred": 1,
}

# `%name = f32[12,4,3]{2,1,0} collective-permute(...)` — capture the op's
# RESULT type + which collective it is.  Tuple-typed results ((f32[...],
# f32[...])) appear for variadic collectives; capture each member.
# Post-scheduling HLO on accelerators splits collectives into async
# `X-start` / `X-done` pairs — accept the `-start` form too (the `-done`
# result repeats the payload, so only `-start` is counted), else the
# validator silently reports zero collective bytes on real-hardware HLO
# while CPU-test HLO (sync forms) keeps the suite green.
_OP_RE = re.compile(
    r"=\s*(?P<type>\([^)]*\)|[a-z0-9]+\[[0-9,]*\][^ ]*)\s+"
    r"(?P<op>collective-permute|all-gather|all-reduce|all-to-all|"
    r"reduce-scatter)(?P<async>-start)?\(",
)
_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")


def _shape_bytes(dt: str, dims: str) -> int:
    if dt not in _DTYPE_BYTES:
        return 0
    n = 1
    for d in dims.split(","):
        if d:
            n *= int(d)
    return n * _DTYPE_BYTES[dt]


def _type_bytes(type_str: str, async_start: bool = False) -> int:
    shapes = _SHAPE_RE.findall(type_str)
    if async_start and type_str.lstrip().startswith("(") and len(shapes) >= 2:
        # `X-start` results are (operand, result[, context...]) tuples —
        # count ONLY the result member (index 1), else operand+result
        # double-counts every async collective.
        return _shape_bytes(*shapes[1])
    return sum(_shape_bytes(dt, dims) for dt, dims in shapes)


def collective_ops(hlo_text: str) -> list[dict]:
    """All collectives in the module: [{op, bytes, line}] (per-shard result
    bytes).  Ops inside a while-loop body appear once — i.e. per
    iteration — which is exactly the per-iteration accounting the comm
    model uses."""
    out = []
    for line in hlo_text.splitlines():
        m = _OP_RE.search(line)
        if m:
            out.append({
                "op": m.group("op"),
                "bytes": _type_bytes(
                    m.group("type"), async_start=bool(m.group("async"))
                ),
                "line": line.strip()[:160],
            })
    return out


def collective_summary(hlo_text: str) -> dict:
    """{op_kind: {"count": N, "bytes": total per-shard result bytes}}."""
    summary: dict = {}
    for rec in collective_ops(hlo_text):
        s = summary.setdefault(rec["op"], {"count": 0, "bytes": 0})
        s["count"] += 1
        s["bytes"] += rec["bytes"]
    return summary


def compiled_collectives(fn, *args, **jit_kw) -> dict:
    """Jit + lower + compile ``fn`` on the given args and summarize its
    collectives.  ``jit_kw`` forwards to jax.jit (in_shardings etc.)."""
    import jax

    compiled = jax.jit(fn, **jit_kw).lower(*args).compile()
    texts = compiled.as_text()
    if isinstance(texts, (list, tuple)):
        texts = "\n".join(texts)
    return collective_summary(texts)
