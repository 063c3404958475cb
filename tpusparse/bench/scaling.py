"""Scaling harness — parity with the reference's PBS benchmark jobs.

The reference's protocol (``runs/single-node-scaling.pbs:56-67``,
``runs/multiple-node-scaling.pbs:57-68``): run the same 300^3 problem at a
sweep of rank counts, append each run's output block to a log, plot KSPSolve
time vs ranks.  Here the sweep is over *device counts* on a
``jax.sharding.Mesh`` — real chips when available, XLA host-emulated devices
otherwise (``XLA_FLAGS=--xla_force_host_platform_device_count=N``) — and
each run emits the same text block plus a JSON record, so the plot layer
never scrapes text (SURVEY.md section 5.5).

Strong scaling: fixed global problem, more devices.  Weak scaling: fixed
per-device problem (the BASELINE.json north star is >= 70% nnz/s efficiency).

Usage:
    python -m tpusparse.bench.scaling strong --n 128 --devices 1,2,4,8
    python -m tpusparse.bench.scaling weak --per-device 64 --devices 1,2,4,8
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys

import jax


@dataclasses.dataclass
class ScalingPoint:
    n_devices: int
    nx: int
    ny: int
    nz: int
    t_solve: float
    iters: int
    linf_error: float
    nnz: int

    @property
    def nnz_per_s(self) -> float:
        # nnz * iters: each CG iteration applies the fine operator once
        return self.nnz * max(self.iters, 1) / self.t_solve


def _poisson_nnz(nx: int, ny: int, nz: int) -> int:
    n = nx * ny * nz
    return 7 * n - 2 * (ny * nz + nx * nz + nx * ny)


def run_strong(
    n: int, device_counts: list[int], rtol: float = 1e-8, **kw
) -> list[ScalingPoint]:
    from tpusparse.bench.driver import solve_poisson

    pts = []
    for d in device_counts:
        rep = solve_poisson(n, rtol=rtol, n_devices=d, **kw)
        pts.append(
            ScalingPoint(
                n_devices=d, nx=n, ny=n, nz=n,
                t_solve=rep.t_solve, iters=rep.iters,
                linf_error=rep.linf_error, nnz=_poisson_nnz(n, n, n),
            )
        )
        print(_reference_line(pts[-1]))
    return pts


def run_weak(
    per_device: int, device_counts: list[int], rtol: float = 1e-8, **kw
) -> list[ScalingPoint]:
    """Grow nz/ny with the device count at fixed per-device box.

    The PHYSICAL DOMAIN grows with the grid (extent = (1, py, pz) at
    h = 1/per per axis) — the standard HPC weak-scaling protocol
    (replicate the same physical subdomain per processor).  Growing the
    grid on a FIXED [0,1]^3 domain instead (round 2's protocol) makes the
    operator progressively anisotropic (hz/hx up to 4x at 8 devices), and
    the isotropic 3^3 aggregation then loses mesh-independence — that, not
    a communication effect, was the 21 -> 52 iteration growth flagged in
    the round-2 review.  With constant h the iteration count stays flat
    and the manufactured cosine solution remains valid (integer periods:
    Neumann derivative is 0 at every boundary of an integer-length box).
    """
    from tpusparse.bench.driver import solve_poisson
    from tpusparse.dist.mesh import _factor2

    pts = []
    for d in device_counts:
        pz, py = _factor2(d)
        nx, ny, nz = per_device, per_device * py, per_device * pz
        rep = solve_poisson(
            nx, ny, nz, rtol=rtol, n_devices=d,
            extent=(1.0, float(py), float(pz)), **kw
        )
        pts.append(
            ScalingPoint(
                n_devices=d, nx=nx, ny=ny, nz=nz,
                t_solve=rep.t_solve, iters=rep.iters,
                linf_error=rep.linf_error, nnz=_poisson_nnz(nx, ny, nz),
            )
        )
        print(_reference_line(pts[-1]))
    return pts


def _reference_line(p: ScalingPoint) -> str:
    """One line per run, shaped like the reference's log contract
    (``scripts/generate_plots.py:87-90`` parses ``<N> Cores ... Time ...``)."""
    return (
        f"{p.n_devices} Devices [{p.nx}x{p.ny}x{p.nz}] "
        f"iters {p.iters} Linf {p.linf_error:.3e} "
        f"Time [solve]: [{p.t_solve:.6f}] "
        f"({p.nnz_per_s/1e9:.2f} Gnnz/s)"
    )


# --- bandwidth-model weak-scaling projection --------------------------------
# Emulated-mesh wall times are meaningless for efficiency claims (one CPU
# executes every "device"), but the COMMUNICATION VOLUME is exact: it is
# fixed by the sharding layout.  Turning it into a projected efficiency
# needs the link rate and the latency of a reduction round between GPUs,
# which no run has measured yet, so the projection reports "not measured"
# for more than one device.
MODEL = {
    # fine-level operator applies per CG+AMG iteration: V-cycle 6 + CG 1
    "fine_applies_per_iter": 7,
    # scalar reductions per CG iteration (alpha dot, r.z, ||r||)
    "psums_per_iter": 3,
    # AMG levels whose halos the model charges beyond level 0.  Each level
    # is 27x smaller but still exchanges planes; with the replicated-coarse
    # policy only level 0 (sharded) has halos, and the fine/coarse seam
    # pays one coarse-vector all-gather per cycle instead (charged below).
    "sharded_levels": 1,
    # coarsening ratio per level (3^3 aggregation)
    "coarsen_ratio": 27,
}


def comm_model(pts: list[ScalingPoint], t_iter_1dev: float) -> list[dict]:
    """Per-point communication volume, and the projected weak-scaling
    efficiency where it needs no unmeasured constant.

    The efficiency would be t_compute / (t_compute + t_halo + t_seam +
    t_latency) with t_compute held at the measured single-device
    per-iteration time; the three communication times need a measured link
    rate and reduction latency, so it is 1.0 for one device and "not
    measured" otherwise.  Traffic terms:

    - fine halos: each sharded axis exchanges one boundary plane per face
      per fine apply (full-duplex links, send+recv each counted once);
    - **coarse seam**: with coarse levels replicated and the level-0
      transfer in the seam-local shard_map form (``dist/seam.py``, round
      5), the restrict's only collective is ONE ring all-reduce of the
      coarse (n/27) field — 2*(p-1)/p * n/27 bytes per device per cycle;
      prolongation is communication-free.  History: GSPMD's default
      lowering moved ~n/3 (all-reduce of the z-coarsened partial +
      all-gather, HLO-measured in round 4: 11264 B vs the round-3 ring
      estimate's 794 B on the 16x16x24 / 8-device case); the seam-local
      form realizes the n/27 ring the round-3 model optimistically
      assumed, and ``hlo_validate`` holds the model to the compiled HLO.
    """
    from tpusparse.dist.mesh import _factor2

    out = []
    itemsize = 4  # f32 inner fields carry the fine-level traffic
    for p in pts:
        pz, py = _factor2(p.n_devices)
        bz, by = p.nz // pz, p.ny // py
        plane_z = by * p.nx * itemsize      # z-face plane bytes
        plane_y = bz * p.nx * itemsize      # y-face plane bytes
        faces_z = 2 if pz > 1 else 0
        faces_y = 2 if py > 1 else 0
        halo_per_apply = faces_z * plane_z + faces_y * plane_y
        halo_per_iter = halo_per_apply * MODEL["fine_applies_per_iter"]
        # fine/coarse seam (seam-local form, see docstring): one ring
        # all-reduce of the coarse field per V-cycle
        n27 = (p.nx * p.ny * p.nz) // MODEL["coarsen_ratio"]
        seam_per_iter = int(
            n27 * itemsize
            * 2.0 * (p.n_devices - 1) / max(p.n_devices, 1)
        )
        out.append(
            {
                "n_devices": p.n_devices,
                "mesh": [pz, py],
                "halo_bytes_per_iter": int(halo_per_iter),
                "coarse_seam_bytes_per_iter": seam_per_iter,
                # +1: the seam collective round
                "collective_rounds_per_iter": MODEL["psums_per_iter"] + 1,
                "t_iter_1dev_s": t_iter_1dev,
                "projected_efficiency": (
                    1.0 if p.n_devices == 1 else "not measured"
                ),
            }
        )
    return out


def hlo_validate(per_device: int = 8, n_devices: int = 8) -> dict:
    """Machine-check comm_model's VOLUME terms against the collectives the
    compiled sharded programs actually contain (post-SPMD HLO), on a weak-
    scaling-shaped grid.  Returns a record for the scaling JSON; after
    this only the model's bandwidth/latency constants are assumptions.
    (Round-3 verdict item 4; test_hlo_comm.py asserts the same terms.)"""
    import numpy as np

    from tpusparse.amg import AMGParams, gamg_setup, vcycle
    from tpusparse.dist import make_mesh, shard_hierarchy, shard_system
    from tpusparse.dist.mesh import _factor2
    from tpusparse.grid.grid3d import Grid3D
    from tpusparse.grid.poisson import poisson_stencil
    from tpusparse.utils.hlostats import compiled_collectives

    pz, py = _factor2(n_devices)
    nx, ny, nz = per_device, per_device * py, per_device * pz
    grid = Grid3D(nx, ny, nz)
    op, b, exact = poisson_stencil(grid, dtype=np.float32)
    hier = gamg_setup(op, AMGParams(coarse_eq_limit=30))
    mesh = make_mesh(n_devices)
    op_s, b_s, _ = shard_system(op, b, exact, mesh)
    hier_s = shard_hierarchy(hier, mesh)

    itemsize = 4
    plane_z = (ny // py) * nx * itemsize
    plane_y = (nz // pz) * nx * itemsize
    halo_model = (2 if pz > 1 else 0) * plane_z + (
        2 if py > 1 else 0
    ) * plane_y

    mv = compiled_collectives(lambda o, x: o.mv(x), op_s, b_s)
    vc = compiled_collectives(lambda h, r: vcycle(h, r), hier_s, b_s)
    mv_cp = mv.get("collective-permute", {"bytes": 0})["bytes"]
    vc_cp = vc.get("collective-permute", {"bytes": 0})["bytes"]
    # seam-local transfer (dist/seam.py): the V-cycle's only non-halo
    # collective must be the ONE coarse-field psum of the level-0
    # restrict; ring-moved bytes = 2*(p-1)/p * payload
    import numpy as _np

    coarse_bytes = (
        int(_np.prod(hier.levels[0].transfer.c_shape)) * itemsize
    )
    seam_model = int(coarse_bytes * 2.0 * (n_devices - 1) / n_devices)
    ar = vc.get("all-reduce", {"bytes": 0, "count": 0})
    vc_seam = int(ar["bytes"] * 2.0 * (n_devices - 1) / n_devices)
    rec = {
        "grid": [nx, ny, nz],
        "n_devices": n_devices,
        "halo_bytes_per_apply": {"model": halo_model, "hlo": mv_cp},
        "vcycle_halo_bytes": {
            "model": (MODEL["fine_applies_per_iter"] - 1) * halo_model,
            "hlo": vc_cp,
        },
        "coarse_seam_bytes": {"model": seam_model, "hlo": vc_seam},
        # round-4 verdict weak #6: the acceptance tolerance is RECORDED so
        # the check cannot silently loosen.  Halos must match exactly;
        # the seam payload must match exactly (one psum of the coarse
        # field) and carry no all-gather at all.
        "tolerance": {"halo": "exact", "seam": "exact",
                      "seam_allgather_bytes": 0},
        "match": bool(
            mv_cp == halo_model
            and vc_cp == (MODEL["fine_applies_per_iter"] - 1) * halo_model
            and ar["bytes"] == coarse_bytes
            and vc.get("all-gather", {"bytes": 0})["bytes"] == 0
        ),
    }
    return rec


def efficiency(pts: list[ScalingPoint], weak: bool) -> dict[int, float]:
    """Scaling efficiency vs the smallest device count in the sweep.

    Weak mode reports the nnz*iters/s rate efficiency (matching BASELINE's
    metric); ``tts_efficiency`` below reports the TIME-TO-SOLUTION form
    that does NOT credit iteration growth as useful work (round-2 review:
    the rate metric alone can hide convergence regressions)."""
    base = pts[0]
    out = {}
    for p in pts:
        scale = p.n_devices / base.n_devices
        if weak:
            out[p.n_devices] = (p.nnz_per_s / base.nnz_per_s) / scale
        else:
            out[p.n_devices] = base.t_solve / (p.t_solve * scale)
    return out


def tts_efficiency(pts: list[ScalingPoint]) -> dict[int, float]:
    """Weak-scaling TIME-TO-SOLUTION efficiency: ideal weak scaling solves
    the p-times-larger problem in the same wall time, so
    eff = t_solve(base) / t_solve(p).  Iteration growth counts AGAINST
    this metric (unlike the nnz-rate form)."""
    base = pts[0]
    return {p.n_devices: base.t_solve / p.t_solve for p in pts}


def save_json(
    pts: list[ScalingPoint], mode: str, path: pathlib.Path,
    t_iter_1dev: float | None = None,
) -> None:
    backend = jax.default_backend()
    rec = {
        "mode": mode,
        "backend": backend,
        # emulated = the "devices" are XLA host-emulated CPU devices
        # timesharing one core: wall times validate code paths (halo
        # exchange, psum, iteration parity), NOT hardware scaling — plots
        # watermark such records (review finding, round 3)
        "emulated": backend == "cpu",
        "points": [dataclasses.asdict(p) for p in pts],
        "efficiency": efficiency(pts, weak=(mode == "weak")),
    }
    if mode == "weak":
        rec["tts_efficiency"] = tts_efficiency(pts)
    if mode == "weak":
        # measured per-iteration compute time anchors the projection; on an
        # emulated mesh it is still a real single-process measurement
        t1 = t_iter_1dev or pts[0].t_solve / max(pts[0].iters, 1)
        rec["projection_model"] = dict(MODEL, t_iter_1dev_s=t1)
        rec["projection"] = comm_model(pts, t1)
        # machine-checked volume terms: the model's halo/seam byte counts
        # vs the collectives in the compiled HLO (verdict item 4)
        try:
            rec["hlo_validation"] = hlo_validate(
                per_device=min(pts[-1].nx, 16),
                n_devices=pts[-1].n_devices,
            )
        except Exception as e:  # record the failure, don't hide the sweep
            rec["hlo_validation"] = {"error": repr(e)}
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(rec, indent=2))
    print(f"wrote {path}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("mode", choices=["strong", "weak"])
    ap.add_argument("--n", type=int, default=128, help="grid edge (strong)")
    ap.add_argument(
        "--per-device", type=int, default=64, help="per-device edge (weak)"
    )
    ap.add_argument("--devices", default="1,2,4,8")
    ap.add_argument("--rtol", type=float, default=1e-8)
    ap.add_argument("--precision", default="mixed")
    ap.add_argument("--out", default="runs/scaling_{mode}.json")
    ap.add_argument(
        "--t-iter", type=float, default=None,
        help="per-iteration compute time (s) anchoring the weak-scaling"
        " projection; pass the CHIP-measured value when the sweep itself"
        " runs on an emulated mesh (default: measured from the 1-device"
        " point of this sweep)",
    )
    args = ap.parse_args(argv)

    counts = [int(c) for c in args.devices.split(",")]
    if max(counts) > len(jax.devices()):
        print(
            f"requested {max(counts)} devices but only {len(jax.devices())} "
            f"available; set XLA_FLAGS=--xla_force_host_platform_device_count=N"
            f" JAX_PLATFORMS=cpu for host emulation",
            file=sys.stderr,
        )
        return 2
    kw = dict(rtol=args.rtol, precision=args.precision)
    if args.mode == "strong":
        pts = run_strong(args.n, counts, **kw)
    else:
        pts = run_weak(args.per_device, counts, **kw)
    eff = efficiency(pts, weak=(args.mode == "weak"))
    for d, e in eff.items():
        print(f"  {d} devices: efficiency {e*100:.1f}%")
    save_json(
        pts, args.mode, pathlib.Path(args.out.format(mode=args.mode)),
        t_iter_1dev=args.t_iter,
    )
    return 0


if __name__ == "__main__":
    jax.config.update("jax_enable_x64", True)
    raise SystemExit(main())
