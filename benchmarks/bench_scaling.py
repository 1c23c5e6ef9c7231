"""Weak-scaling harness: nnz/s and per-iteration time at 1..N devices.

BASELINE.md scaling targets: ">= 80% weak-scaling efficiency (SpMV +
precond apply)" with report points at 1 chip / 1 host / N >= 2 hosts.  This
harness runs the distributed solve (halo-exchange SpMV + distributed Schur
preconditioner, parallel/solve.py + parallel/schur.py) on a banded
regularized saddle-point system whose size grows with the device count
(constant rows per device = weak scaling), and records per-iteration time,
work-model nnz/s, and efficiency vs the 1-device point.

On GPUs the mesh devices are cards and the numbers are true scaling;
with XLA's virtual CPU devices (--force-cpu-devices N, the only
multi-device option in this environment) all shards share one host's cores,
so the table validates the harness, the collectives, and the O(rows/ndev)
memory layout rather than genuine parallel speedup — the artifact states
which mode produced it.

Usage:
    python benchmarks/bench_scaling.py [--rows-per-dev 125000]
        [--devices 1,2,4,8] [--iters 5] [--force-cpu-devices 8]
        [--big-rows 10000000]   # optional 10M-row single-point demo

Writes reports/SCALING_REPORT.json (git-ignored) and prints one JSON line
per point.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def _run_point(ndev: int, rows: int, iters: int, dtype):
    import jax
    from jax.sharding import Mesh

    from cpkrylov_tpu import SolverOptions
    from cpkrylov_tpu.parallel.schur import plan_schur_precond
    from cpkrylov_tpu.parallel.solve import dist_solve, plan_dist
    from cpkrylov_tpu.precond.cp import make_preconditioner
    from cpkrylov_tpu.utils import fixtures
    from cpkrylov_tpu.utils.profiling import work_model

    n = rows
    m = rows // 4
    t0 = time.perf_counter()
    # slope-matched B: the constraint structure whose riffle chunking
    # aligns with equal row shards, so the Schur factor's sharded-exchange
    # apply (O(N/ndev + s) comms) is on the hot path being scaled.
    sysm = fixtures.banded_saddle_system(n, m, bandwidth=3,
                                         g_mode="banded", b_mode="slope",
                                         with_oracle=False)
    gen_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    precond = "schur"
    # Lean configuration (nitref=0, exact direct factor): the production
    # mixed-precision path's inner setting, and the regime where the
    # Schur-native sharded apply (O(N/ndev + s) comms) engages.
    import dataclasses as _dc

    from cpkrylov_tpu import PrecondOptions
    lean = PrecondOptions(nitref=0)
    try:
        M = plan_schur_precond(sysm.G, sysm.B, sysm.C, ndev, panel=128,
                               options=lean, dtype=dtype)
        M = _dc.replace(M, factor_nitref=0)
    except ValueError:
        M = make_preconditioner(sysm.G, sysm.B, sysm.C, options=lean,
                                dtype=dtype)
        precond = "replicated"
    build_s = time.perf_counter() - t0

    mesh = Mesh(np.array(jax.devices()[:ndev]), ("rows",))
    # atol=rtol=0 -> stop_tol 0: run exactly `iters` iterations.
    opts = SolverOptions(atol=0.0, rtol=0.0, itmax=iters)

    def run():
        res, x1, x2 = dist_solve(mesh, "cpminres", sysm.b, sysm.A, sysm.B,
                                 sysm.C, sysm.G, opts=opts, M=M,
                                 dtype=dtype)
        jax.block_until_ready(x1)
        return res

    t0 = time.perf_counter()
    run()
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = run()
    solve_s = time.perf_counter() - t0

    plan = plan_dist(sysm.A, sysm.B, sysm.C, ndev, dtype=dtype)
    halo_hot = (plan.halos["a"] is not None and plan.halos["c"] is not None)
    work = work_model(M, int(sysm.A.nnz), int(sysm.C.nnz))
    per_iter = solve_s / max(int(res.niters), 1)

    # Shared-silicon control: the SAME system solved serially on ONE
    # virtual device.  On virtual CPU meshes all "devices" share the same
    # host cores, so weak-scaling efficiency is meaningless by
    # construction; the meaningful number is the DISTRIBUTION OVERHEAD
    # (sharded time / serial time at equal total work on equal silicon).
    serial_per_iter = None
    overhead = None
    if ndev > 1:
        from cpkrylov_tpu import solve as _serial_solve

        Ms = make_preconditioner(sysm.G, sysm.B, sysm.C,
                                 options=PrecondOptions(nitref=0),
                                 dtype=dtype)
        Ms = _dc.replace(Ms, factor_nitref=0)

        def srun():
            out = _serial_solve("cpminres", sysm.b, sysm.A, sysm.B, sysm.C,
                                sysm.G, opts=opts, M=Ms,
                                dtype=dtype if dtype == np.float32 else None,
                                refine=False)
            return out

        srun()
        t0 = time.perf_counter()
        sout = srun()
        serial_s = time.perf_counter() - t0
        serial_per_iter = serial_s / max(int(sout.niters), 1)
        overhead = per_iter / serial_per_iter

    return {
        "ndev": ndev,
        "rows": n + m,
        "nnz": int(sysm.A.nnz + 2 * sysm.B.nnz + sysm.C.nnz),
        "precond": precond,
        "halo_hot_path": bool(halo_hot),
        "iters": int(res.niters),
        "istatus": int(res.istatus),
        # Forced-iteration timing run (rtol=0): exits on itmax or the
        # indefiniteness guard BY DESIGN — gnnz/s is a work-model rate over
        # non-converging iterations, not a solve (VERDICT r3 weak #4).
        "converged": False,
        "timing_mode": "forced-iteration (rtol=0), not a convergent solve",
        "gen_s": round(gen_s, 2),
        "precond_build_s": round(build_s, 2),
        "compile_s": round(compile_s, 2),
        "per_iter_s": round(per_iter, 5),
        "gnnz_per_s": round(work.nnz_per_iter / per_iter / 1e9, 4),
        "serial_per_iter_s": (round(serial_per_iter, 5)
                              if serial_per_iter else None),
        "dist_overhead_factor": (round(overhead, 2) if overhead else None),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows-per-dev", type=int, default=125_000)
    ap.add_argument("--devices", default="1,2,4,8")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--force-cpu-devices", type=int, default=0,
                    help="use N virtual CPU devices (single-host emulation)")
    ap.add_argument("--big-rows", type=int, default=0,
                    help="also run one point at this many rows on the "
                         "largest device count (10M-row demo)")
    ap.add_argument("--f32", action="store_true",
                    help="run in f32 (default f64, the GPU's main path)")
    args = ap.parse_args()

    import os

    if args.force_cpu_devices:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count="
              f"{args.force_cpu_devices}")
    import jax

    if args.force_cpu_devices:
        jax.config.update("jax_platforms", "cpu")
    # f32 recurrences break down (indefiniteness guard) when rtol=0 forces
    # iterations past the f32 floor, truncating the measured iteration
    # count, so virtual-CPU validation always runs in f64.
    use_f64 = not args.f32 or bool(args.force_cpu_devices)
    dtype = np.float64 if use_f64 else np.float32
    if use_f64:
        jax.config.update("jax_enable_x64", True)

    devlist = [int(d) for d in args.devices.split(",")]
    avail = len(jax.devices())
    devlist = [d for d in devlist if d <= avail]
    mode = ("virtual-cpu" if args.force_cpu_devices
            else str(jax.devices()[0].device_kind))

    out = pathlib.Path(__file__).resolve().parent.parent / "reports"
    out.mkdir(exist_ok=True)
    out = out / "SCALING_REPORT.json"
    report = {
        "mode": mode,
        "note": ("virtual CPU devices share one host's cores: this table "
                 "validates the distributed path (halo collectives, Schur "
                 "preconditioner, O(rows/ndev) shards), not physical "
                 "scaling" if mode == "virtual-cpu" else
                 "real-device scaling"),
        "rows_per_dev": args.rows_per_dev,
        "points": [],
        "big_point": None,
    }

    def flush_report():
        pts = report["points"]
        if pts:
            base = pts[0]["gnnz_per_s"] / pts[0]["ndev"]
            for pt in pts:
                pt["weak_scaling_efficiency"] = round(
                    pt["gnnz_per_s"] / pt["ndev"] / base, 4)
        out.write_text(json.dumps(report, indent=1))

    for ndev in devlist:
        pt = _run_point(ndev, args.rows_per_dev * ndev, args.iters, dtype)
        report["points"].append(pt)
        print(json.dumps(pt), flush=True)
        flush_report()           # partial artifact survives a timeout

    if args.big_rows:
        report["big_point"] = _run_point(devlist[-1], args.big_rows,
                                         max(2, args.iters // 2), dtype)
        print(json.dumps(report["big_point"]), flush=True)
        flush_report()
    print(json.dumps({"wrote": str(out)}))


if __name__ == "__main__":
    main()
