"""Flagship benchmark: time to a 1e-6 true residual on the 1.25M-row banded
saddle system, solved in f64 through ``cpkrylov_tpu.solve`` (CPMINRES with
the GHN residual update and one forced refinement step per application).

Run from the repository root:  python bench.py

Times are warm solves, each ended by ``block_until_ready`` (best of 3);
compilation is reported separately as set-up.  On a GPU the report adds
the modeled device-memory traffic and its share of the card's peak
bandwidth (``PEAK_BYTES_PER_S``); a CPU run reports no roofline share.
Prints ONE JSON line; the full report is written to
``reports/BENCH_REPORT.json`` (git-ignored).
"""
from __future__ import annotations

import json
import pathlib
import time

import numpy as np

# Peak device-memory bandwidth per jax ``device_kind``, with its source.
# A device that is not listed is an error, never a default.
PEAK_BYTES_PER_S = {
    # NVIDIA H100 SXM5 80 GB (HBM3): 3.35 TB/s, NVIDIA H100 data sheet.
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def peak_bandwidth(device_kind: str) -> float:
    """Peak memory bandwidth (bytes/s) of a device kind in the table."""
    try:
        return PEAK_BYTES_PER_S[device_kind]
    except KeyError:
        raise KeyError(f"no peak bandwidth for device kind {device_kind!r}: "
                       "add it to PEAK_BYTES_PER_S with its source") from None


def _mat_bytes(mat, nrows: int, itemsize: int) -> float:
    """Device bytes one matvec moves: matrix arrays + operand read + result
    write."""
    if hasattr(mat, "device_bytes"):          # PGELL / SymPermuted / DIA
        m = mat.device_bytes
    elif hasattr(mat, "data"):                # CSR: data + col idx + row ids
        m = mat.data.size * (np.dtype(mat.data.dtype).itemsize + 8)
    elif hasattr(mat, "diag"):
        m = mat.diag.size * np.dtype(mat.diag.dtype).itemsize
    else:
        m = 0
    return float(m) + 2.0 * itemsize * nrows


def _factor_traffic(tf, itemsize: int) -> float:
    """Device bytes one triangular solve reads/writes for a prepared factor."""
    if hasattr(tf, "w_blocks"):   # ReducedScanTriFactor: r-state scan
        # inv_diag and w one pass each, plus ~4 effective passes over the
        # (nb, r, r) scan state (the scan does ~2 combines per element).
        isz = np.dtype(tf.w_blocks.dtype).itemsize
        return float(tf.inv_diag.size * isz + 2.0 * tf.w_blocks.size * isz
                     + 4.0 * tf.nblocks * tf.r * tf.r * isz)
    if hasattr(tf, "m_blocks"):               # ScanTriFactor: full-panel scan
        mbytes = tf.m_blocks.size * np.dtype(tf.m_blocks.dtype).itemsize
        return float(tf.inv_diag.size * itemsize + 4.0 * mbytes)
    # BlockTriFactor: dense panel inverses + ELL off-entries, read once.
    return float(tf.inv_diag.size * itemsize
                 + tf.off_data.size * (itemsize + 4)   # values + int32 cols
                 + 2.0 * tf.off_cols.shape[0] * itemsize)  # rhs/x passes


def bytes_per_iter(M, a_mat, c_mat, work, itemsize: int) -> float:
    """Modeled device traffic of one CPMINRES iteration."""
    N = M.n + M.m
    # Two permutations (read + write each) and the D^-1 read per solve.
    per_solve = (_factor_traffic(M.factor.tf1, itemsize)
                 + _factor_traffic(M.factor.tf2, itemsize)
                 + 5.0 * itemsize * N)
    # Lanczos recurrence: ~11 vector passes after fusion (coupled dots,
    # three-term updates, normalization, solution update).
    return (_mat_bytes(a_mat, M.n, itemsize) + _mat_bytes(c_mat, M.m, itemsize)
            + work.solves_per_iter * per_solve
            + work.kp_spmv_per_iter * _mat_bytes(M.kp, N, itemsize)
            + 11.0 * itemsize * N)


def main() -> None:
    import jax
    import jax.numpy as jnp

    from cpkrylov_tpu.utils.runtime import (enable_compile_cache,
                                            nvidia_smi_name_power)

    jax.config.update("jax_enable_x64", True)
    cache = enable_compile_cache()

    from cpkrylov_tpu import PrecondOptions, SolverOptions, solve
    from cpkrylov_tpu.ops.formats import Diagonal, csr_from_scipy
    from cpkrylov_tpu.precond.cp import make_preconditioner
    from cpkrylov_tpu.utils import fixtures
    from cpkrylov_tpu.utils.profiling import work_model

    dev = jax.devices()[0]
    on_cpu = dev.platform == "cpu"
    peak = None if on_cpu else peak_bandwidth(dev.device_kind)
    dtype = np.float64
    itemsize = 8
    n, m = (100_000, 25_000) if on_cpu else (1_000_000, 250_000)

    t0 = time.perf_counter()
    sysm = fixtures.banded_saddle_system(n, m, bandwidth=3, with_oracle=False)
    fixture_s = time.perf_counter() - t0
    popts = PrecondOptions(residual_update=True, nitref=1, force_itref=True)
    opts = SolverOptions(atol=0.0, rtol=1e-6, itmax=200)

    t0 = time.perf_counter()
    M = jax.block_until_ready(make_preconditioner(
        sysm.G, sysm.B, sysm.C, options=popts, dtype=dtype))
    ptime = time.perf_counter() - t0

    def run():
        return solve("cpminres", sysm.b, sysm.A, sysm.B, sysm.C, sysm.G,
                     opts=opts, precond_opts=popts, M=M)

    t0 = time.perf_counter()
    out = run()                                    # compile + warm-up
    first_s = time.perf_counter() - t0
    stimes = []
    for _ in range(3):
        out = run()
        stimes.append(out.stime)
    best = min(stimes)

    x = np.asarray(out.x)
    r = sysm.b - np.concatenate([sysm.A @ x[:n] + sysm.B.T @ x[n:],
                                 sysm.B @ x[:n] - sysm.C @ x[n:]])
    rel_resid = float(np.linalg.norm(r) / np.linalg.norm(sysm.b))
    solved = bool(out.solved) and rel_resid <= 1e-6
    iters = int(out.niters)

    a_mat = csr_from_scipy(sysm.A.tocsr(), dtype=dtype)
    c_mat = Diagonal(diag=jnp.asarray(sysm.C.diagonal(), dtype=dtype))
    work = work_model(M, int(sysm.A.nnz), int(sysm.C.nnz))
    bpi = bytes_per_iter(M, a_mat, c_mat, work, itemsize)
    report = {
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "nvidia_smi_name_power_limit": nvidia_smi_name_power(),
        "workload": f"banded_saddle n={n} m={m} bw=3, CPMINRES f64, "
                    "residual_update + nitref=1 + force_itref, stop at "
                    "rtol=1e-6, checked on the f64 true residual",
        "solved": solved,
        "iters": iters,
        "true_rel_residual": rel_resid,
        "warm_solve_s": stimes,
        "setup_s": {"fixture": fixture_s, "precond_build": ptime,
                    "first_call": first_s},
        "compile_cache": cache,
        "bytes_per_iter_model": bpi,
        "a_format": type(a_mat).__name__,
        "kp_format": type(M.kp).__name__,
        "tf1": type(M.factor.tf1).__name__,
        "tf2": type(M.factor.tf2).__name__,
        "factor": M.factor_kind,
    }
    if peak is not None:
        achieved = bpi * iters / best
        report["achieved_bytes_per_s_model"] = achieved
        report["peak_bytes_per_s"] = peak
        report["roofline_share"] = achieved / peak
    out_dir = pathlib.Path(__file__).resolve().parent / "reports"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "BENCH_REPORT.json").write_text(json.dumps(report, indent=1))

    line = {"metric": f"time_to_tol_f64[{dev.device_kind}]"
                      + ("" if solved else "[UNSOLVED]"),
            "value": best, "unit": "s", "iters": iters}
    if peak is not None:
        line["roofline_share"] = report["roofline_share"]
    print(json.dumps(line))


if __name__ == "__main__":
    main()
